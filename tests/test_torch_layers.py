"""The port's core ops (``accelerate_tpu_torch/ops/layers.py`` and the KV
helpers of ``ops/fp8.py``) held against the JAX package on the same numpy
inputs.

Tolerances: f32 elementwise ops 1e-6 (the same IEEE operations in another
order at most); the RoPE tables are built by the same float64 numpy code in
both packages and must agree bit for bit; bf16 RoPE rotates in bf16 on both
sides, 1e-2 (two bf16 ulps at |x| ~ 1); the KV quantizers perform the same
f32 operations and must give identical bytes and scales.

``write_paged_kv``'s drop rules differ in mechanism: JAX discards a dropped
lane (``mode="drop"``/``mode="fill"``), the port routes it to the null
block 0, which is never attended. So every non-null block must agree with
JAX byte for byte, and dropped lanes must leave every non-null block as it
was.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.ops import fp8 as jfp8  # noqa: E402
from accelerate_tpu.ops import layers as jlayers  # noqa: E402
from accelerate_tpu_torch.ops import fp8 as tfp8  # noqa: E402
from accelerate_tpu_torch.ops import layers as tlayers  # noqa: E402

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    ref = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_rms_norm_accumulates_in_f32_and_casts_back():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    got = tlayers.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(w).to(torch.bfloat16))
    ref = jlayers.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


@pytest.mark.parametrize("head_dim,max_seq", [(16, 64), (128, 4096)])
def test_rope_frequencies_identical_to_jax(head_dim, max_seq):
    """Built in float64 numpy then cast to f32, as in JAX: equal bit for
    bit even at the longest positions (f32 arithmetic would drift)."""
    jcos, jsin = jlayers.rope_frequencies(head_dim, max_seq)
    tcos, tsin = tlayers.rope_frequencies(head_dim, max_seq)
    assert tcos.dtype == torch.float32 and tcos.shape == (max_seq, head_dim // 2)
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2], [7, 40, 63]], np.int32)
    jcos, jsin = jlayers.rope_frequencies(16, 64)
    tcos, tsin = tlayers.rope_frequencies(16, 64)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jlayers.apply_rope(jnp.asarray(x, jdt), jcos, jsin, jnp.asarray(pos))
    got = tlayers.apply_rope(torch.from_numpy(x).to(tdt), tcos, tsin, torch.from_numpy(pos))
    assert got.dtype == tdt  # rotates in x.dtype
    tol = 1e-6 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("store", ["int8", "fp8"])
def test_quantize_kv_rows_identical_to_jax(store):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(2, 3, 4, 16)) * 3).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero row keeps scale 1
    x[1, 0, 0, :4] = [0.5, -0.5, 1.5, 127.0 / 254]  # rounding ties
    jdt, _ = jfp8.kv_storage_dtype(store)
    tdt, quantized = tfp8.kv_storage_dtype(store)
    assert quantized and tfp8.kv_qmax(tdt) == jfp8.kv_qmax(jdt)
    jq, js = jfp8.quantize_kv_rows(jnp.asarray(x), jdt)
    tq, ts = tfp8.quantize_kv_rows(torch.from_numpy(x), tdt)
    assert tq.dtype == tdt and ts.dtype == torch.float32 and ts.shape == (2, 3, 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 1, 2].item() == 1.0
    np.testing.assert_array_equal(tq.view(torch.uint8 if store == "fp8" else torch.int8).numpy(),
                                  np.asarray(jq).view(np.uint8 if store == "fp8" else np.int8))
    np.testing.assert_array_equal(tfp8.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jfp8.dequantize_kv(jq, js)))


def test_kv_storage_dtype_names():
    assert tfp8.kv_storage_dtype("bf16") == (torch.bfloat16, False)
    assert tfp8.kv_storage_dtype("f32") == (torch.float32, False)
    assert tfp8.KV_STORAGE_DTYPES == jfp8.KV_STORAGE_DTYPES
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tfp8.kv_storage_dtype("int4")
    with pytest.raises(ValueError, match="not a quantized"):
        tfp8.kv_qmax(torch.bfloat16)


# ---------------------------------------------------------------------------
# write_paged_kv: scatter through the block tables, with drops
# ---------------------------------------------------------------------------

NB, BS, NKV, HD = 9, 4, 2, 8


def _tables():
    """Row 0 owns blocks 3, 5; row 1 owns 1, 2, 4 (both tables 4 wide)."""
    return np.asarray([[3, 5, 0, 0], [1, 2, 4, 0]], np.int32)


def _both_pools(rng, store):
    """Identical non-zero starting pools for both packages (so an unwanted
    write shows), plus scale pools when quantized."""
    base = rng.normal(size=(NB, BS, NKV, HD)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
                "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[store]
    jk, jv = jnp.asarray(base, jdt), jnp.asarray(-base, jdt)

    def same_bytes(a):  # numpy has no fp8: carry the bytes across as uint8
        if store == "fp8":
            return torch.from_numpy(np.asarray(a).view(np.uint8).copy()).view(tdt)
        return torch.from_numpy(np.asarray(a).copy())

    jp, tp = [jk, jv], [same_bytes(jk), same_bytes(jv)]
    if store != "f32":
        sc = rng.uniform(0.5, 2.0, size=(NB, BS, NKV)).astype(np.float32)
        jp += [jnp.asarray(sc), jnp.asarray(sc * 2)]
        tp += [torch.from_numpy(sc.copy()), torch.from_numpy(sc * 2)]
    return jp, tp


def _bytes(t):
    return (t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t).numpy().copy()


def _jbytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _write_both(jp, tp, k, v, bt, pos, mask):
    quant = len(jp) == 4
    jkw = {"k_scale_l": jp[2], "v_scale_l": jp[3]} if quant else {}
    tkw = {"k_scale_l": tp[2], "v_scale_l": tp[3]} if quant else {}
    jout = jlayers.write_paged_kv(jp[0], jp[1], jnp.asarray(k), jnp.asarray(v), bt, pos,
                                  write_mask=None if mask is None else jnp.asarray(mask), **jkw)
    tlayers.write_paged_kv(tp[0], tp[1], torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(bt), torch.from_numpy(pos),
                           write_mask=None if mask is None else torch.from_numpy(mask), **tkw)
    return list(jout)


@pytest.mark.parametrize("store", ["f32", "int8", "fp8"])
def test_write_paged_kv_matches_jax_on_every_live_block(store):
    """A prefill chunk with a padded tail (masked lanes) plus a decode lane
    past the table's end: every non-null block, payload and scales, is
    byte-identical to the JAX scatter."""
    rng = np.random.default_rng(4)
    jp, tp = _both_pools(rng, store)
    bt = _tables()
    s = 6
    k = rng.normal(size=(2, s, NKV, HD)).astype(np.float32)
    v = rng.normal(size=(2, s, NKV, HD)).astype(np.float32)
    pos = np.asarray([[2, 3, 4, 5, 6, 7], [11, 12, 13, 14, 15, 16]], np.int32)
    mask = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    jout = _write_both(jp, tp, k, v, bt, pos, mask)
    for j_arr, t_arr in zip(jout, tp):
        np.testing.assert_array_equal(_bytes(t_arr)[1:], _jbytes(j_arr)[1:])


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_dropped_lanes_leave_every_live_block_untouched(store):
    """Masked lanes (a free or prefilling slot during decode) and positions
    past the table (``positions // bs >= max_blocks``) never write a
    non-null block — in particular never the slot's own last block, which a
    clamp would hit."""
    rng = np.random.default_rng(5)
    _, tp = _both_pools(rng, store)
    before = [_bytes(t) for t in tp]
    bt = _tables()
    k = rng.normal(size=(2, 1, NKV, HD)).astype(np.float32)
    v = rng.normal(size=(2, 1, NKV, HD)).astype(np.float32)
    quant = len(tp) == 4
    kw = {"k_scale_l": tp[2], "v_scale_l": tp[3]} if quant else {}
    # row 0 masked off; row 1 at position 16 = table entry 4 of a 4-wide table
    tlayers.write_paged_kv(tp[0], tp[1], torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(bt), torch.tensor([[5], [16]]),
                           write_mask=torch.tensor([[False], [True]]), **kw)
    # and every lane past the table, no mask at all
    tlayers.write_paged_kv(tp[0], tp[1], torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(bt), torch.tensor([[16], [17]]), **kw)
    for b0, t in zip(before, tp):
        np.testing.assert_array_equal(_bytes(t)[1:], b0[1:])


def test_write_paged_kv_casts_to_the_pool_dtype():
    rng = np.random.default_rng(6)
    kp = torch.zeros((NB, BS, NKV, HD), dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    k = rng.normal(size=(1, 2, NKV, HD)).astype(np.float32)
    out = tlayers.write_paged_kv(kp, vp, torch.from_numpy(k), torch.from_numpy(-k),
                                 torch.tensor([[2, 0]], dtype=torch.int32),
                                 torch.tensor([[0, 1]]))
    assert out[0] is kp  # updated in place
    np.testing.assert_array_equal(kp[2, :2].float().numpy(),
                                  torch.from_numpy(k[0]).to(torch.bfloat16).float().numpy())


def test_gather_and_cached_attention_match_jax():
    """The gather reference: span gathered through the tables, then dense
    cached attention with per-row valid prefixes, GQA by grouped heads."""
    rng = np.random.default_rng(7)
    kp = rng.normal(size=(NB, BS, NKV, HD)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, NKV, HD)).astype(np.float32)
    bt = _tables()
    jk, jv = jlayers.gather_paged_kv(jnp.asarray(kp), jnp.asarray(vp), bt)
    tk, tv = tlayers.gather_paged_kv(torch.from_numpy(kp), torch.from_numpy(vp),
                                     torch.from_numpy(bt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    q = rng.normal(size=(2, 3, 4, HD)).astype(np.float32)
    idx = np.asarray([4, 9], np.int32)
    ref = jlayers.cached_attention(jnp.asarray(q), jk, jv, jnp.asarray(idx))
    got = tlayers.cached_attention(torch.from_numpy(q), tk, tv, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
