"""C4b and C4c: every attention kernel of the port takes any head dim.

The plain versions of B1-B3 (``ops/flash_attention.py``) and of B4
(``ops/paged_attention.py``) — what the CUDA kernels compute, which
``chip_smoke.py`` holds the kernels to on the card — are held against the
JAX package on the same numpy inputs at head dims off every built width:
20 and 36 (not multiples of 8: B1-B3 are handed zero-padded inputs, B4
reads the pool at its real width) and 200 and 256 (past the tensor-core
kernels' 128), and 264, 300 and 512 (past 256, where the kernels walk the
head dim in column blocks of 256: 264 and 300 leave a ragged last block,
512 two whole ones). JAX runs its Pallas kernels in interpret mode, as its own
tests do. Gates, as the existing port tests state them: flash f32 output
2e-5, lse 1e-5, gradients 2e-4 × max(|ref|, 1), bf16 output 3e-2 and
gradients 5e-2 × max(|ref|, 1); paged f32 pools 1e-5, int8 pools 1e-4.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.ops import layers as jlayers  # noqa: E402
from accelerate_tpu.ops.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
    pallas_paged_attention_available,
)
from accelerate_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from accelerate_tpu_torch.ops import layers as tlayers  # noqa: E402
from accelerate_tpu_torch.ops import paged_attention as tpa  # noqa: E402

jfa = importlib.import_module("accelerate_tpu.ops.flash_attention")

torch.set_num_threads(1)

#: the head dims of C4b (two off a multiple of 8, two past 128) and of C4c
#: (past 256: a ragged last column block at 264 and 300, two whole at 512)
HEAD_DIMS = (20, 36, 200, 256, 264, 300, 512)


def _flash_inputs(hd, seed, b=1, s=40, h=2, n_kv=None):
    rng = np.random.default_rng(seed)
    n_kv = n_kv or h
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, n_kv, hd), (b, s, n_kv, hd), (b, s, h, hd)))


def _jax_flash(q, k, v, mask, causal, do, dtype=jnp.float32):
    jm = None if mask is None else jnp.asarray(mask)

    def fn(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, segment_mask=jm, causal=causal, interpret=True)

    out, vjp = jax.vjp(fn, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, dtype))
    return (np.asarray(out.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port_flash(q, k, v, mask, causal, do, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = tfa.flash_attention(tq, tk, tv, tm, causal=causal)
    out.backward(torch.from_numpy(do).to(dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (tq, tk, tv)]


FLASH_CASES = {
    "causal_gqa": dict(causal=True, h=4, n_kv=2),
    "non_causal_left_padded": dict(causal=False, b=2, pad=9),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_flash_matches_jax_at_head_dims(hd, case):
    kw = dict(FLASH_CASES[case])
    causal, pad = kw.pop("causal"), kw.pop("pad", None)
    q, k, v, do = _flash_inputs(hd, seed=hd, **kw)
    mask = None
    if pad is not None:
        mask = np.ones(q.shape[:2], bool)
        mask[:, :pad] = False
    ref_o, ref_grads = _jax_flash(q, k, v, mask, causal, do)
    got_o, got_grads = _port_flash(q, k, v, mask, causal, do)
    np.testing.assert_allclose(got_o, ref_o, rtol=0, atol=2e-5)
    for g, r in zip(got_grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-4 * max(float(np.abs(r).max()), 1.0))


@pytest.mark.parametrize("hd", (20, 256, 300, 512))
def test_plain_flash_bf16_matches_jax_at_head_dims(hd):
    q, k, v, do = _flash_inputs(hd, seed=3 + hd, h=4, n_kv=2)
    ref_o, ref_grads = _jax_flash(q, k, v, None, True, do, jnp.bfloat16)
    got_o, got_grads = _port_flash(q, k, v, None, True, do, torch.bfloat16)
    np.testing.assert_allclose(got_o, ref_o, rtol=0, atol=3e-2)
    for g, r in zip(got_grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=0, atol=5e-2 * max(float(np.abs(r).max()), 1.0))


#: the head dims where bf16 and f16 B1-B3 run their 256-wide tensor-core
#: instances: 136 and 200 (a quarter of zero columns staged, 200 not a
#: multiple of 16), 192 and 256; and each 16-bit dtype's gates (output;
#: gradients × max(|ref|, 1)): the JAX tests' bf16 ones, and for f16 those
#: of ``tests/test_torch_precision.py`` (bf16's scaled by f16's 8× finer
#: mantissa), which ``chip_smoke.py`` holds the kernels to as ``FLASH_GATES``
WIDE_16BIT_HEAD_DIMS = (136, 192, 200, 256)
#: the (head dim, query heads, kv heads) cases of the wide 16-bit test: GQA
#: 8/2 at each of :data:`WIDE_16BIT_HEAD_DIMS`, and GPT-J-6B's head layout
#: (one kv head a query head, no GQA) at 256, where B3's block sums no heads
WIDE_16BIT_CASES = [(hd, 8, 2) for hd in WIDE_16BIT_HEAD_DIMS] + [(256, 4, 4)]
WIDE_16BIT_IDS = [str(hd) for hd in WIDE_16BIT_HEAD_DIMS] + ["256-no_gqa"]
GATES_16BIT = {"bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 5e-2),
               "f16": (jnp.float16, torch.float16, 4e-3, 8e-3)}


@pytest.mark.parametrize("causal", (True, False), ids=("causal", "not_causal"))
@pytest.mark.parametrize("dtype", list(GATES_16BIT))
@pytest.mark.parametrize("hd, h, n_kv", WIDE_16BIT_CASES, ids=WIDE_16BIT_IDS)
def test_plain_flash_16bit_matches_jax_at_wide_head_dims(hd, h, n_kv, dtype, causal):
    """The plain B1-B3 in bf16 and f16 at the head dims of the 256-wide
    tensor-core instances, held to the JAX Pallas kernels in interpret mode
    on the same 16-bit values: GQA 8/2 (and, at 256, GPT-J's 4/4), s = 200
    (a multiple of neither the kernels' key tiles nor their 128-row query
    tiles), a key mask whose first row is left-padded by 9 keys (causal:
    query rows 0-8 see no key) and whose second row is fully masked (output
    and gradients 0 there)."""
    jdt, tdt, o_gate, g_gate = GATES_16BIT[dtype]
    q, k, v, do = _flash_inputs(hd, seed=11 + hd, b=2, s=200, h=h, n_kv=n_kv)
    mask = np.ones((2, 200), bool)
    mask[0, :9] = False
    mask[1] = False
    ref_o, ref_grads = _jax_flash(q, k, v, mask, causal, do, jdt)
    got_o, got_grads = _port_flash(q, k, v, mask, causal, do, tdt)
    np.testing.assert_allclose(got_o, ref_o, rtol=0, atol=o_gate)
    assert not got_o[1].any() and all(not g[1].any() for g in got_grads)
    for g, r in zip(got_grads, ref_grads):
        np.testing.assert_allclose(g, r, rtol=0, atol=g_gate * max(float(np.abs(r).max()), 1.0))


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_kernel_route_pads_the_head_dim_and_slices_back(hd, monkeypatch):
    """The CUDA route's shape handling, with the kernels replaced by their
    plain versions at the width they are handed: q, k, v and dO arrive
    zero-padded to a multiple of 8 (TMA's 16-byte rows), the scale is the
    real head dim's, and the outputs come back at the real width — equal to
    the plain versions on the unpadded inputs."""
    seen = []

    def fwd(q, k, v, mask, scale, causal):
        seen.append(("fwd", q.shape[-1], k.shape[-1], v.shape[-1]))
        return tfa._flash_fwd_plain(q, k, v, mask, scale, causal)

    def bwd_dq(q, k, v, mask, lse, delta, do, scale, causal):
        seen.append(("dq", q.shape[-1], do.shape[-1]))
        o = torch.zeros_like(q)  # delta is handed in: the plain backward's o only feeds it
        dq, _, _ = _plain_bwd_with_delta(q, k, v, mask, o, lse, delta, do, scale, causal)
        return dq

    def bwd_dkv(q, k, v, mask, lse, delta, do, scale, causal):
        seen.append(("dkv", q.shape[-1], do.shape[-1]))
        o = torch.zeros_like(q)
        _, dk, dv = _plain_bwd_with_delta(q, k, v, mask, o, lse, delta, do, scale, causal)
        return dk, dv

    monkeypatch.setattr(tfa, "_flash_fwd_launch", fwd)
    monkeypatch.setattr(tfa, "_bwd_dq_cuda", bwd_dq)
    monkeypatch.setattr(tfa, "_bwd_dkv_cuda", bwd_dkv)
    q, k, v, do = (torch.from_numpy(x) for x in _flash_inputs(hd, seed=7 + hd, h=4, n_kv=2))
    scale = 1.0 / np.sqrt(hd)
    o, lse = tfa._flash_fwd_cuda(q, k, v, None, scale, True)
    ref_o, ref_lse = tfa._flash_fwd_plain(q, k, v, None, scale, True)
    assert o.shape == q.shape and o.is_contiguous()
    torch.testing.assert_close(o, ref_o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-6)
    grads = tfa._flash_bwd_cuda(q, k, v, None, o, lse, do, scale, True)
    ref_grads = tfa._flash_bwd_plain(q, k, v, None, o, lse, do, scale, True)
    for g, r, x in zip(grads, ref_grads, (q, k, v)):
        assert g.shape == x.shape and g.is_contiguous()
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
    width = -(-hd // 8) * 8
    assert seen == [("fwd", width, width, width), ("dq", width, width), ("dkv", width, width)]


def _plain_bwd_with_delta(q, k, v, mask, o, lse, delta, do, scale, causal):
    """The plain backward with ``delta`` given (the kernels' interface):
    ``_delta(o, do)`` is replaced for the one call."""
    original = tfa._delta
    tfa._delta = lambda _o, _do: delta
    try:
        return tfa._flash_bwd_plain(q, k, v, mask, o, lse, do, scale, causal)
    finally:
        tfa._delta = original


def test_takes_head_dim_is_the_one_rule():
    """C4c: no upper bound. Every head dim from 1 is taken, past 256 too;
    only a head dim below 1 is refused, with the rule named, before any
    build; the kernels run at the next multiple of 8."""
    assert tfa.HEAD_DIM_RULE == "any head dim of at least 1"
    for hd in (1, 20, 256, 257, 264, 300, 512, 1024, 4096):
        assert tfa.takes_head_dim(hd)
    for hd in (0, -8):
        assert not tfa.takes_head_dim(hd)
    with pytest.raises(ValueError, match="any head dim of at least 1"):
        tfa._kernel_head_dim(0)
    assert [tfa._kernel_head_dim(hd) for hd in (1, 20, 36, 200, 256, 257, 300, 512)] == [
        8, 24, 40, 200, 256, 264, 304, 512]


# -- B4 ----------------------------------------------------------------------

_STORE = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


def _pools(rng, *, store, hd, s, b=2, n_kv=2, bs=4, mb=5, idx=(9, 14)):
    """Both packages' pools written position by position from the same
    numpy K/V through each package's ``write_paged_kv``, at the real head
    dim (the pool is never padded)."""
    nb = 1 + sum(min((ix + s - 1) // bs + 1, mb) for ix in idx) + 1
    bt = np.zeros((b, mb), np.int32)
    used = iter(range(1, nb))
    for i, ix in enumerate(idx):
        for j in range(min((ix + s - 1) // bs + 1, mb)):
            bt[i, j] = next(used)
    jdt, tdt = _STORE[store]
    quant = store != "f32"
    jp = [jnp.zeros((nb, bs, n_kv, hd), jdt), jnp.zeros((nb, bs, n_kv, hd), jdt)]
    tp = [torch.zeros((nb, bs, n_kv, hd), dtype=tdt), torch.zeros((nb, bs, n_kv, hd), dtype=tdt)]
    if quant:
        jp += [jnp.ones((nb, bs, n_kv), jnp.float32), jnp.ones((nb, bs, n_kv), jnp.float32)]
        tp += [torch.ones((nb, bs, n_kv)), torch.ones((nb, bs, n_kv))]
    for p in range(max(idx) + s):
        k = rng.normal(size=(b, 1, n_kv, hd)).astype(np.float32)
        v = rng.normal(size=(b, 1, n_kv, hd)).astype(np.float32)
        mask = np.asarray([[p < ix + s] for ix in idx])
        pos = np.full((b, 1), p, np.int32)
        scales = {"k_scale_l": jp[2], "v_scale_l": jp[3]} if quant else {}
        jp = list(jlayers.write_paged_kv(jp[0], jp[1], jnp.asarray(k), jnp.asarray(v), bt, pos,
                                         write_mask=mask, **scales))
        tscales = {"k_scale_l": tp[2], "v_scale_l": tp[3]} if quant else {}
        tlayers.write_paged_kv(tp[0], tp[1], torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(bt), torch.from_numpy(pos),
                               write_mask=torch.from_numpy(mask), **tscales)
    if not quant:
        jp += [None, None]
        tp += [None, None]
    return bt, np.asarray(idx, np.int32), jp, tp


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_paged_attention_matches_jax_at_head_dims(hd, store):
    """Decode and a 3-token chunk with 4 query heads over 2 kv heads, held
    to the JAX kernel (interpret mode, or its lax walk where Pallas is
    unavailable) and to its gather reference."""
    impl = "pallas" if pallas_paged_attention_available() else "lax"
    tol = 1e-5 if store == "f32" else 1e-4
    for s in (1, 3):
        rng = np.random.default_rng(50 + hd + s)
        bt, idx, jp, tp = _pools(rng, store=store, hd=hd, s=s)
        q = rng.normal(size=(2, s, 4, hd)).astype(np.float32)
        got = tpa.paged_attention(
            torch.from_numpy(q), tp[0], tp[1], torch.from_numpy(bt), torch.from_numpy(idx),
            k_scale_l=tp[2], v_scale_l=tp[3],
        ).numpy()
        assert got.shape == q.shape
        for jimpl in (impl, "gather"):
            ref = np.asarray(jax_paged_attention(
                jnp.asarray(q), jp[0], jp[1], bt, idx, k_scale_l=jp[2], v_scale_l=jp[3],
                impl=jimpl))
            np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=jimpl)


def test_paged_kernel_route_refuses_head_dims_past_256():
    """C4c: past 256 the CUDA route no longer refuses. Every head dim from 1
    (256, 264, 300 and 512 among them) passes the head-dim check and stops
    at the device check on these CPU tensors; a head dim of 0 is refused
    with the rule named, from the shapes alone, before any device check or
    build."""
    idx = torch.zeros(1, dtype=torch.int32)
    table = torch.zeros((1, 2), dtype=torch.int32)
    for hd, message in ((0, "any head dim of at least 1"),
                        (256, "every tensor must lie on q's CUDA device"),
                        (264, "every tensor must lie on q's CUDA device"),
                        (300, "every tensor must lie on q's CUDA device"),
                        (512, "every tensor must lie on q's CUDA device")):
        q = torch.zeros((1, 1, 2, hd))
        pool = torch.zeros((3, 4, 2, hd))
        with pytest.raises(ValueError, match=message):
            tpa.paged_attention(q, pool, pool, table, idx, impl="cuda")
