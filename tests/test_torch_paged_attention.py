"""The port's paged attention (``accelerate_tpu_torch/ops/paged_attention.py``)
held against the JAX package on the same numpy inputs.

On this CPU box the dispatcher runs the plain PyTorch version (the CUDA
kernel is held against that plain version on the card by
``chip_smoke.py``). The JAX side runs its Pallas kernel in interpret mode,
as ``tests/test_paged_attention.py`` does (the lax walk where Pallas is
unavailable), and its gather reference. Tolerances: f32 pools 1e-5 (the
JAX gate); int8/fp8 pools — written by both packages from the same numpy
K/V — dequantized pools 1e-6 and attention 1e-4.
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.ops import fp8 as jfp8  # noqa: E402
from accelerate_tpu.ops import layers as jlayers  # noqa: E402
from accelerate_tpu.ops.paged_attention import (  # noqa: E402
    paged_attention as jax_paged_attention,
    pallas_paged_attention_available,
)
from accelerate_tpu_torch.ops import fp8 as tfp8  # noqa: E402
from accelerate_tpu_torch.ops import layers as tlayers  # noqa: E402
from accelerate_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

_STORE = {
    "f32": (jnp.float32, torch.float32),
    "int8": (jnp.int8, torch.int8),
    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
}


def _jax_kernel_impl() -> str:
    return "pallas" if pallas_paged_attention_available() else "lax"


def _pools(rng, *, store="f32", b=3, n_kv=2, hd=16, bs=4, mb=5, idx=(9, 6, 14), s=1):
    """Block tables partly filled (tails on block 0) and both packages'
    pools written position by position from the same numpy K/V, through
    each package's own ``write_paged_kv``. Returns numpy tables/idx plus
    ``(jax pools, torch pools)``, each ``(k, v, k_scale, v_scale)``."""
    nb = 1 + sum(min((ix + s - 1) // bs + 1, mb) for ix in idx) + 2
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


def _run_jax(q, bt, idx, jp, impl):
    return np.asarray(jax_paged_attention(
        jnp.asarray(q), jp[0], jp[1], bt, idx, k_scale_l=jp[2], v_scale_l=jp[3], impl=impl,
    ))


def _run_port(q, bt, idx, tp, impl=None):
    return tpa.paged_attention(
        torch.from_numpy(q), tp[0], tp[1], torch.from_numpy(bt), torch.from_numpy(idx),
        k_scale_l=tp[2], v_scale_l=tp[3], impl=impl,
    ).numpy()


CASES = [  # (s, n_heads, n_kv): decode and a 4-token chunk, MHA and GQA
    (1, 2, 2), (1, 8, 2), (4, 2, 2), (4, 8, 2),
]


@pytest.mark.parametrize("s,nh,n_kv", CASES)
def test_plain_matches_jax_kernel_f32(s, nh, n_kv):
    rng = np.random.default_rng(10 + s + nh)
    bt, idx, jp, tp = _pools(rng, n_kv=n_kv, s=s)
    q = rng.normal(size=(3, s, nh, 16)).astype(np.float32)
    ref = _run_jax(q, bt, idx, jp, _jax_kernel_impl())
    np.testing.assert_allclose(_run_port(q, bt, idx, tp), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,nh,n_kv", CASES)
def test_plain_matches_jax_gather_f32(s, nh, n_kv):
    rng = np.random.default_rng(20 + s + nh)
    bt, idx, jp, tp = _pools(rng, n_kv=n_kv, s=s)
    q = rng.normal(size=(3, s, nh, 16)).astype(np.float32)
    ref = _run_jax(q, bt, idx, jp, "gather")
    np.testing.assert_allclose(_run_port(q, bt, idx, tp), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_run_port(q, bt, idx, tp, impl="gather"), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("store", ["int8", "fp8"])
@pytest.mark.parametrize("s", [1, 4])
def test_quantized_pools_match_jax(store, s):
    rng = np.random.default_rng(30 + s)
    bt, idx, jp, tp = _pools(rng, store=store, n_kv=2, s=s)
    # the same numpy K/V, quantized on scatter by each package; block 0 is
    # left out: the port routes dropped lanes there, JAX discards them
    for j_pool, j_scale, t_pool, t_scale in ((jp[0], jp[2], tp[0], tp[2]),
                                             (jp[1], jp[3], tp[1], tp[3])):
        np.testing.assert_allclose(
            tfp8.dequantize_kv(t_pool, t_scale).numpy()[1:],
            np.asarray(jfp8.dequantize_kv(j_pool, j_scale))[1:],
            rtol=1e-6, atol=1e-6,
        )
    q = rng.normal(size=(3, s, 8, 16)).astype(np.float32)
    for impl in (_jax_kernel_impl(), "gather"):
        np.testing.assert_allclose(_run_port(q, bt, idx, tp), _run_jax(q, bt, idx, jp, impl),
                                   rtol=1e-4, atol=1e-4)


def test_null_block_is_never_attended():
    """Block 0 pads every table tail; garbage there must not move the
    output (masking is by logical position, never by block id)."""
    rng = np.random.default_rng(40)
    bt, idx, _, tp = _pools(rng, n_kv=2, s=1)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    before = _run_port(q, bt, idx, tp)
    tp[0][0] = 1e4
    tp[1][0] = -1e4
    np.testing.assert_array_equal(_run_port(q, bt, idx, tp), before)


def test_rows_with_idx_at_block_edges():
    """``idx`` on and beside block edges, including 0, against JAX."""
    rng = np.random.default_rng(41)
    idx = (0, 3, 4, 5, 15)
    bt, idx, jp, tp = _pools(rng, n_kv=2, s=1, b=len(idx), idx=idx, mb=4)
    q = rng.normal(size=(len(idx), 1, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(_run_port(q, bt, idx, tp), _run_jax(q, bt, idx, jp, "gather"),
                               rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(42)
    bt, idx, _, tp = _pools(rng)
    q = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    before = tpa.launches
    np.testing.assert_array_equal(_run_port(q, bt, idx, tp), _run_port(q, bt, idx, tp, "plain"))
    assert tpa.launches == before


def test_cuda_impl_refuses_cpu_tensors():
    """The kernel route never falls back: CPU tensors are refused."""
    rng = np.random.default_rng(43)
    bt, idx, _, tp = _pools(rng)
    q = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        _run_port(q, bt, idx, tp, impl="cuda")


def test_mixed_lengths_block_size_8_match_jax_kernel():
    """One batch whose rows' valid lengths differ (1 .. 38 keys, so the
    kernel's rows use different numbers of splits) over 8-key pages, GQA,
    decode and a 3-token chunk."""
    for s in (1, 3):
        rng = np.random.default_rng(45 + s)
        idx = tuple(max(0, x - s + 1) for x in (0, 7, 8, 9, 23, 37))
        bt, idx, jp, tp = _pools(rng, n_kv=2, s=s, b=len(idx), idx=idx, bs=8, mb=5)
        q = rng.normal(size=(len(idx), s, 8, 16)).astype(np.float32)
        ref = _run_jax(q, bt, idx, jp, _jax_kernel_impl())
        np.testing.assert_allclose(_run_port(q, bt, idx, tp), ref, rtol=1e-5, atol=1e-5)


# (b, s, nh, n_kv, span, sm_count): the flagship decode and prefill chunk on
# an H100, GQA, a tiny table, a huge table, a big batch, s = 5
PLAN_SHAPES = [
    (8, 1, 12, 12, 1024, 132), (1, 32, 12, 12, 1024, 132), (2, 32, 32, 8, 1024, 132),
    (3, 1, 2, 2, 16, 132), (1, 1, 8, 8, 131072, 132), (256, 1, 32, 32, 4096, 132),
    (4, 5, 32, 8, 640, 132), (1, 1, 1, 1, 1, 1),
]


@pytest.mark.parametrize("b,s,nh,n_kv,span,sms", PLAN_SHAPES)
def test_split_plan_bounds_and_partial_shapes(b, s, nh, n_kv, span, sms):
    hd = 128
    plan = tpa._split_plan(b, s, nh, n_kv, hd, span, sms)
    tiles = -(-span // tpa._TILE_KEYS)
    assert 1 <= plan.splits <= tiles
    assert span <= plan.splits * tpa._MAX_SPLIT_KEYS  # no split stages too many pages
    if plan.splits == 1:
        assert plan.part_acc_shape is None and plan.part_ml_shape is None
    else:
        assert plan.part_acc_shape == (b, s, nh, plan.splits, hd)
        assert plan.part_ml_shape == (b, s, nh, plan.splits, 2)


def test_split_plan_fills_the_card_at_the_flagship_decode_shape():
    """8 slots × 12 kv heads, and the 32-query chunk's 12 × 2 row tiles, on
    132 SMs: more than half of one wave of two blocks an SM, never more."""
    for b, s in ((8, 1), (1, 32)):
        plan = tpa._split_plan(b, s, 12, 12, 128, 1024, 132)
        blocks = plan.splits * b * 12 * -(-s // tpa._TILE_ROWS)
        assert 0.5 * 2 * 132 < blocks <= tpa._BLOCKS_PER_SM_TARGET * 132


def test_split_plan_reads_shapes_only():
    """The plan takes no tensor: the same shapes give the same plan whatever
    ``idx`` or the tables hold (a captured graph stays valid), and the
    launch is planned before anything is read from the device."""
    import inspect

    params = list(inspect.signature(tpa._split_plan).parameters)
    assert params == ["b", "s", "nh", "n_kv", "hd", "span", "sm_count"]
    assert tpa._split_plan(8, 1, 12, 12, 128, 1024, 132) == tpa._split_plan(
        8, 1, 12, 12, 128, 1024, 132)


def test_split_plan_constants_match_the_kernel_source():
    from pathlib import Path

    src = (Path(tpa.__file__).resolve().parent.parent / "csrc" / "paged_attention.cu").read_text()
    for name, value in (("kRows", tpa._TILE_ROWS), ("kStageKeys", tpa._TILE_KEYS),
                        ("kMaxSplitKeys", tpa._MAX_SPLIT_KEYS)):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        got = eval(m.group(1), {}, {"kWarps": 4, "kWarpKeys": 16})  # noqa: S307
        assert got == value, (name, got, value)


def test_cpu_tensors_count_no_decode_launch():
    rng = np.random.default_rng(47)
    bt, idx, _, tp = _pools(rng)
    q = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    before = (tpa.launches, tpa.decode_launches)
    _run_port(q, bt, idx, tp)
    assert (tpa.launches, tpa.decode_launches) == before


def test_unknown_impl_raises():
    rng = np.random.default_rng(44)
    bt, idx, _, tp = _pools(rng)
    q = rng.normal(size=(3, 1, 2, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        _run_port(q, bt, idx, tp, impl="pallas")
