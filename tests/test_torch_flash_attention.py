"""The port's flash attention (``accelerate_tpu_torch/ops/flash_attention.py``)
and attention dispatch held against the JAX package on the same numpy
inputs.

On this CPU-only box the port runs its plain versions — the math of the
CUDA kernels, key tile by key tile, with the kernels' masking and rounding
points — and JAX runs its Pallas kernels in interpret mode, so the
comparison is of what both compute. The gates are the JAX package's own
(``tests/test_attention.py``): f32 output 2e-5, lse 1e-5, gradients 2e-4 ×
max(|ref|, 1); a bf16 output 3e-2 compared in f32. The kernels themselves
are held to the plain versions on the card by ``chip_smoke.py``.
"""

import importlib
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu_torch.ops import attention as tattn  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from accelerate_tpu_torch.ops import layers as tlayers  # noqa: E402

# the JAX ops package re-exports a function under the module's name
jfa = importlib.import_module("accelerate_tpu.ops.flash_attention")
jlayers = importlib.import_module("accelerate_tpu.ops.layers")

torch.set_num_threads(1)

B, S, H, D = 1, 64, 2, 32


def _inputs(b=B, s=S, h=H, n_kv=None, d=D, seed=0):
    rng = np.random.default_rng(seed)
    n_kv = n_kv or h
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, n_kv, d), (b, s, n_kv, d), (b, s, h, d)))


def _left_padded(b, s, pad):
    mask = np.ones((b, s), bool)
    mask[:, :pad] = False
    return mask


def _jax_lse(q, k, v, mask, causal):
    """JAX's lse from ``_fwd_call``, through the same padding, bias and GQA
    repeat as its ``flash_attention`` wrapper, cut back to ``[b, h, s]``."""
    b, sq, nh, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if n_kv != nh:
        k, v = (np.repeat(x, nh // n_kv, axis=2) for x in (k, v))
    bq, bkv = jfa._fit_block(sq, 512, 8), jfa._fit_block(skv, 1024, 128)
    sq_p, skv_p = -(-sq // bq) * bq, -(-skv // bkv) * bkv
    qt = jfa._pad_to(jnp.asarray(q).transpose(0, 2, 1, 3), sq_p, 2)
    kt = jfa._pad_to(jnp.asarray(k).transpose(0, 2, 1, 3), skv_p, 2)
    vt = jfa._pad_to(jnp.asarray(v).transpose(0, 2, 1, 3), skv_p, 2)
    valid = np.ones((b, skv), bool) if mask is None else mask
    valid = jfa._pad_to(jnp.asarray(valid), skv_p, 1)
    bias = jnp.where(valid, 0.0, jfa.NEG_INF).astype(jnp.float32)[:, None, None, :]
    _, lse = jfa._fwd_call(qt, kt, vt, bias, 1.0 / np.sqrt(d), causal, bq, bkv, True)
    return np.asarray(lse)[:, :, :sq, 0]


def _jax_flash(q, k, v, mask, causal, do):
    """JAX output and (dq, dk, dv) of <O, dO> through its Pallas kernels."""
    jm = None if mask is None else jnp.asarray(mask)

    def fn(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, segment_mask=jm, causal=causal, interpret=True)

    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_flash(q, k, v, mask, causal, do, impl="plain"):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = tfa.flash_attention(tq, tk, tv, tm, causal=causal, impl=impl)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _assert_grads(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-4 * max(float(np.abs(r).max()), 1.0))


CASES = {
    "causal": dict(causal=True),
    "non_causal": dict(causal=False),
    "ragged_s50": dict(causal=True, s=50),
    "left_padded": dict(causal=True, b=2, pad=20),
    "gqa_4_2": dict(causal=True, h=4, n_kv=2),
    # more than one of the bf16 forward kernel's 128-key tiles
    "ragged_s200": dict(causal=True, s=200),
    # query rows 0..127 (a whole 128-row tile) see no valid key
    "left_padded_s200": dict(causal=True, b=2, s=200, pad=130),
    # the narrow heads the kernels stage as zero-padded 64-column tiles
    "hd16_mha_s129": dict(causal=True, h=4, d=16, s=129),
    "hd16_left_padded": dict(causal=True, b=2, h=4, d=16, pad=20),
    "hd32_gqa_8_2_non_causal": dict(causal=False, h=8, n_kv=2, d=32, s=129),
    # head dims off the built widths (C4): staged as 64- or 128-column tiles
    # whose columns past hd are zero, stored at the real pitch
    "hd24_gqa_4_2": dict(causal=True, h=4, n_kv=2, d=24, s=70),
    "hd48_left_padded": dict(causal=True, b=2, h=2, d=48, pad=20),
    "hd80_non_causal_s129": dict(causal=False, h=2, d=80, s=129),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_flash_matches_jax_pallas_kernels(case):
    kw = dict(CASES[case])
    causal, pad = kw.pop("causal"), kw.pop("pad", None)
    q, k, v, do = _inputs(**kw)
    mask = None if pad is None else _left_padded(q.shape[0], q.shape[1], pad)

    o, lse = tfa.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                           None if mask is None else torch.from_numpy(mask), causal=causal)
    ref_o, ref_grads = _jax_flash(q, k, v, mask, causal, do)
    np.testing.assert_allclose(o.numpy(), ref_o, rtol=0, atol=2e-5)
    ref_lse = _jax_lse(q, k, v, mask, causal)
    assert lse.shape == ref_lse.shape and lse.dtype == torch.float32
    np.testing.assert_array_equal(lse.numpy() == tfa.NEG_INF, ref_lse == jfa.NEG_INF)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=0, atol=1e-5)

    got_o, got_grads = _port_flash(q, k, v, mask, causal, do)
    np.testing.assert_allclose(got_o, ref_o, rtol=0, atol=2e-5)
    _assert_grads(got_grads, ref_grads)
    if pad is not None:
        # fully masked query rows: output 0, lse NEG_INF, finite zero dq
        assert np.abs(got_o[:, :pad]).max() == 0.0
        assert (lse.numpy()[:, :, :pad] == tfa.NEG_INF).all()
        assert all(np.isfinite(g).all() for g in got_grads)
        assert np.abs(got_grads[0][:, :pad]).max() == 0.0


def test_plain_forward_tile_is_the_forward_kernels_tile():
    """The plain forward rounds P at each key tile's running max, where the
    bf16 forward kernel rounds it: their key tiles must be the same."""
    src = (Path(tfa.__file__).resolve().parent.parent / "csrc" / "flash_attention.cu").read_text()
    found = re.findall(r"constexpr int kFwdTileKeys = (\d+);", src)
    assert len(found) == 1
    assert tfa._FWD_TILE == int(found[0])
    assert [t1 - t0 for t0, t1 in tfa._tile_ends(300, 300, False, tfa._FWD_TILE)] == [
        tfa._FWD_TILE, tfa._FWD_TILE, 300 - 2 * tfa._FWD_TILE]


def test_plain_flash_bf16_matches_jax():
    q, k, v, do = _inputs()
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = jfa.flash_attention(*bf, causal=True, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=0, atol=3e-2)
    oracle = jlayers.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(oracle), rtol=0, atol=3e-2)


BF16_GRAD_CASES = {
    "causal_s64": dict(causal=True),
    # rows 0..129 see no valid key: a whole 128-row query tile of the bf16
    # dq kernel is fully masked, and dq of those rows is exactly 0
    "gqa_4_2_s200_pad130": dict(causal=True, b=2, s=200, h=4, n_kv=2, pad=130),
    "non_causal_s64": dict(causal=False),
}


@pytest.mark.parametrize("case", list(BF16_GRAD_CASES))
def test_plain_flash_bf16_grads_match_jax(case):
    """The plain backward on bf16 inputs — dS rounded to K's dtype before
    dS·K, where the bf16 dq kernel rounds it — against the JAX Pallas
    backward in interpret mode on the same bf16 values. Gate: the bf16
    grads within 5e-2 × max(|ref|, 1), compared in f32."""
    kw = dict(BF16_GRAD_CASES[case])
    causal, pad = kw.pop("causal"), kw.pop("pad", None)
    q, k, v, do = _inputs(**kw)
    mask = None if pad is None else _left_padded(q.shape[0], q.shape[1], pad)
    jm = None if mask is None else jnp.asarray(mask)

    def fn(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, segment_mask=jm, causal=causal, interpret=True)

    _, vjp = jax.vjp(fn, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jnp.bfloat16))]

    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                              causal=causal)
    out.backward(torch.from_numpy(do).to(torch.bfloat16))
    assert all(t.grad.dtype == torch.bfloat16 for t in (tq, tk, tv))
    got = [t.grad.float().numpy() for t in (tq, tk, tv)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=5e-2 * max(float(np.abs(r).max()), 1.0))
    if pad is not None:
        assert np.abs(got[0][:, :pad]).max() == 0.0
        assert np.abs(ref[0][:, :pad]).max() == 0.0


def _chip_smoke():
    """``chip_smoke.py`` as a module: it imports only numpy and torch at
    top level, so its parsers run here."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(tfa.__file__).resolve().parents[2] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: ``nvcc -Xptxas -v`` output for a dq kernel and two paged instances (one
#: spilling, one naming a type twice, which the mangling substitutes)
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKhPKfS5_P13__nv_bfloat16iiiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125flash_bwd_dq_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKhPKfS5_P13__nv_bfloat16iiiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122paged_attention_kernelILi64E13__nv_bfloat16S1_Lb0ELb0EEEvPKT0_PKT1_S6_PKfS8_PKiSA_PS2_PfSC_iiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122paged_attention_kernelILi64E13__nv_bfloat16S1_Lb0ELb0EEEvPKT0_PKT1_S6_PKfS8_PKiSA_PS2_PfSC_iiiiii
    16 bytes stack frame, 16 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 20608 bytes smem, 480 bytes cmem[0]
ptxas info    : Function properties for _ZN12_GLOBAL__N_122paged_attention_kernelILi128EfaLb1ELb0EEEvPKT0_PKT1_S6_PKfS8_PKiSA_PS2_PfSC_iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 41088 bytes smem, 480 bytes cmem[0]
ptxas info    : Function properties for __internal_accurate_fdividef
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_chip_smoke_reads_registers_and_spills_from_ptxas():
    smoke = _chip_smoke()
    assert smoke.ptxas_report(PTXAS_LOG) == {
        "flash_bwd_dq_wgmma_kernel<128>":
            {"registers": 160, "spill_stores": 0, "spill_loads": 0, "static_smem": 0},
        "paged_attention_kernel<64, __nv_bfloat16, __nv_bfloat16, false, false>":
            {"registers": 56, "spill_stores": 16, "spill_loads": 32, "static_smem": 20608},
        "paged_attention_kernel<128, float, signed char, true, false>":
            {"registers": 96, "spill_stores": 0, "spill_loads": 0, "static_smem": 41088},
    }
    assert smoke.PAGED_TIMED[0] in smoke.ptxas_report(PTXAS_LOG.replace("ILi64E", "ILi128E"))


def test_chip_smoke_profiler_pattern_finds_each_flash_kernel():
    smoke = _chip_smoke()
    names = {
        "flash_fwd": ["void (anonymous namespace)::flash_fwd_wgmma_kernel<128>(CUtensorMap_st)",
                      "void (anonymous namespace)::flash_fwd_kernel<64>(float const*)"],
        "flash_bwd_dq": ["void (anonymous namespace)::flash_bwd_dq_wgmma_kernel<128>(int)",
                         "void (anonymous namespace)::flash_bwd_dq_kernel<128>(float const*)"],
        "flash_bwd_dkv": ["void (anonymous namespace)::flash_bwd_dkv_wgmma_kernel<128>(int)"],
    }
    for family in names:
        for other, keys in names.items():
            for key in keys:
                found = re.search(smoke.flash_kernel_pattern(family), key) is not None
                assert found == (other == family), (family, key)


def test_chip_smoke_names_the_instance_each_head_dim_and_dtype_launches():
    """``chip_smoke.flash_instances``, which phase 15c holds the profiler's
    kernel names to: bf16 and f16 B1-B3 on their wgmma instances up to hd
    256 (at 256 from 136 on), f32 on the FMA kernels, and every dtype past
    256 on the column-block instances."""
    smoke = _chip_smoke()
    fams = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    assert smoke.flash_instances(80, "bf16") == {f: f"{f}_wgmma_kernel<80, __nv_bfloat16>"
                                                 for f in fams}
    assert smoke.flash_instances(24, "f32") == {f: f"{f}_kernel<32, 64, float, false>"
                                                for f in fams}
    for hd in (136, 200, 256):
        for dtype, t in (("bf16", "__nv_bfloat16"), ("f16", "__half")):
            assert smoke.flash_instances(hd, dtype) == {
                "flash_fwd": f"flash_fwd_wgmma_kernel<256, {t}>",
                "flash_bwd_dq": f"flash_bwd_dq_wgmma_kernel<256, {t}>",
                "flash_bwd_dkv": f"flash_bwd_dkv_wgmma_kernel<256, {t}>"}
        assert smoke.flash_instances(hd, "f32") == {f: f"{f}_kernel<256, 32, float, false>"
                                                    for f in fams}
    assert smoke.flash_instances(512, "f16") == {f: f"{f}_kernel<256, 32, __half, true>"
                                                 for f in fams}
    assert smoke.FLASH_WIDE == tuple(smoke.flash_instances(256, "bf16").values())
    # every (head dim, dtype) the profiler check reads is one the wrapper takes
    assert all(tfa.takes_head_dim(hd) and hd % 8 == 0 for hd, _ in smoke.FLASH_INSTANCE_CASES)


def test_chip_smoke_names_the_sdpa_backend_from_kernel_names():
    """``chip_smoke._sdpa_backend``, which labels each ``library_ms``: the
    backend of the kernel rows sdpa ran, cuDNN's before flash (its kernel
    names hold "flash" too), with the heaviest kernel's name."""
    from types import SimpleNamespace

    smoke = _chip_smoke()

    def rows(*named):
        return [SimpleNamespace(key=k, self_device_time_total=t) for k, t in named]

    cudnn = "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x256_4x"
    assert smoke._sdpa_backend(rows((cudnn, 5.0))) == f"cudnn ({cudnn[:80]})"
    flash = "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<128, 128>>"
    assert smoke._sdpa_backend(rows(("copy", 1.0), (flash, 9.0))) == f"flash ({flash[:80]})"
    eff = "fmha_cutlassF_bf16_aligned_32x128_gmem_sm80(PyTorchMemEffAttention::AttentionKernel)"
    assert smoke._sdpa_backend(rows((eff, 2.0))).startswith("efficient (fmha_cutlassF")
    assert smoke._sdpa_backend(rows(("void at::native::bmm", 1.0))).startswith("math (")
    assert smoke._sdpa_backend([]) == "math"


def test_flash_fwd_bwd_pair_equals_the_autograd_function():
    """``flash_fwd``/``flash_bwd`` (the ring-attention building blocks) give
    what the autograd.Function gives, and the plain backward matches
    autograd through the reference attention."""
    q, k, v, do = _inputs(h=4, n_kv=2, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tfa.flash_fwd(tq, tk, tv, causal=True)
    grads = tfa.flash_bwd(tq, tk, tv, None, o, lse, tdo, causal=True)
    got_o, got_grads = _port_flash(q, k, v, None, True, do)
    np.testing.assert_array_equal(o.numpy(), got_o)
    for a, b in zip(grads, got_grads):
        np.testing.assert_array_equal(a.numpy(), b)
    rq, rk, rv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ref = tlayers.causal_attention(rq, rk, rv)
    ref.backward(tdo)
    np.testing.assert_allclose(got_o, ref.detach().numpy(), rtol=0, atol=2e-5)
    _assert_grads(got_grads, [t.grad.numpy() for t in (rq, rk, rv)])


def test_blockwise_attention_matches_jax_forward_and_grad():
    q, k, v, do = _inputs(b=2, s=48, seed=1)
    mask = np.random.default_rng(1).random((2, 48)) > 0.3
    mask[:, 0] = True
    jm = jnp.asarray(mask)

    def jfn(q_, k_, v_):
        return jfa.blockwise_attention(q_, k_, v_, segment_mask=jm, causal=True, block_kv=16)

    ref, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.blockwise_attention(tq, tk, tv, torch.from_numpy(mask), causal=True, block_kv=16)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    _assert_grads([t.grad.numpy() for t in (tq, tk, tv)], [np.asarray(g) for g in ref_grads])


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v, _ = _inputs(b=2, s=16, h=4, n_kv=2, seed=2)
    mask = _left_padded(2, 16, 3)
    if causal:
        ref = jlayers.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       segment_mask=jnp.asarray(mask))
        got = tlayers.causal_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                       segment_mask=torch.from_numpy(mask))
    else:
        jm = jnp.asarray(mask)[:, None, None, :]
        ref = jlayers.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm)
        got = tlayers.dot_product_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                            mask=torch.from_numpy(mask)[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tlayers.causal_mask(5, 7).numpy(),
                                  np.asarray(jlayers.causal_mask(5, 7)))


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    from accelerate_tpu_torch import _build

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = (tfa.fwd_launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    q, k, v, do = _inputs()
    _port_flash(q, k, v, None, True, do, impl=None)
    with tattn.attention_context(impl="flash"):
        tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    assert (tfa.fwd_launches, tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == before


def test_the_kernel_route_refuses_cpu_tensors():
    """No fallback: asking for the kernels with CPU tensors raises rather
    than quietly running the plain version."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_fwd(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown flash attention impl"):
        tfa.flash_fwd(q, k, v, impl="triton")


def test_attention_dispatch_routes_by_context():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(h=4, n_kv=2, seed=4))
    ref = tlayers.causal_attention(q, k, v)
    for impl in ("auto", "flash", "blockwise", "reference"):
        with tattn.attention_context(impl=impl):
            np.testing.assert_allclose(tattn.attention(q, k, v).numpy(), ref.numpy(),
                                       rtol=0, atol=2e-5, err_msg=impl)
    assert tattn.get_attention_context().impl == "auto"
    with tattn.attention_context(mesh={"cp": 2}, cp_mode="ring"):
        with pytest.raises(ValueError, match="not yet ported"):
            tattn.attention(q, k, v)
    with tattn.attention_context(mesh={"cp": 1}, cp_mode="ring"):
        tattn.attention(q, k, v)
