"""The port's fp8 projections (``accelerate_tpu_torch/ops/fp8.py``, the
matmul half) held against the JAX package's (``accelerate_tpu/ops/fp8.py``)
on the same numpy inputs, mirroring ``tests/test_fp8.py``.

On the CPU the port runs :func:`fp8_matmul`'s plain version: the same
per-tensor amax quantization (the f8 bytes are compared exactly) and the f8
values multiplied in f32, where JAX widens them to bf16 (exactly) and sums
in f32. So the products agree to f32 summation order: forward and both
gradients within 1e-5 × max(|ref|, 1), under ``HYBRID`` (E5M2 gradients)
and ``E4M3``. The tiny llama's fp8 loop: losses 2e-2 relative, the bf16
loop's gate (the rest of the model runs in bf16). On the card the products
run through ``torch._scaled_mm``, which ``chip_smoke.py`` holds to this
plain version.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.ops import fp8 as jfp8  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu_torch import Accelerator, AcceleratorState, FP8RecipeKwargs  # noqa: E402
from accelerate_tpu_torch import GradientState  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.ops import fp8 as tfp8  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _operands(seed, m=24, k=64, n=16, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / 8).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, g


def _jax_fp8(x, w, g, fmt, dtype=jnp.float32):
    """JAX's forward and (dx, dw) of <fp8_matmul(x, w), g>, in f32 numpy."""
    with jfp8.fp8_autocast(fp8_format=fmt):
        out, vjp = jax.vjp(jfp8.fp8_matmul, jnp.asarray(x, dtype), jnp.asarray(w, dtype))
        dx, dw = vjp(jnp.asarray(g, dtype))
    return [np.asarray(t, np.float32) for t in (out, dx, dw)]


def _port_fp8(x, w, g, fmt, dtype=torch.float32):
    tx, tw = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, w))
    out = tfp8.fp8_matmul(tx, tw, fp8_format=fmt)
    out.backward(torch.from_numpy(g).to(dtype))
    assert out.dtype == tx.grad.dtype == tw.grad.dtype == dtype
    return [t.detach().float().numpy() for t in (out, tx.grad, tw.grad)]


@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fp8_matmul_forward_and_grads_match_jax(fmt, dtype):
    x, w, g = _operands(0)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = _jax_fp8(x, w, g, fmt, jdt)
    got = _port_fp8(x, w, g, fmt, tdt)
    # bf16 outputs: one bf16 ulp where the f32 sums round either way
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    for name, a, r in zip(("out", "dx", "dw"), got, ref):
        np.testing.assert_allclose(a, r, rtol=0, atol=tol * max(float(np.abs(r).max()), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
def test_the_quantized_bytes_are_jaxs(fmt):
    """Per-tensor amax quantization, E4M3 for the operands and the recipe's
    format for the gradient: the same f8 bytes and the same scales."""
    x, _, g = _operands(1)
    for arr, (jdt, tdt), top in ((x, (jnp.float8_e4m3fn, torch.float8_e4m3fn), tfp8.E4M3_MAX),
                                 (g, ((jnp.float8_e5m2, torch.float8_e5m2) if fmt == "HYBRID"
                                      else (jnp.float8_e4m3fn, torch.float8_e4m3fn)),
                                  tfp8.E5M2_MAX if fmt == "HYBRID" else tfp8.E4M3_MAX)):
        jq, js = jfp8._quantize(jnp.asarray(arr), jdt, top)
        tq, ts = tfp8._quantize(torch.from_numpy(arr), tdt, top)
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8))
        assert float(ts) == float(js)
    assert (tfp8.E4M3_MAX, tfp8.E5M2_MAX) == (jfp8.E4M3_MAX, jfp8.E5M2_MAX)


def test_fp8_matmul_error_bounded():
    x, w, _ = _operands(2, m=32, k=64, n=16)
    exact = x @ w
    out = tfp8.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    rel = np.abs(out - exact) / (np.abs(exact) + 1.0)
    assert np.median(rel) < 0.05
    assert np.linalg.norm(out - exact) / np.linalg.norm(exact) < 0.05


def test_dense_routes_by_context():
    """``dense`` takes ``nn.Linear``'s ``[out, in]`` weight (JAX's ``[in,
    out]`` transposed): plain ``F.linear`` outside ``fp8_autocast``, the fp8
    product inside, equal to JAX's ``dense`` on the transposed weight."""
    x, w, _ = _operands(3)
    x3 = torch.from_numpy(x).reshape(2, 12, 64)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))  # [out, in]
    assert not tfp8.fp8_is_active()
    np.testing.assert_allclose(tfp8.dense(x3, wt).numpy(), (x @ w).reshape(2, 12, 16),
                               rtol=1e-5, atol=1e-5)
    with tfp8.fp8_autocast():
        assert tfp8.fp8_is_active()
        out = tfp8.dense(x3, wt)
    assert not tfp8.fp8_is_active()
    with jfp8.fp8_autocast():
        ref = np.asarray(jfp8.dense(jnp.asarray(x).reshape(2, 12, 64), jnp.asarray(w)))
    assert out.shape == (2, 12, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="not yet ported"):
        tfp8.dense(x3, torch.zeros((16, 64), dtype=torch.int8))
    with pytest.raises(ValueError, match="fp8_format"):
        tfp8.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w), fp8_format="E3M4")
    # no fallback: the tensor-core route refuses CPU tensors
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfp8.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w), impl="cuda")
    with pytest.raises(ValueError, match="unknown fp8 matmul impl"):
        tfp8.fp8_matmul(torch.from_numpy(x), torch.from_numpy(w), impl="triton")


def test_fp8_quantization_is_actually_applied():
    x, w, _ = _operands(4, m=8, k=128, n=8)
    exact = x @ w
    with tfp8.fp8_autocast():
        out = tfp8.dense(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T))).numpy()
    assert not np.allclose(out, exact, rtol=1e-6), "fp8 path identical to fp32: inactive"


def test_the_gradient_format_is_fixed_at_forward_time():
    """The backward runs after ``fp8_autocast`` has exited; it quantizes
    the gradient in the format the forward ran under, as JAX's residual
    markers fix it."""
    x, w, g = _operands(5)
    outs = {}
    for fmt in ("HYBRID", "E4M3"):
        tw = torch.from_numpy(w).requires_grad_()
        with tfp8.fp8_autocast(fp8_format=fmt):
            out = tfp8.dense(torch.from_numpy(x), tw.t())
        out.backward(torch.from_numpy(g))
        outs[fmt] = tw.grad.numpy()
        ref = _jax_fp8(x, w, g, fmt)[2]
        np.testing.assert_allclose(outs[fmt], ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert not np.array_equal(outs["HYBRID"], outs["E4M3"])


@pytest.mark.parametrize("where", ["x", "w", "g"])
@pytest.mark.parametrize("value", [np.inf, np.nan])
def test_a_non_finite_operand_gives_what_jax_gives(where, value):
    """An inf makes its tensor's scale 0 and the element inf × 0 = NaN (a
    NaN makes the scale NaN), in both packages, though PyTorch's E4M3 cast
    saturates where ml_dtypes' gives NaN: the non-finite entries of the
    output and both gradients are JAX's."""
    x, w, g = _operands(6)
    {"x": x, "w": w, "g": g}[where][1, 2] = value
    ref = _jax_fp8(x, w, g, "HYBRID")
    got = _port_fp8(x, w, g, "HYBRID")
    for name, a, r in zip(("out", "dx", "dw"), got, ref):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(r), err_msg=name)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(r), err_msg=name)
        finite = np.isfinite(r)
        if finite.any():
            np.testing.assert_allclose(a[finite], r[finite], rtol=0,
                                       atol=1e-5 * max(float(np.abs(r[finite]).max()), 1.0))


def test_tiny_llama_fp8_loop_matches_jax():
    """``Accelerator(mixed_precision="fp8")``: bf16 compute with every
    projection (the head's too) as an fp8 product, against JAX's fp8 loop
    from the same weights on the same batch."""
    jcfg = jllama.LlamaConfig.tiny()
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    ids = np.random.default_rng(3).integers(0, 256, size=(8, 32)).astype(np.int32)
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    jacc = JAccelerator(mixed_precision="fp8")
    jmodel, jopt = jacc.prepare(jllama.LlamaForCausalLM.from_config(jcfg, seed=0), optax.adamw(1e-3))
    init = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jmodel.params)
    jlosses = []
    for _ in range(4):
        out = jmodel(input_ids=jnp.asarray(ids), labels=jnp.asarray(ids))
        jacc.backward(out.loss)
        jopt.step()
        jopt.zero_grad()
        jlosses.append(out.loss.item())
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()

    acc = Accelerator(cpu=True, mixed_precision="fp8",
                      kwargs_handlers=[FP8RecipeKwargs(fp8_format="HYBRID")])
    module = tllama.LlamaForCausalLM(tcfg, device="cpu")
    module.load_state_dict(tllama.params_from_jax(init, tcfg))
    model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3,
                                                       betas=(0.9, 0.999), eps=1e-8,
                                                       weight_decay=1e-4))
    assert model.fp8_recipe is not None
    losses = []
    for _ in range(4):
        out = model(input_ids=torch.from_numpy(ids), labels=torch.from_numpy(ids))
        acc.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(float(out.loss.detach()))
    for got, ref in zip(losses, jlosses):
        assert abs(got - ref) / ref < 2e-2, (losses, jlosses)
    assert losses[-1] < losses[0]
    # and fp8 changed the numbers: the bf16 loop's first loss differs
    AcceleratorState._reset_state(reset_partial_state=True)
    bf16 = Accelerator(cpu=True, mixed_precision="bf16").prepare(
        tllama.LlamaForCausalLM(tcfg, device="cpu"))
    bf16.module.load_state_dict(tllama.params_from_jax(init, tcfg))
    assert float(bf16(input_ids=torch.from_numpy(ids), labels=torch.from_numpy(ids)).loss) \
        != losses[0]
