"""fp8: the scaled-fp8 projections and the quantized KV-cache storage (port
of ``accelerate_tpu/ops/fp8.py``).

**Projections.** Under :func:`fp8_autocast` the model's projections, which
go through :func:`dense`, become per-tensor-scaled float8 products
(:func:`fp8_matmul`): E4M3 activations and weights forward, E5M2 gradients
backward under the ``HYBRID`` recipe (E4M3 under ``E4M3``), f32 sums. The
JAX package computes this product outside any Pallas kernel (f8 casts and
a dot that XLA lowers), so it is a library product here too, not a port of
a TPU kernel: on CUDA tensors ``torch._scaled_mm`` runs it on the card's
fp8 tensor cores (cuBLASLt), and raises rather than falls back; on CPU
tensors the plain version runs, the f8 values widened to f32 and
multiplied in f32, as JAX's ``_bf16_dot`` widens them.

**KV storage.** The paged block pools can store K/V in int8 or
``float8_e4m3fn`` with one f32 amax scale per written row (per token
position × kv head). Scales are quantized at write time, so writes are
idempotent, and the paged-attention kernel dequantizes in registers.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
INT8_MAX = 127.0

#: ``torch._scaled_mm`` calls since import (the fp8 GEMMs on the card; the
#: plain version on the CPU never counts)
gemm_launches = 0

_FP8_STATE = {"active": False, "format": "HYBRID"}


def fp8_is_active() -> bool:
    return _FP8_STATE["active"]


@contextlib.contextmanager
def _fp8_state_as(state: dict):
    prev = dict(_FP8_STATE)
    _FP8_STATE.update(state)
    try:
        yield
    finally:
        _FP8_STATE.update(prev)


def fp8_autocast(enabled: bool = True, fp8_format: str = "HYBRID"):
    """A context in which :func:`dense` calls run as fp8 products. Read at
    call time: a product's recipe (its gradients' format) is fixed when its
    forward runs, as the JAX residual markers fix it."""
    return _fp8_state_as({"active": enabled, "format": fp8_format.upper()})


@contextlib.contextmanager
def _joined(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def checkpoint_contexts(inner=None):
    """A ``context_fn`` for ``torch.utils.checkpoint`` over a region that
    may run :func:`dense`: the recompute, which the backward runs after
    :func:`fp8_autocast` has exited, runs under the fp8 state of the
    forward, as JAX fixes it when it traces. ``inner`` is a second
    ``context_fn`` to combine with (a selective-checkpoint policy's)."""
    state = dict(_FP8_STATE)
    if inner is None:
        forward, recompute = contextlib.nullcontext(), contextlib.nullcontext()
    else:
        forward, recompute = inner()
    return forward, _joined(recompute, _fp8_state_as(state))


@dataclass
class FP8RecipeKwargs:
    """The fp8 recipe ``Accelerator(mixed_precision="fp8")`` attaches to a
    prepared model. ``fp8_format`` selects ``HYBRID`` (E5M2 gradients) or
    ``E4M3`` everywhere; the per-tensor just-in-time scaling here needs
    none of the delayed-scaling fields (``margin``, ``amax_history_len``,
    ...), which are accepted for parity."""

    margin: int = 0
    interval: int = 1
    fp8_format: str = "HYBRID"
    amax_history_len: int = 1024
    amax_compute_algo: str = "most_recent"
    override_linear_precision: tuple = (False, False, False)
    backend: str = "XLA"


def _quantize(x: torch.Tensor, dtype: torch.dtype, max_val: float):
    """Per-tensor amax scaling into the fp8 range: ``(q, scale)`` with
    ``scale = max_val / max(amax, 1e-12)`` an f32 device scalar (no host
    sync). A finite ``x`` lands within ``±max_val`` (one f32 rounding
    above it at most, which both packages round to ``max_val``); an inf
    makes ``scale`` 0 and that element NaN (inf × 0), so the product is NaN
    as JAX's is. (PyTorch's E4M3 cast saturates where ml_dtypes' gives NaN,
    but after the scaling no value reaches either.)"""
    x32 = x.float()
    amax = x32.abs().amax()
    # a true division (a Python number over a tensor would multiply by the
    # reciprocal: one ulp off JAX's scale)
    scale = torch.div(torch.full_like(amax, max_val), torch.clamp(amax, min=1e-12))
    return (x32 * scale).to(dtype), scale


def _grad_format(fmt: str) -> tuple[torch.dtype, float]:
    return (torch.float8_e5m2, E5M2_MAX) if fmt == "HYBRID" else (torch.float8_e4m3fn, E4M3_MAX)


def _plain_dot(a8: torch.Tensor, b8: torch.Tensor, denom: torch.Tensor, dtype) -> torch.Tensor:
    """``(a8 @ b8) / denom`` with the f8 values widened to f32 and an f32
    product (the plain version of :func:`_scaled_dot`)."""
    return (torch.matmul(a8.float(), b8.float()) / denom).to(dtype)


def _col_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` laid out column-major (``_scaled_mm``'s second operand)."""
    return t if t.stride(0) == 1 and t.stride(1) == t.shape[0] else t.t().contiguous().t()


def _pad_rows(t: torch.Tensor, mult: int = 16) -> torch.Tensor:
    """``t [m, n]`` with zero rows appended up to a multiple of ``mult``."""
    m = t.shape[0]
    if m % mult == 0:
        return t
    out = t.new_zeros(((m + mult - 1) // mult * mult, t.shape[1]))
    out[:m] = t
    return out


def _scaled_dot(a8, b8, sa, sb, dtype, pad_k: bool = False) -> torch.Tensor:
    """``(a8 @ b8) / (sa * sb)`` on the fp8 tensor cores: ``torch._scaled_mm``
    multiplies by the inverse scales in its epilogue, where JAX divides the
    f32 product by their product. ``a8`` is made row-major and ``b8``
    column-major, as cuBLASLt takes them; with ``pad_k`` the shared dimension
    (the tokens, in the weight gradient) is zero-padded to a multiple of 16,
    which zero rows leave unchanged."""
    global gemm_launches
    if pad_k and a8.shape[1] % 16:
        a8, b8 = _pad_rows(a8.t()).t(), _pad_rows(b8)
    one = torch.ones((), dtype=torch.float32, device=a8.device)
    out = torch._scaled_mm(a8.contiguous(), _col_major(b8), scale_a=one / sa, scale_b=one / sb,
                           out_dtype=dtype)
    gemm_launches += 1
    return out[0] if isinstance(out, tuple) else out


def _dot(a8, b8, sa, sb, dtype, impl: str, pad_k: bool = False) -> torch.Tensor:
    if impl == "cuda":
        return _scaled_dot(a8, b8, sa, sb, dtype, pad_k)
    return _plain_dot(a8, b8, sa * sb, dtype)


class _FP8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fmt, impl):
        x8, sx = _quantize(x, torch.float8_e4m3fn, E4M3_MAX)
        w8, sw = _quantize(w, torch.float8_e4m3fn, E4M3_MAX)
        # f8 residuals (the activation-memory saving is part of the recipe)
        # and the gradients' format, fixed here at forward time
        ctx.save_for_backward(x8, sx, w8, sw)
        ctx.dtypes, ctx.fmt, ctx.impl = (x.dtype, w.dtype), fmt, impl
        return _dot(x8, w8, sx, sw, x.dtype, impl)

    @staticmethod
    def backward(ctx, g):
        x8, sx, w8, sw = ctx.saved_tensors
        g8, sg = _quantize(g, *_grad_format(ctx.fmt))
        dx = _dot(g8, w8.t(), sg, sw, ctx.dtypes[0], ctx.impl)                # [M, K]
        dw = _dot(x8.t(), g8, sx, sg, ctx.dtypes[1], ctx.impl, pad_k=True)    # [K, N]
        return dx, dw, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, fp8_format: str | None = None,
               impl: str | None = None) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` (the JAX layout; 2-D, :func:`dense` flattens
    leading dims) with E4M3 forward operands, each scaled by its own amax,
    and the output in ``x``'s dtype. Differentiable in both: the gradient
    ``g`` is quantized to E5M2 under ``HYBRID`` (E4M3 under ``E4M3``) and
    ``dx = g8 w8ᵀ / (sg sw)``, ``dw = x8ᵀ g8 / (sx sg)``. ``fp8_format``
    defaults to the active recipe's. ``impl=None`` runs the products on the
    fp8 tensor cores for CUDA tensors (``torch._scaled_mm``: ``K`` and ``N``
    multiples of 16) or raises, and the plain version for CPU tensors;
    ``"plain"`` forces the plain version (``chip_smoke.py``'s reference)."""
    fmt = (fp8_format or _FP8_STATE["format"]).upper()
    if fmt not in ("HYBRID", "E4M3"):
        raise ValueError(f"unknown fp8_format {fmt!r}: expected 'HYBRID' or 'E4M3'")
    if impl is None:
        impl = "cuda" if x.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown fp8 matmul impl {impl!r} (None, 'cuda' or 'plain')")
    if impl == "cuda" and not (x.is_cuda and w.is_cuda):
        raise ValueError("fp8_matmul impl='cuda' needs CUDA tensors")
    return _FP8Matmul.apply(x, w, fmt, impl)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """The model's projection ``x [..., in] @ wᵀ`` with ``w`` in
    ``nn.Linear``'s ``[out, in]`` layout (the transpose of JAX's
    ``dense(x, w [in, out])``; per-tensor amax is the same for both): the
    plain ``F.linear`` normally, :func:`fp8_matmul` inside
    :func:`fp8_autocast`, and for a quantized weight (which the streaming
    executor hands the layers, ``big_modeling.py``) JAX's quantized
    products: an int8 GEMM over a :class:`~..utils.quantization.QTensor`,
    one a block over a 4-bit weight. Any other weight raises."""
    from ..utils.quantization import (
        Q4DecodedTensor,
        Q4Tensor,
        QTensor,
        int8_matmul,
        q4_decoded_matmul,
        q4_matmul,
    )

    if isinstance(w, QTensor):
        return int8_matmul(x, w)
    if isinstance(w, Q4Tensor):
        return q4_matmul(x, w)
    if isinstance(w, Q4DecodedTensor):
        return q4_decoded_matmul(x, w)
    if not (isinstance(w, torch.Tensor) and w.is_floating_point()):
        raise ValueError(f"dense takes a floating weight or a quantized one (QTensor, Q4Tensor, "
                         f"Q4DecodedTensor), not a {type(w).__name__} of "
                         f"{getattr(w, 'dtype', None)}")
    if not _FP8_STATE["active"]:
        return torch.nn.functional.linear(x, w)
    lead = x.shape[:-1]
    out = fp8_matmul(x.reshape(-1, x.shape[-1]), w.t())
    return out.reshape(*lead, w.shape[0])

#: engine ``kv_dtype`` policy names (``auto`` — the params' dtype — is
#: resolved by the engine, not here)
KV_STORAGE_DTYPES = ("bf16", "f32", "int8", "fp8")
KV_QUANTIZED_DTYPES = ("int8", "fp8")


def kv_storage_dtype(name: str) -> tuple[torch.dtype, bool]:
    """Resolve a ``kv_dtype`` policy name to ``(torch dtype, quantized)``."""
    if name == "bf16":
        return torch.bfloat16, False
    if name == "f32":
        return torch.float32, False
    if name == "int8":
        return torch.int8, True
    if name == "fp8":
        return torch.float8_e4m3fn, True
    raise ValueError(
        f"unknown kv_dtype {name!r}: expected one of "
        f"{('auto',) + KV_STORAGE_DTYPES}"
    )


def kv_qmax(dtype: torch.dtype) -> float:
    """Largest representable magnitude the amax scale maps onto."""
    if dtype == torch.int8:
        return INT8_MAX
    if dtype == torch.float8_e4m3fn:
        return E4M3_MAX
    raise ValueError(f"{dtype} is not a quantized KV storage dtype")


def quantize_kv_rows(x: torch.Tensor, dtype: torch.dtype):
    """Per-row amax quantization of ``x [..., hd]`` into ``dtype``: returns
    ``(q, scale)`` with ``scale = amax/qmax`` over the last axis (f32,
    shape ``x.shape[:-1]``). An all-zero row keeps ``scale = 1``, so it
    dequantizes to exactly 0. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    qmax = kv_qmax(dtype)
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    scaled = x32 / scale[..., None]
    if dtype == torch.int8:
        q = torch.clamp(torch.round(scaled), -INT8_MAX, INT8_MAX).to(torch.int8)
    else:
        q = scaled.to(dtype)  # round to nearest even
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv_rows`: ``q [..., hd]`` × ``scale [...]``
    → f32."""
    return q.float() * scale[..., None].float()
