"""Quantized KV-cache storage helpers (port of the KV half of
``accelerate_tpu/ops/fp8.py``).

The paged block pools can store K/V in int8 or ``float8_e4m3fn`` with one
f32 amax scale per written row (per token position × kv head). Scales are
quantized at write time, so writes are idempotent, and the paged-attention
kernel dequantizes in registers. The scaled-fp8 matmul and quantized
weights are not ported yet: the model's projections are plain
``nn.Linear`` products.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
INT8_MAX = 127.0

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
