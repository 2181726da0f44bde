"""Attention dispatch: the one entry point the models call (port of
``accelerate_tpu/ops/attention.py``).

Routing by the active :class:`AttentionContext`'s ``impl``:

* ``"auto"`` — ``"flash"`` for CUDA tensors, ``"blockwise"`` for CPU tensors;
* ``"flash"`` — :func:`ops.flash_attention.flash_attention`: the hand-written
  CUDA kernels for CUDA tensors (or the plain versions, when the context's
  ``flash_impl`` is ``"plain"``), the plain versions for CPU tensors;
* ``"blockwise"`` — :func:`ops.flash_attention.blockwise_attention`;
* ``"reference"`` — :func:`ops.layers.causal_attention` /
  :func:`ops.layers.dot_product_attention`.

Context-parallel attention (a ``cp`` extent above 1) is not ported yet and
raises. The CUDA kernels choose their own tiles, so the JAX block-size
fields and ``resolve_flash_blocks`` have no counterpart.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Literal

from .flash_attention import blockwise_attention, flash_attention
from .layers import causal_attention, dot_product_attention


@dataclass(frozen=True)
class AttentionContext:
    #: mesh axis name -> extent; the port has no device mesh yet, so only a
    #: cp extent of 1 is accepted
    mesh: dict | None = None
    cp_mode: Literal["ring", "ulysses", "allgather"] | None = None
    cp_axis: str = "cp"
    impl: Literal["auto", "flash", "blockwise", "reference"] = "auto"
    #: which flash implementation ``"flash"`` runs: None picks by device
    #: (kernels for CUDA tensors), ``"plain"`` the plain versions anywhere
    flash_impl: Literal["cuda", "plain"] | None = None


_current = AttentionContext()


def set_attention_context(ctx: AttentionContext | None) -> None:
    global _current
    _current = ctx or AttentionContext()


def get_attention_context() -> AttentionContext:
    return _current


@contextmanager
def attention_context(**overrides):
    global _current
    prev = _current
    _current = replace(prev, **overrides)
    try:
        yield _current
    finally:
        _current = prev


def attention(q, k, v, segment_mask=None, causal=True, scale=None):
    """``q [b, s, nh, hd]``, ``k``/``v`` ``[b, s, n_kv, hd]``,
    ``segment_mask [b, s]`` (1 = valid token); output in q's layout and
    dtype."""
    ctx = _current
    if ctx.mesh is not None and ctx.cp_mode is not None and ctx.mesh.get(ctx.cp_axis, 1) > 1:
        raise ValueError("context-parallel attention (cp > 1) is not yet ported")
    impl = ctx.impl
    if impl == "auto":
        impl = "flash" if q.is_cuda else "blockwise"
    if impl == "flash":
        return flash_attention(q, k, v, segment_mask=segment_mask, causal=causal, scale=scale,
                               impl=ctx.flash_impl)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, segment_mask=segment_mask, causal=causal,
                                   scale=scale)
    if impl != "reference":
        raise ValueError(f"unknown attention impl {impl!r}")
    if not causal:
        mask = None if segment_mask is None else segment_mask[:, None, None, :].bool()
        return dot_product_attention(q, k, v, mask=mask, scale=scale)
    return causal_attention(q, k, v, segment_mask=segment_mask)
