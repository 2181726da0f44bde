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

With a ``cp`` extent above 1 and a ``cp_mode`` (set by the ``Accelerator``
from its mesh), every call goes to
:func:`~..parallel.context.context_parallel_attention` over the context's
``cp`` group: q, k and v are this rank's chunk of the sequence (and, on a
mesh with ``tp``, its heads: the model projects with its own shard of the
weights, so the kernels see local heads — the counterpart of JAX's
``_flash_sharded``). The CUDA kernels choose their own tiles, so the JAX
block-size fields and ``resolve_flash_blocks`` have no counterpart.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Literal

from .flash_attention import blockwise_attention, flash_attention
from .layers import causal_attention, dot_product_attention


@dataclass(frozen=True)
class AttentionContext:
    #: mesh axis name -> extent (all six of JAX's axes), or None off a mesh
    mesh: dict | None = None
    cp_mode: Literal["ring", "ulysses", "allgather"] | None = None
    cp_axis: str = "cp"
    impl: Literal["auto", "flash", "blockwise", "reference"] = "auto"
    #: which flash implementation ``"flash"`` runs: None picks by device
    #: (kernels for CUDA tensors), ``"plain"`` the plain versions anywhere
    flash_impl: Literal["cuda", "plain"] | None = None
    #: axis name -> (process group or None, this rank's index) of the
    #: sharded mesh's ``cp`` and ``tp`` axes (None where the extent is 1)
    groups: dict | None = None

    @property
    def cp_extent(self) -> int:
        return (self.mesh or {}).get(self.cp_axis, 1)

    def axis(self, name: str) -> tuple:
        """``(group, index)`` of a mesh axis; ``(None, 0)`` off the mesh."""
        return (self.groups or {}).get(name, (None, 0))


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


@contextmanager
def attention_context_as(ctx: AttentionContext):
    """Run under ``ctx`` whole: a checkpoint's recompute under the context
    its forward ran in (:func:`~..parallel.pipeline.remat_wrap`)."""
    global _current
    prev = _current
    _current = ctx
    try:
        yield ctx
    finally:
        _current = prev


def attention(q, k, v, segment_mask=None, causal=True, scale=None):
    """``q [b, s, nh, hd]``, ``k``/``v`` ``[b, s, n_kv, hd]``,
    ``segment_mask [b, s]`` (1 = valid token); output in q's layout and
    dtype."""
    ctx = _current
    if ctx.cp_mode is not None and ctx.cp_extent > 1:
        from ..parallel.context import context_parallel_attention

        return context_parallel_attention(
            q, k, v, segment_mask, mesh=ctx.mesh, group=ctx.axis(ctx.cp_axis)[0],
            mode=ctx.cp_mode, causal=causal, scale=scale, cp_axis=ctx.cp_axis,
            impl=ctx.flash_impl)
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
