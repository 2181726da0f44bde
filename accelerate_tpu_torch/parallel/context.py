"""Context parallelism: ring attention, Ulysses and all-gather over the
``cp`` mesh axis (port of ``accelerate_tpu/parallel/context.py``).

Each ``cp`` rank holds one contiguous chunk of the sequence (the prepared
model cuts the inputs a family names, :func:`sequence_chunk`), so
activations stay sequence-sharded and only attention looks across the
chunks:

* **ring**: each rank keeps its Q chunk and streams every KV chunk past it
  (:class:`RingShift`, one ``batch_isend_irecv`` to the next rank a step),
  merging each chunk's partial attention with the online-softmax rule.
  :func:`ring_attention_local` is the einsum body (the ring's plain version
  and the oracle); on CUDA tensors it runs the flash ring
  (:mod:`..ops.ring_flash`), whose chunks are B1-B3;
* **Ulysses**: ``all_to_all_single`` re-shards ``[seq-sharded, all heads]``
  into ``[all seq, head-sharded]``, attends locally and re-shards back;
* **allgather**: every rank gathers the whole KV (the baseline).

Gradients: the collectives here are differentiable (an all-to-all's
transpose is the reverse all-to-all, an all-gather's a reduce-scatter, a
shift's the shift the other way), so ``backward`` differentiates the ring.
:func:`context_parallel_attention` is the entry the attention dispatcher
calls when the mesh has a ``cp`` extent above 1.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch
import torch.distributed as dist

from ..ops.flash_attention import NEG_INF, blockwise_attention, flash_attention

# ---------------------------------------------------------------------------
# the ring's shift and the differentiable collectives
# ---------------------------------------------------------------------------


class RingShift:
    """The ring's one cross-rank step over a process group: ``shift(tensors)``
    sends each tensor to the next rank (``(idx + 1) % n``) and returns the
    previous rank's, in one ``batch_isend_irecv``; :meth:`back` goes the
    other way (the transpose, for a gradient)."""

    def __init__(self, group, idx: int, n: int):
        self.group = group
        self.idx, self.n = idx, n

    def _exchange(self, tensors, to: int, frm: int):
        to = dist.get_global_rank(self.group, to)
        frm = dist.get_global_rank(self.group, frm)
        outs, ops = [], []
        for t in tensors:
            t = t.contiguous()
            out = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, to, self.group))
            ops.append(dist.P2POp(dist.irecv, out, frm, self.group))
            outs.append(out)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs

    def __call__(self, tensors):
        return self._exchange(tensors, (self.idx + 1) % self.n, (self.idx - 1) % self.n)

    def back(self, tensors):
        return self._exchange(tensors, (self.idx - 1) % self.n, (self.idx + 1) % self.n)


class _Shift(torch.autograd.Function):
    """A shift that autograd differentiates (the einsum ring's): the
    gradient goes back one rank."""

    @staticmethod
    def forward(ctx, shift, *tensors):
        ctx.shift = shift
        return tuple(shift(list(tensors)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.shift.back([g.contiguous() for g in grads]))


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks of dim 0; its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()  # empty_like keeps a permuted view's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllGatherSeq(torch.autograd.Function):
    """Every rank's ``[b, s_loc, ...]`` concatenated on dim 1; the gradient
    is the sum over ranks of each rank's slice (a reduce-scatter, as an
    all-to-all of the slices and a sum, so gloo, which has no
    reduce-scatter, takes it too: each rank moves the bytes of its
    gradient once)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.s = group, x.shape[1]
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        slices = g.unflatten(1, (n, ctx.s)).movedim(1, 0)  # [n, b, s_loc, ...]
        return _all_to_all(slices, ctx.group).sum(0), None


def _gather_seq(x, group):
    """The whole sequence of a non-differentiable ``[b, s_loc, ...]``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose gradient is the sum of the ranks'
    gradients (every rank goes on with the same total)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (as it is without one)."""
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_sequence(x: torch.Tensor, group) -> torch.Tensor:
    """A tensor of no gradient, ``[b, s_loc, ...]`` on each ``cp`` rank,
    whole (``[b, n · s_loc, ...]``)."""
    return x if group is None else _gather_seq(x, group)


# ---------------------------------------------------------------------------
# a model's chunk of the sequence
# ---------------------------------------------------------------------------


def sequence_shard() -> tuple:
    """``(group, index, extent)`` of the ``cp`` axis a model's forward runs
    its chunk of the sequence over: ``(None, 0, 1)`` without a ``cp`` mode
    or at an extent of 1."""
    from ..ops.attention import get_attention_context

    ctx = get_attention_context()
    group, index = ctx.axis(ctx.cp_axis) if ctx.cp_mode else (None, 0)
    return (group, index, ctx.cp_extent) if group is not None else (None, 0, 1)


def sequence_chunk(t, index: int, extent: int):
    """This ``cp`` rank's contiguous chunk of ``t``'s sequence dim (dim 1;
    JAX's ``P(batch_axes, "cp")``), raising JAX's words where the extent
    does not divide it (``context_parallel_attention``'s check); a tensor
    of one dim (row ids) and a non-tensor whole."""
    if not isinstance(t, torch.Tensor) or t.dim() < 2:
        return t
    check_sequence_length(t.shape[1], extent)
    n = t.shape[1] // extent
    return t[:, index * n:(index + 1) * n]


def check_sequence_length(s: int, extent: int, cp_axis: str = "cp") -> None:
    """JAX's refusal of a sequence the ``cp`` extent does not divide."""
    if s % extent != 0:
        raise ValueError(f"sequence length {s} must be divisible by the {cp_axis!r} mesh "
                         f"extent {extent} for context parallelism")


def shifted_targets(labels: torch.Tensor, group, index: int) -> torch.Tensor:
    """Next-token targets of this rank's chunk ``labels [b, s_loc]``: the
    labels are shifted over the whole gathered sequence, so a chunk's last
    position takes the next chunk's first label (the sequence's last takes
    -100). Without a group, :func:`~..ops.layers.shift_labels`."""
    from ..ops.layers import shift_labels

    if group is None:
        return shift_labels(labels)
    s = labels.shape[1]
    return shift_labels(gather_sequence(labels, group))[:, index * s:(index + 1) * s]


def first_token(x: torch.Tensor, group, index: int) -> torch.Tensor:
    """``x[:, 0]`` of the whole sequence (a ``[CLS]`` token) on every ``cp``
    rank, though only rank 0's chunk holds it: rank 0's row summed over the
    group with the others' zeros (:func:`all_reduce_sum`), so its gradient
    is the sum of every rank's. The zeros are the rank's own first row
    times 0, so that every rank's backward runs the sum's collective."""
    if group is None:
        return x[:, 0]
    return all_reduce_sum(x[:, 0] * (1.0 if index == 0 else 0.0), group)


# ---------------------------------------------------------------------------
# per-rank building block: one Q chunk × one KV chunk online-softmax update
# ---------------------------------------------------------------------------


def _chunk_update(carry, q, k_chunk, v_chunk, kv_valid, q_offset, kv_offset, scale, causal):
    """Merge attention of local Q against one KV chunk into ``(acc, m, l)``.

    ``q [b, sq, h, d]``; ``k_chunk``/``v_chunk [b, sk, h, d]``;
    ``kv_valid [b, sk]``; the offsets are the chunks' global token offsets."""
    acc, m_run, l_run = carry
    sq, sk = q.shape[1], k_chunk.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_chunk.float()) * scale
    mask = kv_valid.bool()[:, None, None, :]
    if causal:
        q_pos = q_offset + torch.arange(sq, device=q.device)
        kv_pos = kv_offset + torch.arange(sk, device=q.device)
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])[None, None]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    # fully-masked rows: m_new == NEG_INF (finite) would give exp(0)=1,
    # turning the row into mean(v); zero p so l stays 0 → output 0
    p = torch.where(m_new[..., None] == NEG_INF, 0.0, torch.exp(s - m_new[..., None]))
    alpha = torch.exp(m_run - m_new)
    l_new = alpha * l_run + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_chunk.float())
    return acc, m_new, l_new


def _ring_position(group, cp_index, cp_size):
    idx = dist.get_rank(group) if cp_index is None else int(cp_index)
    n = dist.get_world_size(group) if cp_size is None else int(cp_size)
    return idx, n


def ring_attention_local(q, k, v, kv_valid, *, group=None, causal: bool = True,
                         scale: float | None = None, use_flash: bool | None = None,
                         cp_index: int | None = None, cp_size: int | None = None,
                         shift=None, impl=None):
    """Ring attention body on this rank's chunk: ``q``, ``k``, ``v``
    ``[b, s_loc, h, d]`` (K and V with Q's head count), ``kv_valid [b,
    s_loc]``. The ring is ``group``'s (the ``cp`` group) unless ``cp_index``,
    ``cp_size`` and ``shift`` (a :class:`RingShift`-like exchange) say
    otherwise.

    ``use_flash`` (default: for CUDA tensors) runs the flash ring
    (:func:`~..ops.ring_flash.ring_flash_attention_local`: B1-B3 a chunk on
    the card, their plain versions with ``impl="plain"`` or on the CPU);
    otherwise the einsum online-softmax body below, the numerical oracle."""
    idx, n = _ring_position(group, cp_index, cp_size)
    if shift is None and n > 1:
        shift = RingShift(group, idx, n)
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        from ..ops.ring_flash import ring_flash_attention_local

        return ring_flash_attention_local(q, k, v, kv_valid, idx=idx, n=n, shift=shift,
                                          causal=causal, scale=scale, impl=impl)
    b, s_loc, h, d = q.shape
    scale = scale if scale is not None else 1.0 / float(np.sqrt(d))
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    k_cur, v_cur, valid_cur = k, v, kv_valid.to(torch.uint8)
    for step in range(n):
        src = (idx - step) % n  # chunk id currently held
        acc, m, l = _chunk_update((acc, m, l), q, k_cur, v_cur, valid_cur, idx * s_loc,
                                  src * s_loc, scale, causal)
        if step != n - 1:
            k_cur, v_cur = _Shift.apply(shift, k_cur, v_cur)
            valid_cur = shift([valid_cur])[0]
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ulysses_attention_local(q, k, v, kv_valid, *, group=None, causal: bool = True,
                            scale: float | None = None, use_flash: bool | None = None,
                            impl=None):
    """Ulysses body: ``all_to_all_single`` seq↔head re-shard around dense
    local attention (the flash kernels for CUDA tensors, blockwise on the
    CPU). The heads must divide over the group."""
    n = dist.get_world_size(group)
    b, s_loc, h, d = q.shape

    def to_heads(x):  # [b, s_loc, h, d] -> [b, n·s_loc, h/n, d]
        x = x.reshape(b, s_loc, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(x.contiguous(), group)
        return x.permute(1, 0, 2, 3, 4).reshape(b, n * s_loc, h // n, d)

    def to_seq(x):  # [b, n·s_loc, h/n, d] -> [b, s_loc, h, d]
        x = x.reshape(b, n, s_loc, h // n, d).permute(1, 0, 2, 3, 4)
        x = _AllToAll.apply(x.contiguous(), group)
        return x.permute(1, 2, 0, 3, 4).reshape(b, s_loc, h, d)

    qg, kg, vg = to_heads(q), to_heads(k), to_heads(v)
    valid_g = _gather_seq(kv_valid.to(torch.uint8), group)
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        out = flash_attention(qg, kg, vg, segment_mask=valid_g, causal=causal, scale=scale,
                              impl=impl)
    else:
        out = blockwise_attention(qg, kg, vg, segment_mask=valid_g, causal=causal, scale=scale)
    return to_seq(out)


def allgather_attention_local(q, k, v, kv_valid, *, group=None, causal: bool = True,
                              scale: float | None = None, cp_index: int | None = None):
    """Baseline: gather every KV chunk, run dense attention (the einsum
    chunk update) on the local Q chunk at its global offset."""
    idx, _ = _ring_position(group, cp_index, None)
    b, s_loc, h, d = q.shape
    kg = _AllGatherSeq.apply(k, group)
    vg = _AllGatherSeq.apply(v, group)
    valid_g = _gather_seq(kv_valid.to(torch.uint8), group)
    scale = scale if scale is not None else 1.0 / float(np.sqrt(d))
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    acc, m, l = _chunk_update((acc, m, l), q, kg, vg, valid_g, idx * s_loc, 0, scale, causal)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)


_LOCAL_BODIES = {
    "ring": ring_attention_local,
    "ulysses": ulysses_attention_local,
    "allgather": allgather_attention_local,
}


def context_parallel_attention(q, k, v, segment_mask=None, *, mesh: dict, group,
                               mode: Literal["ring", "ulysses", "allgather"] = "ring",
                               causal: bool = True, scale: float | None = None,
                               cp_axis: str = "cp", head_axis: str = "tp",
                               impl=None) -> torch.Tensor:
    """Sequence-parallel attention over ``cp``: ``q [b, s_loc, nh, d]`` (this
    rank's heads under ``tp``), ``k``/``v [b, s_loc, n_kv, d]``,
    ``segment_mask [b, s_loc]`` (1 = valid key) — this rank's chunk of the
    sequence; ``mesh`` the axis extents, ``group`` the ``cp`` group. GQA KV
    heads are repeated to the query heads first."""
    b, s_loc, nh, d = q.shape
    if k.shape[2] != nh:
        rep = nh // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if segment_mask is None:
        segment_mask = torch.ones((b, s_loc), dtype=torch.bool, device=q.device)
    # the sequence's divisibility by the cp extent is checked where the
    # prepared model cuts it (JAX's message, sequence_chunk)
    cp_extent = mesh.get(cp_axis, 1)
    if mode == "ulysses":
        # the all_to_all splits the *local* head dim (after any tp sharding)
        # q holds this rank's heads already (the tp shard of the weights)
        tp = mesh.get(head_axis, 1)
        if nh % cp_extent != 0:
            raise ValueError(
                f"ulysses context parallelism re-shards heads over {cp_axis!r}: "
                f"per-shard head count {nh} (= {nh * tp} heads"
                + (f" / {head_axis}={tp}" if head_axis in mesh else "")
                + f") must be divisible by the {cp_axis!r} mesh extent {cp_extent}"
            )
    if mode not in _LOCAL_BODIES:
        raise ValueError(f"unknown context-parallel mode {mode!r} (ring, ulysses, allgather)")
    kernels = {} if mode == "allgather" else {"impl": impl}  # allgather runs no kernel
    return _LOCAL_BODIES[mode](q, k, v, segment_mask, group=group, causal=causal, scale=scale,
                               **kernels)
