"""Paged attention: walk the block table, never materialise the span
(port of ``accelerate_tpu/ops/paged_attention.py``).

Attention of ``q [b, s, nh, hd]`` against each row's block-paged span of the
pools ``[num_blocks, bs, n_kv, hd]``, read through ``block_tables [b,
max_blocks]``: query ``j`` of row ``b`` attends logical positions ``<=
idx[b]+j``. GQA by grouped heads (no KV repeat); int8/fp8 pools carry
per-(position, kv head) f32 scales and are dequantized on load.

Three implementations behind one dispatcher:

* the **CUDA kernel** ``csrc/paged_attention.cu`` (hand-written for
  ``sm_90a``; it replaces the TPU kernel
  ``accelerate_tpu/ops/paged_attention.py:_pallas_kernel``) — taken for
  CUDA tensors, and only the kernel: a build or launch failure raises;
* the **plain** PyTorch version (port of ``_paged_attention_lax``): a loop
  over table entries with an online softmax — taken for CPU tensors, and
  by the tests and ``chip_smoke.py`` as the kernel's reference;
* the **gather** reference (port of ``_paged_attention_gather``):
  materialise the span, then :func:`ops.layers.cached_attention`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .fp8 import dequantize_kv

_NEG_INF = float(np.finfo(np.float32).min)

#: CUDA kernel launches since import (the plain and gather versions never
#: count): the serving path's proof that it went through the kernel. A
#: launch recorded into a CUDA graph under capture counts once here; the
#: graph's replays launch it again without passing the wrapper, so the
#: serving engine adds replays × what each capture recorded
launches = 0
#: the share of ``launches`` with one query a row (``s == 1``, decode); the
#: rest are prefill chunks and other multi-token calls
decode_launches = 0

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
_HEAD_DIMS = (16, 32, 64, 128)


def paged_attention(
    q,                      # [b, s, n_heads, hd]
    k_pages_l,              # [num_blocks, bs, n_kv, hd] (storage dtype)
    v_pages_l,              # [num_blocks, bs, n_kv, hd]
    block_tables,           # [b, max_blocks] int32
    idx,                    # [b] int32 — first query's cache position
    k_scale_l=None,         # [num_blocks, bs, n_kv] f32 (quantized pools)
    v_scale_l=None,
    impl: str | None = None,
):
    """``impl=None`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``"plain"`` and ``"gather"`` force a
    reference (tests and ``chip_smoke.py`` only). Output in ``q``'s dtype."""
    if impl is None:
        impl = "cuda" if q.is_cuda else "plain"
    if impl == "cuda":
        return _paged_attention_cuda(
            q, k_pages_l, v_pages_l, block_tables, idx, k_scale_l, v_scale_l
        )
    if impl == "plain":
        return _paged_attention_plain(
            q, k_pages_l, v_pages_l, block_tables, idx, k_scale_l, v_scale_l
        )
    if impl == "gather":
        return _paged_attention_gather(
            q, k_pages_l, v_pages_l, block_tables, idx, k_scale_l, v_scale_l
        )
    raise ValueError(f"unknown paged attention impl {impl!r}")


# ---------------------------------------------------------------------------
# plain version: loop over table entries, online softmax
# ---------------------------------------------------------------------------


def _dequant_block(block, scale_rows):
    """One gathered pool block → f32, applying per-row scales if present."""
    if scale_rows is None:
        return block.float()
    return dequantize_kv(block, scale_rows)


def _paged_attention_plain(q, k_pages_l, v_pages_l, block_tables, idx, k_scale_l, v_scale_l):
    b, s, nh, hd = q.shape
    _, bs, n_kv, _ = k_pages_l.shape
    rep = nh // n_kv
    mb = block_tables.shape[1]
    bt = block_tables.long()
    idx = idx.reshape(b).long()
    dev = q.device

    # scale folded into q once (not per block); grouped heads for GQA
    qg = (q.float() / np.sqrt(float(hd))).reshape(b, s, n_kv, rep, hd)
    q_pos = idx[:, None] + torch.arange(s, device=dev)[None, :]  # [b, s]
    m = torch.full((b, n_kv, rep, s), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, rep, s), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, rep, s, hd), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(_NEG_INF, device=dev)
    for j in range(mb):
        blk = bt[:, j]                                   # [b]
        kb = _dequant_block(k_pages_l[blk], None if k_scale_l is None else k_scale_l[blk])
        vb = _dequant_block(v_pages_l[blk], None if v_scale_l is None else v_scale_l[blk])
        sc = torch.einsum("bsnrd,btnd->bnrst", qg, kb)   # [b, n_kv, rep, s, bs]
        pos = j * bs + torch.arange(bs, device=dev)      # logical positions
        valid = pos[None, None, :] <= q_pos[:, :, None]  # [b, s, bs]
        vmask = valid[:, None, None, :, :]
        sc = torch.where(vmask, sc, neg_inf)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        # while every position so far is masked, m_new == _NEG_INF and
        # sc - m_new == 0 — the explicit mask keeps those lanes at p = 0
        p = torch.where(vmask, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnrst,btnd->bnrsd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]    # [b, n_kv, rep, s, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nh, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# gather reference: materialise the span, then dense cached attention
# ---------------------------------------------------------------------------


def _paged_attention_gather(q, k_pages_l, v_pages_l, block_tables, idx, k_scale_l, v_scale_l):
    from .layers import cached_attention, gather_paged_kv

    if k_scale_l is not None:
        bt = block_tables.long()
        b, mb = bt.shape
        bs = k_pages_l.shape[1]
        k_g = dequantize_kv(k_pages_l[bt], k_scale_l[bt])
        v_g = dequantize_kv(v_pages_l[bt], v_scale_l[bt])
        k_g = k_g.reshape(b, mb * bs, *k_g.shape[3:])
        v_g = v_g.reshape(b, mb * bs, *v_g.shape[3:])
    else:
        k_g, v_g = gather_paged_kv(k_pages_l, v_pages_l, block_tables)
    return cached_attention(q, k_g, v_g, idx.reshape(q.shape[0]))


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------


#: the kernel's tiling (``csrc/paged_attention.cu``: kRows, kStageKeys,
#: kMaxSplitKeys), which the split plan needs on the host
_TILE_ROWS = 16
_TILE_KEYS = 64
_MAX_SPLIT_KEYS = 4096
#: blocks the plan aims for, per SM: one wave of the two blocks an SM holds
#: at the flagship decode shape (each block pays a fixed latency, idx ->
#: table -> first tile, once a wave; one wave beat two and three on the H100)
_BLOCKS_PER_SM_TARGET = 2


class SplitPlan(NamedTuple):
    """How a launch cuts each row's keys: ``splits`` blocks per (row, kv
    head, 16-row query tile), and the f32 partial buffers' shapes (``None``
    when one split writes the output directly)."""

    splits: int
    part_acc_shape: tuple | None
    part_ml_shape: tuple | None


def _split_plan(b: int, s: int, nh: int, n_kv: int, hd: int, span: int,
                sm_count: int) -> SplitPlan:
    """The number of key splits, from static shapes only (``span`` is the
    table's ``max_blocks * block_size``): about ``_BLOCKS_PER_SM_TARGET``
    blocks an SM over the launch, at least one split, never more splits than
    64-key tiles in the table, and no split over 4096 keys. Nothing here
    reads ``idx`` or the tables, so the same shapes always give the same
    launch (a captured CUDA graph stays valid); the kernel cuts each row's
    valid prefix evenly over the splits it needs on the device."""
    row_tiles = -(-((nh // n_kv) * s) // _TILE_ROWS)
    tiles = -(-span // _TILE_KEYS)
    splits = (_BLOCKS_PER_SM_TARGET * sm_count) // max(1, b * n_kv * row_tiles)
    splits = max(1, min(max(splits, -(-span // _MAX_SPLIT_KEYS)), tiles))
    if splits == 1:
        return SplitPlan(1, None, None)
    return SplitPlan(splits, (b, s, nh, splits, hd), (b, s, nh, splits, 2))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _kernel():
    from .. import _build

    lib = _build.load("paged_attention.cu")
    fn = lib.paged_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention CUDA kernel: {msg}")


def _paged_attention_cuda(q, k_pages_l, v_pages_l, block_tables, idx, k_scale_l, v_scale_l):
    """Validate, plan the splits from shapes, allocate, launch on the current
    stream, count."""
    global launches, decode_launches
    tensors = [q, k_pages_l, v_pages_l, block_tables, idx]
    quantized = k_scale_l is not None
    if quantized:
        tensors += [k_scale_l, v_scale_l]
    for t in tensors:
        _check(t is not None and t.is_cuda and t.device == q.device,
               "every tensor must lie on q's CUDA device")
        _check(t.is_contiguous(), "every tensor must be contiguous")
    _check(q.dim() == 4 and k_pages_l.dim() == 4, "q [b,s,nh,hd], pools [nb,bs,n_kv,hd]")
    b, s, nh, hd = q.shape
    nb, bs, n_kv, hd_k = k_pages_l.shape
    mb = block_tables.shape[-1]
    _check(hd == hd_k and v_pages_l.shape == k_pages_l.shape, "q and pool shapes disagree")
    _check(hd in _HEAD_DIMS, f"head_dim {hd} not supported (takes {_HEAD_DIMS})")
    _check(nh % n_kv == 0, f"n_heads {nh} is not a multiple of n_kv {n_kv}")
    _check(q.dtype in _Q_CODES, f"q dtype {q.dtype} not supported")
    _check(k_pages_l.dtype in _POOL_CODES and v_pages_l.dtype == k_pages_l.dtype,
           f"pool dtype {k_pages_l.dtype} not supported")
    pool_quantized = k_pages_l.dtype in (torch.int8, torch.float8_e4m3fn)
    _check(quantized == pool_quantized and (v_scale_l is not None) == quantized,
           "int8/fp8 pools need both scale arrays, float pools none")
    if quantized:
        for sc in (k_scale_l, v_scale_l):
            _check(sc.dtype == torch.float32 and sc.shape == (nb, bs, n_kv),
                   "scales must be f32 [num_blocks, block_size, n_kv]")
    _check(block_tables.dtype == torch.int32 and block_tables.shape == (b, mb),
           "block_tables must be int32 [b, max_blocks]")
    _check(idx.dtype == torch.int32 and idx.numel() == b, "idx must be int32 [b]")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages_l, v_pages_l)),
           "q and the pools must be 16-byte aligned (the kernel copies 16 bytes a thread)")

    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    lib = _kernel()
    # key splits (flash-decoding), planned from shapes alone: partials in
    # f32 scratch, merged by a second kernel; one split writes the output
    plan = _split_plan(b, s, nh, n_kv, hd, mb * bs, _sm_count(q.device.index))
    part_acc = part_ml = None
    if plan.splits > 1:
        part_acc = torch.empty(plan.part_acc_shape, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(plan.part_ml_shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_forward(
        q.data_ptr(), k_pages_l.data_ptr(), v_pages_l.data_ptr(),
        k_scale_l.data_ptr() if quantized else None,
        v_scale_l.data_ptr() if quantized else None,
        block_tables.data_ptr(), idx.data_ptr(), out.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        b, s, nh, n_kv, hd, nb, bs, mb, plan.splits,
        _Q_CODES[q.dtype], _POOL_CODES[k_pages_l.dtype], stream,
    )
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged_attention CUDA kernel launch failed: {msg} ({err})")
    launches += 1
    if s == 1:
        decode_launches += 1
    return out
