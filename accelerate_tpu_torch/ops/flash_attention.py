"""Flash attention forward and backward (port of
``accelerate_tpu/ops/flash_attention.py``), plus the blockwise
memory-efficient attention that is the CPU path of :func:`ops.attention.attention`.

Public layout is the model's ``[batch, seq, heads, head_dim]``. Three
implementations sit behind :func:`flash_attention`, a
``torch.autograd.Function`` whose forward is :func:`flash_fwd` and whose
backward is :func:`flash_bwd`:

* the **CUDA kernels** ``csrc/flash_attention.cu`` (hand-written for
  ``sm_90a``): ``flash_fwd_*`` replaces the TPU kernel ``_fwd_kernel``,
  ``flash_bwd_dq_*`` ``_bwd_dq_kernel`` and ``flash_bwd_dkv_*``
  ``_bwd_dkv_kernel``; bf16 inputs run their products on the tensor cores
  (``wgmma`` fed by a TMA ring), f32 inputs on the FMA units (no TF32).
  Taken for CUDA tensors, and only the
  kernels: a build or launch failure raises;
* the **plain** PyTorch versions :func:`_flash_fwd_plain` and
  :func:`_flash_bwd_plain` — the kernels' math as a loop over key tiles,
  with the same masking and rounding points. Taken for CPU tensors, and by
  the tests and ``chip_smoke.py`` as the kernels' reference;
* :func:`blockwise_attention`, differentiable by autograd (the port of the
  JAX ``lax.scan`` fallback).

:func:`flash_fwd` / :func:`flash_bwd` are exposed on their own (``(o, lse)``
and a backward from ``(o, lse, dO)``, a causal flag per call) for the later
ring-attention port, which calls them per sequence chunk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: the finite float32 minimum: every "fully masked row" rule depends on it
#: being finite (exp(NEG_INF - NEG_INF) = 1 must never reach an output)
NEG_INF = float(np.finfo(np.float32).min)

#: CUDA kernel launches since import, one counter per kernel (the plain and
#: blockwise versions never count): the training path's proof that it went
#: through the kernels
fwd_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernels take (the training entry point refuses others on
#: the card before any step: ``accelerator.check_kernel_head_dim``)
HEAD_DIMS = (64, 128)
#: key tile of the plain forward: the bf16 forward kernel's (``kFwdTileKeys``
#: in ``csrc/flash_attention.cu``), where P is rounded at each tile's running max
_FWD_TILE = 128
#: key tile of the plain backward (P comes from lse there, so the tile does not
#: change its rounding)
_TILE = 64


def _resolve_impl(impl, q) -> str:
    if impl is None:
        return "cuda" if q.is_cuda else "plain"
    if impl not in ("cuda", "plain"):
        raise ValueError(f"unknown flash attention impl {impl!r} (None, 'cuda' or 'plain')")
    return impl


def flash_fwd(q, k, v, segment_mask=None, scale=None, causal=True, impl=None):
    """``(o [b, sq, nh, hd] in q's dtype, lse [b, nh, sq] f32)``. A row with
    no valid key gives ``o = 0`` and ``lse = NEG_INF``. ``impl=None`` launches
    the kernel for CUDA tensors and runs the plain version for CPU tensors."""
    scale = _scale(q, scale)
    if _resolve_impl(impl, q) == "cuda":
        return _flash_fwd_cuda(q, k, v, segment_mask, scale, causal)
    return _flash_fwd_plain(q, k, v, segment_mask, scale, causal)


def flash_bwd(q, k, v, segment_mask, o, lse, do, scale=None, causal=True, impl=None):
    """``(dq, dk, dv)`` from the forward's ``(o, lse)`` and ``dO``, each in
    its input's dtype. ``delta = rowsum(dO * O)`` is computed here in f32,
    before either implementation runs. The mask gets no gradient."""
    scale = _scale(q, scale)
    if _resolve_impl(impl, q) == "cuda":
        return _flash_bwd_cuda(q, k, v, segment_mask, o, lse, do, scale, causal)
    return _flash_bwd_plain(q, k, v, segment_mask, o, lse, do, scale, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_mask, scale, causal, impl):
        o, lse = flash_fwd(q, k, v, segment_mask, scale, causal, impl)
        ctx.save_for_backward(q, k, v, segment_mask, o, lse)
        ctx.scale, ctx.causal, ctx.impl = scale, causal, impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, segment_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, segment_mask, o, lse, do.contiguous(),
                               ctx.scale, ctx.causal, ctx.impl)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, segment_mask=None, causal=True, scale=None, impl=None):
    """Flash attention in model layout: ``q [b, s, nh, hd]``, ``k``/``v``
    ``[b, skv, n_kv, hd]`` (GQA when ``n_kv < nh``), ``segment_mask [b, skv]``
    (1 = valid key). Differentiable in ``q``, ``k`` and ``v``. ``impl=None``
    takes the CUDA kernels for CUDA tensors and the plain versions for CPU
    tensors; ``"plain"`` forces the plain versions (tests, ``chip_smoke.py``)."""
    return _FlashAttention.apply(q, k, v, segment_mask, _scale(q, scale), bool(causal), impl)


def _scale(q, scale) -> float:
    return float(scale) if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))


def _delta(o, do):
    """``rowsum(dO * O)`` in f32, ``[b, nh, sq]``."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# plain versions: the kernels' math over key tiles, tensor code only
# ---------------------------------------------------------------------------


def _heads_first(q, k, v):
    """``[b, s, h, d]`` → ``[b, h, s, d]`` f32, K/V repeated to the query
    heads (head ``h`` reads kv head ``h // rep``)."""
    rep = q.shape[2] // k.shape[2]
    kt = k.transpose(1, 2).float()
    vt = v.transpose(1, 2).float()
    if rep > 1:
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    return q.transpose(1, 2).float(), kt, vt


def _tile_valid(segment_mask, t0, t1, sq, causal, device):
    """Validity of keys ``t0..t1`` for every query: ``[b or 1, 1, sq, t1-t0]``."""
    kv_pos = torch.arange(t0, t1, device=device)
    valid = torch.ones((1, 1, sq, t1 - t0), dtype=torch.bool, device=device)
    if causal:
        q_pos = torch.arange(sq, device=device)
        valid = valid & (q_pos[:, None] >= kv_pos[None, :])[None, None]
    if segment_mask is not None:
        valid = valid & segment_mask[:, t0:t1].bool()[:, None, None, :]
    return valid


def _tile_ends(sq, skv, causal, tile=_TILE):
    """Key tiles the kernels visit: with ``causal``, none starting past the
    last query."""
    end = min(skv, sq) if causal else skv
    return [(t0, min(t0 + tile, skv)) for t0 in range(0, end, tile)]


def _flash_fwd_plain(q, k, v, segment_mask, scale, causal):
    """The math of ``_fwd_kernel``: f32 scores, an online softmax over key
    tiles of ``_FWD_TILE``, P rounded to V's dtype before P·V, f32
    accumulators."""
    b, sq, nh, hd = q.shape
    skv = k.shape[1]
    qt, kt, vt = _heads_first(q, k, v)
    dev = q.device
    m = torch.full((b, nh, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nh, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nh, sq, hd), dtype=torch.float32, device=dev)
    for t0, t1 in _tile_ends(sq, skv, causal, _FWD_TILE):
        s = torch.matmul(qt, kt[:, :, t0:t1].transpose(-1, -2)) * scale
        s = torch.where(_tile_valid(segment_mask, t0, t1, sq, causal, dev), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(m_new[..., None] == NEG_INF, 0.0, torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).float(), vt[:, :, t0:t1])
        acc = acc * alpha[..., None] + pv
        m = m_new
    empty = l == 0.0
    l_safe = torch.where(empty, 1.0, l)
    o = (acc / l_safe[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    lse = torch.where(empty, NEG_INF, m + torch.log(l_safe))
    return o, lse


def _flash_bwd_plain(q, k, v, segment_mask, o, lse, do, scale, causal):
    """The math of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``: P recomputed
    from lse (0 where lse is NEG_INF), dS = P·(dP − δ)·scale, P rounded to
    dO's dtype before Pᵀ·dO and dS to K's / Q's dtype before dS·K / dSᵀ·Q."""
    b, sq, nh, hd = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    rep = nh // n_kv
    qt, kt, vt = _heads_first(q, k, v)
    dot = do.transpose(1, 2).float()
    delta = _delta(o, do)[..., None]
    lse_c = lse[..., None]
    dev = q.device
    dq = torch.zeros((b, nh, sq, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, nh, skv, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, nh, skv, hd), dtype=torch.float32, device=dev)
    for t0, t1 in _tile_ends(sq, skv, causal):
        kb, vb = kt[:, :, t0:t1], vt[:, :, t0:t1]
        s = torch.matmul(qt, kb.transpose(-1, -2)) * scale
        s = torch.where(_tile_valid(segment_mask, t0, t1, sq, causal, dev), s, NEG_INF)
        p = torch.where(lse_c == NEG_INF, 0.0, torch.exp(s - lse_c))
        dp = torch.matmul(dot, vb.transpose(-1, -2))
        ds = p * (dp - delta) * scale
        dq += torch.matmul(ds.to(k.dtype).float(), kb)
        dv[:, :, t0:t1] = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dot)
        dk[:, :, t0:t1] = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qt)
    # GQA: the rep query heads of a kv head sum into it, in f32
    dk = dk.reshape(b, n_kv, rep, skv, hd).sum(dim=2)
    dv = dv.reshape(b, n_kv, rep, skv, hd).sum(dim=2)
    return (
        dq.to(q.dtype).transpose(1, 2).contiguous(),
        dk.to(k.dtype).transpose(1, 2).contiguous(),
        dv.to(v.dtype).transpose(1, 2).contiguous(),
    )


# ---------------------------------------------------------------------------
# blockwise attention: autograd through an online-softmax loop (CPU path)
# ---------------------------------------------------------------------------


def blockwise_attention(q, k, v, segment_mask=None, causal=True, scale=None, block_kv=512):
    """Online-softmax attention as a loop over KV blocks, differentiable by
    autograd: O(s·block_kv) live scores. The same math as the kernels, in
    f32; the port of the JAX ``lax.scan`` fallback that runs where the
    kernels do not (the CPU)."""
    b, sq, nh, hd = q.shape
    skv = k.shape[1]
    scale = _scale(q, scale)
    block_kv = min(block_kv, skv)
    qt, kt, vt = _heads_first(q, k, v)
    dev = q.device
    q_pos = torch.arange(sq, device=dev)
    acc = torch.zeros((b, nh, sq, hd), dtype=torch.float32, device=dev)
    m_run = torch.full((b, nh, sq), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, nh, sq), dtype=torch.float32, device=dev)
    for t0 in range(0, skv, block_kv):
        t1 = min(t0 + block_kv, skv)
        s = torch.matmul(qt, kt[:, :, t0:t1].transpose(-1, -2)) * scale
        col = torch.ones((1, 1, 1, t1 - t0), dtype=torch.bool, device=dev)
        if segment_mask is not None:
            col = segment_mask[:, t0:t1].bool()[:, None, None, :]
        if causal:
            kv_pos = torch.arange(t0, t1, device=dev)
            col = col & (q_pos[:, None] >= kv_pos[None, :])[None, None]
        s = torch.where(col, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.where(m_new[..., None] == NEG_INF, 0.0, torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m_run - m_new)
        l_run = alpha * l_run + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, vt[:, :, t0:t1])
        m_run = m_new
    l_safe = torch.where(l_run == 0.0, 1.0, l_run)
    out = acc / l_safe[..., None]
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------


def _kernel():
    from .. import _build

    lib = _build.load("flash_attention.cu")
    if lib.flash_attention_fwd.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        shape = [i32] * 6 + [f32, i32, i32, ptr]  # b sq skv nh n_kv hd scale causal dtype stream
        lib.flash_attention_fwd.argtypes = [ptr] * 6 + shape
        lib.flash_attention_bwd_dq.argtypes = [ptr] * 8 + shape
        lib.flash_attention_bwd_dkv.argtypes = [ptr] * 9 + shape
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention CUDA kernel: {msg}")


def _validate(q, k, v, segment_mask, *extra):
    """Shapes, dtypes, devices and layouts the kernels take; returns the
    mask as contiguous bytes (or None) and the shape tuple."""
    for t in (q, k, v, *extra):
        _check(t.is_cuda and t.device == q.device, "every tensor must lie on q's CUDA device")
        _check(t.is_contiguous(), "every tensor must be contiguous")
        _check(t.data_ptr() % 16 == 0, "tensors must be 16-byte aligned (16-byte loads)")
    _check(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
           "q [b, s, nh, hd], k and v [b, skv, n_kv, hd]")
    b, sq, nh, hd = q.shape
    _, skv, n_kv, hd_k = k.shape
    _check(k.shape[0] == b and hd_k == hd, "q and k/v shapes disagree")
    _check(hd in HEAD_DIMS, f"head_dim {hd} not supported (takes {HEAD_DIMS})")
    _check(nh % n_kv == 0, f"n_heads {nh} is not a multiple of n_kv {n_kv}")
    _check(q.dtype in _DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k, v must share one dtype of {list(_DTYPE_CODES)}")
    mask = None
    if segment_mask is not None:
        _check(segment_mask.shape == (b, skv), "segment_mask must be [b, skv]")
        mask = segment_mask.to(device=q.device, dtype=torch.bool).contiguous()
    return mask, (b, sq, skv, nh, n_kv, hd)


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention CUDA kernel {what} launch failed: {msg} ({err})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _flash_fwd_cuda(q, k, v, segment_mask, scale, causal):
    global fwd_launches
    mask, shape = _validate(q, k, v, segment_mask)
    b, sq, _, nh, _, _ = shape
    o = torch.empty_like(q)
    lse = torch.empty((b, nh, sq), dtype=torch.float32, device=q.device)
    lib = _kernel()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), o.data_ptr(), lse.data_ptr(),
        *shape, scale, int(causal), _DTYPE_CODES[q.dtype], stream,
    )
    _raise_on(lib, err, "forward")
    fwd_launches += 1
    return o, lse


def _flash_bwd_cuda(q, k, v, segment_mask, o, lse, do, scale, causal):
    delta = _delta(o, do)
    dq = _bwd_dq_cuda(q, k, v, segment_mask, lse, delta, do, scale, causal)
    dk, dv = _bwd_dkv_cuda(q, k, v, segment_mask, lse, delta, do, scale, causal)
    return dq, dk, dv


def _bwd_args(q, k, v, segment_mask, lse, delta, do, scale, causal):
    """The checked mask and the launch's trailing arguments, shared by the
    two backward kernels (each also timed on its own by ``chip_smoke.py``)."""
    mask, shape = _validate(q, k, v, segment_mask, do, lse, delta)
    b, sq, _, nh, _, _ = shape
    _check(do.shape == q.shape and do.dtype == q.dtype, "dO must match q")
    for name, t in (("lse", lse), ("delta", delta)):
        _check(t.dtype == torch.float32 and t.shape == (b, nh, sq), f"{name} must be f32 [b, nh, sq]")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return mask, (*shape, scale, int(causal), _DTYPE_CODES[q.dtype], stream)


def _bwd_dq_cuda(q, k, v, segment_mask, lse, delta, do, scale, causal):
    global bwd_dq_launches
    mask, tail = _bwd_args(q, k, v, segment_mask, lse, delta, do, scale, causal)
    dq = torch.empty_like(q)
    lib = _kernel()
    err = lib.flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *tail,
    )
    _raise_on(lib, err, "dq")
    bwd_dq_launches += 1
    return dq


def _bwd_dkv_cuda(q, k, v, segment_mask, lse, delta, do, scale, causal):
    global bwd_dkv_launches
    mask, tail = _bwd_args(q, k, v, segment_mask, lse, delta, do, scale, causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _kernel()
    err = lib.flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
    )
    _raise_on(lib, err, "dk/dv")
    bwd_dkv_launches += 1
    return dk, dv
