"""Core transformer ops (port of ``accelerate_tpu/ops/layers.py``): the
norm, RoPE, the reference attention and the losses the training step runs,
and the cached attention and block-paged KV cache ops the serving path
runs.

Layouts follow the JAX package at every public function (``[b, s, heads,
head_dim]`` activations, ``[num_blocks, block_size, n_kv, head_dim]``
pools) so the tests hold the two packages against each other like for
like.
"""

from __future__ import annotations

import numpy as np
import torch

#: pool index of the reserved null block: free slots and the unfilled tail
#: of every block table point at it, dropped writes land in it, and it is
#: never attended
NULL_BLOCK = 0


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm accumulated in f32 and cast back to ``x.dtype``."""
    dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(dtype)


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     device=None):
    """RoPE cos/sin tables ``[max_seq, head_dim//2]``, built in float64
    numpy and cast to f32 once (f32 arithmetic would drift at long
    positions)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    t = np.arange(max_seq_len)
    freqs = np.outer(t, inv_freq)
    return (
        torch.as_tensor(np.cos(freqs), dtype=torch.float32, device=device),
        torch.as_tensor(np.sin(freqs), dtype=torch.float32, device=device),
    )


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``[batch, seq, heads, head_dim]`` by position-indexed tables.
    The rotation runs in ``x.dtype`` (bf16 under bf16 compute), as in the
    JAX package; the f32 tables are cast once per gathered slice.

    A position past the table is clamped to its last row, as JAX's gather
    clamps an out-of-range index: the serving engine's dead lane-steps at
    the end of a decode burst and the padded tail of a prefill chunk may
    run past ``max_position_embeddings``, and what they compute is never
    read. The clamp has fixed shapes and no host sync, so a CUDA graph
    can capture it."""
    dtype = x.dtype
    positions = positions.long().clamp(max=cos.shape[0] - 1)
    cos = cos[positions][:, :, None, :].to(dtype)  # [b, s, 1, hd/2]
    sin = sin[positions][:, :, None, :].to(dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def dot_product_attention(q, k, v, mask=None, scale=None):
    """Reference attention: QKᵀ in the inputs' dtype → f32 masked softmax →
    probabilities in q's dtype → PV. ``q [b, s, nh, hd]``, ``k``/``v``
    ``[b, skv, n_kv, hd]`` (GQA by repeating KV heads), ``mask``
    broadcastable to ``[b, nh, s, skv]``. The flash kernels replace it on
    the hot path."""
    b, s, nh, hd = q.shape
    n_kv = k.shape[2]
    if n_kv != nh:
        k = k.repeat_interleave(nh // n_kv, dim=2)
        v = v.repeat_interleave(nh // n_kv, dim=2)
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) * scale).float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_mask(q_len: int, kv_len: int, dtype=torch.bool, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((q_len, kv_len), dtype=dtype, device=device),
                      diagonal=kv_len - q_len)


def causal_attention(q, k, v, segment_mask=None):
    """Causal self-attention; ``segment_mask [b, s]`` marks valid tokens."""
    s, skv = q.shape[1], k.shape[1]
    mask = causal_mask(s, skv, device=q.device)[None, None, :, :]
    if segment_mask is not None:
        mask = mask & segment_mask[:, None, None, :].bool()
    return dot_product_attention(q, k, v, mask=mask)


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-level CE with an ignore mask, f32 log-softmax; the masked mean
    over valid tokens, the count clamped at 1."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def shift_labels(labels, ignore_index: int = -100):
    """Next-token targets without slicing: position t's target is token
    t+1 and the final position is ``ignore_index``, so the sequence length
    (and :func:`fused_cross_entropy`'s chunking) is unchanged."""
    pad = torch.full((labels.shape[0], 1), ignore_index, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([labels[:, 1:], pad], dim=1)


def _chunk_nll(x_i, head, l_i, ignore_index: int):
    """One chunk's summed NLL and valid count; the head product runs in the
    compute dtype and is cast to f32 before the log-softmax."""
    logits = torch.matmul(x_i, head).float()  # [b, s/C, V]
    valid = l_i != ignore_index
    safe = torch.where(valid, l_i, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def fused_cross_entropy(x, head, labels, ignore_index: int = -100, chunk_tokens: int = 1024):
    """Token CE from pre-head hidden states ``x [b, s, h]`` and ``head [h,
    vocab]`` without holding the full ``[b, s, vocab]`` logits: the sequence
    splits into ``C`` chunks, the largest divisor of ``s`` with ``s // C >=
    chunk_tokens // b`` (``C == 1`` is the plain loss), and each chunk runs
    under ``torch.utils.checkpoint`` so the backward recomputes its logits
    (the JAX ``jax.checkpoint`` inside ``lax.scan``). Equal to
    ``cross_entropy_loss(x @ head, labels)``."""
    b, s, _ = x.shape
    rows = max(1, chunk_tokens // b)
    C = 1
    for c in range(1, s + 1):
        if s % c == 0 and s // c >= rows:
            C = c
    if C == 1:
        return cross_entropy_loss(torch.matmul(x, head), labels, ignore_index)
    from torch.utils.checkpoint import checkpoint

    n = s // C
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(C):
        d_nll, d_cnt = checkpoint(_chunk_nll, x[:, i * n:(i + 1) * n], head,
                                  labels[:, i * n:(i + 1) * n], ignore_index,
                                  use_reentrant=False)
        nll = nll + d_nll
        count = count + d_cnt
    return nll / torch.clamp(count, min=1)


def cached_attention(q, k_cache, v_cache, idx):
    """Chunked attention against a KV cache with a per-row valid prefix.

    q ``[b, s, nh, hd]``; caches ``[b, max_cache, n_kv, hd]`` already holding
    this chunk's K/V. Query ``j`` of row ``b`` attends cache positions
    ``<= idx[b]+j``. GQA by grouped heads (head ``h`` reads kv head
    ``h // rep``); f32 scores and softmax."""
    b, s, nh, hd = q.shape
    n_kv = k_cache.shape[2]
    rep = nh // n_kv
    qg = q.float().reshape(b, s, n_kv, rep, hd)
    max_cache = k_cache.shape[1]
    idx = idx.reshape(b).long()
    q_pos = idx[:, None] + torch.arange(s, device=q.device)[None, :]  # [b, s]
    valid = (
        torch.arange(max_cache, device=q.device)[None, None, :] <= q_pos[:, :, None]
    )  # [b, s, max]
    scores = torch.einsum("bqnrd,bknd->bnrqk", qg, k_cache.float()) / np.sqrt(float(hd))
    scores = torch.where(
        valid[:, None, None, :, :], scores,
        torch.tensor(torch.finfo(torch.float32).min, device=q.device),
    )
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnrqk,bknd->bqnrd", probs, v_cache.float())
    return out.reshape(b, s, nh, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Block-paged KV cache (serving engine): one pool of fixed-size blocks per
# layer ``[num_blocks, block_size, n_kv, hd]`` plus a per-slot block table
# mapping each slot's logical block index to a pool block (PagedAttention,
# vLLM, SOSP '23). Block 0 is the reserved null block.
# ---------------------------------------------------------------------------


def _scatter_rows(pool: torch.Tensor, flat: torch.Tensor, rows: torch.Tensor) -> None:
    """``pool.view(nb*bs, ...)[flat] = rows`` in place. fp8 pools scatter
    through a byte view (same itemsize), which every backend supports."""
    nb, bs = pool.shape[0], pool.shape[1]
    dst = pool.view(nb * bs, *pool.shape[2:])
    src = rows.reshape(flat.shape[0], *pool.shape[2:]).contiguous()
    if pool.dtype == torch.float8_e4m3fn:
        dst, src = dst.view(torch.uint8), src.view(torch.uint8)
    dst.index_copy_(0, flat, src)


def write_paged_kv(
    k_pages_l, v_pages_l, k, v, block_tables, positions, write_mask=None,
    k_scale_l=None, v_scale_l=None,
):
    """Scatter a chunk's K/V (``[b, s, n_kv, hd]``) **in place** into the
    block-paged pools ``[num_blocks, block_size, n_kv, hd]`` at absolute
    token ``positions [b, s]`` through each row's ``block_tables`` row
    ``[b, max_blocks]``. In-place update takes the place of the JAX
    engine's buffer donation; the pools are returned for symmetry.

    Dropped lanes never touch a live block: a lane whose position lies past
    the table (``positions // bs >= max_blocks``, JAX's ``mode="fill"``) or
    whose ``write_mask`` is False (the padded tail of a prefill chunk, a
    free or prefilling slot during decode) is routed to the null block 0 —
    never clamped into the slot's own last block. Block 0 is never attended,
    so what lands there is harmless. The routing is a ``torch.where`` on
    fixed shapes: no data-dependent shape, no host sync.

    **Quantize-on-scatter** (``k_scale_l``/``v_scale_l`` given, shape
    ``[num_blocks, bs, n_kv]`` f32): K/V are amax-quantized per row into the
    pool's storage dtype and each row's scale is scattered through the
    *same* flat indices, so payload and scale obey the same drop rules."""
    from .fp8 import quantize_kv_rows

    nb, bs = k_pages_l.shape[0], k_pages_l.shape[1]
    b, s = k.shape[0], k.shape[1]
    bt = block_tables.long()
    positions = positions.long()
    mb = bt.shape[1]
    col = positions // bs
    keep = col < mb
    if write_mask is not None:
        keep = keep & write_mask.bool()
    blk = torch.gather(bt, 1, col.clamp(max=mb - 1))
    flat = torch.where(keep, blk * bs + positions % bs, NULL_BLOCK * bs)
    flat = flat.reshape(b * s)
    if k_scale_l is not None:
        store = k_pages_l.dtype
        k, k_sc = quantize_kv_rows(k, store)   # [b,s,n_kv,hd] + [b,s,n_kv]
        v, v_sc = quantize_kv_rows(v, store)
        _scatter_rows(k_scale_l, flat, k_sc)
        _scatter_rows(v_scale_l, flat, v_sc)
    else:
        k = k.to(k_pages_l.dtype)  # e.g. bf16 storage under f32 compute
        v = v.to(v_pages_l.dtype)
    _scatter_rows(k_pages_l, flat, k)
    _scatter_rows(v_pages_l, flat, v)
    if k_scale_l is not None:
        return k_pages_l, v_pages_l, k_scale_l, v_scale_l
    return k_pages_l, v_pages_l


def gather_paged_kv(k_pages_l, v_pages_l, block_tables):
    """Materialise each slot's logical cache from the pool:
    ``[num_blocks, bs, n_kv, hd]`` through ``[b, max_blocks]`` →
    ``[b, max_blocks*bs, n_kv, hd]`` (logical position ``p`` lands at
    gathered index ``p``)."""
    bt = block_tables.long()
    k = k_pages_l[bt]  # [b, max_blocks, bs, n_kv, hd]
    v = v_pages_l[bt]
    b, mb, bs = k.shape[0], k.shape[1], k.shape[2]
    return (
        k.reshape(b, mb * bs, *k.shape[3:]),
        v.reshape(b, mb * bs, *v.shape[3:]),
    )


def rope_paged_attention_block(
    layer, x, k_pages_l, v_pages_l, cos, sin, block_tables, idx,
    n_heads: int, n_kv_heads: int, head_dim: int, eps: float,
    write_mask=None, k_scale_l=None, v_scale_l=None, attn_impl=None,
):
    """RMSNorm → q/k/v → RoPE at each row's absolute position → block-table
    scatter (quantize-on-scatter when scale pools are given; the pools are
    updated **in place**) → paged attention walking the block table
    (:func:`ops.paged_attention.paged_attention`) → output projection
    residual. ``s == 1`` is the engine's decode step, ``s > 1`` a prefill
    chunk whose padded tail ``write_mask`` drops. ``layer`` carries the
    ``wq``/``wk``/``wv``/``wo`` projections and the ``attn_norm`` weight.
    Returns the new residual stream."""
    from .paged_attention import paged_attention

    b, s, _ = x.shape
    idx = idx.reshape(b)
    positions = idx[:, None].long() + torch.arange(s, device=x.device)[None, :]
    y = rms_norm(x, layer.attn_norm, eps)
    q = apply_rope(layer.wq(y).reshape(b, s, n_heads, head_dim), cos, sin, positions)
    k = apply_rope(layer.wk(y).reshape(b, s, n_kv_heads, head_dim), cos, sin, positions)
    v = layer.wv(y).reshape(b, s, n_kv_heads, head_dim)
    write_paged_kv(
        k_pages_l, v_pages_l, k, v, block_tables, positions,
        write_mask=write_mask, k_scale_l=k_scale_l, v_scale_l=v_scale_l,
    )
    attn = paged_attention(
        q, k_pages_l, v_pages_l, block_tables, idx,
        k_scale_l=k_scale_l, v_scale_l=v_scale_l, impl=attn_impl,
    )
    return x + layer.wo(attn.reshape(b, s, n_heads * head_dim))
