"""Core transformer ops (port of ``accelerate_tpu/ops/layers.py``): the
norm, RoPE, the reference attention and the losses the training step runs,
the dense KV cache ops ``generate()`` runs, and the block-paged KV cache
ops the serving path runs.

Layouts follow the JAX package at every public function (``[b, s, heads,
head_dim]`` activations, ``[num_blocks, block_size, n_kv, head_dim]``
pools) so the tests hold the two packages against each other like for
like.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp8 import checkpoint_contexts, dense, quantize_kv_rows

#: pool index of the reserved null block: free slots and the unfilled tail
#: of every block table point at it, dropped writes land in it, and it is
#: never attended
NULL_BLOCK = 0


def table_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    """The rows of an ``n``-row table that JAX's gather (``table[ids]``)
    reads: a negative index counts from the end once, then every index is
    clamped into ``[0, n)``, where ``nn.Embedding`` or an index would raise
    (a device-side assert on the card). Token ids past the vocabulary and
    positions past a learned position table both take it. No host sync: the
    decode steps that call it are replayed from CUDA graphs."""
    ids = ids.long()
    return torch.where(ids < 0, ids + n, ids).clamp_(0, n - 1)


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


def cross_entropy_sum(logits, labels, ignore_index: int = -100):
    """Token-level CE with an ignore mask, f32 log-softmax: the summed NLL
    over valid tokens and their count."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return ((logz - gold) * valid).sum(), valid.sum()


def cross_entropy_loss(logits, labels, ignore_index: int = -100):
    """Token-level CE with an ignore mask, f32 log-softmax; the masked mean
    over valid tokens, the count clamped at 1."""
    nll, count = cross_entropy_sum(logits, labels, ignore_index)
    return nll / torch.clamp(count, min=1)


def loss_group(whole_batch: bool = False):
    """The process group over which a model's loss is a mean: the ranks
    that hold other tokens of the same global batch. That is ``dp × fsdp ×
    cp`` (the attention context's ``data`` axis), or ``dp × fsdp`` (its
    ``batch`` axis) for a ``whole_batch`` loss, one that every ``cp`` rank
    computes over the same tokens (ResNet, T5, and the pooled classifiers).
    None without a process group, or where one rank spans them."""
    from .attention import get_attention_context

    return get_attention_context().axis("batch" if whole_batch else "data")[0]


def global_token_mean(nll, count, group):
    """A model's token loss, JAX's way: the summed NLL over the valid count
    summed over ``group`` (:func:`loss_group`), every rank returning the
    global batch's mean. The NLL's sum is differentiable, its gradient the
    sum of the ranks' (:func:`~..parallel.context.all_reduce_sum`), so each
    rank's gradient is its part of the global sum times the group's size,
    and the accelerator's average over the ranks gives JAX's gradient (the
    convention of the llama's ``cp`` loss, widened to the data ranks).
    Without a group, ``nll / count``."""
    count = count.to(torch.float32)
    if group is None:
        return nll / torch.clamp(count, min=1)
    import torch.distributed as dist

    from ..parallel.context import all_reduce_sum

    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    return all_reduce_sum(nll, group) / torch.clamp(total, min=1)


def token_loss(logits, labels, whole_batch: bool = False, ignore_index: int = -100):
    """:func:`cross_entropy_loss` over the global batch
    (:func:`global_token_mean` over :func:`loss_group`)."""
    return global_token_mean(*cross_entropy_sum(logits, labels, ignore_index),
                             loss_group(whole_batch))


def shift_labels(labels, ignore_index: int = -100):
    """Next-token targets without slicing: position t's target is token
    t+1 and the final position is ``ignore_index``, so the sequence length
    (and :func:`fused_cross_entropy`'s chunking) is unchanged."""
    pad = torch.full((labels.shape[0], 1), ignore_index, dtype=labels.dtype,
                     device=labels.device)
    return torch.cat([labels[:, 1:], pad], dim=1)


def _chunk_nll(x_i, head, l_i, ignore_index: int, bias=None, vocab_shard=None):
    """One chunk's summed NLL and valid count; the head product
    (:func:`~.fp8.dense`, plus ``bias`` when the head has one) runs in the
    compute dtype and is cast to f32 before the log-softmax.

    ``vocab_shard`` ``(start, group)``: ``head`` holds the columns from
    ``start`` on of a vocabulary split over ``group``'s ranks (Megatron's
    vocab-parallel cross-entropy): the log-partition is the group's max
    and summed exponentials, the gold logit the sum of the one rank's that
    holds it, and ``x``'s gradient is summed over the group."""
    if vocab_shard is not None:
        from ..parallel.sharding import tp_enter, tp_leave

        start, group = vocab_shard
        x_i = tp_enter(x_i, group)
    logits = dense(x_i, head.t())
    if bias is not None:
        logits = logits + bias
    logits = logits.float()  # [b, s/C, V] (this rank's V / tp columns with a vocab_shard)
    valid = l_i != ignore_index
    safe = torch.where(valid, l_i, 0).long()
    if vocab_shard is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        return ((logz - gold) * valid).sum(), valid.sum()
    import torch.distributed as dist

    peak = logits.detach().amax(dim=-1, keepdim=True)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    logz = peak[..., 0] + torch.log(tp_leave(torch.exp(logits - peak).sum(dim=-1), group))
    cols = logits.shape[-1]
    off = safe - start
    inside = (off >= 0) & (off < cols)
    gold = torch.gather(logits, -1, off.clamp(0, cols - 1)[..., None])[..., 0]
    gold = tp_leave(torch.where(inside, gold, 0.0), group)
    return ((logz - gold) * valid).sum(), valid.sum()


def fused_nll(x, head, labels, ignore_index: int = -100, chunk_tokens: int = 1024,
              bias=None, vocab_shard=None):
    """The summed NLL and valid count of :func:`fused_cross_entropy`."""
    b, s, _ = x.shape
    rows = max(1, chunk_tokens // b)
    C = 1
    for c in range(1, s + 1):
        if s % c == 0 and s // c >= rows:
            C = c
    if C == 1:
        return _chunk_nll(x, head, labels, ignore_index, bias, vocab_shard)
    from torch.utils.checkpoint import checkpoint

    n = s // C
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(C):
        d_nll, d_cnt = checkpoint(_chunk_nll, x[:, i * n:(i + 1) * n], head,
                                  labels[:, i * n:(i + 1) * n], ignore_index, bias,
                                  vocab_shard, use_reentrant=False,
                                  context_fn=checkpoint_contexts)
        nll = nll + d_nll
        count = count + d_cnt
    return nll, count


def fused_cross_entropy(x, head, labels, ignore_index: int = -100, chunk_tokens: int = 1024,
                        bias=None, vocab_shard=None):
    """Token CE from pre-head hidden states ``x [b, s, h]`` and ``head [h,
    vocab]`` without holding the full ``[b, s, vocab]`` logits: the sequence
    splits into ``C`` chunks, the largest divisor of ``s`` with ``s // C >=
    chunk_tokens // b`` (``C == 1`` is the plain loss), and each chunk runs
    under ``torch.utils.checkpoint`` so the backward recomputes its logits
    (the JAX ``jax.checkpoint`` inside ``lax.scan``), under the fp8 state of
    the forward. Equal to ``cross_entropy_loss(x @ head, labels)``; the
    head product is :func:`~.fp8.dense`'s, so it runs in fp8 inside
    ``fp8_autocast``. ``bias [vocab]`` is the head's bias, where it has one
    (GPT-J). ``vocab_shard`` ``(start, group)``: ``head`` is this rank's
    columns of a vocabulary split over ``group`` (:func:`_chunk_nll`), and
    every rank returns the whole vocabulary's loss."""
    nll, count = fused_nll(x, head, labels, ignore_index, chunk_tokens, bias, vocab_shard)
    return nll / torch.clamp(count, min=1)


def fused_token_loss(x, head, labels, bias=None, vocab_shard=None):
    """:func:`fused_cross_entropy` over the global batch: a decoder
    family's next-token loss (:func:`global_token_mean` over
    :func:`loss_group`)."""
    return global_token_mean(*fused_nll(x, head, labels, bias=bias, vocab_shard=vocab_shard),
                             loss_group())


def write_kv_cache(k_cache_l, v_cache_l, k, v, idx, spare_slot: bool = False):
    """Append a chunk's K/V (``[b, s, n_kv, hd]``, ``s >= 1``) **in place**
    at each row's own cache positions ``idx[b] .. idx[b]+s-1`` of the dense
    caches ``[b, max_cache, n_kv, hd]`` (port of JAX ``write_kv_cache``;
    ``s == 1`` is the per-token decode, ``s > 1`` the speculative verify
    chunk). The caches are returned for symmetry.

    A position past the cache end is **dropped**, as JAX's ``mode="drop"``
    scatter drops it: a verify chunk near an exact-fit budget overshoots
    the cache, and those tokens are never emitted. PyTorch's scatters have
    no drop mode (an out-of-range index raises on the CPU and faults on the
    card), so a dropped lane is routed to a slot no query reads:

    * ``spare_slot=True``: the cache's last slot holds no position (the
      caches :func:`~accelerate_tpu_torch.generation.generate` keeps carry
      it), so positions run to ``max_cache - 2`` and a dropped lane writes
      there, no read-back needed; :func:`cached_attention` never lets a
      kept query reach it, since a kept query's position is below it;
    * else (JAX's exact layout): slot ``min(idx[b], max_cache) - 1``, which
      is written back with the value it already holds: no lane of this
      chunk writes there (a row's kept lanes start at ``idx[b]``), and every
      lane routed to it writes the same bytes. Overshoot implies ``idx[b] >=
      1`` because ``s <= max_cache``.

    Fixed shapes, no host sync: a CUDA graph captures it."""
    b, s = k.shape[0], k.shape[1]
    max_cache = k_cache_l.shape[1]
    live = max_cache - 1 if spare_slot else max_cache
    if s > live:
        raise ValueError(f"a chunk of {s} tokens does not fit a cache of {live}")
    idx = idx.reshape(b).long()
    pos = idx[:, None] + torch.arange(s, device=k.device)[None, :]  # [b, s]
    keep = pos < live
    if spare_slot:
        target = torch.where(keep, pos, live)
    else:
        target = torch.where(keep, pos, (idx - 1).clamp(0, max_cache - 1)[:, None])
    rows = torch.arange(b, device=k.device)[:, None]
    flat = (rows * max_cache + target).reshape(b * s)
    keep = keep.reshape(b * s, 1, 1)
    for cache, new in ((k_cache_l, k), (v_cache_l, v)):
        dst = cache.view(b * max_cache, *cache.shape[2:])
        src = new.reshape(b * s, *cache.shape[2:]).to(cache.dtype)
        if not spare_slot:
            src = torch.where(keep, src, dst.index_select(0, flat))
        dst.index_copy_(0, flat, src)
    return k_cache_l, v_cache_l


def rope_attention_block(w: dict, x, cos, sin, positions, attend, n_heads: int,
                         n_kv_heads: int, head_dim: int, eps: float, enter=None, leave=None):
    """The attention sub-block of the llama-style families (llama,
    mixtral), in training, prefill and decode alike: RMSNorm → q/k/v
    projections → RoPE at ``positions [b, s]`` → ``attend(q, k, v)`` →
    output projection residual. ``w`` is the layer's weight dict
    (``wq``/``wk``/``wv``/``wo`` ``[out, in]`` and ``attn_norm``); the
    projections run through :func:`~.fp8.dense`, so in fp8 inside
    ``fp8_autocast``. Returns ``x + attn_out``. Under tensor parallelism
    ``w`` holds this rank's heads (``n_heads`` and ``n_kv_heads`` count
    them), ``enter`` takes the normed input into the column shards and
    ``leave`` sums the output projection's row shards
    (:func:`~..parallel.sharding.tp_enter`, ``tp_leave``)."""
    b, s, _ = x.shape
    y = rms_norm(x, w["attn_norm"], eps)
    if enter is not None:
        y = enter(y)
    q = apply_rope(dense(y, w["wq"]).reshape(b, s, n_heads, head_dim), cos, sin, positions)
    k = apply_rope(dense(y, w["wk"]).reshape(b, s, n_kv_heads, head_dim), cos, sin, positions)
    v = dense(y, w["wv"]).reshape(b, s, n_kv_heads, head_dim)
    out = dense(attend(q, k, v).reshape(b, s, n_heads * head_dim), w["wo"])
    return x + (out if leave is None else leave(out))


def cached_attend(k_cache_l, v_cache_l, idx, spare_slot: bool = False):
    """The ``attend(q, k, v)`` of a dense-cache decode step, for every
    decoder family: :func:`write_kv_cache` (in place; ``spare_slot`` is
    its) then :func:`cached_attention` against each row's prefix."""
    def attend(q, k, v):
        write_kv_cache(k_cache_l, v_cache_l, k, v, idx, spare_slot)
        return cached_attention(q, k_cache_l, v_cache_l, idx)

    return attend


def rope_cached_attention_block(w: dict, x, k_cache_l, v_cache_l, cos, sin, idx,
                                n_heads: int, n_kv_heads: int, head_dim: int, eps: float,
                                spare_slot: bool = False):
    """The decode-step attention sub-block (port of JAX
    ``rope_cached_attention_block``): :func:`rope_attention_block` at each
    row's cache position ``idx [b] + j``, attending through
    :func:`cached_attend`. Returns ``(x + attn_out, k_cache_l,
    v_cache_l)``."""
    b, s, _ = x.shape
    idx = idx.reshape(b)
    positions = idx[:, None].long() + torch.arange(s, device=x.device)[None, :]
    x = rope_attention_block(w, x, cos, sin, positions,
                             cached_attend(k_cache_l, v_cache_l, idx, spare_slot),
                             n_heads, n_kv_heads, head_dim, eps)
    return x, k_cache_l, v_cache_l


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
    # masked_fill with a Python scalar: no host tensor is made, so a CUDA
    # graph can capture it
    scores = scores.masked_fill(~valid[:, None, None, :, :], torch.finfo(torch.float32).min)
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
