"""Radix prefix-sharing cache + host swap pool for the serving engine (port
of ``accelerate_tpu/serving/radix.py``: shared semantics).

Production chat traffic shares long prompt prefixes (system prompts,
few-shot preambles, multi-turn history). The block-paged KV pool is the
natural substrate for SGLang/RadixAttention-style sharing: KV for a token
prefix depends only on the prefix's tokens, so two requests whose prompts
agree on the first ``k`` blocks can *read the same pool blocks* — admission
maps the shared blocks into the new request's block table at refcount+1 and
chunk-prefills only the tail.

:class:`RadixCache` owns the host-side bookkeeping (no torch — the engine
performs the device ops it requests):

* a **radix trie** over full token blocks: each node is one ``block_size``
  token span keyed by its exact token tuple (dict hashing of the tuple is
  the "per-block token hash"; matching is exact, never probabilistic);
* **refcounts** (:class:`~.blocks.BlockAllocator`): every cached block
  carries the cache's own reference, plus one per live request mapping it —
  a block leaves the pool only when the last holder lets go;
* **copy-on-write on partial-block divergence**: when a prompt agrees with
  a cached child for only the first ``p`` tokens of a block, the matched
  rows are reused by *copying* the cached block into a freshly allocated
  private block (the engine runs the device copy) — the cached block is
  pinned (incref) across the copy so concurrent eviction can never free it
  first, and the diverging request then overwrites its private copy's tail;
* **LRU eviction**: cached blocks whose only holder is the cache
  (refcount 1) are reclaimable; eviction walks trie *leaves* in
  least-recently-matched order back to the freelist, so hot shared prefixes
  survive pool pressure and admission/decode growth only fails when the
  pool is genuinely full of live data.

A request's matched prefix is capped at ``prompt_len - 1`` tokens: the
engine derives the first output token from the final prompt position's
logits, so at least one prompt token is always prefilled even on a 100% hit.

:class:`SwapPool` is the preemption tier: a capacity-bounded host mirror
of the device pool's block layout, in ONE (pinned, on a CUDA engine) host
tensor. Under pool exhaustion the scheduler's victim has its unshared
blocks copied here, its slot is released, and it re-queues at the front of
its priority class; re-admission copies the rows back into freshly
allocated blocks. ``finish_reason="out_of_blocks"`` becomes the last resort
for when even swap capacity is gone.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from .blocks import BlockAllocator


class RadixNode:
    """One cached full block: ``tokens`` (exact ``block_size`` ids),
    ``block`` (pool id), children keyed by their token tuples."""

    __slots__ = ("tokens", "block", "parent", "children", "last_used")

    def __init__(self, tokens: tuple, block: int, parent: "RadixNode | None"):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: dict[tuple, RadixNode] = {}
        self.last_used = 0


class RadixCache:
    """Refcounted prefix trie over the block pool (see module docstring).

    The cache holds exactly one reference on every cached block; requests
    add theirs via :meth:`acquire` and drop them through the scheduler's
    normal ``decref`` release. ``match`` is a pure query; ``acquire`` is
    the committing form (increfs + LRU touch) and must be paired with
    :meth:`release_acquired` if admission backs out."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.root = RadixNode((), -1, None)
        self._cached_blocks: set[int] = set()
        self._tick = 0
        # cache-churn counters, surfaced via engine.stats() — hit tokens
        # live on the scheduler (the admission-time source of truth), not
        # here, so there is exactly one counter to trust
        self.evicted_blocks = 0
        self.inserted_blocks = 0

    # -- queries -------------------------------------------------------------

    def _nodes(self) -> list[RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    @property
    def cached_block_count(self) -> int:
        return len(self._nodes())

    def exclusive_block_count(self) -> int:
        """Blocks held *only* by the cache (refcount 1) — the evictable
        set, and the idle-engine complement of the freelist."""
        return sum(1 for n in self._nodes() if self.allocator.refcount(n.block) == 1)

    def is_cached(self, block: int) -> bool:
        """True while ``block`` backs a trie node. The engine's swap path
        uses this to tell "shared with the cache only" (swappable: drop
        the request's ref, the cache's evictable copy stays) from "shared
        with another live request" (stays resident)."""
        return block in self._cached_blocks

    def match(self, tokens) -> tuple[list[int], int, int | None]:
        """Longest cached prefix of ``tokens``, capped at ``len - 1``:
        returns ``(full_blocks, matched_tokens, cow_src_block)`` without
        side effects. ``cow_src_block`` is the cached block a partial-block
        match would copy from (None when the match is block-aligned)."""
        bs = self.block_size
        limit = len(tokens) - 1  # final prompt token is always prefilled
        node, blocks, matched = self.root, [], 0
        while matched + bs <= limit:
            child = node.children.get(tuple(int(t) for t in tokens[matched : matched + bs]))
            if child is None:
                break
            node = child
            blocks.append(child.block)
            matched += bs
        # partial-block divergence: reuse the longest common prefix of one
        # child via copy-on-write (p < block_size by construction)
        cow_src = None
        best_p = 0
        room = min(bs, limit - matched)
        if room > 0:
            tail = [int(t) for t in tokens[matched : matched + bs]]
            for key, child in node.children.items():
                p = 0
                for a, b in zip(key, tail):
                    if a != b or p >= room:
                        break
                    p += 1
                if p > best_p:
                    best_p, cow_src = p, child.block
        if best_p > 0:
            matched += best_p
        else:
            cow_src = None
        return blocks, matched, cow_src

    # -- admission-side commits ----------------------------------------------

    def acquire(self, tokens) -> tuple[list[int], int, int | None]:
        """Committing :meth:`match`: increfs the matched full blocks for
        the request AND pins the CoW source (one extra ref the engine drops
        after the device copy), and touches the matched path's LRU clock.
        Back out with :meth:`release_acquired` if admission fails."""
        blocks, matched, cow_src = self.match(tokens)
        self._tick += 1
        bs = self.block_size
        node = self.root
        for i in range(len(blocks)):
            node = node.children[tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])]
            node.last_used = self._tick
        self.allocator.incref(blocks)
        if cow_src is not None:
            self.allocator.incref([cow_src])
            # the CoW source is a HIT too: touch its clock, or a prefix
            # that always ends mid-block (hit on every admission) looks
            # least-recently-used to evict() and dies first
            for child in node.children.values():
                if child.block == cow_src:
                    child.last_used = self._tick
                    break
        return blocks, matched, cow_src

    def release_acquired(self, blocks: list[int], cow_src: int | None = None) -> None:
        self.allocator.decref(list(blocks))
        if cow_src is not None:
            self.allocator.decref([cow_src])

    def insert(self, tokens, blocks: list[int]) -> int:
        """Adopt a prefilled request's full prompt blocks into the trie.
        ``blocks`` is the request's block list; every block fully covered
        by ``tokens`` is cacheable. Existing nodes are kept (the request's
        duplicate block stays private); new nodes take the request's block
        at refcount+1 (the cache's own reference). Returns the number of
        newly cached blocks."""
        bs = self.block_size
        self._tick += 1
        node, added = self.root, 0
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs : (i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(key, blocks[i], node)
                node.children[key] = child
                self.allocator.incref([blocks[i]])
                self._cached_blocks.add(blocks[i])
                added += 1
            child.last_used = self._tick
            node = child
        self.inserted_blocks += added
        return added

    # -- eviction ------------------------------------------------------------

    def evict(self, want_blocks: int) -> int:
        """Free up to ``want_blocks`` cached blocks back to the freelist,
        least-recently-matched leaves first (a parent is only reclaimable
        once its children are gone — the trie stays a valid prefix tree).
        Blocks any live request still maps (refcount > 1) are skipped.
        Returns how many blocks were actually freed.

        One trie walk seeds a min-heap of evictable leaves; a parent whose
        last child falls joins the heap then — O(n + k log n) per call,
        not a rescan per freed block (refcounts cannot change mid-call:
        eviction runs between engine iterations, on one thread)."""
        if want_blocks <= 0:
            return 0
        heap = [
            (n.last_used, id(n), n)
            for n in self._nodes()
            if not n.children and self.allocator.refcount(n.block) == 1
        ]
        heapq.heapify(heap)
        freed = 0
        while freed < want_blocks and heap:
            _, _, victim = heapq.heappop(heap)
            victim.parent.children.pop(victim.tokens, None)
            self._cached_blocks.discard(victim.block)
            self.allocator.decref([victim.block])
            freed += 1
            parent = victim.parent
            if (
                parent is not self.root
                and not parent.children
                and self.allocator.refcount(parent.block) == 1
            ):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        self.evicted_blocks += freed
        return freed


class SwapPool:
    """Capacity-bounded host mirror of the device pool's block layout: one
    K row and one V row of shape ``[layers, block_size, n_kv, hd]`` per
    slot in the pool's dtype (plus f32 ``[layers, block_size, n_kv]`` scale
    rows when quantized), JAX's ``SwapPool`` contract and messages. The slots
    are rows of ONE ``uint8`` host tensor ``[capacity_blocks,
    bytes_per_block]`` (pinned when ``pin_memory``), laid out K | V | K
    scales | V scales, so the engine moves a victim's blocks in one batched
    copy each way (:meth:`store_rows` / :meth:`load_rows`); :meth:`store` and
    :meth:`load` take and give one block's typed rows. ``capacity_gb`` bounds
    the mirror so a preemption storm degrades to truncation instead of
    exhausting the host."""

    def __init__(
        self,
        num_layers: int,
        block_size: int,
        num_kv_heads: int,
        head_dim: int,
        dtype,
        capacity_gb: float,
        quantized: bool = False,
        pin_memory: bool = False,
    ):
        self.block_shape = (int(num_layers), int(block_size), int(num_kv_heads), int(head_dim))
        self.dtype = dtype
        self.quantized = bool(quantized)
        itemsize = torch.empty((), dtype=dtype).element_size()
        payload = itemsize * int(np.prod(self.block_shape))
        self._fields = [("k", dtype, self.block_shape, payload),
                        ("v", dtype, self.block_shape, payload)]
        if self.quantized:
            # f32 amax scale rows park beside the payload: a quantized block
            # is meaningless without them, and they must survive the round
            # trip byte-exact
            self.scale_shape = self.block_shape[:-1]
            scale = 4 * int(np.prod(self.scale_shape))
            self._fields += [("k_scale", torch.float32, self.scale_shape, scale),
                             ("v_scale", torch.float32, self.scale_shape, scale)]
        per_block = sum(f[3] for f in self._fields)
        self.bytes_per_block = per_block
        self.capacity_blocks = max(0, int(capacity_gb * (1 << 30)) // per_block)
        self._rows = torch.zeros((self.capacity_blocks, per_block), dtype=torch.uint8,
                                 pin_memory=pin_memory)
        self._free = list(range(self.capacity_blocks - 1, -1, -1))
        self._held: set[int] = set()

    @property
    def used_blocks(self) -> int:
        return len(self._held)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_hold(self, n_blocks: int) -> bool:
        return n_blocks <= len(self._free)

    def split_rows(self, rows: torch.Tensor, raw: bool = False) -> dict:
        """``rows`` ``[n, bytes_per_block]`` uint8 (any device) → typed
        ``{"k": [n, layers, bs, n_kv, hd], "v": ..., and the scales when
        quantized}``; ``raw`` keeps them bytes, the last dim times the
        itemsize (what a byte view of the pools takes)."""
        out, lo = {}, 0
        for name, dtype, shape, nbytes in self._fields:
            part = rows[:, lo:lo + nbytes].contiguous()
            out[name] = (part.reshape(-1, *shape[:-1], nbytes // int(np.prod(shape[:-1])))
                         if raw else part.view(dtype).reshape(-1, *shape))
            lo += nbytes
        return out

    @staticmethod
    def pack_rows(parts: list) -> torch.Tensor:
        """Typed ``[n, ...]`` blocks in K, V (, K scales, V scales) order →
        ``[n, bytes_per_block]`` uint8 rows (on their device)."""
        n = parts[0].shape[0]
        return torch.cat([p.contiguous().view(torch.uint8).reshape(n, -1) for p in parts], dim=1)

    def store_rows(self, rows: torch.Tensor) -> list[int]:
        """Park ``rows`` ``[n, bytes_per_block]`` (host uint8) in n slots;
        returns their handles, in order."""
        n = rows.shape[0]
        if n > len(self._free):
            raise RuntimeError(
                f"swap pool exhausted ({self.capacity_blocks} blocks, "
                f"{self.bytes_per_block} B each): raise swap_gb"
            )
        handles = [self._free.pop() for _ in range(n)]
        if n:
            self._rows.index_copy_(0, torch.tensor(handles, dtype=torch.long), rows)
        self._held.update(handles)
        return handles

    def load_rows(self, handles: list[int]) -> torch.Tensor:
        """The parked rows of ``handles``, ``[n, bytes_per_block]`` (a host
        copy, pinned when the pool is)."""
        for h in handles:
            if h not in self._held:
                raise ValueError(f"swap handle {h} is not held")
        out = torch.empty((len(handles), self.bytes_per_block), dtype=torch.uint8,
                          pin_memory=self._rows.is_pinned())
        torch.index_select(self._rows, 0, torch.tensor(handles, dtype=torch.long), out=out)
        return out

    def store(self, k_rows, v_rows, k_scale_rows=None, v_scale_rows=None) -> int:
        """Park one block's K/V rows (+ scale rows when quantized);
        returns the swap handle."""
        if not self._free:
            raise RuntimeError(
                f"swap pool exhausted ({self.capacity_blocks} blocks, "
                f"{self.bytes_per_block} B each): raise swap_gb"
            )
        if self.quantized and (k_scale_rows is None or v_scale_rows is None):
            raise ValueError("quantized swap pool needs scale rows on store()")
        parts = [torch.as_tensor(k_rows).to(self.dtype), torch.as_tensor(v_rows).to(self.dtype)]
        if self.quantized:
            parts += [torch.as_tensor(k_scale_rows, dtype=torch.float32),
                      torch.as_tensor(v_scale_rows, dtype=torch.float32)]
        return self.store_rows(self.pack_rows([p.reshape(1, *p.shape) for p in parts]))[0]

    def load(self, handle: int):
        """``(k, v, k_scale, v_scale)`` — the scale pair is ``None`` for
        non-quantized pools."""
        if handle not in self._held:
            raise ValueError(f"swap handle {handle} is not held")
        parts = self.split_rows(self._rows[handle:handle + 1])
        if self.quantized:
            return parts["k"][0], parts["v"][0], parts["k_scale"][0], parts["v_scale"][0]
        return parts["k"][0], parts["v"][0], None, None

    def release(self, handle: int) -> None:
        if handle not in self._held:
            raise ValueError(f"double release of swap handle {handle}")
        self._held.remove(handle)
        self._free.append(handle)
