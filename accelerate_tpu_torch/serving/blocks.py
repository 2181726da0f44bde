"""KV block pool accounting for the serving engine (a copy of
``accelerate_tpu/serving/blocks.py``: pure Python, shared semantics).

The device-side cache is one pool of fixed-size blocks per layer
(``[num_blocks, block_size, n_kv, hd]``); this module owns the *host-side*
bookkeeping: which pool blocks are free, which belong to which request.
The engine translates the per-request block lists into the dense
``[num_slots, max_blocks]`` block-table array the paged step reads.

Block 0 is the reserved **null block**: free slots and the unfilled tail of
every block table point at it. It absorbs the padded decode lanes' writes
and is never inside any live slot's valid prefix, so it never needs to be
allocated, freed, or zeroed.
"""

from __future__ import annotations

from collections import deque

from ..ops.layers import NULL_BLOCK


class BlockAllocator:
    """Freelist over pool blocks ``1 .. num_blocks-1`` (0 is the null
    block). Strict accounting: allocating more than is free raises, freeing
    a block that is not currently allocated (double-free, the null block, an
    out-of-range id) raises — the engine's invariant tests lean on this.

    Blocks are **refcounted** for prefix sharing (:mod:`.radix`): ``allocate``
    hands a block out at refcount 1, ``incref`` adds a holder (a request
    mapping a cached prefix block, or the radix cache itself), ``decref``
    drops one and returns the block to the freelist only when the last
    holder lets go. ``free`` keeps its strictness and additionally
    refuses a *shared* block (refcount > 1) — releasing a block other
    requests still read must go through ``decref``, never a hard free."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need at least 2 blocks (1 usable + the null block), got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self._free: deque[int] = deque(range(1, self.num_blocks))
        self._allocated: set[int] = set()
        self._refcounts: dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        return len(self._allocated)

    def can_allocate(self, n: int) -> bool:
        return n <= len(self._free)

    def allocate(self, n: int) -> list[int]:
        """Pop ``n`` blocks from the freelist; all-or-nothing."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if not self.can_allocate(n):
            raise RuntimeError(
                f"out of KV blocks: requested {n}, free {len(self._free)} "
                f"(pool {self.num_blocks - 1} usable)"
            )
        blocks = [self._free.popleft() for _ in range(n)]
        self._allocated.update(blocks)
        for b in blocks:
            self._refcounts[b] = 1
        return blocks

    def refcount(self, block: int) -> int:
        """Current holder count (0 for free / never-allocated blocks)."""
        return self._refcounts.get(block, 0)

    def _check_allocated(self, b: int, verb: str) -> None:
        if b == NULL_BLOCK:
            raise ValueError(f"cannot {verb} the null block")
        if b not in self._allocated:
            raise ValueError(f"double free (or never allocated): block {b}")

    def incref(self, blocks: list[int]) -> None:
        """Add one holder to each (already-allocated) block — a request
        mapping a cached prefix, or the radix cache adopting a block."""
        for b in blocks:
            self._check_allocated(b, "share")
            self._refcounts[b] += 1

    def decref(self, blocks: list[int]) -> list[int]:
        """Drop one holder from each block; blocks whose last holder left
        return to the freelist. Returns the blocks actually freed. Dropping
        a holder from a free block raises (the double-free invariant holds
        for shared blocks too)."""
        freed = []
        for b in blocks:
            self._check_allocated(b, "release")
            self._refcounts[b] -= 1
            if self._refcounts[b] == 0:
                del self._refcounts[b]
                self._allocated.remove(b)
                self._free.append(b)
                freed.append(b)
        return freed

    def free(self, blocks: list[int]) -> None:
        """Return blocks to the freelist; rejects double-frees, the null
        block, and **shared** blocks (refcount > 1 — another holder still
        reads them; use :meth:`decref`) so leaks/corruption surface as
        exceptions, not wrong tokens."""
        for b in blocks:
            self._check_allocated(b, "free")
            if self._refcounts[b] > 1:
                raise ValueError(
                    f"cannot free shared block {b} "
                    f"(refcount {self._refcounts[b]}): use decref"
                )
            del self._refcounts[b]
            self._allocated.remove(b)
            self._free.append(b)


def blocks_needed(num_tokens: int, block_size: int) -> int:
    """Blocks covering ``num_tokens`` cache positions (ceil division)."""
    return max(0, -(-int(num_tokens) // int(block_size)))
