"""Iteration-level request scheduler for the continuous-batching engine
(port of ``accelerate_tpu/serving/scheduler.py``, pure Python).

Orca-style (OSDI '22) slot scheduling: the paged decode step has a fixed
``num_slots`` batch dimension; this scheduler decides, *between* device
steps, which request occupies which slot.

* **evict** — finished requests release their slot and KV blocks first, so
  the capacity freed this iteration is admittable this iteration; shared
  blocks are *decref'd* (the radix cache or other requests keep them),
  never hard-freed;
* **admit** — queued requests enter free slots in (priority class,
  arrival) order. Admission first maps the request's longest cached prefix
  from the :class:`~.radix.RadixCache` at refcount+1, then allocates only
  the tail; when the freelist is short, refcount-1 cached blocks are LRU
  evicted before admission gives up. Head-of-line blocking is intentional
  (no starvation of long prompts);
* a request whose prompt is still being chunk-prefilled occupies its slot
  in ``PREFILL`` state; the engine advances one chunk per iteration so a
  long prompt never stalls in-flight decodes.

Not ported yet (later slices): swap preemption, deadlines and the usage
ledger hooks of the JAX scheduler.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

from .blocks import BlockAllocator, blocks_needed

#: admission-priority order, highest first
PRIORITY_CLASSES = ("interactive", "batch")


def priority_rank(priority: str) -> int:
    """Smaller = more important. Unknown classes raise at submit()."""
    return PRIORITY_CLASSES.index(priority)


class RequestState(Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


_request_ids = itertools.count()


@dataclass
class Request:
    """One in-flight generation. ``prompt`` is a list of token ids;
    ``output_tokens`` grows as the engine emits. Timing fields are
    ``time.perf_counter`` seconds: ``ttft_s`` spans arrival → first emitted
    token (queue wait + prefill included), ``tpot_s`` is the mean
    inter-token interval after the first.

    Prefix-sharing state: ``prefill_pos`` starts at the matched prefix
    length (cached tokens are never re-prefilled); ``cow`` is a
    ``(src_block, dst_block)`` device copy the engine owes before the first
    prefill chunk."""

    prompt: list[int]
    max_new_tokens: int
    priority: str = "interactive"  # see PRIORITY_CLASSES
    request_id: int = field(default_factory=lambda: next(_request_ids))
    arrival_time: float = field(default_factory=time.perf_counter)
    state: RequestState = RequestState.QUEUED
    output_tokens: list[int] = field(default_factory=list)
    finish_reason: str | None = None  # "eos" | "length" | "stop" | "out_of_blocks"
    slot: int | None = None
    #: resolved :class:`~.sampling.SamplingParams` (None on a
    #: per_slot_sampling=False engine). Lives on the request — not the
    #: slot — and the lanes are rebuilt from it on every dispatch
    sampling: object = None
    #: grammar table row this request holds a reference on (0 = the
    #: unconstrained sentinel row) and its authoritative DFA state — the
    #: host advances it per emitted token; on-device advances only feed
    #: mid-burst masking and are discarded with the burst tail
    grammar_row: int = 0
    dfa_state: int = 0
    #: per-token logprob dicts when the request asked for them
    logprobs: list | None = None
    blocks: list[int] = field(default_factory=list)
    prefill_pos: int = 0  # prompt tokens whose K/V are already cached
    first_token_time: float | None = None
    finish_time: float | None = None
    matched_tokens: int = 0  # prefix-cache hit length at admission
    cow: tuple[int, int] | None = None  # (src, dst) pending device copy

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def context_len(self) -> int:
        """Tokens whose K/V sit in the cache (prompt + fed output)."""
        return self.prefill_pos + max(len(self.output_tokens) - 1, 0)

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot_s(self) -> float | None:
        n = len(self.output_tokens)
        if self.finish_time is None or self.first_token_time is None or n < 2:
            return None
        return (self.finish_time - self.first_token_time) / (n - 1)


class SlotScheduler:
    """Owns the waiting queues (one per priority class), the slot table,
    the block allocator, and (optionally) the radix prefix cache."""

    def __init__(self, num_slots: int, allocator: BlockAllocator, block_size: int,
                 max_seq_len: int, radix=None):
        self.num_slots = int(num_slots)
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.radix = radix
        self.waiting: dict[str, deque[Request]] = {p: deque() for p in PRIORITY_CLASSES}
        self.slots: list[Request | None] = [None] * self.num_slots
        #: cumulative prompt tokens of admitted requests — the denominator
        #: of the prefix hit ratio
        self.prompt_tokens_admitted = 0
        self.prefix_hit_tokens = 0

    # -- queries -------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self.waiting.values())

    def active(self, state: RequestState | None = None) -> list[Request]:
        reqs = [r for r in self.slots if r is not None]
        if state is not None:
            reqs = [r for r in reqs if r.state is state]
        return reqs

    @property
    def occupancy(self) -> float:
        return sum(r is not None for r in self.slots) / self.num_slots

    def has_work(self) -> bool:
        return self.queue_depth > 0 or any(r is not None for r in self.slots)

    def peek_head(self) -> Request | None:
        """The next request admission would consider (highest nonempty
        class, FCFS within it)."""
        for p in PRIORITY_CLASSES:
            if self.waiting[p]:
                return self.waiting[p][0]
        return None

    # -- transitions ---------------------------------------------------------

    def submit(self, request: Request) -> Request:
        if request.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {request.priority!r}: "
                f"expected one of {PRIORITY_CLASSES}"
            )
        total = request.prompt_len + request.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request needs {total} cache positions "
                f"(prompt {request.prompt_len} + max_new {request.max_new_tokens}) "
                f"but the engine's max_seq_len is {self.max_seq_len}"
            )
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if request.prompt_len < 1:
            raise ValueError("empty prompt")
        usable = self.allocator.num_blocks - 1
        admit_need = max(blocks_needed(request.prompt_len + 1, self.block_size), 1)
        if admit_need > usable:
            # an unaffordable-forever head request would head-of-line block
            # admit() on every iteration and spin run_until_idle() for good
            raise ValueError(
                f"prompt needs {admit_need} KV blocks to admit but the pool "
                f"only has {usable}: raise num_blocks or shrink the prompt"
            )
        request.state = RequestState.QUEUED
        self.waiting[request.priority].append(request)
        return request

    def evict_finished(self) -> list[Request]:
        """Release slots + blocks of finished requests (engine marks them).
        Blocks are decref'd: a block the radix cache (or another request)
        still holds stays resident; the rest return to the freelist."""
        evicted = []
        for i, req in enumerate(self.slots):
            if req is not None and req.state is RequestState.FINISHED:
                self.allocator.decref(req.blocks)
                req.blocks = []
                req.slot = None
                self.slots[i] = None
                evicted.append(req)
        return evicted

    def _ensure_free(self, need: int) -> bool:
        """Freelist coverage for ``need`` blocks, LRU-evicting refcount-1
        cached blocks to make room."""
        short = need - self.allocator.free_count
        if short > 0 and self.radix is not None:
            self.radix.evict(short)
        return self.allocator.can_allocate(need)

    def admit(self) -> list[Request]:
        """Priority-then-FCFS admission into free slots, bounded by the
        block freelist (after radix eviction). A request maps its longest
        cached prefix at refcount+1 and allocates only the tail: the blocks
        covering its prompt plus the first decode write; decode grows the
        rest. Head-of-line blocking on blocks is intentional; a free slot
        with an unaffordable head request stays empty until eviction refills
        the freelist."""
        admitted = []
        free_slots = [i for i, r in enumerate(self.slots) if r is None]
        while free_slots:
            req = self.peek_head()
            if req is None:
                break
            total_need = max(blocks_needed(req.prompt_len + 1, self.block_size), 1)
            shared, matched, cow_src = [], 0, None
            if self.radix is not None:
                shared, matched, cow_src = self.radix.acquire(req.prompt)
            need = total_need - len(shared)
            if not self._ensure_free(need):
                if self.radix is not None:
                    self.radix.release_acquired(shared, cow_src)
                break
            fresh = self.allocator.allocate(need)
            req.blocks = shared + fresh
            req.matched_tokens = matched
            req.prefill_pos = matched
            if cow_src is not None:
                # the engine copies src -> the first private block before
                # this request's first prefill chunk
                req.cow = (cow_src, fresh[0])
            self.prompt_tokens_admitted += req.prompt_len
            self.prefix_hit_tokens += matched
            req.state = RequestState.PREFILL
            self.waiting[req.priority].popleft()
            req.slot = free_slots.pop(0)
            self.slots[req.slot] = req
            admitted.append(req)
        return admitted

    def grow_for_decode(self, req: Request, tokens_ahead: int = 1) -> bool:
        """Ensure blocks exist for the next ``tokens_ahead`` cache writes (a
        decode burst writes positions ``context_len ..
        context_len+tokens_ahead-1``). The span is capped at the request's
        own ``prompt + max_new`` budget and the per-slot maximum: burst
        lane-steps past the budget write into the null block, which is
        harmless. When the freelist is dry, refcount-1 cached blocks are
        LRU-evicted first. False = the pool is exhausted even after
        eviction; the engine force-finishes the request with
        ``finish_reason="out_of_blocks"``."""
        need = blocks_needed(
            min(
                req.context_len + tokens_ahead,
                req.prompt_len + req.max_new_tokens,
                self.max_seq_len,
            ),
            self.block_size,
        )
        while len(req.blocks) < need:
            if not self._ensure_free(1):
                return False
            req.blocks.extend(self.allocator.allocate(1))
        return True
