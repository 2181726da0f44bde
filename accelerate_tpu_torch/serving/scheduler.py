"""Iteration-level request scheduler for the continuous-batching engine
(port of ``accelerate_tpu/serving/scheduler.py``, pure Python).

Orca-style (OSDI '22) slot scheduling: the paged decode step has a fixed
``num_slots`` batch dimension; this scheduler decides, *between* device
steps, which request occupies which slot.

* **evict** — finished requests release their slot and KV blocks first, so
  the capacity freed this iteration is admittable this iteration;
* **admit** — queued requests enter free slots in (priority class,
  arrival) order, bounded by the block freelist. Head-of-line blocking is
  intentional (no starvation of long prompts);
* a request whose prompt is still being chunk-prefilled occupies its slot
  in ``PREFILL`` state; the engine advances one chunk per iteration so a
  long prompt never stalls in-flight decodes.

Not ported yet (later slices): the radix prefix cache, swap preemption,
deadlines and the usage ledger hooks of the JAX scheduler.
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
    inter-token interval after the first."""

    prompt: list[int]
    max_new_tokens: int
    priority: str = "interactive"  # see PRIORITY_CLASSES
    request_id: int = field(default_factory=lambda: next(_request_ids))
    arrival_time: float = field(default_factory=time.perf_counter)
    state: RequestState = RequestState.QUEUED
    output_tokens: list[int] = field(default_factory=list)
    finish_reason: str | None = None  # "eos" | "length" | "out_of_blocks"
    slot: int | None = None
    blocks: list[int] = field(default_factory=list)
    prefill_pos: int = 0  # prompt tokens whose K/V are already cached
    first_token_time: float | None = None
    finish_time: float | None = None

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
    """Owns the waiting queues (one per priority class), the slot table and
    the block allocator."""

    def __init__(self, num_slots: int, allocator: BlockAllocator, block_size: int,
                 max_seq_len: int):
        self.num_slots = int(num_slots)
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.waiting: dict[str, deque[Request]] = {p: deque() for p in PRIORITY_CLASSES}
        self.slots: list[Request | None] = [None] * self.num_slots

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
        """Release slots + blocks of finished requests (engine marks them)."""
        evicted = []
        for i, req in enumerate(self.slots):
            if req is not None and req.state is RequestState.FINISHED:
                self.allocator.decref(req.blocks)
                req.blocks = []
                req.slot = None
                self.slots[i] = None
                evicted.append(req)
        return evicted

    def admit(self) -> list[Request]:
        """Priority-then-FCFS admission into free slots, bounded by the
        block freelist. A request is admitted with the blocks covering its
        prompt plus the first decode write; decode grows the rest."""
        admitted = []
        free_slots = [i for i, r in enumerate(self.slots) if r is None]
        while free_slots:
            req = self.peek_head()
            if req is None:
                break
            need = max(blocks_needed(req.prompt_len + 1, self.block_size), 1)
            if not self.allocator.can_allocate(need):
                break
            req.blocks = self.allocator.allocate(need)
            req.prefill_pos = 0
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
        harmless. False = the pool is exhausted; the engine force-finishes
        the request with ``finish_reason="out_of_blocks"``."""
        need = blocks_needed(
            min(
                req.context_len + tokens_ahead,
                req.prompt_len + req.max_new_tokens,
                self.max_seq_len,
            ),
            self.block_size,
        )
        while len(req.blocks) < need:
            if not self.allocator.can_allocate(1):
                return False
            req.blocks.extend(self.allocator.allocate(1))
        return True
