"""Iteration-level request scheduler for the continuous-batching engine
(port of ``accelerate_tpu/serving/scheduler.py``, pure Python).

Orca-style (OSDI '22) slot scheduling: the paged decode step has a fixed
``num_slots`` batch dimension; this scheduler decides, *between* device
steps, which request occupies which slot. All decisions are host-side
Python — admission, eviction, and block accounting never touch the
captured programs, which is why each is captured once per engine.

Policy (priority classes, prefix sharing, swap preemption):

* **evict** — finished requests release their slot and KV blocks first, so
  the capacity freed this iteration is admittable this iteration; shared
  blocks are *decref'd* (the radix cache or other requests keep them),
  never hard-freed;
* **admit** — queued requests enter free slots in (priority class,
  arrival) order. Admission first maps the request's longest cached prefix
  from the :class:`~.radix.RadixCache` at refcount+1, then allocates only
  the tail; when the freelist is short, refcount-1 cached blocks are LRU
  evicted before admission gives up. Head-of-line blocking is per-fleet
  and intentional (no starvation of long prompts) — but the *engine* may
  preempt a lower-priority running request to unblock a higher-priority
  head (see ``InferenceEngine._admit_and_place``);
* **preemption** — under pool exhaustion the engine swaps a victim
  (:meth:`SlotScheduler.pick_victim`: lowest priority class first, latest
  arrival within it) to the host-DRAM swap pool and the victim re-queues
  at the *front* of its class via :meth:`requeue_preempted`;
* a request whose prompt is still being chunk-prefilled occupies its slot
  in ``PREFILL`` state; the engine advances one chunk per iteration so a
  long prompt never stalls in-flight decodes.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum

from .blocks import BlockAllocator, blocks_needed

#: admission-priority order, highest first (``interactive`` preempts
#: ``batch``, never the reverse)
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

    Prefix-sharing/preemption state: ``prefill_pos`` starts at the matched
    prefix length (cached tokens are never re-prefilled); ``cow`` is a
    ``(src_block, dst_block)`` device copy the engine owes before the first
    prefill chunk; ``swap_plan`` is ``[(block_index, swap_handle), ...]``
    for a preempted request's swapped-out rows, restored on re-admission."""

    prompt: list[int]
    max_new_tokens: int
    priority: str = "interactive"  # see PRIORITY_CLASSES
    #: accounting dimension, not an admission gate: any string is legal
    #: (the engine normalizes), unknown tenants never raise, and the key
    #: rides payload → Ticket → add_request → here exactly like
    #: ``priority``/``trace_id``, echoed on answer rows and usage rollups
    tenant: str = "default"
    request_id: int = field(default_factory=lambda: next(_request_ids))
    #: distributed-trace identity of the JAX engine. The port does not carry
    #: tracing yet (``add_request`` refuses ``trace_id``), so it stays None;
    #: the usage ledger's summaries read it
    trace_id: str | None = None
    arrival_time: float = field(default_factory=time.perf_counter)
    #: absolute ``time.perf_counter`` expiry (None = no deadline): the
    #: scheduler finishes the request with ``finish_reason=
    #: "deadline_exceeded"`` the first iteration after this passes, queued
    #: or running — freed blocks are admittable the same iteration
    deadline: float | None = None
    state: RequestState = RequestState.QUEUED
    output_tokens: list[int] = field(default_factory=list)
    finish_reason: str | None = None
    # "eos" | "length" | "stop" | "out_of_blocks" | "deadline_exceeded"
    slot: int | None = None
    #: resolved :class:`~.sampling.SamplingParams` (None on a
    #: per_slot_sampling=False engine). Lives on the request — not the
    #: slot — so preemption/swap/re-admission carries it for free and the
    #: lanes are rebuilt from it on every dispatch.
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
    swap_plan: list[tuple[int, int]] = field(default_factory=list)
    preempted: bool = False
    preemptions: int = 0
    #: final cost summary (device_time_s / kv_block_seconds / swap_bytes)
    #: stamped by the usage ledger when the engine processes completion;
    #: None on a usage_accounting=False engine
    usage: dict | None = None

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
                 max_seq_len: int, radix=None, usage=None):
        self.num_slots = int(num_slots)
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_seq_len = int(max_seq_len)
        self.radix = radix
        #: the engine's :class:`~.usage.UsageLedger` (None = accounting
        #: off): block-ownership edges here are where per-request KV
        #: block-seconds accrue
        self.usage = usage
        self.waiting: dict[str, deque[Request]] = {p: deque() for p in PRIORITY_CLASSES}
        self.slots: list[Request | None] = [None] * self.num_slots
        #: cumulative prompt tokens of admitted (fresh) requests — the
        #: denominator of the prefix hit ratio
        self.prompt_tokens_admitted = 0
        self.prefix_hit_tokens = 0
        #: live requests carrying a deadline — the expiry sweep is guarded
        #: on this, so deadline-free serving pays one integer check per
        #: iteration (the telemetry/sanitizer null-path rule)
        self.deadline_live = 0

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
        class, FCFS within it; preempted victims sit at the front)."""
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
        if request.deadline is not None:
            self.deadline_live += 1
        request.state = RequestState.QUEUED
        self.waiting[request.priority].append(request)
        return request

    def requeue_preempted(self, request: Request) -> None:
        """A swapped-out victim goes back to the *front* of its class: it
        already waited its turn once, and its swap handles hold host DRAM
        that should drain as soon as capacity returns."""
        self.slots[request.slot] = None
        request.slot = None
        request.state = RequestState.QUEUED
        request.preempted = True
        request.preemptions += 1
        self.waiting[request.priority].appendleft(request)

    def evict_finished(self) -> list[Request]:
        """Release slots + blocks of finished requests (engine marks them).
        Blocks are decref'd: a block the radix cache (or another request)
        still holds stays resident; the rest return to the freelist."""
        evicted = []
        for i, req in enumerate(self.slots):
            if req is not None and req.state is RequestState.FINISHED:
                self.allocator.decref(req.blocks)
                req.blocks = []
                if self.usage is not None:
                    self.usage.update_blocks(req)
                req.slot = None
                self.slots[i] = None
                if req.deadline is not None:
                    self.deadline_live -= 1
                evicted.append(req)
        return evicted

    def expire_deadlines(
        self, now: float | None = None, skip_slots: set | None = None
    ) -> list[Request]:
        """Finish every queued or running request whose deadline has
        passed (``finish_reason="deadline_exceeded"``). Running requests
        keep their partial output; their blocks are freed by the
        ``evict_finished`` sweep the engine runs right after — same
        iteration, so the capacity a missed deadline was holding is
        admittable immediately (block tables only: the captured programs
        never see any of this). Queued requests leave the
        waiting deques directly (they hold no blocks; a *preempted* queued
        request's swap handles are the engine's to release — see
        ``InferenceEngine.step``). The caller only invokes this while
        ``deadline_live > 0``.

        ``skip_slots``: slots the sweep must leave alone this pass. The
        double-buffered engine passes the in-flight round's slots — those
        requests still have a token landing at this iteration's harvest
        (the token the synchronous engine emitted LAST iteration), so the
        engine defers their expiry to just after that harvest to keep the
        two loops token-identical."""
        now = time.perf_counter() if now is None else now
        expired: list[Request] = []
        for priority in PRIORITY_CLASSES:
            q = self.waiting[priority]
            if any(r.deadline is not None and now > r.deadline for r in q):
                keep: deque[Request] = deque()
                for r in q:
                    if r.deadline is not None and now > r.deadline:
                        r.finish_reason = "deadline_exceeded"
                        r.finish_time = now
                        r.state = RequestState.FINISHED
                        self.deadline_live -= 1
                        expired.append(r)
                    else:
                        keep.append(r)
                self.waiting[priority] = keep
        for req in self.slots:
            if (
                req is not None
                and req.state is not RequestState.FINISHED
                and req.deadline is not None
                and now > req.deadline
            ):
                if skip_slots is not None and req.slot in skip_slots:
                    continue
                req.finish_reason = "deadline_exceeded"
                req.finish_time = now
                req.state = RequestState.FINISHED
                # deadline_live drops at evict_finished, which releases the
                # slot+blocks this iteration
                expired.append(req)
        return expired

    def _ensure_free(self, need: int) -> bool:
        """Freelist coverage for ``need`` blocks, LRU-evicting refcount-1
        cached blocks to make room."""
        short = need - self.allocator.free_count
        if short > 0 and self.radix is not None:
            self.radix.evict(short)
        return self.allocator.can_allocate(need)

    def admit(self) -> list[Request]:
        """Priority-then-FCFS admission into free slots, bounded by the
        block freelist (after radix eviction). Fresh requests map their
        longest cached prefix at refcount+1 and allocate only the tail;
        preempted requests re-allocate exactly their swapped-out blocks
        (the engine restores the rows). Head-of-line blocking on blocks is
        intentional; a free slot with an unaffordable head request stays
        empty until eviction/preemption refills the freelist."""
        admitted = []
        free_slots = [i for i, r in enumerate(self.slots) if r is None]
        while free_slots:
            req = self.peek_head()
            if req is None:
                break
            if req.preempted:
                need = len(req.swap_plan)
                if not self._ensure_free(need):
                    break
                fresh = self.allocator.allocate(need)
                for (idx, _handle), nb in zip(req.swap_plan, fresh):
                    req.blocks[idx] = nb
                req.state = (
                    RequestState.PREFILL
                    if req.prefill_pos < req.prompt_len
                    else RequestState.DECODE
                )
            else:
                total_need = max(
                    blocks_needed(req.prompt_len + 1, self.block_size), 1
                )
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
                    # the engine copies src -> the first private block
                    # before this request's first prefill chunk
                    req.cow = (cow_src, fresh[0])
                self.prompt_tokens_admitted += req.prompt_len
                self.prefix_hit_tokens += matched
                req.state = RequestState.PREFILL
            self.waiting[req.priority].popleft()
            req.slot = free_slots.pop(0)
            self.slots[req.slot] = req
            if self.usage is not None:
                # block-ownership edge: fresh admits start their integral
                # here; preempted re-admits resume at full holdings once
                # the engine clears swap_plan in _place_admitted
                self.usage.update_blocks(req)
            admitted.append(req)
        return admitted

    def pick_victim(self) -> Request | None:
        """Preemption order: lowest priority class first, latest arrival
        within it (the youngest request has the least sunk prefill/decode
        work and re-queues at the front of its class anyway)."""
        cands = [
            r for r in self.slots
            if r is not None and r.state is not RequestState.FINISHED
        ]
        if not cands:
            return None
        return max(cands, key=lambda r: (priority_rank(r.priority), r.arrival_time))

    def grow_for_decode(self, req: Request, tokens_ahead: int = 1) -> bool:
        """Ensure blocks exist for the next ``tokens_ahead`` cache writes
        (a decode burst writes positions ``context_len ..
        context_len+tokens_ahead-1``). The span is capped at the request's
        own ``prompt + max_new`` budget (and the per-slot maximum): burst
        lane-steps past the budget may scatter into the null block, which
        is harmless, and allocating for them would truncate requests under
        pool pressure whose real remaining tokens already fit. When the
        freelist is dry, refcount-1 cached blocks are LRU-evicted first.
        False = the pool is exhausted even after eviction; the engine
        preempts a victim to the swap pool (or, with swap off/full,
        force-finishes with ``finish_reason="out_of_blocks"``)."""
        need = blocks_needed(
            min(
                req.context_len + tokens_ahead,
                req.prompt_len + req.max_new_tokens,
                self.max_seq_len,
            ),
            self.block_size,
        )
        if len(req.blocks) >= need:
            return True
        while len(req.blocks) < need:
            if not self._ensure_free(1):
                if self.usage is not None:
                    self.usage.update_blocks(req)  # partial growth still held
                return False
            req.blocks.extend(self.allocator.allocate(1))
        if self.usage is not None:
            self.usage.update_blocks(req)
        return True
