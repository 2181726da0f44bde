"""Per-request resource attribution — the conservation-checked usage ledger
(a copy of ``accelerate_tpu/serving/usage.py``: pure Python, shared
semantics).

Every request accrues **measured** costs as it runs, rolled up by request,
priority class, and tenant:

* **decode device-seconds** — each harvested decode round's ``device_wait``
  interval (the exact float the flight recorder accrues, when flight is on)
  apportioned across the round's live slots, weighted by how many tokens
  each request actually emitted from that harvest;
* **prefill device-seconds** — per prefill chunk, wall time around the
  chunk dispatch, attributed to the one request the chunk belongs to;
* **KV block-seconds** — the integral of per-request *held* blocks over
  wall time, accrued at every refcount edge (admit, decode growth, CoW
  resolve, swap-out/in, deadline release, eviction). "Held" means blocks
  the request owns allocator references to (``req.blocks`` minus blocks
  parked host-side in ``req.swap_plan``); a prefix block shared by N
  requests bills each holder — the fair-division choice chargeback wants.
  Radix-cache-exclusive blocks belong to the cache, not any request, and
  are deliberately outside the ledger;
* **swap bytes** in/out, **speculative** drafted/accepted tokens, and
  **grammar-masked** steps.

The headline property is **conservation, asserted not estimated**: the
ledger independently accrues two partner totals per resource —
``device_wait_seconds`` (one add per harvest) vs the sum of per-request
decode shares, and ``pool_block_seconds`` (one pool-wide integrand) vs
the sum of per-request block-second integrals — using the *same*
timestamps at the *same* edges, so the pairs agree to float tolerance no
matter how requests are preempted, swapped, expired, or speculated.
Per-request accounting closes when the engine processes the request's
completion (the iteration its answer row is emitted); the extra
iteration the scheduler holds the blocks before eviction is excluded
from *both* sides of the integral, consistently.

Framework-free by design, like :mod:`.flight`. The disabled
path is one truthiness check per engine iteration
(``EngineConfig(usage_accounting=False)`` → ``engine.usage is None``),
the telemetry/flight discipline.

Tenant-label cardinality on any exported surface is capped to the
``top_k`` heaviest tenants plus an ``other`` fold (:func:`cap_by_key`),
so a hostile tenant-id stream can never blow up the metrics registry or
a scrape.
"""

from __future__ import annotations

import time

__all__ = [
    "DEFAULT_TOP_K",
    "OTHER_TENANT",
    "USAGE_SCHEMA",
    "UsageLedger",
    "cap_by_key",
    "normalize_tenant",
]

#: schema stamp on ledger snapshots (telemetry step rows, stats()["usage"])
USAGE_SCHEMA = 1

#: exported tenant-label cardinality cap: top-K heaviest + ``other``
DEFAULT_TOP_K = 8

#: the fold bucket every beyond-top-K tenant aggregates into; a real
#: tenant named "other" merges with the fold (documented, not detected)
OTHER_TENANT = "other"

#: tenant ids are labels on metrics and JSONL rows — bound them
_TENANT_MAX_LEN = 64

#: the tenant every request without one belongs to (unknown-safe: a
#: malformed tenant value normalizes here instead of raising)
DEFAULT_TENANT = "default"


def normalize_tenant(value) -> str:
    """The tenant key contract: any non-empty string (stripped, bounded
    to 64 chars); everything else — ``None``, numbers, empty — is the
    ``default`` tenant. Never raises: tenant is an accounting dimension,
    not an admission gate."""
    if isinstance(value, str):
        v = value.strip()
        if v:
            return v[:_TENANT_MAX_LEN]
    return DEFAULT_TENANT


def cap_by_key(entries: dict, top_k: int, weight_field: str = "device_seconds") -> dict:
    """Cap a ``{tenant: rollup}`` dict to the ``top_k`` heaviest (by
    ``weight_field``, ties broken by name for determinism) plus an
    ``other`` bucket summing every numeric field of the rest."""
    if len(entries) <= top_k:
        return {k: dict(v) for k, v in entries.items()}
    ranked = sorted(
        entries.items(), key=lambda kv: (-float(kv[1].get(weight_field) or 0.0), kv[0])
    )
    out = {k: dict(v) for k, v in ranked[:top_k]}
    other: dict = {}
    for _, row in ranked[top_k:]:
        for field, val in row.items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            other[field] = other.get(field, 0) + val
    # fold INTO an existing literal "other" tenant rather than clobber it
    if OTHER_TENANT in out:
        for field, val in other.items():
            out[OTHER_TENANT][field] = out[OTHER_TENANT].get(field, 0) + val
    else:
        out[OTHER_TENANT] = other
    return out


class _RequestUsage:
    """One live request's accruals. A plain slotted record — this sits on
    the engine's per-token path, so no dataclass machinery."""

    __slots__ = (
        "tenant", "priority", "trace_id", "request_id",
        "decode_device_s", "prefill_device_s", "block_seconds",
        "held_blocks", "held_since",
        "swap_bytes_in", "swap_bytes_out",
        "spec_drafted", "spec_accepted", "grammar_masked_steps",
    )

    def __init__(self, request_id, tenant, priority, trace_id, now):
        self.request_id = request_id
        self.tenant = tenant
        self.priority = priority
        self.trace_id = trace_id
        self.decode_device_s = 0.0
        self.prefill_device_s = 0.0
        self.block_seconds = 0.0
        self.held_blocks = 0
        self.held_since = now
        self.swap_bytes_in = 0
        self.swap_bytes_out = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.grammar_masked_steps = 0


def _zero_rollup() -> dict:
    return {
        "requests": 0,
        "tokens": 0,
        "device_seconds": 0.0,
        "decode_device_seconds": 0.0,
        "prefill_device_seconds": 0.0,
        "block_seconds": 0.0,
        "swap_bytes": 0,
        "spec_drafted_tokens": 0,
        "spec_accepted_tokens": 0,
        "grammar_masked_steps": 0,
    }


def _fold(table: dict, key: str, rec: _RequestUsage, tokens: int,
          block_seconds: float) -> None:
    row = table.get(key)
    if row is None:
        row = table[key] = _zero_rollup()
    row["requests"] += 1
    row["tokens"] += tokens
    row["decode_device_seconds"] += rec.decode_device_s
    row["prefill_device_seconds"] += rec.prefill_device_s
    row["device_seconds"] += rec.decode_device_s + rec.prefill_device_s
    row["block_seconds"] += block_seconds
    row["swap_bytes"] += rec.swap_bytes_in + rec.swap_bytes_out
    row["spec_drafted_tokens"] += rec.spec_drafted
    row["spec_accepted_tokens"] += rec.spec_accepted
    row["grammar_masked_steps"] += rec.grammar_masked_steps


class UsageLedger:
    """The engine-owned per-request cost accumulator.

    Hooks (all no-ops for unknown request ids, so late edges after a
    request closed are safe):

    * :meth:`begin` — on admission to the scheduler;
    * :meth:`update_blocks` — at every block-ownership edge;
    * :meth:`accrue_decode` — once per harvested round, with the exact
      ``device_wait`` seconds and per-request emission weights;
    * :meth:`accrue_prefill` / :meth:`accrue_swap` / :meth:`accrue_spec`
      / :meth:`accrue_grammar`;
    * :meth:`finish` — when the engine processes the completion; returns
      the answer-row cost summary and folds the record into the
      tenant/class rollups and heavy-hitter ranking.
    """

    def __init__(self, top_k: int = DEFAULT_TOP_K):
        now = time.perf_counter()
        self.top_k = top_k
        self._live: dict = {}  # request_id -> _RequestUsage
        self._by_tenant: dict = {}
        self._by_class: dict = {}
        self._heavy: list = []  # finished-request summaries, heaviest first
        self._requests_finished = 0
        # conservation partners: each accrued ONCE per edge, independently
        # of the per-request apportionment they must sum to
        self._device_wait_s = 0.0
        self._pool_held = 0
        self._pool_block_seconds = 0.0
        self._pool_since = now

    # -- lifecycle hooks -----------------------------------------------------

    def begin(self, req) -> None:
        now = time.perf_counter()
        self._live[req.request_id] = _RequestUsage(
            req.request_id, req.tenant, req.priority, req.trace_id, now
        )

    def update_blocks(self, req) -> None:
        """Accrue block-seconds up to now and restamp the held count.
        Held = allocator references the request owns: ``req.blocks``
        minus entries parked host-side in ``req.swap_plan``."""
        rec = self._live.get(req.request_id)
        if rec is None:
            return
        held = len(req.blocks) - len(req.swap_plan)
        self._accrue_blocks(rec, held, time.perf_counter())

    def _accrue_blocks(self, rec: _RequestUsage, held: int, now: float) -> None:
        if rec.held_blocks:
            rec.block_seconds += rec.held_blocks * (now - rec.held_since)
        # the pool-wide integrand advances at the SAME edge with the SAME
        # stamp, so Σ per-request integrals == the pool integral exactly
        # (up to float rounding), by construction
        if self._pool_held:
            self._pool_block_seconds += self._pool_held * (now - self._pool_since)
        self._pool_since = now
        self._pool_held += held - rec.held_blocks
        rec.held_blocks = held
        rec.held_since = now

    def accrue_decode(self, device_wait_s: float, shares) -> None:
        """One harvested round: ``device_wait_s`` is the round's exact
        device-wait interval (the float the flight recorder accrued, when
        flight is on); ``shares`` is ``[(request_id, weight), ...]`` with
        arbitrary non-negative weights (normalized here — the engine
        passes per-request emitted-token counts)."""
        self._device_wait_s += device_wait_s
        total = sum(w for _, w in shares)
        if not total:
            return
        live = self._live
        for rid, w in shares:
            rec = live.get(rid)
            if rec is not None:
                rec.decode_device_s += device_wait_s * (w / total)

    def accrue_prefill(self, req, dt_s: float) -> None:
        rec = self._live.get(req.request_id)
        if rec is not None:
            rec.prefill_device_s += dt_s

    def accrue_swap(self, req, *, bytes_out: int = 0, bytes_in: int = 0) -> None:
        rec = self._live.get(req.request_id)
        if rec is not None:
            rec.swap_bytes_out += bytes_out
            rec.swap_bytes_in += bytes_in

    def accrue_spec(self, req, drafted: int, accepted: int) -> None:
        rec = self._live.get(req.request_id)
        if rec is not None:
            rec.spec_drafted += drafted
            rec.spec_accepted += accepted

    def accrue_grammar(self, req) -> None:
        rec = self._live.get(req.request_id)
        if rec is not None:
            rec.grammar_masked_steps += 1

    def finish(self, req) -> dict | None:
        """Close the request's account: final block-second accrual (held
        drops to 0 on both sides of the integral), fold into rollups, and
        return the answer-row summary. Exactly-once: a second finish (or
        any later edge) no-ops."""
        rec = self._live.pop(req.request_id, None)
        if rec is None:
            return None
        self._accrue_blocks(rec, 0, time.perf_counter())
        tokens = len(req.output_tokens)
        _fold(self._by_tenant, rec.tenant, rec, tokens, rec.block_seconds)
        _fold(self._by_class, rec.priority, rec, tokens, rec.block_seconds)
        self._requests_finished += 1
        device_s = rec.decode_device_s + rec.prefill_device_s
        swap_bytes = rec.swap_bytes_in + rec.swap_bytes_out
        entry = {
            "request_id": rec.request_id,
            "trace_id": rec.trace_id,
            "tenant": rec.tenant,
            "class": rec.priority,
            "device_seconds": device_s,
            "block_seconds": rec.block_seconds,
            "swap_bytes": swap_bytes,
            "new_tokens": tokens,
            "finish_reason": req.finish_reason,
        }
        heavy = self._heavy
        heavy.append(entry)
        heavy.sort(key=lambda e: -e["device_seconds"])
        del heavy[self.top_k:]
        return {
            "device_time_s": device_s,
            "kv_block_seconds": rec.block_seconds,
            "swap_bytes": swap_bytes,
        }

    # -- read side -----------------------------------------------------------

    def snapshot(self) -> dict:
        """Cumulative ledger state (finished rollups + live accruals to
        now, without mutating any edge stamps): totals, capped
        ``by_tenant``, ``by_class``, heavy hitters, and the conservation
        partner totals."""
        now = time.perf_counter()
        tenants = {k: dict(v) for k, v in self._by_tenant.items()}
        classes = {k: dict(v) for k, v in self._by_class.items()}
        for rec in self._live.values():
            live_bs = rec.block_seconds + rec.held_blocks * (now - rec.held_since)
            for table, key in ((tenants, rec.tenant), (classes, rec.priority)):
                row = table.get(key)
                if row is None:
                    row = table[key] = _zero_rollup()
                row["decode_device_seconds"] += rec.decode_device_s
                row["prefill_device_seconds"] += rec.prefill_device_s
                row["device_seconds"] += rec.decode_device_s + rec.prefill_device_s
                row["block_seconds"] += live_bs
                row["swap_bytes"] += rec.swap_bytes_in + rec.swap_bytes_out
                row["spec_drafted_tokens"] += rec.spec_drafted
                row["spec_accepted_tokens"] += rec.spec_accepted
                row["grammar_masked_steps"] += rec.grammar_masked_steps
        totals = _zero_rollup()
        del totals["requests"], totals["tokens"]
        for row in tenants.values():
            for field in totals:
                totals[field] += row[field]
        pool_bs = self._pool_block_seconds
        if self._pool_held:
            pool_bs += self._pool_held * (now - self._pool_since)
        return {
            "schema": USAGE_SCHEMA,
            "requests_finished": self._requests_finished,
            "requests_live": len(self._live),
            "top_k": self.top_k,
            **totals,
            # conservation partners (Σ decode shares vs device_wait; Σ
            # block-seconds vs the pool integrand)
            "device_wait_seconds": self._device_wait_s,
            "pool_block_seconds": pool_bs,
            "by_tenant": cap_by_key(tenants, self.top_k),
            "by_class": classes,
            "heavy_hitters": [dict(e) for e in self._heavy],
        }

    def reset(self) -> None:
        """``engine.reset_stats()``: zero every accrual but keep live
        requests' identities and current block holdings (they re-base at
        now, like the flight recorder's reset)."""
        now = time.perf_counter()
        self._by_tenant.clear()
        self._by_class.clear()
        self._heavy = []
        self._requests_finished = 0
        self._device_wait_s = 0.0
        self._pool_block_seconds = 0.0
        self._pool_since = now
        for rec in self._live.values():
            rec.decode_device_s = 0.0
            rec.prefill_device_s = 0.0
            rec.block_seconds = 0.0
            rec.held_since = now
            rec.swap_bytes_in = 0
            rec.swap_bytes_out = 0
            rec.spec_drafted = 0
            rec.spec_accepted = 0
            rec.grammar_masked_steps = 0
