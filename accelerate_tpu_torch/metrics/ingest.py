"""Record → metric mapping: ONE translation from the telemetry record
stream (and the tracer's span exits / the serving engine's stats dict) into
registry updates, shared by two consumers:

* **in-process**: ``TelemetryRecorder._emit`` calls :func:`observe_record`
  on every record when a registry is active, so a serving job's
  ``GET /metrics`` reflects the live process;
* **sidecar**: :class:`~.exporter.LoggingDirExporter` tails the telemetry
  JSONL segments and replays each new row through the same function, so a
  training job gets scraped without embedding an HTTP server in the train
  loop — both surfaces agree on names and semantics by construction.

Counters increment per row (both consumers see each row exactly once);
run-cumulative *fields* on rows (``recompiles``, ``optimizer_steps``)
ratchet counters via ``set_total`` so a restarted sidecar re-reading a
trail converges to the same totals.
"""

from __future__ import annotations

from .registry import DEFAULT_BUCKETS

__all__ = [
    "observe_record",
    "observe_span",
    "observe_engine_stats",
    "observe_flight",
    "observe_hang",
    "observe_router_row",
]

#: tighter buckets for per-token latencies (TTFT/TPOT)
_LATENCY_BUCKETS = tuple(b for b in DEFAULT_BUCKETS if b <= 60.0)


def _num(value):
    return value if isinstance(value, (int, float)) and not isinstance(value, bool) else None


def observe_record(registry, record: dict) -> None:
    """Feed one telemetry record into ``registry``. Must never raise on a
    malformed row — the sidecar tails files other processes (or versions)
    wrote; unknown types are counted, not errors."""
    rtype = record.get("type")
    if rtype == "step":
        registry.counter("steps", "Training steps recorded").inc()
        if record.get("skipped"):
            registry.counter("skipped_steps", "Steps skipped (non-finite grads)").inc()
        if _num(record.get("optimizer_steps")) is not None:
            registry.counter(
                "optimizer_steps", "Optimizer (sync) steps completed"
            ).set_total(record["optimizer_steps"])
        if _num(record.get("recompiles")) is not None:
            registry.counter(
                "recompiles", "Cumulative XLA compilations"
            ).set_total(record["recompiles"])
        if _num(record.get("step_time_s")) is not None:
            registry.histogram(
                "step_time_seconds", "Wall-clock per training step"
            ).observe(record["step_time_s"])
        for field, name, help in (
            ("tokens_per_sec", "tokens_per_second", "Training token throughput"),
            ("examples_per_sec", "examples_per_second", "Training example throughput"),
            ("mfu", "mfu_ratio", "Model FLOPs utilization (0-1)"),
        ):
            if _num(record.get(field)) is not None:
                registry.gauge(name, help).set(record[field])
    elif rtype == "compile":
        registry.counter("compiles", "XLA compile events").inc()
        if _num(record.get("total_s")) is not None:
            registry.counter(
                "compile_seconds", "Wall-clock spent in trace+lower+compile"
            ).inc(record["total_s"])
    elif rtype == "memory":
        for field, name, help in (
            ("device_bytes_in_use", "device_bytes_in_use", "Device HBM bytes in use"),
            ("device_peak_bytes", "device_peak_bytes", "Device HBM high-water mark"),
            ("host_rss_bytes", "host_rss_bytes", "Host resident set size"),
        ):
            if _num(record.get(field)) is not None:
                registry.gauge(name, help).set(record[field])
    elif rtype == "generate":
        registry.counter("generations", "generate() calls").inc(
            mode=str(record.get("mode", "unknown"))
        )
        if _num(record.get("new_tokens")) is not None:
            registry.counter("generated_tokens", "Tokens emitted by generate()").inc(
                record["new_tokens"]
            )
    elif rtype == "serving":
        _observe_serving(registry, record)
    elif rtype == "checkpoint":
        kind = str(record.get("kind", "unknown"))
        registry.counter("checkpoints", "Checkpoint save/restore events").inc(kind=kind)
        if _num(record.get("seconds")) is not None:
            registry.histogram(
                "checkpoint_seconds", "Wall-clock per checkpoint save/restore"
            ).observe(record["seconds"], kind=kind)
        if _num(record.get("bytes")) is not None:
            registry.counter(
                "checkpoint_bytes", "Bytes written/read by checkpointing"
            ).inc(record["bytes"], kind=kind)
    elif rtype == "event":
        kind = str(record.get("kind", "unknown"))
        registry.counter("events", "Free-form telemetry events").inc(kind=kind)
        if kind == "watchdog_hang":
            observe_hang(registry)
    elif rtype is not None:
        registry.counter("records_other", "Telemetry rows of unmapped types").inc(
            type=str(rtype)
        )


#: prefix-sharing/preemption counters shared by the telemetry step-row path
#: (_observe_serving) and the live stats()-dict path (observe_engine_stats) —
#: one table, so the two export surfaces can never silently diverge
_SHARING_COUNTERS = (
    ("prefix_hit_tokens", "serving_prefix_hit_tokens",
     "Prompt tokens mapped from the radix prefix cache"),
    ("preemptions", "serving_preemptions",
     "Requests swapped to host DRAM under pool pressure"),
    ("swapped_out_blocks", "serving_swapped_out_blocks",
     "KV blocks device_get-swapped to the host pool"),
    ("swapped_in_blocks", "serving_swapped_in_blocks",
     "KV blocks restored from the host pool on re-admission"),
    ("out_of_blocks_total", "serving_out_of_blocks",
     "Requests truncated with finish_reason=out_of_blocks (last resort)"),
    ("deadline_expired_total", "serving_deadline_expired",
     "Requests finished with finish_reason=deadline_exceeded by the engine"),
)
_PREFIX_HIT_GAUGE = (
    "prefix_hit_ratio", "serving_prefix_hit_ratio",
    "Prompt tokens served from the radix prefix cache (fraction)",
)
#: kv_dtype policy gauges — same one-table-two-surfaces rule as above
_KV_GAUGES = (
    ("kv_bytes_per_token", "serving_kv_bytes_per_token",
     "Bytes one cached token holds across layers (K+V payload + scales)"),
    ("kv_slot_capacity", "serving_kv_slot_capacity",
     "Max-length requests the paged pool holds concurrently"),
)
#: speculative-decoding counters/gauge — the accept rate is serving's TPOT
#: lever (each spec round costs one dispatch and emits accept+1 tokens);
#: counters render with the OpenMetrics ``_total`` suffix, giving the
#: documented ``serving_spec_{drafted,accepted}_tokens_total``
_SPEC_COUNTERS = (
    ("spec_drafted_tokens", "serving_spec_drafted_tokens",
     "Draft tokens proposed by the speculative decoder"),
    ("spec_accepted_tokens", "serving_spec_accepted_tokens",
     "Draft tokens the verify forward accepted (greedy agreeing prefix)"),
)
_SPEC_ACCEPT_GAUGE = (
    "spec_accept_rate", "serving_spec_accept_rate",
    "Accepted / drafted speculative tokens (0-1, run-cumulative)",
)
#: per-slot sampling / constrained-decoding health — one-table-two-surfaces
#: again. The sampled-tokens counter is mode-labeled (greedy vs sample),
#: rendering as the documented ``serving_sampled_tokens_total{mode=...}``;
#: the rejection accept rate is the sampled-slot analogue of
#: ``serving_spec_accept_rate`` (rejection-sampling verify acceptance).
_SAMPLING_MODE_FIELDS = (
    ("sampled_tokens_greedy", "greedy"),
    ("sampled_tokens_sample", "sample"),
)
_GRAMMAR_COUNTER = (
    "grammar_masked_steps", "serving_grammar_masked_steps",
    "Emitted tokens that passed through a grammar DFA allow-mask",
)
_REJECTION_GAUGE = (
    "rejection_accept_rate", "serving_rejection_accept_rate",
    "Accepted / drafted rejection-sampled draft tokens (0-1, run-cumulative)",
)


def _observe_sampling(registry, rec: dict) -> None:
    """Sampling/grammar fields of a step row or a stats() dict → registry.
    Shared by both export surfaces, like the tables above."""
    for field, mode in _SAMPLING_MODE_FIELDS:
        if _num(rec.get(field)) is not None:
            registry.counter(
                "serving_sampled_tokens",
                "Tokens emitted by the engine per sampling mode",
            ).set_total(rec[field], mode=mode)
    field, name, help = _GRAMMAR_COUNTER
    if _num(rec.get(field)) is not None:
        registry.counter(name, help).set_total(rec[field])
    field, name, help = _REJECTION_GAUGE
    if _num(rec.get(field)) is not None:
        registry.gauge(name, help).set(rec[field])
#: usage-ledger tenant counters — one-table-two-surfaces: telemetry step
#: rows carry a ``usage`` ledger snapshot and ``observe_engine_stats``
#: reads ``stats()["usage"]``. Tenant-label cardinality is capped at the
#: *producer* (the ledger folds beyond-top-K tenants into ``other``), so
#: the scrape stays bounded whatever tenant ids the traffic carries.
#: Counter names render with the OpenMetrics ``_total`` suffix, giving
#: the documented ``serving_usage_{device_seconds,block_seconds,
#: swap_bytes}_total{tenant=...}``.
_USAGE_TENANT_COUNTERS = (
    ("device_seconds", "serving_usage_device_seconds",
     "Measured device-seconds (decode device_wait shares + prefill "
     "chunks) attributed per tenant by the usage ledger"),
    ("block_seconds", "serving_usage_block_seconds",
     "KV block-seconds (integral of held blocks over wall time) per tenant"),
    ("swap_bytes", "serving_usage_swap_bytes",
     "Bytes moved to/from the host-DRAM swap tier per tenant"),
)


def _observe_usage(registry, usage) -> None:
    """One usage-ledger snapshot (a step row's ``usage`` field or
    ``stats()["usage"]``) → tenant-labeled counters. Shared by both export
    surfaces; never raises on malformed snapshots."""
    if not isinstance(usage, dict):
        return
    tenants = usage.get("by_tenant")
    if isinstance(tenants, dict):
        for tenant, trow in tenants.items():
            if not isinstance(trow, dict):
                continue
            for field, name, help in _USAGE_TENANT_COUNTERS:
                if _num(trow.get(field)) is not None:
                    registry.counter(name, help).set_total(
                        trow[field], tenant=str(tenant)[:64]
                    )
    if _num(usage.get("requests_finished")) is not None:
        registry.counter(
            "serving_usage_requests",
            "Requests whose usage-ledger account has closed",
        ).set_total(usage["requests_finished"])


#: flight-recorder / device-memory gauges — one-table-two-surfaces again:
#: telemetry step rows and ``observe_engine_stats`` both splice this in.
#: Mirrors ``accelerate_tpu_torch.serving.flight.ITERATION_PHASES`` semantics
#: (hardcoded here so this module stays importable without the serving
#: package; a test pins the tuple against the recorder's).
_FLIGHT_PHASES = ("schedule", "prefill", "dispatch", "device_wait", "harvest")
_FLIGHT_GAUGES = (
    ("host_fraction", "serving_host_fraction",
     "1 - (device_wait + overlap_hidden)/wall over recorded iterations "
     "(flight recorder)"),
    ("overlap_hidden_s", "serving_overlap_hidden_seconds",
     "Cumulative host time run under an in-flight dispatch (double-"
     "buffered engine; 0 with --sync-engine)"),
    ("iteration_p50_s", "serving_iteration_p50_seconds",
     "Median engine iteration wall time over the flight ring"),
    ("iteration_p99_s", "serving_iteration_p99_seconds",
     "p99 engine iteration wall time over the flight ring"),
    ("hbm_used_bytes", "serving_hbm_used_bytes",
     "Device memory in use (memory_stats, else static params+pools estimate)"),
    ("hbm_headroom_bytes", "serving_hbm_headroom_bytes",
     "Device memory limit minus bytes in use (when a limit is known)"),
)


def observe_flight(registry, entry: dict) -> None:
    """One flight-recorder iteration entry → the per-phase iteration
    histogram (phase label vocabulary is the fixed
    :data:`_FLIGHT_PHASES` + ``total``, so cardinality stays bounded)."""
    hist = registry.histogram(
        "serving_iteration_seconds",
        "Engine iteration wall time decomposed by flight-recorder phase",
        buckets=_LATENCY_BUCKETS,
    )
    if _num(entry.get("wall_s")) is not None:
        hist.observe(entry["wall_s"], phase="total")
    for p in _FLIGHT_PHASES:
        if _num(entry.get(f"{p}_s")) is not None:
            hist.observe(entry[f"{p}_s"], phase=p)
    # not a sixth phase: re-counts host time hidden under an in-flight
    # dispatch, so the exclusive-phase sum still telescopes to `total`
    if _num(entry.get("overlap_hidden_s")) is not None:
        hist.observe(entry["overlap_hidden_s"], phase="overlap_hidden")


def _observe_serving(registry, record: dict) -> None:
    kind = record.get("kind")
    if kind == "request":
        registry.counter("serving_requests", "Completed serving requests").inc(
            finish_reason=str(record.get("finish_reason", "unknown"))
        )
        if _num(record.get("new_tokens")) is not None:
            registry.counter("serving_tokens", "Tokens emitted by the engine").inc(
                record["new_tokens"]
            )
        # per-priority-class latency series (rows without a priority — old
        # trails, foreign writers — keep the unlabeled series), and a
        # trace_id exemplar so a scrape links a bad bucket straight to the
        # request's stitched trace (`accelerate-tpu trace tail` / merge)
        labels = (
            {"class": record["priority"]}
            if isinstance(record.get("priority"), str)
            else {}
        )
        exemplar = (
            # capped so the exemplar labelset can never trip the spec's
            # 128-char limit, whatever a foreign trail put in the row
            {"trace_id": record["trace_id"][:64]}
            if isinstance(record.get("trace_id"), str) and record["trace_id"]
            else None
        )
        if _num(record.get("ttft_s")) is not None:
            registry.histogram(
                "serving_ttft_seconds", "Time to first token",
                buckets=_LATENCY_BUCKETS,
            ).observe(record["ttft_s"], exemplar=exemplar, **labels)
        if _num(record.get("tpot_s")) is not None:
            registry.histogram(
                "serving_tpot_seconds", "Time per output token",
                buckets=_LATENCY_BUCKETS,
            ).observe(record["tpot_s"], exemplar=exemplar, **labels)
    elif kind == "step":
        for field, name, help in (
            ("tokens_per_sec", "serving_tokens_per_second", "Engine token throughput (window)"),
            ("queue_depth", "serving_queue_depth", "Requests waiting for a slot"),
            ("active_slots", "serving_active_slots", "Decode slots holding a live request"),
            ("slot_occupancy", "serving_slot_occupancy", "Fraction of decode slots busy"),
            ("free_blocks", "serving_free_blocks", "Free KV-cache blocks"),
            _PREFIX_HIT_GAUGE,
            *_KV_GAUGES,
            _SPEC_ACCEPT_GAUGE,
            *_FLIGHT_GAUGES,
        ):
            if _num(record.get(field)) is not None:
                registry.gauge(name, help).set(record[field])
        for field, name, help in (
            ("decode_compiles", "serving_decode_compiles", "Decode executable re-traces"),
            ("completed_total", "serving_completed",
             "Engine-reported completed requests (cumulative)"),
            *_SHARING_COUNTERS,
            *_SPEC_COUNTERS,
        ):
            if _num(record.get(field)) is not None:
                registry.counter(name, help).set_total(record[field])
        _observe_usage(registry, record.get("usage"))
        _observe_sampling(registry, record)


#: router-level robustness counters — fed from the fleet trail's aggregate
#: ``kind: "router"`` rows (written once per health tick) by the sidecar
#: exporter, the same one-table-two-surfaces rule as the engine counters.
#: Counter names render with the OpenMetrics ``_total`` suffix, giving the
#: documented ``serving_router_{respawns,shed,deadline_expired}_total``.
_ROUTER_COUNTERS = (
    ("respawns", "serving_router_respawns",
     "Dead replicas respawned by the fleet supervisor"),
    ("shed", "serving_router_shed",
     "Requests shed by bounded-queue admission control"),
    ("deadline_expired", "serving_router_deadline_expired",
     "Requests answered with a deadline-exceeded error row by the router"),
    ("requeues", "serving_router_requeues",
     "Dispatches requeued after a replica failure or timeout"),
    ("rejected", "serving_router_rejected",
     "Submissions answered with an admission error row"),
    ("delivered", "serving_router_delivered",
     "Requests delivered exactly once by the router"),
    ("scale_ups", "serving_router_scale_ups",
     "Replicas spawned by queue-pressure autoscaling"),
    ("scale_downs", "serving_router_scale_downs",
     "Replicas drained by idle-fleet autoscaling"),
)
_ROUTER_GAUGES = (
    ("queue_depth", "serving_router_queue_depth",
     "Requests waiting in the router queue"),
    ("outstanding", "serving_router_outstanding",
     "Requests submitted but not yet delivered"),
    ("quarantined", "serving_router_quarantined",
     "Replicas currently under crash-loop quarantine"),
    ("pending_respawns", "serving_router_pending_respawns",
     "Dead replicas waiting out their respawn backoff"),
)


def observe_router_row(registry, row: dict) -> None:
    """One fleet-trail row → registry updates. Aggregate ``kind="router"``
    rows ratchet the router counters; per-replica rows refresh a restart
    gauge. Never raises on malformed rows (the exporter tails files other
    processes wrote)."""
    if row.get("kind") == "router":
        for field, name, help in _ROUTER_COUNTERS:
            if _num(row.get(field)) is not None:
                registry.counter(name, help).set_total(row[field])
        for field, name, help in _ROUTER_GAUGES:
            if _num(row.get(field)) is not None:
                registry.gauge(name, help).set(row[field])
        tenants = row.get("by_tenant")
        if isinstance(tenants, dict):
            # Tenant-labeled views of the delivery counters. Cardinality is
            # capped at the producer (router folds beyond-top-K tenants into
            # ``other``); the by_tenant field ``requeued`` feeds the same
            # ``serving_router_requeues`` family as the aggregate row.
            for tenant, trow in tenants.items():
                if not isinstance(trow, dict):
                    continue
                for field, name, help in (
                    ("delivered", "serving_router_delivered",
                     "Requests delivered exactly once by the router"),
                    ("shed", "serving_router_shed",
                     "Requests shed by bounded-queue admission control"),
                    ("deadline_expired", "serving_router_deadline_expired",
                     "Requests answered with a deadline-exceeded error row "
                     "by the router"),
                    ("requeued", "serving_router_requeues",
                     "Dispatches requeued after a replica failure or timeout"),
                ):
                    if _num(trow.get(field)) is not None:
                        registry.counter(name, help).set_total(
                            trow[field], tenant=str(tenant)[:64]
                        )
        return
    rid = row.get("replica_id")
    if rid is not None and _num(row.get("restarts")) is not None:
        registry.gauge(
            "serving_replica_restarts", "Respawn count per replica identity"
        ).set(row["restarts"], replica=str(rid))


def observe_span(registry, name: str, seconds: float) -> None:
    """One closed trace span → the per-phase latency histogram. Span names
    are a small fixed vocabulary (the built-in instrumentation points), so
    the label cardinality stays bounded."""
    registry.histogram(
        "span_seconds", "Wall-clock per instrumented phase (trace spans)"
    ).observe(seconds, name=name)


def observe_hang(registry) -> None:
    registry.counter("watchdog_hangs", "Watchdog hang-report firings").inc()


def observe_engine_stats(registry, stats: dict) -> None:
    """Refresh gauges from ``InferenceEngine.stats()`` — called by the serve
    front end on each ``GET /metrics`` so a scrape is never staler than the
    engine's own counters, even between periodic telemetry rows."""
    for field, name, help in (
        ("queue_depth", "serving_queue_depth", "Requests waiting for a slot"),
        ("active_slots", "serving_active_slots", "Decode slots holding a live request"),
        ("slot_occupancy_mean", "serving_slot_occupancy", "Fraction of decode slots busy"),
        ("free_blocks", "serving_free_blocks", "Free KV-cache blocks"),
        ("tokens_per_sec", "serving_tokens_per_second", "Engine token throughput (window)"),
    ):
        if _num(stats.get(field)) is not None:
            registry.gauge(name, help).set(stats[field])
    if _num(stats.get("tokens_emitted")) is not None:
        registry.counter("serving_tokens", "Tokens emitted by the engine").set_total(
            stats["tokens_emitted"]
        )
    if _num(stats.get("completed")) is not None:
        registry.counter(
            "serving_completed", "Engine-reported completed requests (cumulative)"
        ).set_total(stats["completed"])
    if _num(stats.get("decode_compiles")) is not None:
        registry.counter(
            "serving_decode_compiles", "Decode executable re-traces"
        ).set_total(stats["decode_compiles"])
    if _num(stats.get("iterations")) is not None:
        registry.counter("serving_iterations", "Engine scheduler iterations").set_total(
            stats["iterations"]
        )
    for field, name, help in (
        _PREFIX_HIT_GAUGE, *_KV_GAUGES, _SPEC_ACCEPT_GAUGE, *_FLIGHT_GAUGES
    ):
        if _num(stats.get(field)) is not None:
            registry.gauge(name, help).set(stats[field])
    for field, name, help in (*_SHARING_COUNTERS, *_SPEC_COUNTERS):
        if _num(stats.get(field)) is not None:
            registry.counter(name, help).set_total(stats[field])
    _observe_usage(registry, stats.get("usage"))
    _observe_sampling(registry, stats)
