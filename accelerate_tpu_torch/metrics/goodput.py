"""Goodput ledger: attribute each host's wall-clock to exclusive causes.

The production question the step instrumentation couldn't answer: *what
fraction of the time we paid for did productive work, and where did the
rest go?* — Google's ML Goodput framing. The trace spans the diagnostics
subsystem already writes carry everything needed: this module sweeps one
host's span timeline and attributes every instant of elapsed wall-clock to
exactly one bucket:

``step``        productive train/serve work — step + backward dispatch,
                device wait, eager collectives, the serving engine's
                schedule/prefill/decode phases, generation
``compile``     trace/lower/compile (the AOT path's spans)
``checkpoint``  save/restore (resilience subsystem spans)
``dataloader``  host input pipeline stalls (``dataloader/fetch``)
``hang``        watchdog-diagnosed no-progress intervals
                (``watchdog/hang`` instants carry ``elapsed_s``)
``idle``        everything uncovered — prepare/setup, Python between
                steps, true idleness

Overlaps are resolved by priority (``hang`` > ``checkpoint`` > ``compile``
> ``dataloader`` > ``step``): a compile that fires *inside* a backward
span bills to ``compile``, the surrounding step keeps only its uncovered
remainder. ``idle`` is defined as the uncovered measure, so the ledger
carries a structural invariant the tests assert:

    sum(buckets) == elapsed wall-clock, exactly.

Consumed three ways: ``accelerate-tpu monitor``'s goodput panel, the
sidecar exporter's ``accelerate_goodput_*`` gauges, and ``bench.py``'s
``goodput_pct`` row.
"""

from __future__ import annotations

import glob
import logging
import os
import time

logger = logging.getLogger(__name__)

__all__ = [
    "BUCKETS",
    "ledger_from_events",
    "ledger_from_dir",
    "ledger_from_dir_throttled",
    "span_bucket",
]

#: exclusive attribution buckets, highest overlap-priority first (idle is
#: never matched by a span — it is the uncovered remainder by definition)
BUCKETS: tuple[str, ...] = ("hang", "checkpoint", "compile", "dataloader", "step", "idle")

_PREFIX_BUCKET: tuple[tuple[str, str], ...] = (
    ("compile/", "compile"),
    ("checkpoint/", "checkpoint"),
    ("dataloader/", "dataloader"),
    ("step/", "step"),
    ("backward/", "step"),
    ("collective/", "step"),
    ("serve/", "step"),
    ("generate", "step"),
)

#: ignore per-host trace trails bigger than this by default — the monitor
#: repaints every couple of seconds and must not re-parse a multi-GB trail
DEFAULT_MAX_TRACE_BYTES = 256 * 1024 * 1024


def span_bucket(name: str) -> str | None:
    """Bucket for a span name; None for spans that don't bill anywhere
    (``prepare`` etc. — they fall into ``idle`` as uncovered time)."""
    for prefix, bucket in _PREFIX_BUCKET:
        if name.startswith(prefix):
            return bucket
    return None


def _sweep(intervals: list[tuple[float, float, str]], t0: float, t1: float) -> dict[str, float]:
    """Exclusive attribution by priority sweep: every elementary segment of
    ``[t0, t1]`` bills to the highest-priority bucket covering it. Returns
    seconds per bucket with ``idle`` as the uncovered remainder — by
    construction the values sum to ``t1 - t0`` exactly."""
    priority = {bucket: i for i, bucket in enumerate(BUCKETS)}
    events: list[tuple[float, int, int]] = []  # (time, +1/-1, priority)
    for start, end, bucket in intervals:
        start, end = max(start, t0), min(end, t1)
        if end <= start:
            continue
        p = priority[bucket]
        events.append((start, 1, p))
        events.append((end, -1, p))
    out = {bucket: 0.0 for bucket in BUCKETS}
    if not events:
        out["idle"] = max(0.0, t1 - t0)
        return out
    events.sort(key=lambda e: e[0])
    active = [0] * len(BUCKETS)
    covered = 0.0
    prev = t0
    i = 0
    n = len(events)
    while i < n:
        t = events[i][0]
        if t > prev:
            # bill [prev, t) to the highest-priority active bucket
            for p, count in enumerate(active):
                if count > 0:
                    out[BUCKETS[p]] += t - prev
                    covered += t - prev
                    break
            prev = t
        while i < n and events[i][0] == t:
            active[events[i][2]] += events[i][1]
            i += 1
    # tail after the last boundary is uncovered by definition
    out["idle"] = max(0.0, (t1 - t0) - covered)
    return out


def _epoch_buckets(events: list[dict]) -> dict[str, float] | None:
    """Bucket seconds for ONE monotonic epoch's events (see
    :func:`ledger_from_events` for why epochs must not be mixed)."""
    intervals: list[tuple[float, float, str]] = []
    t_min = t_max = None

    def _seen(ts_us: float) -> None:
        nonlocal t_min, t_max
        t_min = ts_us if t_min is None else min(t_min, ts_us)
        t_max = ts_us if t_max is None else max(t_max, ts_us)

    for event in events:
        ph = event.get("ph")
        ts = event.get("ts")
        if ts is None:
            continue
        ts = float(ts)
        if ph == "X":
            dur = float(event.get("dur") or 0.0)
            _seen(ts)
            _seen(ts + dur)
            bucket = span_bucket(str(event.get("name", "")))
            if bucket is not None and dur > 0:
                intervals.append((ts, ts + dur, bucket))
        elif ph == "i":
            _seen(ts)
            if event.get("name") == "watchdog/hang":
                elapsed_s = (event.get("args") or {}).get("elapsed_s")
                if isinstance(elapsed_s, (int, float)) and elapsed_s > 0:
                    intervals.append((ts - float(elapsed_s) * 1e6, ts, "hang"))
                    _seen(ts - float(elapsed_s) * 1e6)
        elif ph == "C":
            _seen(ts)
    if t_min is None or t_max <= t_min:
        return None
    buckets_us = _sweep(intervals, t_min, t_max)
    return {bucket: us / 1e6 for bucket, us in buckets_us.items()}


def ledger_from_events(events: list[dict], host=None) -> dict | None:
    """One host's ledger from its parsed Chrome trace events (monotonic µs
    ``ts``/``dur``). None when the trail holds nothing timed.

    A trail can hold SEVERAL monotonic epochs: the tracer appends across
    auto-resume restarts, each opening with a fresh ``clock_sync`` metadata
    event and a fresh ``perf_counter`` origin (the same situation
    ``merge_traces`` re-bases for). Raw timestamps are only comparable
    *within* an epoch, so the event stream is partitioned at ``clock_sync``
    markers and each epoch is attributed independently; the ledger sums
    bucket- and elapsed-seconds across epochs (downtime *between* the
    incarnations is invisible to monotonic clocks and is deliberately not
    billed — the ledger attributes recorded process lifetime)."""
    epochs: list[list[dict]] = [[]]
    for event in events:
        if event.get("ph") == "M" and event.get("name") == "clock_sync":
            if epochs[-1]:
                epochs.append([])
            continue
        epochs[-1].append(event)
    per_epoch = [b for b in (_epoch_buckets(e) for e in epochs) if b is not None]
    if not per_epoch:
        return None
    buckets_s = {
        bucket: sum(b[bucket] for b in per_epoch) for bucket in BUCKETS
    }
    elapsed_s = sum(buckets_s.values())
    return {
        "host": host,
        "epochs": len(per_epoch),
        "elapsed_s": elapsed_s,
        "buckets_s": buckets_s,
        "goodput_pct": 100.0 * buckets_s["step"] / elapsed_s if elapsed_s > 0 else 0.0,
        "lost_s_by_cause": {
            bucket: seconds
            for bucket, seconds in buckets_s.items()
            if bucket != "step"
        },
    }


def _aggregate(hosts: list[dict]) -> dict:
    """Fleet view: host-seconds summed per bucket (goodput % is then the
    elapsed-weighted mean across hosts)."""
    elapsed = sum(h["elapsed_s"] for h in hosts)
    buckets = {bucket: sum(h["buckets_s"][bucket] for h in hosts) for bucket in BUCKETS}
    return {
        "hosts": len(hosts),
        "elapsed_s": elapsed,
        "buckets_s": buckets,
        "goodput_pct": 100.0 * buckets["step"] / elapsed if elapsed > 0 else 0.0,
        "lost_s_by_cause": {
            bucket: seconds for bucket, seconds in buckets.items() if bucket != "step"
        },
        "per_host": hosts,
    }


def ledger_from_dir(
    logging_dir: str, max_trace_bytes: int | None = None
) -> dict | None:
    """The ledger for a run's ``logging_dir`` — parses every
    ``traces/host_*.trace.json`` (skipping rows with an unknown ``schema``,
    like every other reader) and aggregates across hosts. Returns None when
    there are no traces (diagnostics off) or they exceed ``max_trace_bytes``
    (``ACCELERATE_GOODPUT_MAX_TRACE_BYTES`` overrides the default)."""
    from ..diagnostics.tracing import TRACE_SUBDIR, parse_trace_file

    if max_trace_bytes is None:
        max_trace_bytes = int(
            os.environ.get(
                "ACCELERATE_GOODPUT_MAX_TRACE_BYTES", str(DEFAULT_MAX_TRACE_BYTES)
            )
        )
    paths = sorted(glob.glob(os.path.join(logging_dir, TRACE_SUBDIR, "host_*.trace.json")))
    if not paths:
        return None
    try:
        total_bytes = sum(os.path.getsize(p) for p in paths)
    except OSError:
        total_bytes = 0
    if max_trace_bytes and total_bytes > max_trace_bytes:
        logger.warning(
            "goodput: trace trail is %d bytes (> %d cap), skipping attribution",
            total_bytes, max_trace_bytes,
        )
        return None
    hosts = []
    for path in paths:
        base = os.path.basename(path)
        try:
            host = int(base.split("_")[1].split(".")[0])
        except (IndexError, ValueError):
            host = base
        ledger = ledger_from_events(parse_trace_file(path), host=host)
        if ledger is not None:
            hosts.append(ledger)
    if not hosts:
        return None
    return _aggregate(hosts)


#: the ledger re-parses every trace trail from scratch — consumers that run
#: on a cadence (the monitor's repaint loop, the sidecar answering a
#: per-second Prometheus scrape) must not do that continuously on a fat
#: trail, so they share this per-logging_dir throttle (the panel's numbers
#: move on the scale of minutes by nature)
GOODPUT_REFRESH_SECONDS = 10.0
_throttle_cache: dict[str, tuple[float, dict | None]] = {}


def throttled_from_dir(cache, logging_dir, min_interval_s, compute):
    """Shared per-logging_dir throttle for cadence consumers (the monitor
    repaint loop, a per-second scrape): run ``compute(logging_dir)`` at
    most every ``min_interval_s`` per dir, caching in ``cache``; errors
    degrade to a cached None, never propagate — a broken trail must not
    kill a monitor/exporter loop. Also backs the request-trace tail panel
    (:mod:`accelerate_tpu_torch.diagnostics.reqtrace`)."""
    key = os.path.abspath(logging_dir)
    cached = cache.get(key)
    now = time.monotonic()
    if cached is not None and now - cached[0] < min_interval_s:
        return cached[1]
    try:
        result = compute(logging_dir)
    except Exception:
        logger.warning("%s failed for %s", getattr(compute, "__name__", "compute"),
                       logging_dir, exc_info=True)
        result = None
    cache[key] = (now, result)
    return result


def ledger_from_dir_throttled(
    logging_dir: str, min_interval_s: float = GOODPUT_REFRESH_SECONDS
) -> dict | None:
    """:func:`ledger_from_dir`, recomputed at most every
    ``min_interval_s`` per logging_dir."""
    return throttled_from_dir(
        _throttle_cache, logging_dir, min_interval_s, ledger_from_dir
    )
