"""Request-flow reconstruction and tail-latency attribution — the engine
behind ``accelerate-tpu-torch trace tail`` (a copy of
``accelerate_tpu/diagnostics/reqtrace.py``).

The serving stack writes request-scoped events (``cat="request"``, keyed on
the request's ``trace_id``) into per-process trace files: the router's
``submit → dispatch → finish`` half under ``<logging_dir>/traces/`` and
each replica engine's ``arrive → admit → prefill → first_token → finish``
half under ``replica_<i>/traces/``. This module reads those files back,
stitches every request's events into one wall-clock-corrected timeline, and
answers the question aggregates cannot: *which phase* made the slowest
requests slow.

Phase model (TTFT decomposition — the phases sum to the span-derived TTFT):

* ``queued``    — arrival → first admission (waiting for a slot behind
  other requests' prefills/decodes);
* ``swap_in``   — restoring a preempted request's KV rows from host DRAM
  (the explicit ``seconds`` each ``req/swap_in`` event carries);
* ``preempted`` — swapped out and waiting to be re-admitted;
* ``prefill``   — the remainder: admitted and actually prefilling/decoding
  toward the first token.

TTFT itself is computed from the spans (``req/first_token.ts`` minus
``req/arrive.ts``) — both events are stamped with the engine's own timing
fields, so the number equals the engine-reported ``ttft_s`` rather than
approximating it. The attribution table over the slowest-K set is the
direct input to scaling decisions: "p99 TTFT is 62% queued" wants more
replicas (or disaggregated prefill); "62% swap_in" wants a bigger pool.
"""

from __future__ import annotations

import os

from .tracing import (
    REQUEST_CATEGORY,
    discover_trace_files,
    iter_offset_events,
    parse_trace_file,
)

__all__ = [
    "collect_request_flows",
    "collect_iterations",
    "request_timeline",
    "tail_report",
    "iteration_report",
    "render_tail_report",
    "render_iteration_report",
    "tail_from_dir_throttled",
]

#: TTFT phases in render order (highest-leverage first when equal)
TTFT_PHASES = ("queued", "prefill", "swap_in", "preempted")

#: the flight recorder's exclusive iteration phases, in stamp order —
#: mirrors ``accelerate_tpu_torch.serving.flight.ITERATION_PHASES`` (hardcoded
#: so this reader imports without the serving package; a test pins
#: the two tuples against each other)
ITERATION_PHASES = ("schedule", "prefill", "dispatch", "device_wait", "harvest")

#: skip trails bigger than this (the monitor repaints; a multi-GB trace
#: trail must not be re-parsed per refresh) — same contract as the goodput
#: ledger's ACCELERATE_GOODPUT_MAX_TRACE_BYTES
DEFAULT_MAX_TRACE_BYTES = 256 * 1024 * 1024


def _max_trace_bytes() -> int:
    try:
        return int(
            os.environ.get("ACCELERATE_REQTRACE_MAX_TRACE_BYTES", "")
            or DEFAULT_MAX_TRACE_BYTES
        )
    except ValueError:
        return DEFAULT_MAX_TRACE_BYTES


def collect_request_flows(
    logging_dir: str | None = None, paths: list[str] | None = None
) -> dict[str, list[dict]]:
    """Every request-scoped event under ``logging_dir`` (router + all
    replicas), grouped by trace id and sorted on the wall-corrected
    timestamp. Each event dict carries ``name``/``ph``/``ts`` (wall µs)/
    ``args``/``role`` (the writing process's ``process_name``)."""
    if paths is None:
        paths = discover_trace_files(logging_dir)
    flows: dict[str, list[dict]] = {}
    for path in paths:
        role = os.path.basename(os.path.dirname(os.path.dirname(path))) or path
        # sequential clock_sync epochs via the shared iterator, so this
        # reader and merge_traces agree on every wall timestamp
        for e, offset_us in iter_offset_events(parse_trace_file(path)):
            if e.get("ph") == "M":
                args = e.get("args") or {}
                if e.get("name") == "process_name" and args.get("name"):
                    role = str(args["name"])
                continue
            if e.get("cat") != REQUEST_CATEGORY or "id" not in e:
                continue
            try:
                ts = float(e.get("ts", 0.0)) + offset_us
            except (TypeError, ValueError):
                continue
            flows.setdefault(str(e["id"]), []).append(
                {
                    "name": e.get("name"),
                    "ph": e.get("ph"),
                    "ts": ts,
                    "args": e.get("args") or {},
                    "role": role,
                }
            )
    for events in flows.values():
        events.sort(key=lambda ev: ev["ts"])
    return flows


def collect_iterations(
    logging_dir: str | None = None, paths: list[str] | None = None
) -> list[dict]:
    """Every engine iteration's ``serve/flight`` instant under
    ``logging_dir`` (all replicas), wall-corrected and sorted by
    timestamp. Each dict carries ``role``/``ts`` (wall µs) plus the flight
    entry's fields (``iteration``, ``wall_s``, ``<phase>_s``) — the same
    numbers ``stats()`` aggregates, read back from the trace trail."""
    if paths is None:
        paths = discover_trace_files(logging_dir)
    iterations: list[dict] = []
    for path in paths:
        role = os.path.basename(os.path.dirname(os.path.dirname(path))) or path
        for e, offset_us in iter_offset_events(parse_trace_file(path)):
            if e.get("ph") == "M":
                args = e.get("args") or {}
                if e.get("name") == "process_name" and args.get("name"):
                    role = str(args["name"])
                continue
            if e.get("name") != "serve/flight" or e.get("ph") != "i":
                continue
            args = e.get("args") or {}
            try:
                ts = float(e.get("ts", 0.0)) + offset_us
                wall = float(args["wall_s"])
                phases = {p: float(args[f"{p}_s"]) for p in ITERATION_PHASES}
            except (KeyError, TypeError, ValueError):
                continue  # foreign/older trail row: skip, never raise
            # optional (absent on pre-async and synchronous-engine rows):
            # host time run under an in-flight dispatch — parsed with a
            # 0.0 default OUTSIDE the skip guard so old trails keep reading
            try:
                overlap = float(args.get("overlap_hidden_s", 0.0) or 0.0)
            except (TypeError, ValueError):
                overlap = 0.0
            row = {"role": role, "ts": ts,
                   "iteration": args.get("iteration"), "wall_s": wall,
                   "overlap_hidden_s": overlap}
            for p in ITERATION_PHASES:
                row[f"{p}_s"] = phases[p]
            iterations.append(row)
    iterations.sort(key=lambda r: r["ts"])
    return iterations


def iteration_report(
    logging_dir: str | None = None,
    paths: list[str] | None = None,
    k: int = 10,
) -> dict:
    """The slowest-``k`` engine iterations by wall time with per-phase
    attribution over that tail, plus the cumulative host-vs-device split
    over *all* recorded iterations — computed exactly like the engine's
    ``stats()['host_fraction']`` (1 − (Σdevice_wait + Σoverlap_hidden) /
    Σwall; the overlap term is 0 on synchronous-engine and pre-async
    trails), so the two surfaces agree on the ROADMAP item-5 number by
    construction."""
    rows = collect_iterations(logging_dir, paths=paths)
    wall_total = sum(r["wall_s"] for r in rows)
    phase_totals = {
        p: sum(r[f"{p}_s"] for r in rows) for p in ITERATION_PHASES
    }
    overlap_total = sum(r.get("overlap_hidden_s", 0.0) for r in rows)
    host_fraction = (
        max(0.0, 1.0 - (phase_totals["device_wait"] + overlap_total) / wall_total)
        if wall_total > 0 else 0.0
    )
    tail = sorted(rows, key=lambda r: -r["wall_s"])[: max(1, int(k))]
    attribution: dict[str, float] = {}
    tail_wall = sum(r["wall_s"] for r in tail)
    if tail_wall > 0:
        attribution = {
            p: 100.0 * sum(r[f"{p}_s"] for r in tail) / tail_wall
            for p in ITERATION_PHASES
        }
    return {
        "iterations": len(rows),
        "k": len(tail) if rows else 0,
        "wall_total_s": wall_total,
        "phase_totals_s": phase_totals,
        "overlap_hidden_total_s": overlap_total,
        "host_fraction": host_fraction,
        "device_fraction": 1.0 - host_fraction,
        "tail": tail if rows else [],
        "attribution": attribution,
    }


def render_iteration_report(report: dict) -> str:
    """Terminal table for ``accelerate-tpu trace tail --iterations`` —
    the host-vs-device attribution the async-engine refactor is judged
    against."""
    lines = [
        f"{report['iterations']} engine iteration(s) traced, "
        f"{report['wall_total_s']:.4f}s wall: "
        f"host {100.0 * report['host_fraction']:.1f}%  "
        f"device {100.0 * report['device_fraction']:.1f}%"
    ]
    if report.get("overlap_hidden_total_s"):
        lines.append(
            f"overlap hidden: {report['overlap_hidden_total_s']:.4f}s host "
            "work run under an in-flight dispatch (off the critical path; "
            "counted as device time above)"
        )
    if report["attribution"]:
        lines.append(
            "slowest-tail attribution: "
            + "   ".join(
                f"{phase} {pct:.1f}%"
                for phase, pct in sorted(
                    report["attribution"].items(), key=lambda kv: -kv[1]
                )
            )
        )
    if report["tail"]:
        lines.append(
            f"  {'role':<12} {'iter':>6} {'wall_s':>9} "
            + " ".join(f"{p:>11}" for p in ITERATION_PHASES)
        )
        for r in report["tail"]:
            lines.append(
                f"  {str(r['role'])[:12]:<12} "
                f"{str(r.get('iteration') if r.get('iteration') is not None else '-'):>6} "
                f"{r['wall_s']:>9.5f} "
                + " ".join(f"{r[f'{p}_s']:>11.5f}" for p in ITERATION_PHASES)
            )
    else:
        lines.append("  (no iteration events — is tracing armed and "
                     "flight_history > 0?)")
    return "\n".join(lines)


def _first(events: list[dict], name: str) -> dict | None:
    for e in events:
        if e["name"] == name:
            return e
    return None


#: the engine-side lifecycle vocabulary (everything else under the trace id
#: is the router's half)
_ENGINE_EVENTS = frozenset((
    "req/arrive", "req/admit", "req/prefill_chunk", "req/first_token",
    "req/preempt", "req/swap_in", "req/finish",
))


def _engine_half(events: list[dict]) -> tuple[list[dict], int]:
    """The engine lifecycle this request's *delivered* answer came from,
    plus the total engine-finish count across all processes.

    One trace id can legitimately hold TWO full engine lifecycles: a
    ``request_timeout`` expiry on a slow-but-alive replica requeues the
    ticket while the first replica keeps decoding, and both engines write
    arrive→…→finish under the same id. The router delivers the FIRST
    answer, so the half whose engine finish comes earliest is the one the
    caller actually observed — pairing A's arrival with B's first token
    would report a TTFT matching neither."""
    halves: dict[str, list[dict]] = {}
    finish_total = 0
    for e in events:
        if e["name"] not in _ENGINE_EVENTS:
            continue
        if e["name"] == "req/finish" and "finish_reason" not in e["args"]:
            continue  # the router's end event, not an engine lifecycle
        halves.setdefault(e["role"], []).append(e)
        if e["name"] == "req/finish":
            finish_total += 1
    best = None
    for evs in halves.values():
        if _first(evs, "req/arrive") is None:
            continue
        finish = next(
            (x for x in evs if x["name"] == "req/finish"), None
        )
        rank = (0, finish["ts"]) if finish is not None else (1, evs[0]["ts"])
        if best is None or rank < best[0]:
            best = (rank, evs)
    return (best[1] if best is not None else []), finish_total


def request_timeline(trace_id: str, events: list[dict]) -> dict:
    """One request's reconstructed lifecycle + TTFT phase decomposition.

    ``complete`` means the engine half is whole: an arrival, a terminal
    finish with a reason, and — for answered requests — a first token.
    Requests the engine expired while queued finish without one; they are
    complete too (their TTFT is simply unknown)."""
    submit = _first(events, "req/submit")
    dispatch = _first(events, "req/dispatch")
    router_finish = None
    for e in events:
        if e["name"] == "req/finish" and "finish_reason" not in e["args"]:
            router_finish = e
    engine_events, finish_events = _engine_half(events)
    arrive = _first(engine_events, "req/arrive")
    first_token = _first(engine_events, "req/first_token")
    engine_finish = next(
        (e for e in engine_events if e["name"] == "req/finish"), None
    )
    admits = [e for e in engine_events if e["name"] == "req/admit"]
    out: dict = {
        "trace_id": trace_id,
        "roles": sorted({e["role"] for e in events}),
        "events": len(events),
        "engine_finish_events": finish_events,
        "ttft_s": None,
        "tpot_s": None,
        "finish_reason": None,
        "new_tokens": None,
        "phases": {},
        "router_queue_s": None,
        "attempts": None,
        "complete": False,
    }
    if router_finish is not None:
        out["attempts"] = router_finish["args"].get("attempts")
    if submit is not None and dispatch is not None:
        out["router_queue_s"] = max(0.0, (dispatch["ts"] - submit["ts"]) / 1e6)
    if engine_finish is not None:
        out["finish_reason"] = engine_finish["args"].get("finish_reason")
        out["new_tokens"] = engine_finish["args"].get("new_tokens")
        out["tpot_s"] = engine_finish["args"].get("tpot_s")
    if arrive is None:
        return out
    if first_token is not None:
        ttft = (first_token["ts"] - arrive["ts"]) / 1e6
        out["ttft_s"] = ttft
        cutoff = first_token["ts"]
        queued = (
            max(0.0, (admits[0]["ts"] - arrive["ts"]) / 1e6) if admits else 0.0
        )
        swap_in = sum(
            float(e["args"].get("seconds") or 0.0)
            for e in engine_events
            if e["name"] == "req/swap_in" and e["ts"] <= cutoff
        )
        preempted = 0.0
        for e in engine_events:
            if e["name"] != "req/preempt" or e["ts"] > cutoff:
                continue
            readmit = next(
                (a for a in admits if a["ts"] >= e["ts"]), first_token
            )
            preempted += max(0.0, (readmit["ts"] - e["ts"]) / 1e6)
        prefill = max(0.0, ttft - queued - swap_in - preempted)
        out["phases"] = {
            "queued": queued,
            "prefill": prefill,
            "swap_in": swap_in,
            "preempted": preempted,
        }
    out["complete"] = engine_finish is not None and (
        first_token is not None or out["finish_reason"] == "deadline_exceeded"
    )
    return out


def tail_report(
    logging_dir: str | None = None,
    paths: list[str] | None = None,
    k: int = 10,
    metric: str = "ttft",
) -> dict:
    """The slowest-``k`` requests by ``metric`` (``"ttft"`` or ``"tpot"``)
    with a per-phase attribution table over exactly that tail set —
    "where did the p99 go"."""
    if metric not in ("ttft", "tpot"):
        raise ValueError(f"unknown tail metric {metric!r}: want ttft or tpot")
    key = f"{metric}_s"
    flows = collect_request_flows(logging_dir, paths=paths)
    timelines = [request_timeline(tid, evs) for tid, evs in flows.items()]
    measured = [t for t in timelines if t[key] is not None]
    measured.sort(key=lambda t: -t[key])
    tail = measured[: max(1, int(k))]
    attribution: dict[str, float] = {}
    if metric == "ttft":
        totals = {phase: 0.0 for phase in TTFT_PHASES}
        for t in tail:
            for phase in TTFT_PHASES:
                totals[phase] += t["phases"].get(phase, 0.0)
        grand = sum(totals.values())
        if grand > 0:
            attribution = {
                phase: 100.0 * seconds / grand
                for phase, seconds in totals.items()
            }
    return {
        "metric": metric,
        "k": len(tail),
        "total_requests": len(timelines),
        "measured_requests": len(measured),
        "incomplete": sum(1 for t in timelines if not t["complete"]),
        "tail": tail,
        "attribution": attribution,
    }


def render_tail_report(report: dict) -> str:
    """Terminal table for ``accelerate-tpu trace tail`` (and the monitor
    panel's one-liner comes from the same attribution dict)."""
    metric = report["metric"]
    lines = [
        f"slowest {report['k']} of {report['measured_requests']} measured "
        f"request(s) by {metric.upper()} "
        f"({report['total_requests']} traced, "
        f"{report['incomplete']} incomplete)"
    ]
    if report["attribution"]:
        lines.append(
            "tail attribution: "
            + "   ".join(
                f"{phase} {pct:.1f}%"
                for phase, pct in sorted(
                    report["attribution"].items(), key=lambda kv: -kv[1]
                )
            )
        )
    if report["tail"]:
        lines.append(
            f"  {'trace_id':<18} {metric + '_s':>9} "
            + " ".join(f"{p:>9}" for p in TTFT_PHASES)
            + f" {'attempts':>8}  finish"
        )
        for t in report["tail"]:
            phases = t.get("phases") or {}
            lines.append(
                f"  {t['trace_id'][:18]:<18} {t[metric + '_s']:>9.4f} "
                + " ".join(
                    f"{phases.get(p, 0.0):>9.4f}" for p in TTFT_PHASES
                )
                + f" {str(t.get('attempts') if t.get('attempts') is not None else '-'):>8}"
                + f"  {t.get('finish_reason') or '?'}"
            )
    else:
        lines.append("  (no measured requests — is request tracing armed?)")
    return "\n".join(lines)


#: monitor-panel throttle (the repaint loop must not re-parse the trails
#: 30x/minute), keyed per logging_dir like the goodput ledger's cache
TAIL_REFRESH_SECONDS = 10.0
_throttle_cache: dict[str, tuple[float, dict | None]] = {}


def tail_from_dir_throttled(
    logging_dir: str, min_interval_s: float = TAIL_REFRESH_SECONDS, k: int = 3
) -> dict | None:
    """:func:`tail_report`, recomputed at most every ``min_interval_s`` per
    logging_dir (the goodput ledger's shared throttle); None when no
    request events exist or the trail exceeds the byte cap."""
    from ..metrics.goodput import throttled_from_dir

    def compute(d):
        paths = discover_trace_files(d)
        if not paths or sum(os.path.getsize(p) for p in paths) > _max_trace_bytes():
            return None
        report = tail_report(paths=paths, k=k)
        return report if report["measured_requests"] else None

    compute.__name__ = "request_tail"
    return throttled_from_dir(_throttle_cache, logging_dir, min_interval_s, compute)
