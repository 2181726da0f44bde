"""Live run status from a ``logging_dir`` — the `monitor` engine (a copy of
``accelerate_tpu/diagnostics/monitor.py``).

Everything here reads the observability artifacts the training processes
already write (telemetry JSONL, heartbeat files, hang reports) — the
monitor never talks to the job, so it works on a run that is wedged, from
a different machine over a shared filesystem, or post-mortem on a dead
one. Pure functions (collect → render) so tests and other tooling can
consume the status dict directly.

The heartbeat files and hang reports are written by the port's hang
watchdog (:mod:`.watchdog`). The per-host collective digests are written by
a module the port does not have yet (the compiled programs' sanitizer,
ROADMAP item 23); their reader is copied here, so that panel shows what a
run without that writer shows.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any

#: where the hang watchdog writes its heartbeat files (JAX
#: ``diagnostics/watchdog.py``), and the sanitizer its collective digests
HEARTBEAT_SUBDIR = "diagnostics"
DIGEST_SUBDIR = "diagnostics"
_DIGEST_PREFIX = "collectives_host_"

#: a heartbeat older than max(multiplier · host EMA, floor) flags the host
STALE_FLOOR_S = 30.0
STALE_MULTIPLIER = 10.0
#: a live host this many steps behind the front-runner is named a straggler
STRAGGLER_LAG_STEPS = 10
#: a serving replica whose newest router row is older than this (while the
#: router ticks every ~0.5s) is wedged-or-dead; a `terminated` row is clean
#: history and never ages into an alarm
ROUTER_STALE_S = 15.0
#: newest router-row schema this reader understands (rows stamped newer are
#: skipped, like telemetry rows)
ROUTER_SCHEMA_SUPPORTED = 1


def _tail_jsonl(path: str, max_records: int = 500) -> list[dict]:
    """Last ``max_records`` parsed records of a JSONL file without reading
    a multi-GB trail into memory (bounded backward seek)."""
    records: list[dict] = []
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            # ~300 bytes/record is generous; clamp the read window
            window = min(size, max_records * 512)
            f.seek(size - window)
            chunk = f.read().decode("utf-8", errors="replace")
        lines = chunk.splitlines()
        if window < size and lines:
            lines = lines[1:]  # first line may be torn by the seek
        for line in lines[-max_records:]:
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    except OSError:
        pass
    return records


def _tail_trail(jsonl_path: str, max_records: int = 500) -> tuple[list[dict], int]:
    """Tail of the whole (possibly rotated) telemetry trail: newest segment
    first, walking back through ``telemetry.jsonl.N`` until ``max_records``
    are gathered. Rows stamped with a newer ``schema`` than this reader
    understands are skipped (returned as a count, surfaced in the render)
    instead of KeyError-ing downstream."""
    from ..telemetry import schema_compatible, telemetry_segments

    records: list[dict] = []
    for segment in reversed(telemetry_segments(jsonl_path)):
        chunk = _tail_jsonl(segment, max_records - len(records))
        records = chunk + records
        if len(records) >= max_records:
            break
    compatible = [r for r in records if schema_compatible(r)]
    return compatible, len(records) - len(compatible)


def _trail_head(jsonl_path: str) -> dict | None:
    """First parseable, schema-compatible record of the OLDEST surviving
    segment — anchors run-wide rates (the tail window alone shrinks with
    record rate and would wildly extrapolate a single event)."""
    from ..telemetry import schema_compatible, telemetry_segments

    for segment in telemetry_segments(jsonl_path):
        try:
            with open(segment, "rb") as f:
                chunk = f.read(64 * 1024)
        except OSError:
            continue
        for line in chunk.splitlines():
            try:
                record = json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(record, dict) and schema_compatible(record):
                return record
    return None


#: rates (recompiles/hour) need at least this much observed wall before
#: they can back an SLO threshold — one benign event in a seconds-wide
#: window must not extrapolate into a page
MIN_RATE_WINDOW_S = 600.0


def collect_status(logging_dir: str, now: float | None = None) -> dict[str, Any]:
    """One snapshot of run health:

    * ``steps``/``step_rate``/``mfu``/``tokens_per_sec``/``recompiles`` from
      the telemetry JSONL tail (main-process trail),
    * per-host ``hosts`` entries from the heartbeat files, each with
      ``lag_steps`` (behind the front-runner) and ``stale_s``,
    * ``stragglers`` / ``wedged`` — hosts behind on steps / heartbeat-silent
      beyond their own deadline,
    * ``hang_reports`` — any ``HANG_REPORT_*.json`` with its stalled phase.
    """
    now = time.time() if now is None else now
    status: dict[str, Any] = {
        "logging_dir": logging_dir,
        "ts": now,
        "steps": None,
        "optimizer_steps": None,
        "step_time_s": None,
        "step_rate": None,
        "examples_per_sec": None,
        "tokens_per_sec": None,
        "mfu": None,
        "recompiles": None,
        "recompiles_per_hour": None,
        "last_record_age_s": None,
        "serving": None,
        "goodput": None,
        "request_tail": None,
        "skipped_unknown_schema": 0,
        "hosts": [],
        "stragglers": [],
        "wedged": [],
        "hang_reports": [],
        "race_reports": [],
        "collective_divergence": [],
        "fleet": [],
        "fleet_dead": [],
        "router": None,
        "slo": None,
        "scale_decisions": [],
    }

    # -- telemetry tail ------------------------------------------------------
    jsonl = os.path.join(logging_dir, "telemetry", "telemetry.jsonl")
    records, status["skipped_unknown_schema"] = _tail_trail(jsonl)
    steps = [r for r in records if r.get("type") == "step"]
    if steps:
        last = steps[-1]
        status["steps"] = last.get("step")
        status["optimizer_steps"] = last.get("optimizer_steps")
        status["recompiles"] = last.get("recompiles")
        recent = steps[-20:]
        times = [r["step_time_s"] for r in recent if r.get("step_time_s")]
        if times:
            times.sort()
            median = times[len(times) // 2]
            status["step_time_s"] = median
            status["step_rate"] = 1.0 / median if median > 0 else None
        for key in ("examples_per_sec", "tokens_per_sec", "mfu"):
            vals = [r[key] for r in recent if r.get(key) is not None]
            if vals:
                status[key] = vals[-1]
        if last.get("ts"):
            status["last_record_age_s"] = max(0.0, now - float(last["ts"]))

    # recompile rate over the WHOLE surviving trail (an SLO-rule input):
    # the cumulative `recompiles` field on the newest step row minus the
    # trail head's baseline, over the head→now wall window. Anchoring on
    # the head (not the 500-record tail, whose width shrinks with record
    # rate) plus a minimum-window floor keeps one benign recompile from
    # extrapolating into a page.
    if steps:
        head = _trail_head(jsonl)
        last = steps[-1]
        t0 = (head or {}).get("ts")
        t1 = last.get("ts")
        if (
            isinstance(t0, (int, float))
            and isinstance(t1, (int, float))
            and t1 - t0 >= MIN_RATE_WINDOW_S
            and isinstance(last.get("recompiles"), (int, float))
        ):
            baseline = head.get("recompiles")
            baseline = baseline if isinstance(baseline, (int, float)) else 0
            window_hours = (t1 - t0) / 3600.0
            status["recompiles_per_hour"] = (
                max(0.0, last["recompiles"] - baseline) / window_hours
            )

    # -- serving engine rows -------------------------------------------------
    serving = [r for r in records if r.get("type") == "serving"]
    srv_steps = [r for r in serving if r.get("kind") == "step"]
    srv_reqs = [r for r in serving if r.get("kind") == "request"]
    if srv_steps or srv_reqs:
        last_step = srv_steps[-1] if srv_steps else {}
        ttfts = sorted(r["ttft_s"] for r in srv_reqs if r.get("ttft_s") is not None)
        status["serving"] = {
            "tokens_per_sec": last_step.get("tokens_per_sec"),
            "queue_depth": last_step.get("queue_depth"),
            "slot_occupancy": last_step.get("slot_occupancy"),
            "free_blocks": last_step.get("free_blocks"),
            "decode_compiles": last_step.get("decode_compiles"),
            # run-total: the step row's cumulative counter (the JSONL tail
            # is bounded, so counting request rows windows long runs) plus
            # request rows newer than it (the counter lags by up to one
            # stats interval). Counting rows older than the step row would
            # resurrect totals from a previous run in the appended trail.
            "completed": (
                int(last_step["completed_total"])
                + sum(
                    1 for r in srv_reqs
                    if (r.get("ts") or 0) > (last_step.get("ts") or 0)
                )
                if last_step.get("completed_total") is not None
                else len(srv_reqs)
            ),
            # percentiles over the tail's recent requests (windowed by design)
            "ttft_p50_s": ttfts[len(ttfts) // 2] if ttfts else None,
            "ttft_p99_s": (
                ttfts[min(len(ttfts) - 1, int(0.99 * len(ttfts)))] if ttfts else None
            ),
            # prefix-cache + swap-preemption health (cumulative step-row
            # counters, so the bounded tail still shows run totals)
            "prefix_hit_ratio": last_step.get("prefix_hit_ratio"),
            "preemptions": last_step.get("preemptions"),
            "swapped_out_blocks": last_step.get("swapped_out_blocks"),
            "out_of_blocks_total": last_step.get("out_of_blocks_total"),
            # kv_dtype policy rows (quantized KV cache)
            "kv_dtype": last_step.get("kv_dtype"),
            "kv_bytes_per_token": last_step.get("kv_bytes_per_token"),
            "kv_slot_capacity": last_step.get("kv_slot_capacity"),
            # speculative decoding (cumulative step-row counters + the
            # accept-rate gauge — absent entirely when spec is off)
            "spec_k": last_step.get("spec_k"),
            "spec_draft": last_step.get("spec_draft"),
            "spec_accept_rate": last_step.get("spec_accept_rate"),
            "spec_drafted_tokens": last_step.get("spec_drafted_tokens"),
            "spec_accepted_tokens": last_step.get("spec_accepted_tokens"),
            # per-slot sampling + constrained decoding (cumulative step-row
            # counters — absent on a per_slot_sampling=False engine)
            "sampled_tokens_greedy": last_step.get("sampled_tokens_greedy"),
            "sampled_tokens_sample": last_step.get("sampled_tokens_sample"),
            "grammar_masked_steps": last_step.get("grammar_masked_steps"),
            "rejection_accept_rate": last_step.get("rejection_accept_rate"),
            # flight-recorder iteration attribution + HBM watermarks
            # (gauges riding the step rows — absent on flight_history=0)
            "host_fraction": last_step.get("host_fraction"),
            "overlap_hidden_s": last_step.get("overlap_hidden_s"),
            "iteration_p50_s": last_step.get("iteration_p50_s"),
            "iteration_p99_s": last_step.get("iteration_p99_s"),
            "flight_phase": last_step.get("flight_phase"),
            "hbm_used_bytes": last_step.get("hbm_used_bytes"),
            "hbm_headroom_bytes": last_step.get("hbm_headroom_bytes"),
            "hbm_bytes_source": last_step.get("hbm_bytes_source"),
            # usage ledger snapshot (conservation-checked per-request
            # attribution — absent on usage_accounting=False engines)
            "usage": last_step.get("usage"),
        }
        last_ts = serving[-1].get("ts")
        if last_ts:
            age = max(0.0, now - float(last_ts))
            status["last_record_age_s"] = (
                age
                if status["last_record_age_s"] is None
                else min(status["last_record_age_s"], age)
            )

    # -- heartbeats ----------------------------------------------------------
    hb_glob = os.path.join(logging_dir, HEARTBEAT_SUBDIR, "heartbeat_*.json")
    hosts: list[dict] = []
    for path in sorted(glob.glob(hb_glob)):
        try:
            with open(path) as f:
                hb = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        hb["stale_s"] = max(0.0, now - float(hb.get("ts", 0.0)))
        hosts.append(hb)
    max_step = max((h.get("step") or 0 for h in hosts), default=0)
    for h in hosts:
        h["lag_steps"] = max_step - (h.get("step") or 0)
        ema = h.get("ema_step_s")
        deadline = max(STALE_MULTIPLIER * ema, STALE_FLOOR_S) if ema else STALE_FLOOR_S
        if h["stale_s"] > deadline or h.get("fired"):
            status["wedged"].append(h["host"])
        elif h["lag_steps"] > STRAGGLER_LAG_STEPS:
            status["stragglers"].append(h["host"])
    status["hosts"] = hosts

    # -- hang reports --------------------------------------------------------
    for path in sorted(glob.glob(os.path.join(logging_dir, "HANG_REPORT_*.json"))):
        try:
            with open(path) as f:
                report = json.load(f)
            status["hang_reports"].append(
                {
                    "path": path,
                    "host": report.get("host"),
                    "stalled_phase": report.get("stalled_phase"),
                    "elapsed_s": report.get("elapsed_s"),
                    "ts": report.get("ts"),
                    # serving hangs: the flight recorder names the exact
                    # engine phase the iteration died in
                    "flight_phase": (report.get("flight_tail") or {}).get(
                        "current_phase"
                    ),
                }
            )
        except (OSError, json.JSONDecodeError):
            status["hang_reports"].append({"path": path})

    # -- race reports (LockWatch lock-order violations) ----------------------
    for path in sorted(glob.glob(os.path.join(logging_dir, "RACE_REPORT_*.json"))):
        try:
            with open(path) as f:
                report = json.load(f)
            status["race_reports"].append(
                {
                    "path": path,
                    "host": report.get("host"),
                    "acquiring": report.get("acquiring"),
                    "while_holding": report.get("while_holding"),
                    "cycle": report.get("cycle"),
                    "ts": report.get("ts"),
                }
            )
        except (OSError, json.JSONDecodeError):
            status["race_reports"].append({"path": path})

    # -- serving fleet (the router's per-replica JSONL trail) ----------------
    fleet_trail = os.path.join(logging_dir, "router", "replicas.jsonl")
    if os.path.exists(fleet_trail):
        latest: dict[int, dict] = {}
        for row in _tail_jsonl(fleet_trail, max_records=500):
            schema = row.get("schema")
            if isinstance(schema, int) and schema > ROUTER_SCHEMA_SUPPORTED:
                status["skipped_unknown_schema"] += 1
                continue
            rid = row.get("replica_id")
            if rid is not None:
                latest[rid] = row  # rows are append-ordered: newest wins
            elif row.get("kind") == "router":
                # aggregate supervisor/admission totals, one row per tick
                status["router"] = row
            elif row.get("kind") == "scale_decision":
                # the supervisor's SLO-policy verdicts (append-ordered)
                status["scale_decisions"].append(row)
        for rid in sorted(latest):
            row = dict(latest[rid])
            row["row_age_s"] = (
                max(0.0, now - float(row["ts"])) if row.get("ts") else None
            )
            state = row.get("state")
            # dead = the router said so, or a live-state replica whose rows
            # stopped (router crashed / box gone) — `terminated` is a clean
            # shutdown and never alarms, however old the trail
            row["dead"] = state == "dead" or (
                state in ("starting", "ready", "draining")
                and row["row_age_s"] is not None
                and row["row_age_s"] > ROUTER_STALE_S
            )
            if row["dead"]:
                status["fleet_dead"].append(rid)
            status["fleet"].append(row)

    # -- collective-sequence digests (written per host by the sanitizer,
    # analysis/compiled.py): hosts whose compiled programs disagree on
    # collective order WILL deadlock at the first mismatched rendezvous —
    # naming the divergent host here is the pre-deadlock diagnosis --------
    digests = _read_host_digests(logging_dir)
    if len(digests) >= 2:
        status["collective_divergence"] = _diff_host_digests(digests)

    # -- goodput ledger (trace trails; None when diagnostics is off or the
    # trail exceeds the parse cap — throttled per logging_dir so the repaint
    # loop never re-parses a fat trail 30x/minute; a `--once` probe runs in
    # a fresh process and computes fresh by construction) --------------------
    from ..metrics.goodput import ledger_from_dir_throttled

    status["goodput"] = ledger_from_dir_throttled(logging_dir)

    # -- request-trace tail (slowest requests + phase attribution from the
    # request-scoped trace events; throttled like the goodput ledger, None
    # when request tracing is off) -------------------------------------------
    from .reqtrace import tail_from_dir_throttled

    status["request_tail"] = tail_from_dir_throttled(logging_dir)

    # -- SLO verdict (ALERTS.json, written by the exporter / monitor --once /
    # metrics export — schema 2 carries the full windowed scorecard) ---------
    from ..metrics.alerts import ALERTS_FILENAME

    alerts_path = os.path.join(logging_dir, ALERTS_FILENAME)
    if os.path.exists(alerts_path):
        try:
            with open(alerts_path) as f:
                slo = json.load(f)
            if isinstance(slo, dict):
                status["slo"] = slo
        except (OSError, json.JSONDecodeError):
            pass
    return status


def _read_host_digests(logging_dir: str) -> dict[int, dict]:
    """{host: {label: digest_record}} from every digest file under the
    logging dir. Pure file reads."""
    out: dict[int, dict] = {}
    directory = os.path.join(logging_dir, DIGEST_SUBDIR)
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith(_DIGEST_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                data = json.load(f)
            out[int(data.get("host", name[len(_DIGEST_PREFIX):-5]))] = data.get(
                "digests", {}
            )
        except (OSError, json.JSONDecodeError, ValueError):
            continue
    return out


def _diff_host_digests(digests: dict[int, dict]) -> list[dict]:
    """Labels on which hosts disagree, with the minority host(s) named:
    ``[{label, digests: {host: digest}, divergent_hosts: [...], tie: bool}]``.
    The majority digest is presumed correct — in a pre-deadlock divergence
    the straggler minority is the actionable name. When no digest holds a
    strict majority (e.g. two hosts split 1-1) there is no side to presume
    correct: every disagreeing host is named and ``tie`` is True."""
    labels: set[str] = set()
    for per_host in digests.values():
        labels.update(per_host)
    out = []
    for label in sorted(labels):
        by_host = {
            host: per_host[label].get("digest")
            for host, per_host in digests.items()
            if label in per_host
        }
        distinct = set(by_host.values())
        if len(by_host) >= 2 and len(distinct) > 1:
            counts = {d: sum(1 for v in by_host.values() if v == d) for d in distinct}
            top = max(counts.values())
            tie = sum(1 for c in counts.values() if c == top) > 1
            if tie:
                divergent = sorted(by_host)
            else:
                majority = max(counts, key=lambda d: counts[d])
                divergent = sorted(h for h, d in by_host.items() if d != majority)
            out.append(
                {
                    "label": label,
                    "digests": by_host,
                    "divergent_hosts": divergent,
                    "tie": tie,
                }
            )
    return out


def _fmt(value, pattern="{:.3g}", none="-") -> str:
    return none if value is None else pattern.format(value)


def render_status(status: dict[str, Any]) -> str:
    """The terminal summary `accelerate-tpu monitor` repaints."""
    lines = [
        f"accelerate-tpu monitor — {status['logging_dir']}",
        f"  steps {_fmt(status['steps'], '{}')} "
        f"(opt {_fmt(status['optimizer_steps'], '{}')})   "
        f"step {_fmt(status['step_time_s'], '{:.4f}')}s   "
        f"rate {_fmt(status['step_rate'], '{:.2f}')}/s   "
        f"recompiles {_fmt(status['recompiles'], '{}')}",
        f"  throughput: {_fmt(status['examples_per_sec'], '{:.1f}')} ex/s   "
        f"{_fmt(status['tokens_per_sec'], '{:.0f}')} tok/s   "
        f"MFU {_fmt(status['mfu'], '{:.1%}')}   "
        f"last record {_fmt(status['last_record_age_s'], '{:.0f}')}s ago",
    ]
    srv = status.get("serving")
    if srv:
        lines.append(
            f"  serving: {_fmt(srv['tokens_per_sec'], '{:.0f}')} tok/s   "
            f"queue {_fmt(srv['queue_depth'], '{}')}   "
            f"occupancy {_fmt(srv['slot_occupancy'], '{:.0%}')}   "
            f"free blocks {_fmt(srv['free_blocks'], '{}')}   "
            f"done {srv['completed']} (ttft p50 {_fmt(srv['ttft_p50_s'], '{:.2f}')}s "
            f"p99 {_fmt(srv.get('ttft_p99_s'), '{:.2f}')}s)   "
            f"decode compiles {_fmt(srv['decode_compiles'], '{}')}"
        )
        if srv.get("host_fraction") is not None:
            hbm = ""
            if srv.get("hbm_used_bytes") is not None:
                hbm = (
                    f"   hbm {srv['hbm_used_bytes'] / (1 << 30):.2f} GiB"
                    + (
                        f" (headroom {srv['hbm_headroom_bytes'] / (1 << 30):.2f})"
                        if srv.get("hbm_headroom_bytes") is not None
                        else ""
                    )
                    + (
                        " [estimate]"
                        if srv.get("hbm_bytes_source") == "estimate"
                        else ""
                    )
                )
            # overlap only when the double-buffered engine actually hid
            # host work — sync engines keep the exact legacy line
            overlap = ""
            if srv.get("overlap_hidden_s"):
                overlap = f"   overlap {srv['overlap_hidden_s']:.4f}s hidden"
            lines.append(
                f"  iteration: host {_fmt(srv['host_fraction'], '{:.0%}')}   "
                f"p50 {_fmt(srv.get('iteration_p50_s'), '{:.4f}')}s "
                f"p99 {_fmt(srv.get('iteration_p99_s'), '{:.4f}')}s   "
                f"phase {srv.get('flight_phase') or '?'}" + overlap + hbm
            )
        if srv.get("kv_dtype"):
            lines.append(
                f"  kv cache: {srv['kv_dtype']}   "
                f"{_fmt(srv.get('kv_bytes_per_token'), '{:.0f}')} B/token   "
                f"slot capacity {_fmt(srv.get('kv_slot_capacity'), '{}')}"
            )
        if srv.get("spec_k"):
            lines.append(
                f"  spec: k={srv['spec_k']} ({srv.get('spec_draft') or '?'})   "
                f"accept {_fmt(srv.get('spec_accept_rate'), '{:.0%}')}   "
                f"drafted {_fmt(srv.get('spec_drafted_tokens'), '{}')}   "
                f"accepted {_fmt(srv.get('spec_accepted_tokens'), '{}')}"
            )
        if srv.get("sampled_tokens_greedy") is not None:
            rej = (
                f"   rejection accept "
                f"{_fmt(srv.get('rejection_accept_rate'), '{:.0%}')}"
                if srv.get("rejection_accept_rate") is not None
                else ""
            )
            lines.append(
                f"  sampling: greedy {_fmt(srv.get('sampled_tokens_greedy'), '{}')}   "
                f"sampled {_fmt(srv.get('sampled_tokens_sample'), '{}')}   "
                f"grammar-masked {_fmt(srv.get('grammar_masked_steps'), '{}')}"
                + rej
            )
        usage = srv.get("usage")
        if isinstance(usage, dict):
            by_tenant = usage.get("by_tenant")
            tenants = ""
            if isinstance(by_tenant, dict) and by_tenant:
                top = sorted(
                    (
                        (t, row.get("device_seconds") or 0.0)
                        for t, row in by_tenant.items()
                        if isinstance(row, dict)
                    ),
                    key=lambda kv: -kv[1],
                )[:3]
                tenants = "   tenants: " + ", ".join(
                    f"{t} {_fmt(s, '{:.3g}')}s" for t, s in top
                )
            lines.append(
                f"  usage: device {_fmt(usage.get('device_seconds'), '{:.3g}')}s   "
                f"kv {_fmt(usage.get('block_seconds'), '{:.3g}')} blk·s   "
                f"swap {_fmt(usage.get('swap_bytes'), '{}')} B   "
                f"closed {_fmt(usage.get('requests_finished'), '{}')} "
                f"(live {_fmt(usage.get('requests_live'), '{}')})" + tenants
            )
        if srv.get("prefix_hit_ratio") is not None or srv.get("preemptions"):
            lines.append(
                f"  prefix cache: hit {_fmt(srv.get('prefix_hit_ratio'), '{:.0%}')}   "
                f"preemptions {_fmt(srv.get('preemptions'), '{}')}   "
                f"swapped-out blocks {_fmt(srv.get('swapped_out_blocks'), '{}')}   "
                f"out-of-blocks {_fmt(srv.get('out_of_blocks_total'), '{}')}"
            )
    tail = status.get("request_tail")
    if tail and tail.get("tail"):
        attribution = "   ".join(
            f"{phase} {pct:.0f}%"
            for phase, pct in sorted(
                (tail.get("attribution") or {}).items(), key=lambda kv: -kv[1]
            )
            if pct >= 0.5
        )
        lines.append(
            f"  slow requests ({tail['metric']} tail of "
            f"{tail['measured_requests']}): " + (attribution or "-")
        )
        for t in tail["tail"][:3]:
            lines.append(
                f"    {t['trace_id'][:16]:<16} "
                f"{tail['metric']} {_fmt(t.get(tail['metric'] + '_s'), '{:.3f}')}s  "
                f"queued {_fmt((t.get('phases') or {}).get('queued'), '{:.3f}')}s  "
                f"finish {t.get('finish_reason') or '?'}"
            )
    fleet = status.get("fleet")
    if fleet:
        lines.append(f"  fleet ({len(fleet)} replica(s)):")
        for r in fleet:
            slots = (
                f"{r.get('active_slots')}/{r.get('num_slots')}"
                if r.get("num_slots") else _fmt(r.get("active_slots"), "{}")
            )
            mark = "  [DEAD]" if r.get("dead") else ""
            # supervisor state: restart count always when supervised, plus
            # backoff/quarantine while a respawn is pending or armed
            sup = ""
            if r.get("restarts"):
                sup += f"  restarts {r['restarts']}"
            if r.get("quarantined"):
                sup += "  QUARANTINED"
            if r.get("probation"):
                sup += "  probation"
            if r.get("respawn_in_s") is not None:
                sup += (
                    f"  respawn in {_fmt(r.get('respawn_in_s'), '{:.1f}')}s "
                    f"(backoff {_fmt(r.get('backoff_s'), '{:.1f}')}s)"
                )
            lines.append(
                f"    replica {r.get('replica_id')}: {r.get('state')}  "
                f"queue {_fmt(r.get('queue_depth'), '{}')}  "
                f"slots {slots}  in-flight {_fmt(r.get('in_flight'), '{}')}  "
                f"heartbeat {_fmt(r.get('heartbeat_age_s'), '{:.1f}')}s  "
                f"last row {_fmt(r.get('row_age_s'), '{:.0f}')}s ago{mark}{sup}"
            )
        router = status.get("router")
        if router:
            parts = [
                f"queue {_fmt(router.get('queue_depth'), '{}')}",
                f"delivered {_fmt(router.get('delivered'), '{}')}",
                f"requeues {_fmt(router.get('requeues'), '{}')}",
                f"shed {_fmt(router.get('shed'), '{}')}",
                f"deadline-expired {_fmt(router.get('deadline_expired'), '{}')}",
            ]
            if router.get("respawns") is not None:
                parts.append(
                    f"respawns {router['respawns']} "
                    f"(quarantined {_fmt(router.get('quarantined'), '{}')}, "
                    f"scale +{_fmt(router.get('scale_ups'), '{}')}"
                    f"/-{_fmt(router.get('scale_downs'), '{}')}, "
                    f"fleet {_fmt(router.get('min_replicas'), '{}')}-"
                    f"{_fmt(router.get('max_replicas'), '{}')})"
                )
            lines.append("  router: " + "  ".join(parts))
            by_tenant = router.get("by_tenant")
            if isinstance(by_tenant, dict) and by_tenant:
                tenant_parts = [
                    f"{t} {_fmt(row.get('delivered'), '{}')}d"
                    f"/{_fmt(row.get('shed'), '{}')}s"
                    f"/{_fmt(row.get('requeued'), '{}')}r"
                    f"/{_fmt(row.get('deadline_expired'), '{}')}x"
                    for t, row in sorted(
                        by_tenant.items(),
                        key=lambda kv: -(
                            (kv[1].get("delivered") or 0)
                            if isinstance(kv[1], dict) else 0
                        ),
                    )[:5]
                    if isinstance(row, dict)
                ]
                if tenant_parts:
                    lines.append(
                        "  tenants (delivered/shed/requeued/expired): "
                        + "  ".join(tenant_parts)
                    )
    goodput = status.get("goodput")
    if goodput:
        lost = goodput["lost_s_by_cause"]
        lost_text = "  ".join(
            f"{cause} {seconds:.1f}s"
            for cause, seconds in sorted(lost.items(), key=lambda kv: -kv[1])
            if seconds > 0
        )
        lines.append(
            f"  goodput: {goodput['goodput_pct']:.1f}% of "
            f"{goodput['elapsed_s']:.0f}s wall "
            f"({goodput.get('hosts', 1)} host(s))"
            + (f"   lost: {lost_text}" if lost_text else "")
        )
    slo = status.get("slo")
    if isinstance(slo, dict) and (slo.get("objectives") or slo.get("firing")):
        firing_names = {
            f.get("rule") for f in (slo.get("firing") or []) if isinstance(f, dict)
        }
        objectives = slo.get("objectives") or {}
        if objectives:
            lines.append("  slo:")
            for name, o in objectives.items():
                if not isinstance(o, dict):
                    continue
                phase = o.get("dominant_phase")
                lines.append(
                    f"    {name:<24} burn {_fmt(o.get('burn_rate'), '{:.2f}')}x "
                    f"(long {_fmt(o.get('burn_rate_long'), '{:.2f}')}x)  "
                    f"budget {_fmt(o.get('budget_remaining'), '{:.2f}')}  "
                    f"observed {_fmt(o.get('observed'), '{:.4g}')}"
                    + (f"  phase {phase}" if phase else "")
                    + ("  [FIRING]" if name in firing_names else "")
                )
        elif firing_names:  # pre-windowed (schema 1) ALERTS.json
            lines.append("  slo: firing " + ", ".join(sorted(firing_names)))
    decisions = status.get("scale_decisions")
    if decisions:
        last = decisions[-1]
        evidence = ""
        if last.get("objective"):
            evidence = (
                f"  [{last['objective']} burn "
                f"{_fmt(last.get('burn_rate'), '{:.2f}')}x, phase "
                f"{last.get('dominant_phase') or '?'}]"
            )
        lines.append(
            f"  scale: {last.get('action')} ({last.get('reason')})  "
            f"queue {_fmt(last.get('queue_depth'), '{}')}  "
            f"ready {_fmt(last.get('ready_replicas'), '{}')}"
            + evidence
            + (
                f"  ({len(decisions)} decision(s) in trail tail)"
                if len(decisions) > 1 else ""
            )
        )
    if status.get("skipped_unknown_schema"):
        lines.append(
            f"  ! skipped {status['skipped_unknown_schema']} telemetry rows "
            f"with an unknown schema version (reader older than writer?)"
        )
    if status["hosts"]:
        lines.append(f"  hosts ({len(status['hosts'])}):")
        for h in status["hosts"]:
            marks = []
            if h["host"] in status["wedged"]:
                marks.append("WEDGED")
            if h["host"] in status["stragglers"]:
                marks.append("STRAGGLER")
            if h.get("fired"):
                marks.append("watchdog-fired")
            lines.append(
                f"    host {h.get('host')}: step {h.get('step')} "
                f"(lag {h.get('lag_steps')})  heartbeat {h['stale_s']:.0f}s ago  "
                f"ema {_fmt(h.get('ema_step_s'), '{:.3f}')}s"
                + ("   [" + ", ".join(marks) + "]" if marks else "")
            )
    else:
        lines.append("  hosts: no heartbeat files (diagnostics off or run not started)")
    for r in status["hang_reports"]:
        flight = (
            f" (engine phase {r['flight_phase']})" if r.get("flight_phase") else ""
        )
        lines.append(
            f"  !! HANG host {r.get('host')}: stalled in "
            f"{r.get('stalled_phase') or '?'} after {_fmt(r.get('elapsed_s'), '{:.0f}')}s"
            f"{flight} — {r['path']}"
        )
    for r in status.get("race_reports") or []:
        cycle = " -> ".join(r.get("cycle") or []) or "?"
        lines.append(
            f"  !! RACE host {r.get('host')}: lock-order inversion "
            f"({r.get('acquiring') or '?'} acquired while holding "
            f"{r.get('while_holding') or '?'}; cycle {cycle}) — {r['path']}"
        )
    for d in status.get("collective_divergence") or []:
        per_host = "  ".join(
            f"host {h}: {digest}" for h, digest in sorted(d["digests"].items())
        )
        divergent = ", ".join(str(h) for h in d["divergent_hosts"])
        if d.get("tie"):
            lines.append(
                f"  !! COLLECTIVE ORDER DIVERGES on '{d['label']}' — hosts "
                f"{divergent} compiled different collective sequences with no "
                f"majority (will deadlock at the first mismatched rendezvous): "
                f"{per_host}"
            )
        else:
            lines.append(
                f"  !! COLLECTIVE ORDER DIVERGES on '{d['label']}' — host(s) "
                f"{divergent} compiled a different collective sequence than the "
                f"majority (will deadlock at the first mismatched rendezvous): "
                f"{per_host}"
            )
    return "\n".join(lines)
