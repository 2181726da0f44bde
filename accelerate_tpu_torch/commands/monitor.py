"""``accelerate-tpu-torch monitor`` + ``accelerate-tpu-torch trace`` — the
operator surface of the diagnostics subsystem (a copy of
``accelerate_tpu/commands/monitor.py``).

* ``monitor <logging_dir>`` tails the telemetry JSONL and the per-host
  heartbeat files into a live terminal summary (step rate, MFU, per-host
  lag, recompiles, hang reports). Pure file reads — works on a wedged or
  dead run, and from any machine that can see the logging dir.
* ``trace merge <logging_dir>`` fuses ``traces/host_*.trace.json`` into
  one Perfetto/``chrome://tracing``-loadable timeline with host-clock-
  offset correction.

Neither command imports torch — they must run on a laptop against a synced
logging dir without a GPU (or any accelerator) in sight.
"""

from __future__ import annotations

import os
import sys
import time


def monitor_command(args) -> int:
    """Exit codes in ``--once`` mode (the scriptable health check):

    * ``0`` — healthy (or nothing to report yet)
    * ``1`` — usage error (``logging_dir`` is not a directory)
    * ``2`` — a host is wedged, a ``HANG_REPORT`` exists, a ``RACE_REPORT``
      exists (LockWatch witnessed a lock-order inversion — a deadlock
      waiting for the right interleaving), a serving-fleet replica is
      dead or its router rows went stale mid-run, or the per-host
      collective-sequence digests diverge (a pre-deadlock condition: the
      sanitizer writes one digest file per host, and disagreement means
      a cross-host collective will never match up). A supervised replica
      waiting out its respawn backoff still counts as dead — the
      condition clears itself once the respawned process writes a fresh
      ``ready`` row (newest row per replica wins)
    * ``3`` — an ``ACCELERATE_SLO_*`` alert rule is firing (``ALERTS.json``
      written next to the run's artifacts; wedged/hang wins when both hold)

    Precedence is fixed: ``1`` (usage) > ``2`` (wedged/dead/race/divergence)
    > ``3`` (SLO) > ``0`` — a wedged fleet must not be masked by a mere SLO
    breach, and scripts can rely on the ordering.
    """
    from ..diagnostics.monitor import collect_status, render_status
    from ..metrics.alerts import EXIT_SLO_VIOLATION
    from ..metrics.slo import evaluate_from_dir, write_slo_alerts

    logging_dir = args.logging_dir
    if not os.path.isdir(logging_dir):
        print(f"monitor: {logging_dir} is not a directory", file=sys.stderr)
        return 1
    try:
        while True:
            status = collect_status(logging_dir)
            text = render_status(status)
            if args.once:
                # windowed burn-rate evaluation (metrics/slo.py) over the
                # run's own trails — the verdict lands in ALERTS.json
                # (schema 2) exactly as the exporter would write it
                verdict = evaluate_from_dir(logging_dir)
                firing = verdict["firing"]
                write_slo_alerts(
                    logging_dir, firing, verdict["objectives"],
                    snapshot=verdict["snapshot"],
                )
                for alert in firing:
                    observed = alert.get("observed")
                    extra = f", burn {alert['burn_rate']:.2f}x"
                    if alert.get("dominant_phase"):
                        extra += f", phase {alert['dominant_phase']}"
                    text += (
                        f"\n  !! SLO {alert['rule']}: observed "
                        f"{observed if observed is None else format(observed, '.4g')}"
                        f" vs threshold "
                        f"{alert['threshold']:.4g} ({alert['env']}{extra})"
                    )
                print(text)
                if (
                    status["wedged"]
                    or status["hang_reports"]
                    or status.get("race_reports")
                    or status.get("collective_divergence")
                    or status.get("fleet_dead")
                ):
                    return 2
                return EXIT_SLO_VIOLATION if firing else 0
            # repaint in place: clear screen + home, like `watch`
            sys.stdout.write("\x1b[2J\x1b[H" + text + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def trace_merge_command(args) -> int:
    from ..diagnostics.tracing import (
        discover_profile_artifacts,
        discover_trace_files,
        merge_traces,
        validate_chrome_trace,
    )

    trace_dir = args.logging_dir
    # accept the logging dir, its traces/ subdir, or a whole routed-fleet
    # dir (router traces/ + every replica_*/traces/) — discovery finds all
    # per-process files so one merge shows a request hopping processes
    paths = discover_trace_files(trace_dir)
    if not paths:
        print(f"trace merge: no host_*.trace.json under {trace_dir}", file=sys.stderr)
        return 1
    subdir = os.path.join(trace_dir, "traces")
    out_dir = subdir if os.path.isdir(subdir) else trace_dir
    output = args.output or os.path.join(out_dir, "merged.trace.json")
    trace = merge_traces(paths=paths, output_path=output)
    validate_chrome_trace(trace)
    hosts = trace["metadata"]["merged_hosts"]
    flows = trace["metadata"].get("request_flows") or {}
    flow_text = ""
    if flows.get("trace_ids"):
        flow_text = (
            f"\nstitched {flows['trace_ids']} request flow(s) by trace_id "
            f"({flows['cross_process']} cross-process, "
            f"{flows['orphan_flows']} orphan flow event(s))"
        )
    profile_text = ""
    profiles = discover_profile_artifacts(trace_dir)
    if profiles:
        profile_text = (
            f"\n{len(profiles)} on-demand profiler capture(s) "
            "(profiler artifacts + flight windows):\n"
            + "\n".join(f"  {p}" for p in profiles)
        )
    print(
        f"merged {len(trace['traceEvents'])} events from "
        f"{len(hosts) or '?'} process(es) -> {output}{flow_text}\n"
        f"open in https://ui.perfetto.dev or chrome://tracing" + profile_text
    )
    return 0


def trace_tail_command(args) -> int:
    """Tail-latency attribution over the slowest K requests (or, with
    ``--iterations``, the slowest K engine iterations by wall time with
    host-vs-device phase attribution) — exit 1 when the directory holds
    no matching trace events at all (tracing was off, or the run predates
    this instrumentation)."""
    import json as _json

    from ..diagnostics.reqtrace import (
        iteration_report,
        render_iteration_report,
        render_tail_report,
        tail_report,
    )

    if not os.path.isdir(args.logging_dir):
        print(f"trace tail: {args.logging_dir} is not a directory", file=sys.stderr)
        return 1
    if getattr(args, "iterations", False):
        try:
            report = iteration_report(args.logging_dir, k=args.k)
        except (FileNotFoundError, ValueError) as e:
            print(f"trace tail: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(_json.dumps(report, indent=2))
        else:
            print(render_iteration_report(report))
        return 0 if report["iterations"] else 1
    try:
        report = tail_report(args.logging_dir, k=args.k, metric=args.metric)
    except (FileNotFoundError, ValueError) as e:
        print(f"trace tail: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(_json.dumps(report, indent=2))
    else:
        print(render_tail_report(report))
    return 0 if report["total_requests"] else 1


def add_parser(subparsers):
    monitor = subparsers.add_parser(
        "monitor", help="Live terminal status of a training run's logging dir"
    )
    monitor.add_argument("logging_dir", help="the run's logging/project dir")
    monitor.add_argument(
        "--interval", type=float, default=2.0, help="refresh period in seconds"
    )
    monitor.add_argument(
        "--once",
        action="store_true",
        help="print one snapshot and exit (scriptable health check: exit 2 "
        "when a host is wedged or a hang report exists, exit 3 when an "
        "ACCELERATE_SLO_* alert rule fires — ALERTS.json is written — else 0)",
    )
    monitor.set_defaults(func=monitor_command)

    trace = subparsers.add_parser(
        "trace", help="Operate on diagnostics trace files"
    )
    trace_sub = trace.add_subparsers(dest="trace_command")
    merge = trace_sub.add_parser(
        "merge",
        help="fuse per-host trace files into one Perfetto-loadable timeline",
    )
    merge.add_argument("logging_dir", help="the run's logging dir (or its traces/ subdir)")
    merge.add_argument("-o", "--output", default=None, help="merged output path")
    merge.set_defaults(func=trace_merge_command)

    tail = trace_sub.add_parser(
        "tail",
        help="slowest-K requests by TTFT/TPOT with per-phase tail attribution "
        "(queued / prefill / swap_in / preempted) from the request-scoped "
        "trace events",
    )
    tail.add_argument("logging_dir", help="the serve/route logging dir")
    tail.add_argument("-k", type=int, default=10, help="tail size (default 10)")
    tail.add_argument("--metric", choices=("ttft", "tpot"), default="ttft",
                      help="latency metric ranking the tail (default ttft)")
    tail.add_argument("--iterations", action="store_true",
                      help="rank engine iterations instead of requests: "
                      "slowest-K by wall time with per-phase host-vs-device "
                      "attribution from the flight recorder's serve/flight "
                      "events")
    tail.add_argument("--json", action="store_true",
                      help="machine-readable report instead of the table")
    tail.set_defaults(func=trace_tail_command)
    return monitor
