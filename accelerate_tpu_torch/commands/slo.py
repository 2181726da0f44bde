"""``accelerate-tpu-torch slo`` — the scenario × objective scorecard (a copy
of ``accelerate_tpu/commands/slo.py``).

``slo report <logging_dir>`` renders one run's (or a whole suite's) SLO
verdict from its trails alone: per-objective burn rates and pass/fail
from the windowed engine (:mod:`accelerate_tpu_torch.metrics.slo`), the tail's
phase attribution with exemplar trace_ids (so a failing row links
straight into ``trace tail``/``trace merge``), and the supervisor's
``scale_decision`` rows — what the closed loop actually *did* about it.

Given a dir that is itself a traced run (it has a ``WORKLOAD.json``
manifest, or any trails at all) the scorecard has one scenario row; given
a suite dir whose immediate children are traced runs (``bench.py fleet``
lays scenarios out this way), one row per child. ``--json`` emits the
same scorecard machine-readably — the smoke pins that the two agree.

Pure file reads, no torch — like ``monitor``, it runs anywhere the logging
dir is visible.
"""

from __future__ import annotations

import json
import os
import sys

#: scorecard schema stamp on the --json output
REPORT_SCHEMA = 1


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def _scale_decisions(logging_dir: str, max_rows: int = 50) -> list[dict]:
    from ..diagnostics.monitor import _tail_jsonl

    path = os.path.join(logging_dir, "router", "replicas.jsonl")
    return [
        row
        for row in _tail_jsonl(path, max_records=2000)
        if row.get("kind") == "scale_decision"
    ][-max_rows:]


def scorecard_for_run(logging_dir: str) -> dict:
    """One scenario row: workload identity + windowed objective verdicts +
    tail attribution + exemplars + scaling decisions."""
    from ..diagnostics.reqtrace import tail_from_dir_throttled
    from ..metrics.slo import evaluate_from_dir
    from ..serving.workload import WORKLOAD_FILENAME

    manifest = _read_json(os.path.join(logging_dir, WORKLOAD_FILENAME)) or {}
    verdict = evaluate_from_dir(logging_dir)
    tail = tail_from_dir_throttled(logging_dir) or {}
    objectives = verdict["objectives"]
    firing = verdict["firing"]
    if not objectives:
        outcome = "unarmed"
    elif firing:
        outcome = "fail"
    elif all(o.get("burn_rate") is None for o in objectives.values()):
        outcome = "no-data"
    else:
        outcome = "pass"
    return {
        "dir": logging_dir,
        "scenario": manifest.get("scenario") or "(untraced)",
        "spec": manifest.get("spec"),
        "seed": manifest.get("seed"),
        "requests": manifest.get("requests"),
        "schedule_sha256": manifest.get("schedule_sha256"),
        "objectives": objectives,
        "firing": firing,
        "verdict": outcome,
        "attribution": tail.get("attribution") or {},
        "exemplar_trace_ids": [
            t["trace_id"] for t in (tail.get("tail") or [])[:3] if t.get("trace_id")
        ],
        "scale_decisions": _scale_decisions(logging_dir)[-10:],
    }


def build_report(logging_dir: str) -> dict:
    """The full scorecard: the dir itself when it is a traced run, else
    every immediate child that is one (a ``bench.py fleet`` suite dir)."""
    from ..serving.workload import WORKLOAD_FILENAME

    def is_run(d: str) -> bool:
        return (
            os.path.exists(os.path.join(d, WORKLOAD_FILENAME))
            or os.path.isdir(os.path.join(d, "router"))
            or os.path.isdir(os.path.join(d, "traces"))
            or os.path.isdir(os.path.join(d, "telemetry"))
        )

    runs = []
    if is_run(logging_dir):
        runs.append(logging_dir)
    else:
        for name in sorted(os.listdir(logging_dir)):
            child = os.path.join(logging_dir, name)
            if os.path.isdir(child) and is_run(child):
                runs.append(child)
    scenarios = [scorecard_for_run(d) for d in runs]
    return {
        "schema": REPORT_SCHEMA,
        "logging_dir": logging_dir,
        "scenarios": scenarios,
        "pass": bool(scenarios)
        and all(s["verdict"] in ("pass", "unarmed", "no-data") for s in scenarios),
    }


def render_report(report: dict) -> str:
    lines = [f"accelerate-tpu slo report — {report['logging_dir']}"]
    if not report["scenarios"]:
        lines.append("  no traced runs found (nothing with trails or WORKLOAD.json)")
        return "\n".join(lines)
    for s in report["scenarios"]:
        spec = f" [{s['spec']}]" if s.get("spec") else ""
        head = f"  scenario {s['scenario']}{spec}: {s['verdict'].upper()}"
        if s.get("requests") is not None:
            head += f"  ({s['requests']} scheduled requests)"
        if s.get("schedule_sha256"):
            head += f"  schedule {s['schedule_sha256'][:12]}"
        lines.append(head)
        firing_names = {f["rule"] for f in s["firing"]}
        for name, o in s["objectives"].items():
            def fmt(v, p="{:.2f}"):
                return "-" if v is None else p.format(v)

            mark = "FAIL" if name in firing_names else (
                "pass" if o.get("burn_rate") is not None else "no-data"
            )
            lines.append(
                f"    {name:<24} {mark:<8} "
                f"burn {fmt(o.get('burn_rate'))}x "
                f"(long {fmt(o.get('burn_rate_long'))}x)  "
                f"budget {fmt(o.get('budget_remaining'))}  "
                f"observed {fmt(o.get('observed'), '{:.4g}')}  "
                f"window {o.get('window_s'):.0f}s"
            )
        if not s["objectives"]:
            lines.append(
                "    no objectives armed (set ACCELERATE_SLO_* to arm)"
            )
        if s["attribution"]:
            attribution = "   ".join(
                f"{phase} {pct:.0f}%"
                for phase, pct in sorted(
                    s["attribution"].items(), key=lambda kv: -kv[1]
                )
                if pct >= 0.5
            )
            lines.append(f"    tail attribution: {attribution}")
        if s["exemplar_trace_ids"]:
            lines.append(
                "    exemplar trace_ids: " + ", ".join(s["exemplar_trace_ids"])
            )
        for d in s["scale_decisions"][-3:]:
            evidence = ""
            if d.get("objective"):
                burn = d.get("burn_rate")
                evidence = (
                    f"  [{d['objective']} burn "
                    f"{'-' if burn is None else format(burn, '.2f')}x, "
                    f"phase {d.get('dominant_phase') or '?'}]"
                )
            lines.append(
                f"    decision: {d.get('action')} ({d.get('reason')})"
                f"  queue {d.get('queue_depth')}"
                f"  ready {d.get('ready_replicas')}" + evidence
            )
    lines.append(f"  overall: {'PASS' if report['pass'] else 'FAIL'}")
    return "\n".join(lines)


def slo_report_command(args) -> int:
    if not os.path.isdir(args.logging_dir):
        print(f"slo report: {args.logging_dir} is not a directory", file=sys.stderr)
        return 1
    report = build_report(args.logging_dir)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render_report(report))
    return 0


def add_parser(subparsers):
    p = subparsers.add_parser(
        "slo", help="Windowed SLO scorecards over a run's logging dir"
    )
    sub = p.add_subparsers(dest="slo_command")
    report = sub.add_parser(
        "report",
        help="scenario × objective scorecard: burn rates, pass/fail, tail "
        "attribution, exemplar trace_ids, and the supervisor's scale "
        "decisions — from the trails alone",
    )
    report.add_argument(
        "logging_dir",
        help="a traced run's logging dir, or a suite dir whose children are "
        "traced runs (bench.py fleet layout)",
    )
    report.add_argument("--json", action="store_true",
                        help="machine-readable scorecard instead of the table")
    report.set_defaults(func=slo_report_command)
    return p
