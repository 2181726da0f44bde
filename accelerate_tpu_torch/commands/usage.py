"""``accelerate-tpu-torch usage`` — the per-request resource-attribution
report (a copy of ``accelerate_tpu/commands/usage.py``).

``usage report <logging_dir>`` renders one run's (or a whole suite's)
usage-ledger rollup from its trails alone: who spent the device
(device-seconds split decode/prefill), who occupied the KV cache
(block-seconds), who churned the swap tier (bytes in+out), by tenant or
by priority class, plus the heaviest individual requests with their
``trace_id`` exemplars (so an expensive row links straight into ``trace
tail``). The report re-checks the ledger's **conservation invariant**
from the snapshot's partner totals — Σ per-request decode shares vs the
engine's cumulative ``device_wait``, and Σ per-request block-second
integrals vs the pool-occupancy integral — and the scorecard fails if
either pair disagrees beyond float tolerance.

Data comes from the newest telemetry step row carrying a ``usage``
snapshot (the ledger's cumulative state), plus the router fleet trail's
``by_tenant`` delivery outcomes when the run was routed. Pure file
reads, no torch — like ``monitor`` and ``slo``, it runs anywhere the
logging dir is visible.
"""

from __future__ import annotations

import json
import os
import sys

#: report schema stamp on the --json output
REPORT_SCHEMA = 1

#: conservation re-check tolerance: the partner totals are accrued from
#: the same floats at the same edges, so only accumulation-order rounding
#: separates them
_REL_TOL = 1e-6
_ABS_TOL = 1e-9


def _conserved(total, partner) -> dict:
    ok = None
    if isinstance(total, (int, float)) and isinstance(partner, (int, float)):
        ok = abs(total - partner) <= _ABS_TOL + _REL_TOL * max(
            abs(total), abs(partner)
        )
    return {"sum": total, "partner": partner, "ok": ok}


def _newest_usage(logging_dir: str) -> dict | None:
    """The newest serving step row's ``usage`` snapshot — the ledger's
    cumulative state as of the run's last telemetry flush."""
    from ..diagnostics.monitor import _tail_trail

    jsonl = os.path.join(logging_dir, "telemetry", "telemetry.jsonl")
    records, _ = _tail_trail(jsonl, max_records=2000)
    for row in reversed(records):
        if (
            row.get("type") == "serving"
            and row.get("kind") == "step"
            and isinstance(row.get("usage"), dict)
        ):
            return row["usage"]
    return None


def _router_tenants(logging_dir: str) -> dict | None:
    """The newest aggregate router row's ``by_tenant`` delivery outcomes
    (delivered/shed/requeued/deadline_expired), when the run was routed."""
    from ..diagnostics.monitor import _tail_jsonl

    path = os.path.join(logging_dir, "router", "replicas.jsonl")
    tenants = None
    for row in _tail_jsonl(path, max_records=2000):
        if row.get("kind") == "router" and isinstance(row.get("by_tenant"), dict):
            tenants = row["by_tenant"]  # append-ordered: newest wins
    return tenants


def report_for_run(logging_dir: str) -> dict:
    usage = _newest_usage(logging_dir)
    row = {
        "dir": logging_dir,
        "usage": usage,
        "router_by_tenant": _router_tenants(logging_dir),
        "conservation": None,
    }
    if usage is not None:
        row["conservation"] = {
            "device": _conserved(
                usage.get("decode_device_seconds"),
                usage.get("device_wait_seconds"),
            ),
            "blocks": _conserved(
                usage.get("block_seconds"), usage.get("pool_block_seconds")
            ),
        }
    return row


def build_report(logging_dir: str, by: str = "tenant") -> dict:
    """The full report: the dir itself when it is a traced run, plus every
    immediate child that is one — covering a plain ``serve`` run, a
    ``bench.py fleet`` suite dir, and a routed fleet's layout (router
    trail at the root, one telemetry trail per ``replica_<i>/`` child).
    ``pass`` requires every run with a ledger snapshot to conserve both
    resources."""

    def is_run(d: str) -> bool:
        return (
            os.path.isdir(os.path.join(d, "telemetry"))
            or os.path.isdir(os.path.join(d, "router"))
        )

    runs = []
    if is_run(logging_dir):
        runs.append(logging_dir)
    for name in sorted(os.listdir(logging_dir)):
        child = os.path.join(logging_dir, name)
        if os.path.isdir(child) and is_run(child):
            runs.append(child)
    rows = [report_for_run(d) for d in runs]
    checked = [
        check["ok"]
        for r in rows
        if r["conservation"]
        for check in r["conservation"].values()
        if check["ok"] is not None
    ]
    conserved = all(checked) if checked else None
    return {
        "schema": REPORT_SCHEMA,
        "logging_dir": logging_dir,
        "by": by,
        "runs": rows,
        "conserved": conserved,
        "pass": bool(rows) and conserved is not False,
    }


def _fmt(value, pattern="{:.4g}", none="-") -> str:
    return none if value is None else pattern.format(value)


def render_report(report: dict) -> str:
    by = report["by"]
    lines = [f"accelerate-tpu usage report — {report['logging_dir']} (by {by})"]
    if not report["runs"]:
        lines.append("  no runs found (nothing with telemetry or router trails)")
        return "\n".join(lines)
    for r in report["runs"]:
        usage = r.get("usage")
        if usage is None:
            lines.append(
                f"  {r['dir']}: no usage snapshot in the telemetry trail "
                f"(usage_accounting off, or no step rows yet)"
            )
            continue
        lines.append(
            f"  {r['dir']}: {usage.get('requests_finished')} closed / "
            f"{usage.get('requests_live')} live — "
            f"device {_fmt(usage.get('device_seconds'))}s "
            f"(decode {_fmt(usage.get('decode_device_seconds'))} + "
            f"prefill {_fmt(usage.get('prefill_device_seconds'))})   "
            f"kv {_fmt(usage.get('block_seconds'))} blk·s   "
            f"swap {_fmt(usage.get('swap_bytes'), '{}')} B"
        )
        cons = r.get("conservation") or {}
        for label, key, unit in (
            ("decode device-time", "device", "s"),
            ("block-seconds", "blocks", "blk·s"),
        ):
            c = cons.get(key)
            if not c:
                continue
            mark = {True: "CONSERVED", False: "VIOLATED", None: "no-data"}[c["ok"]]
            lines.append(
                f"    conservation {label:<18} {mark:<10} "
                f"Σ shares {_fmt(c['sum'], '{:.6g}')}{unit} vs "
                f"partner {_fmt(c['partner'], '{:.6g}')}{unit}"
            )
        table = usage.get("by_tenant" if by == "tenant" else "by_class") or {}
        for key, row in sorted(
            table.items(),
            key=lambda kv: -(kv[1].get("device_seconds") or 0.0)
            if isinstance(kv[1], dict)
            else 0.0,
        ):
            if not isinstance(row, dict):
                continue
            lines.append(
                f"    {by} {str(key):<16} "
                f"req {_fmt(row.get('requests'), '{}'):<5} "
                f"tok {_fmt(row.get('tokens'), '{}'):<7} "
                f"device {_fmt(row.get('device_seconds'))}s  "
                f"kv {_fmt(row.get('block_seconds'))} blk·s  "
                f"swap {_fmt(row.get('swap_bytes'), '{}')} B  "
                f"spec {_fmt(row.get('spec_accepted_tokens'), '{}')}"
                f"/{_fmt(row.get('spec_drafted_tokens'), '{}')}  "
                f"grammar {_fmt(row.get('grammar_masked_steps'), '{}')}"
            )
        for h in (usage.get("heavy_hitters") or [])[:5]:
            lines.append(
                f"    heavy: {str(h.get('trace_id') or h.get('request_id'))[:16]:<16} "
                f"tenant {h.get('tenant')}  class {h.get('class')}  "
                f"device {_fmt(h.get('device_seconds'))}s  "
                f"kv {_fmt(h.get('block_seconds'))} blk·s  "
                f"tokens {_fmt(h.get('new_tokens'), '{}')}  "
                f"finish {h.get('finish_reason') or '?'}"
            )
        router = r.get("router_by_tenant")
        if router:
            parts = [
                f"{t} {_fmt(row.get('delivered'), '{}')}d"
                f"/{_fmt(row.get('shed'), '{}')}s"
                f"/{_fmt(row.get('requeued'), '{}')}r"
                f"/{_fmt(row.get('deadline_expired'), '{}')}x"
                for t, row in sorted(router.items())
                if isinstance(row, dict)
            ]
            lines.append(
                "    router (delivered/shed/requeued/expired): "
                + "  ".join(parts)
            )
    verdict = report.get("conserved")
    lines.append(
        "  overall: "
        + {True: "CONSERVED", False: "VIOLATED", None: "no ledger data"}[verdict]
    )
    return "\n".join(lines)


def usage_report_command(args) -> int:
    if not os.path.isdir(args.logging_dir):
        print(f"usage report: {args.logging_dir} is not a directory", file=sys.stderr)
        return 1
    report = build_report(args.logging_dir, by=args.by)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
    else:
        print(render_report(report))
    return 0 if report["pass"] else 1


def add_parser(subparsers):
    p = subparsers.add_parser(
        "usage", help="Per-request resource attribution from a run's trails"
    )
    sub = p.add_subparsers(dest="usage_command")
    report = sub.add_parser(
        "report",
        help="who spent the device / held the KV cache / churned swap, by "
        "tenant or class, with heavy-hitter exemplars and the ledger's "
        "conservation re-check — from the trails alone",
    )
    report.add_argument(
        "logging_dir",
        help="a run's logging dir, or a suite dir whose children are runs",
    )
    report.add_argument(
        "--by", choices=("tenant", "class"), default="tenant",
        help="rollup dimension for the rendered table (default: tenant)",
    )
    report.add_argument("--json", action="store_true",
                        help="machine-readable report instead of the table")
    report.set_defaults(func=usage_report_command)
    return p
