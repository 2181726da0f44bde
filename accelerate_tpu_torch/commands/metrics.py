"""``accelerate-tpu-torch metrics`` — the scrape surface over a run's logging
dir (a copy of ``accelerate_tpu/commands/metrics.py``).

``metrics export <logging_dir>`` runs the sidecar exporter: it tails the
telemetry JSONL segments and trace trails the training (or serving) job
writes, aggregates them into OpenMetrics, and answers ``GET /metrics`` on
a local port — a Prometheus scrape target for a job that embeds no HTTP
server. Like ``monitor``, it never talks to the job: pure file reads, so
it runs next to the job, on a login host over a shared filesystem, or
post-mortem. ``--once`` prints one exposition to stdout instead (pipe it,
diff it, or use the exit code: 3 when an ``ACCELERATE_SLO_*`` rule fires,
0 otherwise — the same contract as ``monitor --once``).

No torch import anywhere on this path — the sidecar must run on a CPU-only
probe box.
"""

from __future__ import annotations

import os
import sys


def metrics_export_command(args) -> int:
    from ..metrics.alerts import EXIT_SLO_VIOLATION
    from ..metrics.exporter import LoggingDirExporter, serve_exporter

    logging_dir = args.logging_dir
    if not os.path.isdir(logging_dir):
        print(f"metrics export: {logging_dir} is not a directory", file=sys.stderr)
        return 1
    exporter = LoggingDirExporter(logging_dir)
    if args.once:
        firing = exporter.refresh()
        sys.stdout.write(exporter.render())
        for alert in firing:
            print(
                f"SLO {alert['rule']}: observed {alert['observed']:.4g} vs "
                f"threshold {alert['threshold']:.4g} ({alert['env']})",
                file=sys.stderr,
            )
        return EXIT_SLO_VIOLATION if firing else 0

    server = serve_exporter(
        exporter, args.port, host=args.host, min_refresh_seconds=args.min_refresh
    )
    bound_port = server.server_address[1]
    print(
        f"exporting {logging_dir} on http://{args.host}:{bound_port}/metrics "
        f"(scrape-triggered refresh, min {args.min_refresh:g}s; /healthz for "
        f"liveness)",
        file=sys.stderr,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


def add_parser(subparsers):
    metrics = subparsers.add_parser(
        "metrics", help="OpenMetrics export of a run's logging dir"
    )
    metrics_sub = metrics.add_subparsers(dest="metrics_command")
    export = metrics_sub.add_parser(
        "export",
        help="sidecar exporter: tail telemetry/trace files, serve GET /metrics",
    )
    export.add_argument("logging_dir", help="the run's logging/project dir")
    export.add_argument(
        "--port", type=int, default=9464,
        help="HTTP port (0 picks a free one; default mirrors the OTel "
        "Prometheus-exporter convention)",
    )
    export.add_argument("--host", default="127.0.0.1", help="bind address")
    export.add_argument(
        "--min-refresh", type=float, default=1.0,
        help="minimum seconds between file re-scans (scrapes inside the "
        "window serve the cached registry)",
    )
    export.add_argument(
        "--once", action="store_true",
        help="print one exposition to stdout and exit (exit 3 when an "
        "ACCELERATE_SLO_* rule fires, else 0)",
    )
    export.set_defaults(func=metrics_export_command)
    return metrics
