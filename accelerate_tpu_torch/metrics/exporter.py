"""Sidecar metrics exporter: tail a run's ``logging_dir`` artifacts into a
registry and serve OpenMetrics over HTTP — scrape a training job without
embedding a server in the train loop.

The train process keeps writing exactly what its telemetry writes
(telemetry JSONL segments, per-host trace trails, heartbeats); this
exporter — ``accelerate-tpu metrics export <logging_dir>`` — replays every
*new* telemetry row through the same :mod:`.ingest` mapping the in-process
hooks use, recomputes the goodput ledger from the trace trails, reads the
heartbeat files, and answers ``GET /metrics``. Pure file reads, like the
monitor: it works on a wedged or dead run and from any machine that can
see the logging dir.

Tailing is **rotation-proof**: segments are identified by a fingerprint of
their first bytes (not their name), so when ``telemetry.jsonl`` rolls over
to ``telemetry.jsonl.1`` the exporter keeps its per-segment offset and
never re-counts or drops rows. A torn final line (the writer mid-append)
is left unconsumed until its newline lands.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from collections import deque

from .goodput import BUCKETS, ledger_from_dir_throttled
from .ingest import observe_record, observe_router_row
from .openmetrics import CONTENT_TYPE, render_openmetrics
from .registry import MetricsRegistry
from .slo import SloEngine, publish_gauges, write_slo_alerts

logger = logging.getLogger(__name__)

__all__ = ["LoggingDirExporter", "serve_exporter"]


def _fingerprint_fd(f) -> str | None:
    """Identity of a segment independent of its (rotating) name: a hash of
    its FIRST LINE — complete the moment it is written and immutable
    afterwards (appends land below it, rotation only renames). None while
    the file has no complete first line yet. Takes an open fd, NOT a path:
    fingerprint, size, and the data read must all come from the same open
    file, or a rotation between the calls charges the new live file's
    bytes to the old segment's offset."""
    f.seek(0)
    head = f.read(8192)
    newline = head.find(b"\n")
    if newline < 0:
        return None  # nothing stable to identify yet; retry next refresh
    return hashlib.sha1(head[: newline + 1]).hexdigest()


class LoggingDirExporter:
    """Aggregates one run's logging_dir into a scrapeable registry.

    Args:
        logging_dir: the run's logging/project dir (the thing you'd pass
            to ``accelerate-tpu monitor``).
        registry: bring-your-own registry; default builds an ungated one
            (the sidecar aggregates files, not process-local state).
        ttft_window: completed-request window for the TTFT p99 the SLO
            rule evaluates.
    """

    def __init__(
        self,
        logging_dir: str,
        registry: MetricsRegistry | None = None,
        ttft_window: int = 512,
    ):
        self.logging_dir = logging_dir
        self.registry = registry or MetricsRegistry(gate_main_process=False)
        self._offsets: dict[str, int] = {}  # segment fingerprint -> consumed bytes
        self._skipped_schema = 0
        self._warned_schema = False
        self._ttfts: deque = deque(maxlen=int(ttft_window))
        self._compile_rows = 0
        self._row_ts_min: float | None = None
        self._row_ts_max: float | None = None
        # windowed SLO engine (metrics/slo.py): fed incrementally from the
        # same row stream, evaluated on every refresh — ALERTS.json carries
        # burn rates instead of lifetime-total verdicts
        self.slo = SloEngine()
        self._router_prev: tuple | None = None
        self.last_goodput: dict | None = None
        self.last_firing: list[dict] = []
        self.last_refresh: float | None = None

    # -- telemetry tail ------------------------------------------------------

    def _segments(self) -> list[str]:
        from ..telemetry import telemetry_segments

        jsonl = os.path.join(self.logging_dir, "telemetry", "telemetry.jsonl")
        return telemetry_segments(jsonl)

    def _consume_row(self, row: dict) -> None:
        from ..telemetry import schema_compatible

        if not schema_compatible(row):
            self._skipped_schema += 1
            if not self._warned_schema:
                self._warned_schema = True
                logger.warning(
                    "skipping telemetry rows with unknown schema version "
                    "(first: %r) — upgrade this exporter", row.get("schema"),
                )
            return
        observe_record(self.registry, row)
        ts = row.get("ts")
        if isinstance(ts, (int, float)):
            self._row_ts_min = ts if self._row_ts_min is None else min(self._row_ts_min, ts)
            self._row_ts_max = ts if self._row_ts_max is None else max(self._row_ts_max, ts)
        if row.get("type") == "compile":
            self._compile_rows += 1
            if isinstance(ts, (int, float)):
                self.slo.observe_recompile(ts)
        elif row.get("type") == "serving" and row.get("kind") == "request":
            if isinstance(row.get("ttft_s"), (int, float)):
                self._ttfts.append(float(row["ttft_s"]))
            if isinstance(ts, (int, float)):
                self.slo.observe_request(
                    ts, ttft_s=row.get("ttft_s"), tpot_s=row.get("tpot_s")
                )

    def _tail_jsonl(self, path: str, on_row) -> None:
        """Rotation-proof incremental tail shared by every trail this
        exporter consumes: fingerprint-keyed offsets, torn final line left
        for the next refresh, each complete new row handed to ``on_row``."""
        try:
            with open(path, "rb") as f:
                fp = _fingerprint_fd(f)
                if fp is None:
                    return
                offset = self._offsets.get(fp, 0)
                # size from the SAME open file as the fingerprint — a
                # rename-under-us (rotation) cannot mix two files' state
                size = os.fstat(f.fileno()).st_size
                if size <= offset:
                    return
                f.seek(offset)
                chunk = f.read(size - offset)
        except OSError:
            return
        # leave a torn final line for the next refresh
        last_newline = chunk.rfind(b"\n")
        if last_newline < 0:
            return
        consumed = chunk[: last_newline + 1]
        self._offsets[fp] = offset + len(consumed)
        for line in consumed.splitlines():
            try:
                row = json.loads(line)
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(row, dict):
                try:
                    on_row(row)
                except Exception:
                    logger.warning("metrics ingest failed on a row", exc_info=True)

    def _tail_segment(self, path: str) -> None:
        self._tail_jsonl(path, self._consume_row)

    # -- router fleet trail --------------------------------------------------

    def _tail_router_trail(self) -> None:
        """Tail ``router/replicas.jsonl`` (the fleet supervisor's trail)
        through the same fingerprint-offset machinery as the telemetry
        segments, replaying each new row through
        :func:`~.ingest.observe_router_row` — this is how the
        ``serving_router_{respawns,shed,deadline_expired}_total`` counters
        reach a scrape without the router embedding an HTTP server."""
        path = os.path.join(self.logging_dir, "router", "replicas.jsonl")
        if not os.path.exists(path):
            return
        self._tail_jsonl(path, self._consume_router_row)

    def _consume_router_row(self, row: dict) -> None:
        observe_router_row(self.registry, row)
        # totals-row cumulative counters → ok/error outcome deltas for the
        # windowed error-rate objective, stamped at each row's own ts
        if row.get("kind") != "router":
            return
        ts = row.get("ts")
        delivered, shed = row.get("delivered"), row.get("shed")
        # fleet-wide expiry counter (router queue + engine-side evictions)
        # when the trail carries it; router-queue-only view otherwise
        expired = row.get("fleet_deadline_expired")
        if not isinstance(expired, (int, float)):
            expired = row.get("deadline_expired")
        if not isinstance(ts, (int, float)) or not all(
            isinstance(v, (int, float)) for v in (delivered, shed, expired)
        ):
            return
        if self._router_prev is not None:
            d_ok = delivered - self._router_prev[0]
            d_err = (shed - self._router_prev[1]) + (expired - self._router_prev[2])
            # negative deltas mean a router restart reset the counters —
            # skip the seam rather than counting time running backwards
            if d_ok >= 0 and d_err >= 0:
                self.slo.observe_outcomes(ts, ok=d_ok, errors=d_err)
        self._router_prev = (delivered, shed, expired)

    # -- heartbeats / goodput / alerts ---------------------------------------

    def _observe_heartbeats(self, now: float) -> None:
        import glob

        from ..diagnostics.monitor import HEARTBEAT_SUBDIR

        pattern = os.path.join(self.logging_dir, HEARTBEAT_SUBDIR, "heartbeat_*.json")
        for path in sorted(glob.glob(pattern)):
            try:
                with open(path) as f:
                    hb = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue
            host = str(hb.get("host", "?"))
            if isinstance(hb.get("step"), (int, float)):
                self.registry.gauge(
                    "host_step", "Latest heartbeat step per host"
                ).set(hb["step"], host=host)
            if isinstance(hb.get("ts"), (int, float)):
                self.registry.gauge(
                    "host_heartbeat_age_seconds", "Heartbeat staleness per host"
                ).set(max(0.0, now - hb["ts"]), host=host)
            self.registry.gauge(
                "host_watchdog_fired", "1 when the host's watchdog has fired"
            ).set(1.0 if hb.get("fired") else 0.0, host=host)

    def _observe_goodput(self, now: float) -> None:
        # throttled: a per-second scrape must not re-parse the trace trails
        # continuously (shared cache with the monitor's repaint loop)
        ledger = ledger_from_dir_throttled(self.logging_dir)
        self.last_goodput = ledger
        if ledger is None:
            return
        # the ledger is cumulative; stamped "now" it ages out of the SLO
        # window once the trails stop being refreshed
        self.slo.observe_goodput(now, ledger.get("goodput_pct"))
        self.registry.gauge(
            "goodput_ratio", "Productive-step fraction of elapsed wall-clock (0-1)"
        ).set(ledger["goodput_pct"] / 100.0)
        seconds = self.registry.gauge(
            "goodput_bucket_seconds", "Wall-clock attributed per cause (host-seconds)"
        )
        for bucket in BUCKETS:
            seconds.set(ledger["buckets_s"][bucket], bucket=bucket)

    def snapshot(self) -> dict:
        """The SLO-rule inputs this exporter can currently observe."""
        snap: dict = {
            "goodput_pct": self.last_goodput["goodput_pct"] if self.last_goodput else None,
            "ttft_p99_s": None,
            "recompiles_per_hour": None,
        }
        if self._ttfts:
            ttfts = sorted(self._ttfts)
            snap["ttft_p99_s"] = ttfts[min(len(ttfts) - 1, int(0.99 * len(ttfts)))]
        from ..diagnostics.monitor import MIN_RATE_WINDOW_S

        if (
            self._compile_rows
            and self._row_ts_min is not None
            and self._row_ts_max is not None
            # window floor shared with the monitor: a rate extrapolated
            # from seconds of evidence must not back a per-hour threshold
            and self._row_ts_max - self._row_ts_min >= MIN_RATE_WINDOW_S
        ):
            hours = (self._row_ts_max - self._row_ts_min) / 3600.0
            snap["recompiles_per_hour"] = self._compile_rows / hours
        return snap

    # -- public surface ------------------------------------------------------

    def refresh(self, now: float | None = None) -> list[dict]:
        """One scan: new telemetry rows → registry, goodput recomputed from
        traces, heartbeats re-read, the windowed SLO objectives evaluated
        as multi-window burn rates (and ``ALERTS.json`` schema 2 rewritten
        when any objective is armed). Returns the firing breaches."""
        now = time.time() if now is None else now
        for path in self._segments():
            self._tail_segment(path)
        self._tail_router_trail()
        self._observe_heartbeats(now)
        self._observe_goodput(now)
        if self._skipped_schema:
            self.registry.counter(
                "rows_skipped_unknown_schema",
                "Telemetry rows skipped for an unknown schema version",
            ).set_total(self._skipped_schema)
        snap = self.snapshot()
        # dominant tail phase rides along on every breach row (throttled —
        # shares the monitor's request-trace tail cache)
        from ..diagnostics.reqtrace import tail_from_dir_throttled

        tail = tail_from_dir_throttled(self.logging_dir)
        attribution = (tail or {}).get("attribution") or {}
        if attribution:
            self.slo.observe_phases(now, attribution)
        report = self.slo.report(now)
        firing = self.slo.evaluate(now)
        self.last_firing = firing
        write_slo_alerts(self.logging_dir, firing, report, snapshot=snap)
        if report:
            publish_gauges(self.registry, report)
            alert_gauge = self.registry.gauge(
                "slo_violation", "1 while the named SLO rule is firing"
            )
            for rule in report:
                alert_gauge.set(
                    1.0 if any(f["rule"] == rule for f in firing) else 0.0,
                    rule=rule,
                )
        self.last_refresh = now
        return firing

    def render(self) -> str:
        return render_openmetrics(self.registry)


def serve_exporter(
    exporter: LoggingDirExporter,
    port: int,
    host: str = "127.0.0.1",
    min_refresh_seconds: float = 1.0,
):
    """Serve ``GET /metrics`` (and ``/healthz``) for ``exporter``. Each
    scrape triggers a refresh, throttled to ``min_refresh_seconds`` so an
    over-eager scraper cannot make the sidecar re-parse traces in a loop.
    Returns the bound ``ThreadingHTTPServer`` (caller runs
    ``serve_forever``; ``server.server_address[1]`` is the real port when 0
    was requested)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    refresh_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, content_type: str):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0].rstrip("/")
            if path in ("", "/metrics"):
                with refresh_lock:
                    if (
                        exporter.last_refresh is None
                        or time.time() - exporter.last_refresh >= min_refresh_seconds
                    ):
                        try:
                            exporter.refresh()
                        except Exception:
                            logger.warning("exporter refresh failed", exc_info=True)
                    body = exporter.render().encode()
                self._send(200, body, CONTENT_TYPE)
            elif path == "/healthz":
                payload = json.dumps(
                    {
                        "logging_dir": exporter.logging_dir,
                        "last_refresh": exporter.last_refresh,
                        "firing": exporter.last_firing,
                    }
                ).encode()
                self._send(200, payload, "application/json")
            else:
                self._send(404, b'{"error": "unknown path"}', "application/json")

    return ThreadingHTTPServer((host, port), Handler)
