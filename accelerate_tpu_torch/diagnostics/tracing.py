"""Request-scoped tracing — Chrome/Perfetto ``trace_event`` JSON (the
request-scoped half of ``accelerate_tpu/diagnostics/tracing.py``: trace
ids, the :class:`Tracer` with its spans, instants, counters, request
events and flow arrows, the process-wide active tracer and
:func:`trace_span`, and the readers ``trace merge``, ``trace tail`` and the
goodput ledger parse with; the hang watchdog is not ported).

The on-disk format is the JAX package's, so its ``accelerate-tpu trace
merge`` reads a trace this module wrote:

* one file per process: ``{logging_dir}/traces/host_<n>.trace.json``
* JSON *array format*: a ``[`` line followed by one event object per line,
  each terminated by ``,\n`` and flushed — Perfetto and ``chrome://tracing``
  both accept a trailing comma / missing ``]``, so a SIGKILL'd run's trace
  is loadable as-is.
* event ``ts``/``dur`` are **monotonic** microseconds (``perf_counter``);
  a ``clock_sync`` metadata event records this host's wall-minus-monotonic
  offset so the merge tool can place all hosts on one wall-clock axis.

The disabled path is a single module-global read returning a shared no-op
context manager — cheap enough to leave ``trace_span`` calls in every hot
path unconditionally. Spans and request events are host-side records:
the serving engine emits them around its dispatches, never inside a
captured CUDA graph.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import uuid
from typing import Any

from ..metrics.ingest import observe_span as _observe_metrics_span
from ..metrics.registry import get_active_registry as _get_metrics_registry

logger = logging.getLogger(__name__)

#: file name pattern for per-host traces (the merge tool globs on this)
TRACE_FILE_PATTERN = "host_{host}.trace.json"
TRACE_SUBDIR = "traces"

#: category stamped on every request-scoped event (async ``b``/``n``/``e``
#: and flow ``s``/``f`` phases) — the merge stitcher and ``trace tail``
#: select on this, so free-form span names can never collide with the
#: request lifecycle vocabulary
REQUEST_CATEGORY = "request"

#: the shape a trace id must have to ride the wire: client-supplied ids
#: outside this alphabet are replaced at the submit boundary (a trace id
#: lands in file names, JSONL rows, and exemplar labels — it must never
#: need escaping anywhere)
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9_.:-]{1,64}$")


def new_trace_id() -> str:
    """A fresh 16-hex request trace id (random, not sequential: ids from
    independent routers/engines must not collide in a merged timeline)."""
    return uuid.uuid4().hex[:16]


def valid_trace_id(trace_id) -> bool:
    return isinstance(trace_id, str) and bool(_TRACE_ID_RE.match(trace_id))


def ensure_trace_id(trace_id) -> str:
    """The submit-boundary contract: a well-formed client-supplied id
    survives verbatim; anything else (missing, wrong type, unsafe chars)
    is replaced with a generated one — tracing must never reject a
    request."""
    return trace_id if valid_trace_id(trace_id) else new_trace_id()

#: version stamped as ``schema`` on every trace event (the trace-row
#: counterpart of ``telemetry.SCHEMA_VERSION``): readers skip-with-warning
#: events from a NEWER writer; events with no field are legacy = accepted
TRACE_SCHEMA_VERSION = 1


def _trace_schema_compatible(event: dict) -> bool:
    version = event.get("schema", 0)
    try:
        return int(version) <= TRACE_SCHEMA_VERSION
    except (TypeError, ValueError):
        return False


def _host_index() -> int:
    """This process's host index without forcing backend init: prefer an
    initialized PartialState, fall back to the launcher's env."""
    try:
        from ..state import PartialState

        if PartialState._shared_state:  # don't *create* state just to trace
            return int(PartialState().process_index)
    except Exception:
        pass
    return int(os.environ.get("ACCELERATE_PROCESS_INDEX", 0))


class _NullSpan:
    """Shared no-op context manager held by the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, **attrs):
        pass


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """Disabled-mode tracer: ``bool()`` is False, spans are the shared
    no-op (mirrors telemetry's NULL_TELEMETRY contract)."""

    enabled = False

    def __bool__(self):
        return False

    def span(self, name, **attrs):
        return _NULL_SPAN

    def instant(self, name, **attrs):
        pass

    def counter(self, name, value):
        pass

    def request_begin(self, trace_id, name, ts=None, **attrs):
        pass

    def request_instant(self, trace_id, name, ts=None, **attrs):
        pass

    def request_end(self, trace_id, name, ts=None, **attrs):
        pass

    def flow(self, trace_id, phase, name="req/hop", **attrs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


NULL_TRACER = _NullTracer()

#: process-wide active tracer (Borg like telemetry's active recorder): free
#: functions (lazy.py, operations.py, data_loader.py) trace through this
_ACTIVE_TRACER: "_NullTracer | Tracer" = NULL_TRACER


def get_tracer():
    return _ACTIVE_TRACER


def set_active_tracer(tracer) -> None:
    global _ACTIVE_TRACER
    _ACTIVE_TRACER = tracer if tracer is not None else NULL_TRACER


class _Span:
    """One open span: records entry on ``__enter__``, emits a complete
    Chrome ``ph:"X"`` event on ``__exit__``."""

    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0

    def set_attr(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._emit_complete(self.name, self._t0, t1 - self._t0, self.attrs)
        return False


class Tracer:
    """Per-host Chrome ``trace_event`` writer.

    Args:
        logging_dir: root under which ``traces/host_<n>.trace.json`` is
            appended. ``None`` disables the file sink.
        host: process index used as the trace ``pid``; default resolves
            from ``PartialState``/env.
        buffer_events: batch this many events per write+flush (1 = flush
            every event, the crash-safest; the default batches a little to
            keep the hot path cheap without risking more than a step's
            worth of spans on a crash).
        process_name: label for this process in the merged timeline
            (default ``host_<n>``) — serving processes pass ``router`` /
            ``replica_<i>`` so a stitched request flow reads as a hop
            between *roles*, not anonymous host indices.
    """

    enabled = True

    def __init__(
        self,
        logging_dir: str | None = None,
        host: int | None = None,
        buffer_events: int = 16,
        process_name: str | None = None,
    ):
        self.host = _host_index() if host is None else int(host)
        self.process_name = process_name or f"host_{self.host}"
        self._file = None
        self.path = None
        self._lock = threading.Lock()
        self._buffer: list[str] = []
        self._buffer_events = max(1, int(buffer_events))
        self._closed = False

        if logging_dir is not None:
            trace_dir = os.path.join(logging_dir, TRACE_SUBDIR)
            try:
                os.makedirs(trace_dir, exist_ok=True)
                self.path = os.path.join(
                    trace_dir, TRACE_FILE_PATTERN.format(host=self.host)
                )
                fresh = not os.path.exists(self.path)
                self._file = open(self.path, "a")
                if fresh:
                    self._file.write("[\n")
            except OSError:
                logger.warning("tracing disabled: cannot write under %s", trace_dir, exc_info=True)
                self._file = None
                self.path = None
        # metadata: name the process after the host, and record the
        # wall-vs-monotonic clock offset the merge tool corrects with
        self._write_event(
            {
                "name": "process_name", "ph": "M", "pid": self.host, "tid": 0,
                "args": {"name": self.process_name},
            },
            flush=True,
        )
        self.clock_offset_s = time.time() - time.perf_counter()
        self._write_event(
            {
                "name": "clock_sync", "ph": "M", "pid": self.host, "tid": 0,
                "args": {"wall_minus_mono_s": self.clock_offset_s, "pid_os": os.getpid()},
            },
            flush=True,
        )
        # crash paths must not lose the buffered tail (same contract as the
        # telemetry recorder's atexit close; close() unregisters)
        import atexit

        atexit.register(self.close)

    # -- span surface --------------------------------------------------------

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs):
        """A zero-duration marker (``ph:"i"``) — recompiles, preemption
        flags."""
        self._write_event(
            {
                "name": name, "ph": "i", "s": "p",
                "ts": time.perf_counter() * 1e6,
                "pid": self.host, "tid": threading.get_ident(),
                "args": attrs,
            }
        )

    def counter(self, name: str, value: float):
        self._write_event(
            {
                "name": name, "ph": "C",
                "ts": time.perf_counter() * 1e6,
                "pid": self.host, "tid": threading.get_ident(),
                "args": {"value": value},
            }
        )

    # -- request-scoped events (the per-request lifecycle surface) -----------
    #
    # Perfetto *nestable async* events keyed on (cat="request", id=trace_id):
    # ``b``/``e`` bracket the request's lifetime inside THIS process and the
    # ``n`` instants mark lifecycle transitions in between — deliberately
    # NOT per-token spans, so a 10k-token completion costs a handful of
    # events, not 10k. ``ts`` may be supplied (monotonic seconds) so an
    # event can be stamped with the engine's own timing fields — `trace
    # tail` then reproduces the engine-reported TTFT exactly instead of
    # within call-latency noise.

    def _request_event(self, ph: str, trace_id: str, name: str,
                       ts: float | None, attrs: dict):
        event = {
            "name": name, "cat": REQUEST_CATEGORY, "ph": ph,
            "id": str(trace_id),
            "ts": (time.perf_counter() if ts is None else float(ts)) * 1e6,
            "pid": self.host, "tid": threading.get_ident(),
        }
        if attrs:
            event["args"] = attrs
        self._write_event(event)

    def request_begin(self, trace_id: str, name: str, ts: float | None = None,
                      **attrs):
        self._request_event("b", trace_id, name, ts, attrs)

    def request_instant(self, trace_id: str, name: str, ts: float | None = None,
                        **attrs):
        self._request_event("n", trace_id, name, ts, attrs)

    def request_end(self, trace_id: str, name: str, ts: float | None = None,
                    **attrs):
        self._request_event("e", trace_id, name, ts, attrs)

    def flow(self, trace_id: str, phase: str, name: str = "req/hop", **attrs):
        """A flow-event endpoint (``s`` = arrow tail at the sender, ``f`` =
        arrow head at the receiver) keyed on the trace id: after ``trace
        merge`` fuses the per-process files, Perfetto draws the arrow from
        the router's dispatch to the replica's admission — the visual form
        of cross-process trace propagation."""
        event = {
            "name": name, "cat": REQUEST_CATEGORY, "ph": phase,
            "id": str(trace_id),
            "ts": time.perf_counter() * 1e6,
            "pid": self.host, "tid": threading.get_ident(),
        }
        if phase == "f":
            event["bp"] = "e"  # bind to the enclosing slice
        if attrs:
            event["args"] = attrs
        self._write_event(event)

    # -- internals -----------------------------------------------------------

    def _emit_complete(self, name: str, t0: float, dur: float, attrs: dict):
        event = {
            "name": name, "ph": "X",
            "ts": t0 * 1e6, "dur": dur * 1e6,
            "pid": self.host, "tid": threading.get_ident(),
        }
        if attrs:
            event["args"] = attrs
        self._write_event(event)
        # span exit → per-phase latency histogram on the scrape surface
        # (one global read when no registry is active — and this line only
        # runs at all when tracing itself is enabled)
        registry = _get_metrics_registry()
        if registry:
            try:
                _observe_metrics_span(registry, name, dur)
            except Exception:
                pass

    def _write_event(self, event: dict, flush: bool = False):
        if self._file is None:
            return
        event.setdefault("schema", TRACE_SCHEMA_VERSION)
        try:
            line = json.dumps(event, default=str) + ",\n"
        except (TypeError, ValueError):
            return
        with self._lock:
            if self._file is None:
                return
            self._buffer.append(line)
            if flush or len(self._buffer) >= self._buffer_events:
                self._drain_locked()

    def _drain_locked(self):
        if self._file is None or not self._buffer:
            self._buffer.clear()
            return
        try:
            # tpu-lint: ignore[RC003] — serializing this trace file IS this lock's job: buffered batch append, crash-safe format, and span exit is the only writer
            self._file.write("".join(self._buffer))
            self._file.flush()  # tpu-lint: ignore[RC003] — same rationale
        except (OSError, ValueError):
            pass
        self._buffer.clear()

    def flush(self):
        with self._lock:
            self._drain_locked()

    def close(self):
        """Idempotent; leaves the file in the same trailing-comma format a
        crash would (the array format tolerates it, merge normalizes it)."""
        if self._closed:
            return
        self._closed = True
        import atexit

        try:
            atexit.unregister(self.close)
        except Exception:
            pass
        with self._lock:
            self._drain_locked()
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
        global _ACTIVE_TRACER
        if _ACTIVE_TRACER is self:
            _ACTIVE_TRACER = NULL_TRACER


def trace_span(name: str, **attrs):
    """Module-level span entry point for the instrumented hot paths:
    ``with trace_span("serve/decode"): ...``. Routes through the
    process-wide active tracer; disabled this is one global read returning
    a shared no-op context manager."""
    tracer = _ACTIVE_TRACER
    if tracer:
        return tracer.span(name, **attrs)
    return _NULL_SPAN


def trace_instant(name: str, **attrs):
    _ACTIVE_TRACER.instant(name, **attrs)


def traced(name: str | None = None):
    """Decorator form of :func:`trace_span`: every call to the function runs
    in a span named ``name`` (default: the function's name). The eager
    collectives wear it as ``collective/<name>``."""
    import functools

    def deco(fn):
        span_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with trace_span(span_name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# readers: `trace merge`, `trace tail` and the goodput ledger (copies of the
# JAX package's; pure file reads)
# ---------------------------------------------------------------------------


def parse_trace_file(path: str) -> list[dict]:
    """Lenient line-oriented parse of the append-format trace file: skips
    the ``[``/``]`` bracket lines, any torn tail line a crash left, and —
    with a warning — events stamped with a newer ``schema`` version than
    this reader understands."""
    events: list[dict] = []
    skipped_schema = 0
    try:
        with open(path) as f:
            for line in f:
                line = line.strip().rstrip(",")
                if not line or line in ("[", "]"):
                    continue
                try:
                    event = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail from a crash mid-write
                if not isinstance(event, dict):
                    continue
                if not _trace_schema_compatible(event):
                    skipped_schema += 1
                    continue
                events.append(event)
    except OSError:
        pass
    if skipped_schema:
        logger.warning(
            "%s: skipped %d events with an unknown schema version (> %d) — "
            "upgrade this reader", path, skipped_schema, TRACE_SCHEMA_VERSION,
        )
    return events


def discover_trace_files(logging_dir: str) -> list[str]:
    """Every per-process trace file a run (or a routed fleet) left under
    ``logging_dir``: the host files in ``traces/`` plus — for a fleet —
    each replica's own ``replica_*/traces/`` files, so one merge shows a
    request hopping router → replica."""
    import glob as _glob

    pats = (
        os.path.join(logging_dir, TRACE_SUBDIR, "host_*.trace.json"),
        os.path.join(logging_dir, "host_*.trace.json"),
        os.path.join(logging_dir, "replica_*", TRACE_SUBDIR, "host_*.trace.json"),
    )
    seen: list[str] = []
    for pat in pats:
        for path in sorted(_glob.glob(pat)):
            if path not in seen:
                seen.append(path)
    return seen


def discover_profile_artifacts(logging_dir: str) -> list[str]:
    """Every on-demand profiler capture directory a run (or fleet) left
    under ``logging_dir`` — the ``profiles/profile_<stamp>_<pid>/`` dirs
    :class:`accelerate_tpu_torch.serving.flight.ProfileWindow` writes,
    per replica for a fleet — so ``trace merge`` can point the operator
    at the profiler artifacts riding beside the merged timeline."""
    import glob as _glob

    pats = (
        os.path.join(logging_dir, "profiles", "profile_*"),
        os.path.join(logging_dir, "replica_*", "profiles", "profile_*"),
    )
    seen: list[str] = []
    for pat in pats:
        for path in sorted(_glob.glob(pat)):
            if os.path.isdir(path) and path not in seen:
                seen.append(path)
    return seen


def iter_offset_events(events):
    """Yield ``(event, offset_us)`` pairs where ``offset_us`` is the most
    recent ``clock_sync``'s wall-minus-monotonic offset — applied
    SEQUENTIALLY, because one file can hold several monotonic epochs (the
    tracer appends across restarts, each with a fresh ``perf_counter``
    origin). The single source of the offset arithmetic shared by
    :func:`merge_traces` and the reqtrace reader, so ``trace merge`` and
    ``trace tail`` can never disagree about a file's wall timestamps.
    ``clock_sync`` rows are yielded too (with the offset they establish)
    so callers can record per-host offsets and warn on torn payloads."""
    offset_us = 0.0
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "clock_sync":
            wall_minus_mono = (e.get("args") or {}).get("wall_minus_mono_s")
            if wall_minus_mono is not None:
                offset_us = float(wall_minus_mono) * 1e6
        yield e, offset_us


def _stitch_request_flows(merged: list[dict]) -> dict:
    """Cross-process request accounting over the merged (clock-corrected)
    timeline: for every trace id, which processes it touched and whether
    its flow arrows pair up. ``orphan_flows`` counts ``s`` events with no
    ``f`` (or vice versa) — the smoke harness's zero-orphans bar."""
    by_id: dict[str, dict] = {}
    for e in merged:
        if e.get("cat") != REQUEST_CATEGORY or "id" not in e:
            continue
        info = by_id.setdefault(e["id"], {"pids": set(), "s": 0, "f": 0})
        info["pids"].add(e.get("pid"))
        ph = e.get("ph")
        if ph == "s":
            info["s"] += 1
        elif ph == "f":
            info["f"] += 1
    orphans = sum(abs(i["s"] - i["f"]) for i in by_id.values())
    return {
        "trace_ids": len(by_id),
        "cross_process": sum(1 for i in by_id.values() if len(i["pids"]) > 1),
        "orphan_flows": orphans,
    }


def merge_traces(
    trace_dir: str | None = None,
    output_path: str | None = None,
    paths: list[str] | None = None,
) -> dict:
    """Fuse ``host_*.trace.json`` files into ONE Perfetto-loadable timeline.

    Every host's events carry monotonic timestamps with an arbitrary origin;
    each file's ``clock_sync`` metadata records that host's wall-minus-
    monotonic offset. The merge shifts every host onto the wall clock
    (``ts + offset``), then rebases the union so the earliest event sits at
    t=0 — cross-host skew is then exactly the wall-clock skew between
    hosts, which is what a straggler investigation wants to see.

    ``paths`` (instead of a directory) merges an explicit file list — the
    ``trace merge``/``trace tail`` CLIs pass a whole fleet's files (router
    + every replica) through :func:`discover_trace_files`. Two *files*
    claiming the same pid (a router and a replica each being host 0 of
    their own process) are disambiguated by remapping the later file onto
    a fresh pid, so the merged view keeps one track per process. Request-
    scoped events (``cat="request"``) are stitched by trace id and the
    tally lands in ``metadata.request_flows``.

    Returns the merged trace dict (``{"traceEvents": [...]}``); when
    ``output_path`` is given it is also written there as well-formed JSON.
    """
    import glob as _glob

    if paths is None:
        paths = sorted(_glob.glob(os.path.join(trace_dir, "host_*.trace.json")))
    if not paths:
        raise FileNotFoundError(f"no host_*.trace.json under {trace_dir}")

    merged: list[dict] = []
    offsets: dict[int, float] = {}
    used_pids: set[int] = set()
    for path in paths:
        events = parse_trace_file(path)
        # pid disambiguation across FILES: each process writes its own file
        # with its own host index as pid, and two independent processes
        # (router + replica, or two replicas' own host 0) may collide —
        # remap this file's colliding pids onto fresh ones so each file
        # stays one distinct track in the merged timeline
        file_pids = sorted(
            {e["pid"] for e in events if isinstance(e.get("pid"), int)}
        )
        pid_map: dict[int, int] = {}
        for pid in file_pids:
            if pid in used_pids:
                new = (max(used_pids | set(pid_map.values())) + 1) if used_pids else 0
                pid_map[pid] = new
                used_pids.add(new)
            else:
                used_pids.add(pid)
        if pid_map:
            remapped = []
            for e in events:
                if isinstance(e.get("pid"), int) and e["pid"] in pid_map:
                    e = dict(e)
                    e["pid"] = pid_map[e["pid"]]
                remapped.append(e)
            events = remapped
        # offsets apply SEQUENTIALLY via iter_offset_events — every event
        # uses the most recent clock_sync above it, so a resumed run's
        # spans land at their true wall-clock position, not the dead
        # process's (a file holds one epoch per restart)
        saw_clock_sync = False
        for e, offset_us in iter_offset_events(events):
            if e.get("ph") == "M":
                if e.get("name") == "clock_sync":
                    # a partial/killed host can leave a clock_sync with a
                    # torn/missing args payload: warn and keep the previous
                    # offset (zero before the first good one) instead of
                    # crashing the whole merge on one casualty's file
                    wall_minus_mono = (e.get("args") or {}).get("wall_minus_mono_s")
                    if wall_minus_mono is None:
                        logger.warning(
                            "%s: clock_sync without wall_minus_mono_s "
                            "(partial/killed host?) — assuming zero offset", path,
                        )
                    else:
                        saw_clock_sync = True
                    host = e.get("pid")
                    if host is not None:
                        offsets[int(host)] = offset_us / 1e6  # last epoch wins
                    continue  # consumed; per-host process_name survives
                merged.append(e)
                continue
            e = dict(e)
            if "ts" in e:
                e["ts"] = float(e["ts"]) + offset_us
            merged.append(e)
        if not saw_clock_sync:
            # the host still lands on the merged timeline (at its raw
            # monotonic positions) and is still counted in merged_hosts —
            # its cross-host skew is simply unknown
            logger.warning(
                "%s: no clock_sync metadata (partial/killed host?) — events "
                "merged with zero clock offset", path,
            )
            base = os.path.basename(path)
            try:
                host_id = int(base.split("_")[1].split(".")[0])
                offsets.setdefault(host_id, 0.0)
            except (IndexError, ValueError):
                pass

    timed = [e for e in merged if "ts" in e]
    t0 = min((float(e["ts"]) for e in timed), default=0.0)
    for e in timed:
        e["ts"] = float(e["ts"]) - t0
    merged.sort(key=lambda e: float(e.get("ts", 0.0)))

    trace = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged_hosts": sorted(offsets),
            "clock_offsets_s": {str(h): o for h, o in sorted(offsets.items())},
            "t0_wall_s": t0 / 1e6,
            "request_flows": _stitch_request_flows(merged),
        },
    }
    if output_path is not None:
        tmp = output_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f)
        os.replace(tmp, output_path)
    return trace


def validate_chrome_trace(trace: dict | list) -> None:
    """Raise ValueError unless ``trace`` is loadable by Perfetto /
    ``chrome://tracing`` (schema check used by tests and trace-smoke)."""
    events = trace.get("traceEvents") if isinstance(trace, dict) else trace
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents")
    for e in events:
        if not isinstance(e, dict):
            raise ValueError(f"non-object event: {e!r}")
        if "ph" not in e or "name" not in e:
            raise ValueError(f"event missing ph/name: {e!r}")
        if e["ph"] in ("X", "B", "E", "i", "C") and "ts" not in e:
            raise ValueError(f"timed event missing ts: {e!r}")
        if e["ph"] == "X" and "dur" not in e:
            raise ValueError(f"complete event missing dur: {e!r}")
