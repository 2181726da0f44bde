"""Labeled counter/gauge/histogram registry — the fleet-scrape surface (a
copy of ``accelerate_tpu/metrics/registry.py``; the main-process gate reads
the port's :class:`~accelerate_tpu_torch.state.PartialState`).

Telemetry and tracing record everything into per-host JSONL/trace files;
this registry is the *live* aggregation those records (and the
span/watchdog/serving hooks) feed so one ``GET /metrics`` answers "how is
this job doing right now" without tailing files. Design mirrors the other observability subsystems:

* a process-wide **active registry** (:func:`get_active_registry` /
  :func:`set_active_registry`) holding :data:`NULL_REGISTRY` when metrics
  are off — every instrumentation point costs one global read + one
  truthiness test in the disabled path, exactly like ``trace_span``;
* **main-process gating** like ``tracking.on_main_process`` and the
  telemetry JSONL sink: on a multi-host job only host 0's registry is
  enabled by default (the sidecar exporter covers per-host scraping);
* three metric kinds with Prometheus/OpenMetrics semantics — monotonic
  ``Counter`` (``inc``; ``set_total`` for readers reconstructing totals
  from a cumulative field in a record trail), ``Gauge`` (``set``), and
  ``Histogram`` (``observe`` into cumulative ``le`` buckets).

Rendering to exposition text lives in :mod:`.openmetrics`; the record →
metric mapping shared by the in-process hooks and the sidecar exporter
lives in :mod:`.ingest`.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "DEFAULT_BUCKETS",
    "get_active_registry",
    "set_active_registry",
]

#: default histogram buckets (seconds-flavored: spans µs-scale dispatches
#: through multi-minute compiles/checkpoints)
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
)

_VALID_KINDS = ("counter", "gauge", "histogram")


def _is_main_process() -> bool:
    """Same gate as the telemetry JSONL sink: process 0 of an initialized
    :class:`~accelerate_tpu_torch.state.PartialState`, or this process when
    none is (the state is read, never created: creating it would pick a
    device)."""
    from ..state import PartialState

    return PartialState._shared_state.get("process_index", 0) == 0


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """One (metric, label-set) time series."""

    __slots__ = ("labels", "value", "bucket_counts", "total", "count", "exemplars")

    def __init__(self, labels: tuple, n_buckets: int = 0):
        self.labels = labels
        self.value = 0.0
        if n_buckets:
            self.bucket_counts = [0] * n_buckets
            self.total = 0.0
            self.count = 0
            #: bucket index (len(buckets) = the +Inf bucket) → the newest
            #: OpenMetrics exemplar observed into it: (label pairs, value,
            #: wall ts). One slot per bucket — a scrape links a bad bucket
            #: to ONE representative trace, not a history.
            self.exemplars: dict[int, tuple[tuple, float, float]] = {}

    def snapshot(self) -> "_Series":
        """A consistent copy (caller holds the registry lock): the renderer
        must never read live series state, or a concurrent ``observe()``
        can tear a histogram mid-render (a finite ``le`` bucket counted but
        ``count`` not yet bumped → non-monotonic buckets that the strict
        parser — and strict scrapers — reject)."""
        copy = _Series(self.labels)
        copy.value = self.value
        if hasattr(self, "count"):
            copy.bucket_counts = list(self.bucket_counts)
            copy.total = self.total
            copy.count = self.count
            copy.exemplars = dict(self.exemplars)
        return copy


class Metric:
    """One metric family: a name, a kind, a help string, and its series
    (one per distinct label set). All mutation goes through the owning
    registry's lock — the serve HTTP scrape thread and the engine loop
    touch the same families concurrently."""

    def __init__(self, name: str, kind: str, help: str, lock: threading.Lock,
                 buckets: tuple[float, ...] | None = None):
        if kind not in _VALID_KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self._lock = lock
        self.buckets: tuple[float, ...] | None = None
        if kind == "histogram":
            buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
            if not buckets:
                raise ValueError("histogram needs at least one bucket bound")
            self.buckets = buckets
        self._series: dict[tuple, _Series] = {}

    def _get_series(self, labels: dict | None) -> _Series:
        key = _label_key(labels)
        series = self._series.get(key)
        if series is None:
            series = _Series(key, len(self.buckets) if self.buckets else 0)
            self._series[key] = series
        return series

    # -- mutation (each takes the registry lock) -----------------------------

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {value})")
        with self._lock:
            self._get_series(labels).value += value

    def set(self, value: float, **labels):
        with self._lock:
            self._get_series(labels).value = float(value)

    def set_total(self, value: float, **labels):
        """Counter ratchet for readers that reconstruct a total from a
        cumulative field in a record trail (e.g. the sidecar reading
        ``recompiles`` off step rows): keeps the counter monotonic even if
        rows arrive out of order or a trail is re-read."""
        with self._lock:
            series = self._get_series(labels)
            if value > series.value:
                series.value = float(value)

    def observe(self, value: float, exemplar: dict | None = None, **labels):
        """``exemplar`` (e.g. ``{"trace_id": "..."}``) attaches an
        OpenMetrics exemplar to the bucket this observation lands in: the
        scrape then links the bucket straight to the trace that filled it
        (``# {trace_id="…"} value ts`` per the 1.0 spec). An exemplar
        whose labelset exceeds the spec's 128-character cap is dropped
        here — the renderer must never emit exposition text its own
        strict parser rejects."""
        with self._lock:
            series = self._get_series(labels)
            # per-bucket raw counts; the renderer accumulates them into the
            # cumulative-`le` form the exposition format requires
            idx = bisect_left(self.buckets, value)
            if idx < len(self.buckets):
                series.bucket_counts[idx] += 1
            series.total += float(value)
            series.count += 1
            if exemplar:
                pairs = tuple(
                    sorted((str(k), str(v)) for k, v in exemplar.items())
                )
                if sum(len(k) + len(v) for k, v in pairs) <= 128:
                    series.exemplars[idx] = (pairs, float(value), time.time())

    # -- queries -------------------------------------------------------------

    def series(self) -> list[_Series]:
        with self._lock:
            return [s.snapshot() for s in self._series.values()]

    def value(self, **labels):
        """Test/debug accessor: the scalar value (counter/gauge) or
        ``(count, sum)`` (histogram) of one series; None when absent."""
        with self._lock:
            series = self._series.get(_label_key(labels))
            if series is None:
                return None
            if self.kind == "histogram":
                return (series.count, series.total)
            return series.value


class MetricsRegistry:
    """Holds metric families and hands them to the exposition renderer.

    Args:
        namespace: prefix applied to every metric name (``accelerate`` →
            ``accelerate_steps_total``).
        gate_main_process: when True (the default), a non-main process gets
            a disabled registry — mutations are dropped at the family
            accessors, mirroring the telemetry JSONL sink's gate. The
            sidecar exporter passes False (it aggregates *files*, not
            process state).
    """

    def __init__(self, namespace: str = "accelerate", gate_main_process: bool = True):
        self.namespace = namespace
        self.enabled = _is_main_process() if gate_main_process else True
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def __bool__(self) -> bool:
        return self.enabled

    def _family(self, name: str, kind: str, help: str,
                buckets: tuple[float, ...] | None = None) -> Metric:
        full = f"{self.namespace}_{name}" if self.namespace else name
        with self._lock:
            metric = self._metrics.get(full)
            if metric is None:
                metric = Metric(full, kind, help, self._lock, buckets)
                self._metrics[full] = metric
        if metric.kind != kind:
            raise ValueError(
                f"metric {full} already registered as {metric.kind}, not {kind}"
            )
        return metric

    def counter(self, name: str, help: str = "") -> Metric:
        return self._family(name, "counter", help)

    def gauge(self, name: str, help: str = "") -> Metric:
        return self._family(name, "gauge", help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] | None = None) -> Metric:
        return self._family(name, "histogram", help, buckets)

    def collect(self) -> list[Metric]:
        with self._lock:
            return list(self._metrics.values())


class _NullRegistry:
    """Disabled-mode registry: falsy, and every accessor returns a shared
    do-nothing metric — instrumentation sites guard with one truthiness
    test and never reach these, but a leaked reference stays harmless."""

    enabled = False
    namespace = "accelerate"

    def __bool__(self):
        return False

    def counter(self, name, help=""):
        return _NULL_METRIC

    def gauge(self, name, help=""):
        return _NULL_METRIC

    def histogram(self, name, help="", buckets=None):
        return _NULL_METRIC

    def collect(self):
        return []


class _NullMetric:
    def inc(self, value=1.0, **labels):
        pass

    def set(self, value, **labels):
        pass

    def set_total(self, value, **labels):
        pass

    def observe(self, value, exemplar=None, **labels):
        pass

    def series(self):
        return []

    def value(self, **labels):
        return None


_NULL_METRIC = _NullMetric()
NULL_REGISTRY = _NullRegistry()

#: process-wide active registry (Borg like telemetry's active recorder and
#: the active tracer): the telemetry emit hook, the tracer's span-exit
#: hook, the watchdog, and the serve front end all publish through this
_ACTIVE_REGISTRY: "_NullRegistry | MetricsRegistry" = NULL_REGISTRY


def get_active_registry():
    return _ACTIVE_REGISTRY


def set_active_registry(registry) -> None:
    global _ACTIVE_REGISTRY
    _ACTIVE_REGISTRY = registry if registry is not None else NULL_REGISTRY
