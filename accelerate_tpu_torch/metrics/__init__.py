"""Live metrics: the labeled registry (:mod:`.registry`), OpenMetrics text
and its strict parser (:mod:`.openmetrics`), and the one record → metric
mapping (:mod:`.ingest`) — copies of ``accelerate_tpu/metrics``' serving
surface, so ``serve --http``'s ``GET /metrics`` answers the same families
as the JAX package's."""

from .ingest import observe_engine_stats, observe_flight, observe_record, observe_span
from .openmetrics import CONTENT_TYPE, parse_openmetrics, render_openmetrics
from .registry import (
    DEFAULT_BUCKETS,
    NULL_REGISTRY,
    MetricsRegistry,
    get_active_registry,
    set_active_registry,
)

__all__ = [
    "CONTENT_TYPE",
    "DEFAULT_BUCKETS",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "get_active_registry",
    "observe_engine_stats",
    "observe_flight",
    "observe_record",
    "observe_span",
    "parse_openmetrics",
    "render_openmetrics",
    "set_active_registry",
]
