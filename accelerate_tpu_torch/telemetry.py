"""Telemetry: crash-safe JSONL rows and their feed into the live metrics
registry (the serving, checkpoint and event rows of
``accelerate_tpu/telemetry.py``).

A :class:`TelemetryRecorder` appends one JSON object a line to
``{logging_dir}/telemetry/telemetry.jsonl`` — the file, the row shapes and
the size-capped rotation are the JAX package's, so its ``accelerate-tpu
monitor`` and metrics exporter read a trail this module wrote. Rows:

* ``{"type": "serving", "kind": "request" | "step" | "profile", ...}`` from
  the serving engine (:meth:`record_serving`): one a finished request, one
  every ``EngineConfig.stats_interval`` iterations, one a ``/profile``
  window;
* ``{"type": "compile", "label": <program>, ...}`` one a CUDA-graph capture
  (:meth:`record_capture`): the port's counterpart of the JAX package's
  one row an XLA compile (it has no lazy compile cache to hook);
* ``{"type": "generate", "mode": ...}`` one a ``generate()`` call
  (:meth:`record_generation`);
* ``{"type": "checkpoint", "kind": "save" | "restore", ...}`` one a
  checkpoint save or restore (:meth:`record_checkpoint`, fed by
  ``checkpointing.py``);
* ``{"type": "event", "kind": ...}`` (:meth:`record_event`), e.g. the
  emergency save's ``"preemption"`` and the watchdog's ``"watchdog_hang"``.

Every row also passes through :func:`~.metrics.ingest.observe_record` into
the active :class:`~.metrics.registry.MetricsRegistry`, so ``GET
/metrics`` reflects it. The process-wide active recorder holds
:data:`NULL_TELEMETRY` when telemetry is off: each instrumentation point
pays one global read and one truthiness test.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque

from .metrics.ingest import observe_record as _observe_metrics_record
from .metrics.registry import _is_main_process
from .metrics.registry import get_active_registry as _get_metrics_registry

logger = logging.getLogger(__name__)

#: version stamped as ``schema`` on every row (the JAX package's readers
#: skip rows of a newer version)
SCHEMA_VERSION = 1


def schema_compatible(row: dict) -> bool:
    """True when this reader understands ``row``'s schema version (missing
    field = legacy = compatible; garbage values are incompatible)."""
    version = row.get("schema", 0)
    try:
        return int(version) <= SCHEMA_VERSION
    except (TypeError, ValueError):
        return False


def telemetry_segments(jsonl_path: str) -> list[str]:
    """Existing JSONL segments for a trail, oldest → newest: rotated
    ``telemetry.jsonl.N`` … ``telemetry.jsonl.1`` then the live file.
    Readers (``monitor``'s tail, the metrics exporter) iterate this instead
    of assuming one unbounded file."""
    segments: list[str] = []
    suffixes = []
    try:
        directory = os.path.dirname(jsonl_path) or "."
        base = os.path.basename(jsonl_path)
        for name in os.listdir(directory):
            if name.startswith(base + "."):
                tail = name[len(base) + 1:]
                if tail.isdigit():
                    suffixes.append(int(tail))
    except OSError:
        pass
    for n in sorted(suffixes, reverse=True):
        segments.append(f"{jsonl_path}.{n}")
    if os.path.exists(jsonl_path):
        segments.append(jsonl_path)
    return segments


class _NullTelemetry:
    """The disabled recorder: every method is a no-op and ``bool()`` is
    False, so an instrumentation point is one truthiness test."""

    def __bool__(self):
        return False

    def record_serving(self, *a, **k):
        pass

    def record_capture(self, *a, **k):
        pass

    def record_generation(self, *a, **k):
        pass

    def record_checkpoint(self, *a, **k):
        pass

    def record_event(self, *a, **k):
        pass


NULL_TELEMETRY = _NullTelemetry()

_ACTIVE: _NullTelemetry | "TelemetryRecorder" = NULL_TELEMETRY


def get_active_recorder():
    return _ACTIVE


def set_active_recorder(recorder) -> None:
    global _ACTIVE
    _ACTIVE = recorder if recorder is not None else NULL_TELEMETRY


class TelemetryRecorder:
    """Collects serving rows into a ring (``records``), the JSONL file and
    the active metrics registry.

    Args:
        logging_dir: root under which ``telemetry/telemetry.jsonl`` is
            appended (no file sink when None, or off the main process).
        ring_size: rows kept in memory.

    The trail is size-capped: past ``ACCELERATE_TELEMETRY_MAX_BYTES``
    (default 64 MiB; 0 disables) the live file rolls to
    ``telemetry.jsonl.1``, older segments shift up, and the oldest beyond
    ``ACCELERATE_TELEMETRY_KEEP_SEGMENTS`` (default 4) is dropped.
    """

    def __init__(self, logging_dir: str | None = None, ring_size: int = 1024):
        self._closed = False
        self.records: deque = deque(maxlen=int(ring_size))
        self.recompile_count = 0
        self._jsonl = None
        self._jsonl_path = None
        self._jsonl_bytes = 0
        self._jsonl_max_bytes = int(
            os.environ.get("ACCELERATE_TELEMETRY_MAX_BYTES", str(64 * 1024 * 1024))
        )
        self._jsonl_keep = max(1, int(os.environ.get("ACCELERATE_TELEMETRY_KEEP_SEGMENTS", "4")))
        if logging_dir is not None and _is_main_process():
            tel_dir = os.path.join(logging_dir, "telemetry")
            os.makedirs(tel_dir, exist_ok=True)
            self._jsonl_path = os.path.join(tel_dir, "telemetry.jsonl")
            try:
                self._jsonl_bytes = os.path.getsize(self._jsonl_path)
            except OSError:
                self._jsonl_bytes = 0
            self._jsonl = open(self._jsonl_path, "a")
        # a crash path that never reaches close() still leaves a complete
        # tail (close() is idempotent and unregisters this)
        import atexit

        atexit.register(self.close)

    # -- sinks ---------------------------------------------------------------

    def _emit(self, record: dict) -> None:
        record.setdefault("ts", time.time())
        record.setdefault("schema", SCHEMA_VERSION)
        self.records.append(record)
        registry = _get_metrics_registry()
        if registry:
            try:
                _observe_metrics_record(registry, record)
            except Exception:  # the scrape surface must never kill serving
                logger.warning("metrics ingest failed", exc_info=True)
        if self._jsonl is not None:
            try:
                line = json.dumps(record, default=_json_default) + "\n"
                self._jsonl.write(line)
                self._jsonl.flush()
                self._jsonl_bytes += len(line)
                if self._jsonl_max_bytes and self._jsonl_bytes >= self._jsonl_max_bytes:
                    self._rotate_jsonl()
            except ValueError:  # closed file (close() raced a record)
                pass

    def _rotate_jsonl(self) -> None:
        """Close the live file, shift the rotated segments up one (dropping
        the oldest past the keep count), move the live trail to ``.1`` and
        reopen a fresh one. A crash mid-rotation loses at most the rename in
        flight: segment files are never rewritten."""
        if self._jsonl is None or self._jsonl_path is None:
            return
        try:
            self._jsonl.close()
        except Exception:
            pass
        self._jsonl = None
        path = self._jsonl_path
        try:
            oldest = f"{path}.{self._jsonl_keep}"
            if os.path.exists(oldest):
                os.unlink(oldest)
            for n in range(self._jsonl_keep - 1, 0, -1):
                src = f"{path}.{n}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{n + 1}")
            os.replace(path, f"{path}.1")
        except OSError:
            logger.warning("telemetry JSONL rotation failed", exc_info=True)
        try:
            self._jsonl = open(path, "a")
            self._jsonl_bytes = 0
        except OSError:
            logger.warning("telemetry JSONL reopen failed; file sink disabled", exc_info=True)
            self._jsonl = None

    # -- rows ----------------------------------------------------------------

    def record_serving(self, kind: str, **fields) -> None:
        """One serving-engine row: ``kind="step"`` (periodic: windowed
        tokens/s, queue depth, slots, free blocks, cumulative counters),
        ``"request"`` (a completion: TTFT/TPOT, token counts, finish
        reason, its costs) or ``"profile"`` (a ``/profile`` window)."""
        self._emit({"type": "serving", "kind": kind, **fields})

    def record_capture(self, label: str, seconds: float, **facts) -> None:
        """One CUDA-graph capture of the serving program ``label``, as a
        ``type="compile"`` row (the JAX package writes one an XLA compile):
        ``total_s`` is the warm-up and capture time."""
        self.recompile_count += 1
        self._emit({
            "type": "compile",
            "label": label,
            "static_key": label,
            "compile_s": float(seconds),
            "total_s": float(seconds),
            "mono": time.perf_counter(),
            "recompiles": self.recompile_count,
            **facts,
        })

    def record_generation(self, mode: str, new_tokens: int, seconds: float,
                          accept_rate: float | None = None,
                          verify_rounds: int | None = None) -> None:
        """One ``generate()`` call: its path (``"kv_cache"``,
        ``"full_forward"`` or ``"speculative"``), the tokens it emitted and
        its wall time; a speculative call adds its acceptance and verify
        rounds."""
        record = {
            "type": "generate",
            "mode": mode,
            "new_tokens": int(new_tokens),
            "seconds": float(seconds),
            "tokens_per_sec": (new_tokens / seconds) if seconds > 0 else None,
        }
        if accept_rate is not None:
            record["accept_rate"] = float(accept_rate)
        if verify_rounds is not None:
            record["verify_rounds"] = int(verify_rounds)
        self._emit(record)

    def record_checkpoint(self, kind: str, seconds: float | None = None,
                          bytes_written: int | None = None, shard_count: int | None = None,
                          is_async: bool = False, path: str | None = None) -> None:
        """One checkpoint save or restore: how long, how many bytes, how many
        per-process shard directories, and whether the write rode the async
        writer (JAX's row)."""
        self._emit({
            "type": "checkpoint",
            "kind": kind,
            "seconds": None if seconds is None else float(seconds),
            "bytes": None if bytes_written is None else int(bytes_written),
            "shard_count": None if shard_count is None else int(shard_count),
            "async": bool(is_async),
            "path": path,
        })

    def record_event(self, kind: str, **fields) -> None:
        self._emit({"type": "event", "kind": kind, **fields})

    def close(self) -> None:
        """Idempotent: safe from the serve command's exit and the atexit
        hook in any order."""
        if _ACTIVE is self:
            set_active_recorder(None)
        if self._jsonl is not None:
            try:
                self._jsonl.close()
            except Exception:
                pass
            self._jsonl = None
        if not self._closed:
            self._closed = True
            import atexit

            try:
                atexit.unregister(self.close)
            except Exception:
                pass


def _json_default(obj):
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return str(obj)
