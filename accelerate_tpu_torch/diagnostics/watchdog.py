"""Hang/straggler watchdog: a deadline armed around every training step
(port of ``accelerate_tpu/diagnostics/watchdog.py``).

A wedged collective is silent — every process blocks inside the same
all-reduce waiting for the one that died, and the job burns its cards
until an operator notices. The watchdog turns that silence into a
diagnosis: a background thread arms a deadline around each step
(``max(multiplier · EMA(step_time), floor)``); if no progress lands before
it expires, the thread dumps *this* process's state into
``HANG_REPORT_<host>.json`` — all-thread Python stacks, the open trace-span
stack (naming the stalled phase), the last N telemetry records, and the
card's memory (``torch.cuda.memory_stats`` and ``mem_get_info``) — and
optionally raises the resilience subsystem's preemption flag so the
consensus emergency save fires instead of a silent hang.

Per-host **heartbeat files** (``{logging_dir}/diagnostics/heartbeat_<n>.json``,
atomically replaced) give the main process — and the ``monitor`` command —
the cross-host view: a host whose heartbeat goes stale while the others
advance is the straggler/wedged host by definition, no collective needed to
name it (a hung collective can't run a collective to debug itself).

Progress signals, cheapest first:

* ``touch(phase)`` — called by every trace-span entry/exit; defers the
  deadline without touching the EMA (keeps long first-compiles and
  checkpoint saves from false-firing while still catching a hang *inside*
  any one phase).
* ``step_completed(step_time_s)`` — called by the optimizer wrapper at
  each step boundary; feeds the EMA, re-arms the deadline, and (throttled)
  rewrites the heartbeat file.

Overhead: disabled is ``None``-check-only at every call site; enabled is
two monotonic reads + a few float ops per signal, and the monitor thread
wakes at ``check_interval``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from typing import Any

logger = logging.getLogger(__name__)

HANG_REPORT_PATTERN = "HANG_REPORT_{host}.json"
HEARTBEAT_SUBDIR = "diagnostics"
HEARTBEAT_PATTERN = "heartbeat_{host}.json"

#: process-wide active watchdog (the tracer touches it on span boundaries)
_ACTIVE_WATCHDOG: "Watchdog | None" = None


def get_active_watchdog() -> "Watchdog | None":
    return _ACTIVE_WATCHDOG


def _set_active_watchdog(wd) -> None:
    global _ACTIVE_WATCHDOG
    _ACTIVE_WATCHDOG = wd


def _atomic_write_json(path: str, payload: dict) -> None:
    # tmp name unique per writer thread: the watchdog thread and the main
    # thread (step_completed) may both rewrite a heartbeat concurrently
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _thread_stacks() -> dict[str, list[str]]:
    """Formatted Python stacks of every live thread, keyed by
    ``"<name> (tid)"`` — the heart of the hang report."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks: dict[str, list[str]] = {}
    for tid, frame in sys._current_frames().items():
        key = f"{names.get(tid, 'unknown')} ({tid})"
        stacks[key] = [line.rstrip() for line in traceback.format_stack(frame)]
    return stacks


def _device_memory() -> dict[str, Any] | None:
    """The card's memory (JAX's keys, plus the allocator's reserved bytes
    and the card's free bytes); None without a card."""
    try:
        from ..utils.memory import get_device_memory_info

        return get_device_memory_info() or None
    except Exception:
        return None


def _flight_tail(k: int = 8) -> dict[str, Any] | None:
    """The serving engine's last-``k`` flight-recorder iterations + the
    phase it is in RIGHT NOW — a wedged engine's hang report names
    whether it died scheduling, dispatching, or waiting on the device.
    None outside a serving process (lazy import: the watchdog must not
    drag the serving package into training-only processes)."""
    try:
        from ..serving.flight import get_active_flight_recorder

        fl = get_active_flight_recorder()
        if fl is None:
            return None
        return {
            "current_phase": fl.current_phase,
            "iterations": fl.iterations,
            "host_fraction": fl.host_fraction(),
            "entries": fl.tail(k),
        }
    except Exception:
        return None


class Watchdog:
    """Arms a progress deadline around the training loop; see module doc.

    Args:
        logging_dir: where ``HANG_REPORT_<host>.json`` and the heartbeat
            files land (cwd when None — a hang report must never be lost
            to a missing directory).
        multiplier: deadline = ``max(multiplier · EMA(step_time), floor)``.
        floor_seconds: minimum deadline — absorbs first-step compiles and
            other legitimately slow cold paths.
        check_interval_seconds: monitor thread wake cadence.
        ema_alpha: EMA smoothing for step times.
        heartbeat_interval_seconds: minimum spacing of heartbeat rewrites.
        grace_seconds: deadline override while the CURRENT open phase is a
            grace phase (``compile/*``, ``checkpoint/*``, ``prepare``) —
            host-local work that is legitimately unbounded by step time.
            A first compile or a fat save can run this long without a
            false fire; a hang in a *collective* keeps the tight deadline.
        telemetry_tail: how many telemetry ring-buffer records the hang
            report embeds.
        preempt_on_hang: on expiry, raise the active
            :class:`~accelerate_tpu_torch.resilience.preemption.PreemptionHandler`
            flag so the consensus emergency-save path fires (requires
            ``Accelerator(fault_tolerance=...)`` to be armed).
        telemetry: the owning accelerator's recorder (for the record tail);
            best-effort, may be the null recorder.
        host: process index; resolved from state/env when None.
    """

    def __init__(
        self,
        logging_dir: str | None = None,
        multiplier: float = 5.0,
        floor_seconds: float = 120.0,
        check_interval_seconds: float = 5.0,
        ema_alpha: float = 0.2,
        heartbeat_interval_seconds: float = 5.0,
        grace_seconds: float = 1800.0,
        telemetry_tail: int = 50,
        preempt_on_hang: bool = False,
        telemetry=None,
        host: int | None = None,
    ):
        from .tracing import _host_index

        self.multiplier = float(multiplier)
        self.floor_seconds = float(floor_seconds)
        self.check_interval_seconds = max(0.05, float(check_interval_seconds))
        self.ema_alpha = float(ema_alpha)
        self.heartbeat_interval_seconds = float(heartbeat_interval_seconds)
        self.grace_seconds = float(grace_seconds)
        self.grace_phases: tuple[str, ...] = ("compile/", "checkpoint/", "prepare")
        self.telemetry_tail = int(telemetry_tail)
        self.preempt_on_hang = bool(preempt_on_hang)
        self.telemetry = telemetry
        self.host = _host_index() if host is None else int(host)

        self.report_dir = logging_dir if logging_dir is not None else os.getcwd()
        self.report_path = os.path.join(
            self.report_dir, HANG_REPORT_PATTERN.format(host=self.host)
        )
        self._heartbeat_path = None
        if logging_dir is not None:
            hb_dir = os.path.join(logging_dir, HEARTBEAT_SUBDIR)
            try:
                os.makedirs(hb_dir, exist_ok=True)
                self._heartbeat_path = os.path.join(
                    hb_dir, HEARTBEAT_PATTERN.format(host=self.host)
                )
            except OSError:
                pass

        self.step_count = 0
        self.ema_step_s: float | None = None
        self.last_step_s: float | None = None
        self.fired = False
        self._last_progress = time.perf_counter()
        self._last_phase: str | None = None
        self._last_step_mono: float | None = None
        self._last_heartbeat = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._last_progress = time.perf_counter()
        self._thread = threading.Thread(
            target=self._monitor, name="accelerate-watchdog", daemon=True
        )
        self._thread.start()
        _set_active_watchdog(self)
        self._write_heartbeat(force=True)
        return self

    def stop(self):
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=2 * self.check_interval_seconds)
            self._write_heartbeat(force=True)  # final step count for the monitor
        if get_active_watchdog() is self:
            _set_active_watchdog(None)

    # -- progress signals ----------------------------------------------------

    def touch(self, phase: str | None = None):
        """Any sign of life (span entry/exit): defer the deadline without
        polluting the step-time EMA. Kept minimal — this runs on every
        span boundary; heartbeat freshness is the monitor *thread*'s job,
        so a host sitting inside a long phase still reads alive."""
        self._last_progress = time.perf_counter()
        self._last_phase = phase
        if self.fired:
            self.fired = False  # progress resumed: re-arm for a future hang

    def step_completed(self, step_time_s: float | None = None):
        """A full step landed: feed the EMA, re-arm, heartbeat. With no
        explicit ``step_time_s``, the cadence between consecutive calls is
        the sample — the TRUE loop period including the user's host work.
        The very first boundary only sets the baseline (its interval spans
        prepare + the first compile, which would poison the EMA)."""
        now = time.perf_counter()
        self.step_count += 1
        if step_time_s is None:
            if self._last_step_mono is not None:
                step_time_s = now - self._last_step_mono
            self._last_step_mono = now
        if step_time_s is not None and step_time_s > 0:
            self.last_step_s = float(step_time_s)
            if self.ema_step_s is None:
                self.ema_step_s = float(step_time_s)
            else:
                a = self.ema_alpha
                self.ema_step_s = a * float(step_time_s) + (1 - a) * self.ema_step_s
        self._last_progress = now
        self._last_phase = None
        if self.fired:
            self.fired = False
        self._write_heartbeat()

    @property
    def deadline_seconds(self) -> float:
        if self.ema_step_s is None:
            deadline = self.floor_seconds
        else:
            deadline = max(self.multiplier * self.ema_step_s, self.floor_seconds)
        phase = self._last_phase
        if phase and phase.startswith(self.grace_phases):
            # host-local unbounded work (first compile, fat save): the step
            # deadline doesn't apply; a hang here still fires, just later
            deadline = max(deadline, self.grace_seconds)
        return deadline

    # -- monitor thread ------------------------------------------------------

    def _monitor(self):
        while not self._stop.wait(self.check_interval_seconds):
            # the watchdog thread owns heartbeat freshness: a host sitting
            # in a legitimate long phase (or a wedged collective!) still
            # writes — staleness then means the PROCESS is gone, while the
            # embedded fired/phase fields carry the watchdog's own verdict
            self._write_heartbeat()
            elapsed = time.perf_counter() - self._last_progress
            deadline = self.deadline_seconds
            if elapsed > deadline and not self.fired:
                self.fired = True
                try:
                    self._fire(elapsed, deadline)
                except Exception:
                    logger.error("watchdog report failed", exc_info=True)

    def _fire(self, elapsed: float, deadline: float):
        report = self.build_report(elapsed, deadline)
        os.makedirs(self.report_dir, exist_ok=True)
        _atomic_write_json(self.report_path, report)
        # publish the verdict while fired is still True — the monitor CLI's
        # wedged check reads this field, not just heartbeat staleness
        self._write_heartbeat(force=True)
        logger.error(
            "WATCHDOG: no step progress for %.1fs (deadline %.1fs, stalled "
            "phase: %s) — hang report at %s",
            elapsed, deadline, report["stalled_phase"], self.report_path,
        )
        from .tracing import get_tracer

        tracer = get_tracer()
        if tracer:
            tracer.instant(
                "watchdog/hang", elapsed_s=elapsed, stalled_phase=report["stalled_phase"]
            )
            tracer.flush()
        if self.telemetry:
            try:
                self.telemetry.record_event(
                    "watchdog_hang",
                    elapsed_s=elapsed,
                    deadline_s=deadline,
                    stalled_phase=report["stalled_phase"],
                    report=self.report_path,
                )
            except Exception:
                pass
        else:
            # no telemetry = no record stream to carry the event to the
            # scrape surface; publish the hang counter directly (with
            # telemetry on, the record_event above already feeds it)
            from ..metrics.ingest import observe_hang
            from ..metrics.registry import get_active_registry

            registry = get_active_registry()
            if registry:
                try:
                    observe_hang(registry)
                except Exception:
                    pass
        if self.preempt_on_hang:
            from ..resilience.preemption import get_active_handler

            handler = get_active_handler()
            if handler is not None:
                # the flag rides the preemption machinery: next step boundary →
                # cross-host consensus → ONE emergency save → clean exit.
                # (If the loop is truly wedged in a collective the save
                # can't run either — but a *straggler* that eventually
                # crawls to the boundary now exits with a checkpoint.)
                handler.request_preemption(reason=f"watchdog-hang:{report['stalled_phase']}")
            else:
                logger.warning(
                    "preempt_on_hang set but no PreemptionHandler is "
                    "installed (pass fault_tolerance=... to Accelerator)"
                )

    def build_report(self, elapsed: float, deadline: float) -> dict:
        """Everything a human (or the monitor CLI) needs to name the hang:
        who, where (open spans + all-thread stacks), and the recent record
        trail."""
        from .tracing import get_tracer

        open_spans = get_tracer().open_spans()
        stalled_phase = self._last_phase or "unknown"
        # the innermost open span of the oldest-stalled thread is the most
        # specific name for "where it is stuck"
        oldest_age = -1.0
        for frames in open_spans.values():
            if frames and frames[0]["age_s"] > oldest_age:
                oldest_age = frames[0]["age_s"]
                stalled_phase = frames[-1]["name"]
        tail = []
        if self.telemetry is not None and getattr(self.telemetry, "records", None):
            tail = list(self.telemetry.records)[-self.telemetry_tail:]
        return {
            "type": "hang_report",
            "host": self.host,
            "pid": os.getpid(),
            "ts": time.time(),
            "elapsed_s": elapsed,
            "deadline_s": deadline,
            "step": self.step_count,
            "ema_step_s": self.ema_step_s,
            "stalled_phase": stalled_phase,
            "open_spans": {str(tid): frames for tid, frames in open_spans.items()},
            "threads": _thread_stacks(),
            "telemetry_tail": tail,
            "device_memory": _device_memory(),
            "flight_tail": _flight_tail(),
        }

    # -- heartbeats ----------------------------------------------------------

    def _write_heartbeat(self, force: bool = False):
        if self._heartbeat_path is None:
            return
        now = time.monotonic()
        if not force and now - self._last_heartbeat < self.heartbeat_interval_seconds:
            return
        self._last_heartbeat = now
        _atomic_write_json(
            self._heartbeat_path,
            {
                "host": self.host,
                "pid": os.getpid(),
                "step": self.step_count,
                "ts": time.time(),
                "ema_step_s": self.ema_step_s,
                "last_step_s": self.last_step_s,
                "phase": self._last_phase,
                "fired": self.fired,
            },
        )
