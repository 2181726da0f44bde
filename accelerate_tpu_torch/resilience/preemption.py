"""Preemption detection: SIGTERM/SIGINT handlers and an optional
maintenance-event poller that raise a flag (port of
``accelerate_tpu/resilience/preemption.py``).

The handler only *sets a flag*; the loop that owns the work observes it at
a safe boundary: the training loop at a step boundary
(``Accelerator.backward`` → ``check_preemption``, which agrees across the
process group, takes ONE emergency ``save_state()`` and exits with a
sentinel file), ``serve`` between engine iterations, where it stops
admission, drains what was admitted and exits 0. Acting from inside a
signal handler would race the step in flight.

A second SIGINT while the flag is already set restores the previous
handler's behaviour (usually KeyboardInterrupt) so a user mashing Ctrl-C
still gets out.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from typing import Any

logger = logging.getLogger(__name__)

from .manifest import SENTINEL_NAME

#: GCE metadata endpoint announcing host maintenance (``NONE`` or
#: ``TERMINATE_ON_HOST_MAINTENANCE``); polled only with
#: ``monitor_maintenance``, and absent outside GCE
GCE_MAINTENANCE_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/maintenance-event"
)

#: the handler currently owning the process signals (one per process; a new
#: install replaces the previous one)
_ACTIVE_HANDLER: "PreemptionHandler | None" = None


def get_active_handler() -> "PreemptionHandler | None":
    return _ACTIVE_HANDLER


class PreemptionHandler:
    """Installs SIGTERM/SIGINT handlers (and optionally a maintenance-event
    poller thread) that raise a preemption flag.

    Args:
        handle_sigint: also treat Ctrl-C as a preemption request (second
            SIGINT falls through to the previous handler).
        monitor_maintenance: poll the GCE metadata server for host
            maintenance events on a daemon thread.
        poll_seconds: maintenance poll interval.
        handle_signals: False keeps the flag only (tests raise it by hand).
    """

    def __init__(
        self,
        handle_sigint: bool = True,
        monitor_maintenance: bool = False,
        poll_seconds: float = 30.0,
        handle_signals: bool = True,
    ):
        self.handle_signals = bool(handle_signals)
        self.handle_sigint = bool(handle_sigint)
        self.monitor_maintenance = bool(monitor_maintenance)
        self.poll_seconds = float(poll_seconds)
        self._flag = threading.Event()
        self._reason: str | None = None
        self._previous: dict[int, Any] = {}
        self._poller: threading.Thread | None = None
        self._stop_poller = threading.Event()
        self._installed = False

    # -- flag ---------------------------------------------------------------

    @property
    def preemption_requested(self) -> bool:
        return self._flag.is_set()

    @property
    def reason(self) -> str | None:
        return self._reason

    def request_preemption(self, reason: str = "manual"):
        """Raise the flag programmatically (tests; in-band watchdogs)."""
        self._reason = reason
        self._flag.set()
        self._trace_flag()

    def reset(self):
        self._flag.clear()
        self._reason = None

    # -- install/uninstall ---------------------------------------------------

    def install(self) -> bool:
        """Register the signal handlers. Signals can only be bound from the
        main thread — elsewhere this degrades to flag-only operation (the
        poller still works) and returns False."""
        global _ACTIVE_HANDLER
        if _ACTIVE_HANDLER is not None and _ACTIVE_HANDLER is not self:
            _ACTIVE_HANDLER.uninstall()
        _ACTIVE_HANDLER = self
        ok = True
        if not self._installed and self.handle_signals:
            signals = [signal.SIGTERM]
            if self.handle_sigint:
                signals.append(signal.SIGINT)
            try:
                for sig in signals:
                    self._previous[sig] = signal.signal(sig, self._on_signal)
                self._installed = True
            except ValueError:  # not the main thread
                logger.warning(
                    "PreemptionHandler.install() outside the main thread: "
                    "signal handlers not registered (flag-only mode)"
                )
                ok = False
        if self.monitor_maintenance and self._poller is None:
            self._stop_poller.clear()
            self._poller = threading.Thread(
                target=self._poll_maintenance, name="preemption-poller", daemon=True
            )
            self._poller.start()
        return ok

    def uninstall(self):
        global _ACTIVE_HANDLER
        if self._installed:
            for sig, previous in self._previous.items():
                try:
                    signal.signal(sig, previous)
                except (ValueError, TypeError):
                    pass
            self._previous.clear()
            self._installed = False
        if self._poller is not None:
            self._stop_poller.set()
            self._poller = None
        if _ACTIVE_HANDLER is self:
            _ACTIVE_HANDLER = None

    # -- signal path ---------------------------------------------------------

    def _on_signal(self, signum, frame):
        if self._flag.is_set() and signum == signal.SIGINT:
            # second Ctrl-C: the user wants OUT, now — fall through
            previous = self._previous.get(signum)
            if callable(previous):
                previous(signum, frame)
                return
            raise KeyboardInterrupt
        self._reason = signal.Signals(signum).name
        self._flag.set()
        self._trace_flag()
        logger.warning("%s received — acting on it at the next safe boundary", self._reason)

    def _trace_flag(self):
        """Mark the flag-raise on the trace timeline: the gap between this
        instant and the drain's end is the reaction latency."""
        try:
            from ..diagnostics.tracing import trace_instant

            trace_instant("preemption/flag_raised", reason=self._reason)
        except Exception:
            pass

    def _read_maintenance_event(self) -> str:
        """One read of the metadata endpoint (``NONE`` when no event)."""
        import urllib.request

        req = urllib.request.Request(GCE_MAINTENANCE_URL, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.read().decode().strip()

    def _poll_maintenance(self):
        while not self._stop_poller.wait(self.poll_seconds):
            try:
                event = self._read_maintenance_event()
            except Exception:
                continue  # not on GCE / transient metadata failure
            if event and event != "NONE":
                self._reason = f"maintenance-event:{event}"
                self._flag.set()
                return

    # -- cross-host agreement ------------------------------------------------

    def consensus(self) -> bool:
        """Do ANY processes want to preempt? One all-reduce (MAX) of the
        local flag over the process group — a collective, so every process
        must call it at the same step boundary (the Accelerator's consensus
        cadence guarantees that). Without a group: the local flag."""
        from ..state import PartialState

        if not PartialState._shared_state:  # no state, no group: read, never create
            return self._flag.is_set()
        return PartialState().consensus_any(self._flag.is_set())

    # -- sentinel ------------------------------------------------------------

    def write_sentinel(self, directory: str, checkpoint: str | None, step: int | None):
        """Drop ``PREEMPTED.json`` next to the checkpoints: the restarted
        run (and the operator) can see why the process exited and where the
        emergency save landed."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, SENTINEL_NAME)
        payload = {
            "reason": self._reason or "preemption",
            "checkpoint": checkpoint,
            "step": step,
            "pid": os.getpid(),
            "timestamp": time.time(),
        }
        try:
            with open(path, "w") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            logger.warning("could not write preemption sentinel %s", path, exc_info=True)
        return path
