"""Per-iteration flight recorder: host/device time attribution for the
engine loop (a copy of ``accelerate_tpu/serving/flight.py`` up to its
profiler window; stdlib only).

Every :meth:`InferenceEngine.step` iteration is decomposed into
**exclusive, telescoping phases** — consecutive ``perf_counter`` stamps,
so the phase durations sum to the measured iteration wall time *exactly*
(modulo float ulp; :meth:`FlightRecorder.record` asserts the invariant
rather than logging it):

``schedule``
    admission and eviction — pure host work.
``prefill``
    the prefill chunk of every prefilling slot, each replayed from its
    CUDA graph; a chunk that ends its prompt reads its first token, which
    waits for the in-flight decode round on the same stream.
``dispatch``
    filling the decode operands and replaying the decode burst's CUDA
    graph — host work again.
``device_wait``
    the wait on the harvest copy's event in ``_harvest_inflight`` — the
    *residual* sync the host could not hide behind its own work.
``harvest``
    token emission and finish bookkeeping — host work.

``host_fraction`` = 1 − (device_wait + overlap_hidden) / wall over the
recorded window. Under the double-buffered engine host phases can run
*while a decode round is in flight on the device*; such intervals are
still attributed to their phase (the vocabulary stays exclusive and
telescoping) but are also accumulated into the per-iteration
``overlap_hidden_s``, because they are off the critical path — the device
was busy the whole time. With the synchronous engine ``overlap_hidden_s``
is identically 0.0 and the formula reduces to 1 − device_wait / wall.

The recorder is a process-global active object: the engine holds a direct
reference, external readers take ONE :func:`get_active_flight_recorder`
read, and the disabled path is a single ``is None`` check per iteration.

:class:`ProfileWindow` is the on-demand profiler window behind ``GET
/profile?seconds=N`` (the port of the JAX module's
``capture_profile_window``): ``torch.profiler`` over the CPU and the card
replaces ``jax.profiler``, a Chrome trace lands in the window's directory,
and the manifest has the JAX keys. Only it imports torch, lazily.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque

#: the exclusive phases, in stamp order — ``record()`` requires exactly
#: these keyword arguments and the metrics/trace surfaces label by them
ITERATION_PHASES = ("schedule", "prefill", "dispatch", "device_wait", "harvest")

_active_flight_recorder = None


def get_active_flight_recorder():
    """The process-global recorder (None when no engine armed one) — the
    single read external consumers (watchdog, profiler dump) pay."""
    return _active_flight_recorder


def set_active_flight_recorder(recorder) -> None:
    global _active_flight_recorder
    _active_flight_recorder = recorder


class FlightRecorder:
    """Bounded ring of per-iteration phase breakdowns + cumulative
    totals. Ring entries answer "what were the last K iterations doing"
    (HANG_REPORT, ``trace tail --iterations`` windows, the ``/profile``
    dump); the cumulative totals answer "what is the run's host share"
    (``stats()['host_fraction']``) without rescanning the ring."""

    def __init__(self, history: int = 256):
        self.history = max(1, int(history))
        self._ring: deque[dict] = deque(maxlen=self.history)
        #: what the engine is doing *right now* — updated at phase
        #: boundaries so a wedged engine's HANG_REPORT names the phase it
        #: died in, not just the last completed iteration
        self.current_phase = "idle"
        self.reset()

    def reset(self) -> None:
        """Zero the measurement window (``reset_stats()`` folds this in:
        a warmup→reset→measure cycle reports only post-reset
        iterations for both the ring and the cumulative fractions)."""
        self._ring.clear()
        self.iterations = 0
        self.wall_total_s = 0.0
        self.overlap_hidden_total_s = 0.0
        self.phase_totals_s = {p: 0.0 for p in ITERATION_PHASES}
        self.current_phase = "idle"

    def record(self, iteration: int, t_start: float, wall_s: float,
               overlap_hidden_s: float = 0.0, **phases: float) -> dict:
        """Append one iteration. ``phases`` must cover exactly
        :data:`ITERATION_PHASES` and sum to ``wall_s`` — the stamps
        telescope (each phase is the diff of consecutive perf_counter
        reads), so a mismatch means a stamp was dropped or double-counted
        and the attribution is garbage. Asserted, not logged.

        ``overlap_hidden_s`` is *not* a sixth phase: it re-counts the
        portion of the host phases that ran under an in-flight dispatch
        (double-buffered engine), so it is bounded by
        ``wall_s − device_wait`` — also asserted."""
        if set(phases) != set(ITERATION_PHASES):
            raise AssertionError(
                f"flight phases {sorted(phases)} != {sorted(ITERATION_PHASES)}"
            )
        total = sum(phases.values())
        # telescoping stamps sum exactly; the tolerance only absorbs float
        # ulp on the subtraction chain, never a real accounting hole
        if not math.isclose(total, wall_s, rel_tol=1e-9, abs_tol=1e-6):
            raise AssertionError(
                f"flight phase sum {total!r} != iteration wall {wall_s!r} "
                f"({ {p: phases[p] for p in ITERATION_PHASES} })"
            )
        overlap_hidden_s = float(overlap_hidden_s)
        host_s = wall_s - phases["device_wait"]
        if not (-1e-6 <= overlap_hidden_s <= host_s + 1e-6):
            raise AssertionError(
                f"overlap_hidden_s {overlap_hidden_s!r} outside "
                f"[0, wall - device_wait = {host_s!r}]"
            )
        entry = {"iteration": int(iteration), "t_start": float(t_start),
                 "wall_s": float(wall_s),
                 "overlap_hidden_s": overlap_hidden_s}
        for p in ITERATION_PHASES:
            entry[f"{p}_s"] = float(phases[p])
            self.phase_totals_s[p] += float(phases[p])
        self._ring.append(entry)
        self.iterations += 1
        self.wall_total_s += float(wall_s)
        self.overlap_hidden_total_s += overlap_hidden_s
        return entry

    def __len__(self) -> int:
        return len(self._ring)

    def tail(self, k: int = 8) -> list[dict]:
        """Newest-last last-``k`` ring entries (crash forensics)."""
        if k <= 0:
            return []
        return list(self._ring)[-k:]

    def window(self, since_perf_t: float) -> list[dict]:
        """Ring entries whose iteration started at/after a perf_counter
        stamp — the ``/profile?seconds=N`` capture window."""
        return [e for e in self._ring if e["t_start"] >= since_perf_t]

    def host_fraction(self) -> float:
        """1 − (device_wait + overlap_hidden)/wall over everything
        recorded since reset — host time *on the critical path*. Hidden
        overlap counts as device time: the accelerator was busy under it.
        Cumulative, so it matches ``trace tail --iterations`` computed
        over the same iterations."""
        if self.wall_total_s <= 0.0:
            return 0.0
        hidden = (
            self.phase_totals_s["device_wait"] + self.overlap_hidden_total_s
        )
        return max(0.0, 1.0 - hidden / self.wall_total_s)

    def _percentiles(self, values: list[float]) -> dict:
        # no numpy on purpose: the module stays stdlib-only
        vs = sorted(values)
        n = len(vs)

        def pct(q: float) -> float:
            if n == 1:
                return vs[0]
            pos = q * (n - 1)
            lo = int(pos)
            hi = min(lo + 1, n - 1)
            return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)

        return {"p50": pct(0.50), "p99": pct(0.99)}

    def telemetry_fields(self) -> dict:
        """Flat fields for the telemetry step row (and via ingest, the
        metrics gauges) — cheap cumulative reads only."""
        if not self._ring:
            return {}
        walls = [e["wall_s"] for e in self._ring]
        pw = self._percentiles(walls)
        return {
            "host_fraction": self.host_fraction(),
            "iteration_p50_s": pw["p50"],
            "iteration_p99_s": pw["p99"],
            "overlap_hidden_s": self.overlap_hidden_total_s,
            "flight_phase": self.current_phase,
        }

    def summary(self) -> dict:
        """``stats()`` fields: the flat telemetry keys plus per-phase
        p50/p99 over the ring window. Empty when nothing recorded."""
        if not self._ring:
            return {}
        out = self.telemetry_fields()
        out["flight_window"] = len(self._ring)
        out["iteration_phases_s"] = {
            p: self._percentiles([e[f"{p}_s"] for e in self._ring])
            for p in ITERATION_PHASES
        }
        return out


class ProfileWindow:
    """One on-demand profiler window over the live engine: ``torch.profiler``
    (CPU, and CUDA when the engine runs on the card) for ``seconds``, and the
    flight-recorder iterations that start inside it, both under
    ``<logging_dir>/profiles/profile_<stamp>_<pid>/``.

    :meth:`open` and :meth:`close` start and stop the profiler; the serve
    loop calls them on the engine's own thread, between iterations, because
    a CUDA call from another thread while the engine captures a CUDA graph
    would invalidate the capture. :meth:`finish` exports the Chrome trace
    (``trace.json``), a per-kernel summary (``kernel_summary.json``: launches
    and device microseconds by kernel name) and the flight window, and
    writes ``manifest.json`` with the JAX manifest's keys; it is host work,
    done on the requesting thread while the engine keeps serving."""

    def __init__(self, logging_dir: str, seconds: float):
        self.seconds = float(seconds)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.profile_dir = os.path.join(logging_dir, "profiles",
                                        f"profile_{stamp}_{os.getpid()}")
        os.makedirs(self.profile_dir, exist_ok=True)
        #: set once the window is closed (or failed to open: ``error``)
        self.closed = threading.Event()
        self.error: str | None = None
        self._prof = None
        self._start = 0.0

    def open(self, flight, cuda: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        self._flight = flight
        self._iters_before = flight.iterations if flight is not None else 0
        self._prof = profile(activities=activities)
        self._prof.start()
        self._start = time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() - self._start >= self.seconds

    def close(self) -> None:
        t_stop = time.perf_counter()
        self._prof.stop()
        self.elapsed = time.perf_counter() - self._start
        #: how long stopping the profiler held the engine thread
        self.stop_s = self.elapsed - (t_stop - self._start)
        fl = self._flight
        # read on the engine thread: the ring is not touched meanwhile
        self.window = fl.window(self._start) if fl is not None else []
        self.host_fraction = fl.host_fraction() if fl is not None else None
        self.closed.set()

    def finish(self) -> dict:
        """The window's artifacts and manifest (after :meth:`close`)."""
        import torch

        trace_path = os.path.join(self.profile_dir, "trace.json")
        self._prof.export_chrome_trace(trace_path)
        kernels = {}
        for e in self._prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                kernels[e.key] = {"launches": e.count,
                                  "device_time_us": e.self_device_time_total}
        summary_path = os.path.join(self.profile_dir, "kernel_summary.json")
        with open(summary_path, "w") as f:
            json.dump(kernels, f, indent=2)
        flight_path = os.path.join(self.profile_dir, "flight_window.json")
        with open(flight_path, "w") as f:
            json.dump(
                {
                    "seconds_requested": self.seconds,
                    "seconds_measured": self.elapsed,
                    "iterations": len(self.window),
                    "iterations_before": self._iters_before,
                    "profiler_stop_s": self.stop_s,
                    "host_fraction": self.host_fraction,
                    "phases": list(ITERATION_PHASES),
                    "entries": self.window,
                },
                f, indent=2,
            )
        manifest = {
            "profile_dir": self.profile_dir,
            "seconds": self.elapsed,
            "flight_iterations": len(self.window),
            "host_fraction": self.host_fraction,
            "artifacts": sorted([trace_path, summary_path, flight_path]),
        }
        with open(os.path.join(self.profile_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

        from ..telemetry import get_active_recorder

        tel = get_active_recorder()
        if tel:
            tel.record_serving(kind="profile", profile_dir=self.profile_dir,
                               seconds=self.elapsed, flight_iterations=len(self.window))
        return manifest
