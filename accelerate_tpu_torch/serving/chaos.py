"""Seeded fault-injection harness for the serving fleet (a copy of
``accelerate_tpu/serving/chaos.py``: pure stdlib, the same grammar, the
same seeded schedule).

Chaos engineering for the router/replica boundary: a replica started with
``accelerate-tpu-torch serve --chaos-spec SPEC`` (or ``ACCELERATE_CHAOS_SPEC``)
injects a *deterministic* schedule of faults keyed on its own ``/generate``
request ordinal — the same spec against the same trace produces the same
failure sequence, so a chaos run is a regression test, not a dice roll.
Faults land at the replica boundary (the HTTP front end), never inside the
engine: the engine's invariants are what the chaos run is *checking*, so
the harness must not reach around them.

Fault grammar (``;``- or ``,``-separated entries; ``rK:`` scopes an entry
to the replica whose ``--replica-id`` is ``K``, unscoped entries apply to
every replica)::

    seed=7              # seeds the jittered-delay RNG (default 0)
    r0:kill@5           # SIGKILL self when generate request #5 arrives
    r0:stop@3           # SIGSTOP self at request #3 (wedged until killed)
    r0:stop@3:2.5       # same, but a detached helper SIGCONTs after 2.5s
    r1:delay@4:0.25     # sleep 0.25s before serving request #4
    r1:delay@4:0.1..0.5 # seeded uniform delay in [0.1, 0.5) at request #4
    err503@2:3          # answer HTTP 503 to requests #2, #3, #4
    blackout@6:1.5      # /healthz goes dark for 1.5s once request #6 lands
    blackout@0:4.0      # /healthz dark for the first 4.0s after startup

Ordinals are 1-based over the requests the front end *receives* (``@0`` is
"at startup", meaningful only for ``blackout``). ``kill`` and ``stop``
fire before the request is admitted, so the router observes exactly what a
production crash looks like: a torn connection with requests in flight.

The module is pure stdlib, like the rest of the router side —
``tests/test_torch_route_cli.py`` and ``chip_smoke.py`` (phase 5g) drive
real serve processes with these specs and assert the fleet invariants
(every request answered exactly once, no orphaned processes, recovery to
the target replica count) that make the self-healing story honest. On the
card a ``kill`` drops the replica's CUDA context mid graph replay (the
CUDA driver frees its memory) and a ``stop`` freezes a process that holds one.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

#: fault kinds the injector knows how to apply
FAULT_KINDS = ("kill", "stop", "delay", "err503", "blackout")

#: environment variables the serve front end consults when --chaos-spec is
#: absent (the route CLI forwards the flag; a fleet can also flip chaos on
#: without touching any command line)
CHAOS_SPEC_ENV = "ACCELERATE_CHAOS_SPEC"
CHAOS_SEED_ENV = "ACCELERATE_CHAOS_SEED"


@dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``at_request`` is the 1-based ordinal of the
    triggering ``/generate`` request (0 = at startup); ``arg``/``arg2`` are
    the kind-specific parameters (seconds, counts, or a delay range)."""

    kind: str
    at_request: int
    arg: float | None = None
    arg2: float | None = None
    replica: int | None = None  # None = applies to every replica


class ChaosSpecError(ValueError):
    """Malformed chaos spec — raised at parse time so a typo fails the
    bring-up loudly instead of silently running a clean (faultless) test."""


def _parse_entry(entry: str) -> Fault:
    replica = None
    body = entry
    if body[:1] == "r":
        scope, sep, rest = body.partition(":")
        if sep and scope[1:].isdigit():
            replica = int(scope[1:])
            body = rest
    kind, at, args = body, None, []
    if "@" in body:
        kind, _, tail = body.partition("@")
        parts = tail.split(":")
        at = parts[0]
        args = parts[1:]
    if kind not in FAULT_KINDS:
        raise ChaosSpecError(
            f"unknown chaos fault {kind!r} in {entry!r}: expected one of {FAULT_KINDS}"
        )
    try:
        at_request = int(at)
        if at_request < 0:
            raise ValueError
    except (TypeError, ValueError):
        raise ChaosSpecError(
            f"chaos fault {entry!r} needs a non-negative request ordinal after '@'"
        ) from None
    arg = arg2 = None
    if args:
        if len(args) > 1:
            raise ChaosSpecError(f"too many ':' arguments in chaos fault {entry!r}")
        raw = args[0]
        try:
            if ".." in raw:  # seeded uniform range, delay only
                lo, hi = raw.split("..", 1)
                arg, arg2 = float(lo), float(hi)
                if not (0 <= arg <= arg2):
                    raise ValueError
            else:
                arg = float(raw)
                if arg < 0:
                    raise ValueError
        except ValueError:
            raise ChaosSpecError(
                f"chaos fault {entry!r}: malformed argument {raw!r}"
            ) from None
    if kind in ("delay", "err503", "blackout") and arg is None:
        raise ChaosSpecError(f"chaos fault {entry!r} needs an argument (':X')")
    if arg2 is not None and kind != "delay":
        raise ChaosSpecError(f"chaos fault {entry!r}: ranges only apply to delay")
    if kind != "blackout" and at_request == 0:
        raise ChaosSpecError(
            f"chaos fault {entry!r}: ordinal 0 (startup) only applies to blackout"
        )
    return Fault(kind=kind, at_request=at_request, arg=arg, arg2=arg2, replica=replica)


def parse_chaos_spec(spec: str) -> tuple[int, list[Fault]]:
    """Parse a spec string into ``(seed, faults)``. Raises
    :class:`ChaosSpecError` on any malformed entry."""
    seed, faults = 0, []
    for raw in spec.replace(",", ";").split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            try:
                seed = int(entry[5:])
            except ValueError:
                raise ChaosSpecError(f"malformed chaos seed {entry!r}") from None
            continue
        faults.append(_parse_entry(entry))
    return seed, faults


class ChaosInjector:
    """Applies one replica's slice of a chaos schedule.

    The serve front end calls :meth:`on_generate` once per received
    ``/generate`` request (before admission) and
    :meth:`healthz_blackout` on every ``/healthz`` probe. Everything is
    counted under a lock — the HTTP server is threaded — and the RNG is
    seeded with ``seed`` folded with the replica id, so two replicas
    sharing a spec draw distinct but reproducible jitter.
    """

    def __init__(self, faults: list[Fault], seed: int = 0, replica_id: int | None = None):
        self.replica_id = replica_id
        mine = [
            f for f in faults
            if f.replica is None or replica_id is None or f.replica == replica_id
        ]
        # fold the replica id into the seed: replicas sharing a spec draw
        # distinct but reproducible jitter streams
        from ..analysis.lockwatch import maybe_watch

        self._rng = random.Random(int(seed) * 1_000_003 + (replica_id or 0))
        self._lock = maybe_watch(threading.Lock(), "ChaosInjector._lock")
        self._requests = 0
        self._kills = {f.at_request for f in mine if f.kind == "kill"}
        self._stops = {f.at_request: f.arg for f in mine if f.kind == "stop"}
        self._delays = {
            f.at_request: (f.arg, f.arg2) for f in mine if f.kind == "delay"
        }
        # err503@N:K covers ordinals N .. N+K-1
        self._err503: set[int] = set()
        for f in mine:
            if f.kind == "err503":
                self._err503.update(range(f.at_request, f.at_request + int(f.arg)))
        self._blackouts = {f.at_request: f.arg for f in mine if f.kind == "blackout"}
        self._blackout_until = 0.0
        if 0 in self._blackouts:  # startup blackout arms immediately
            self._blackout_until = time.monotonic() + self._blackouts[0]
        self.injected = {"kill": 0, "stop": 0, "delay": 0, "err503": 0, "blackout": 0}

    @classmethod
    def from_spec(
        cls, spec: str | None, replica_id: int | None = None, seed: int | None = None
    ) -> "ChaosInjector | None":
        """Build from a spec string (or the ``ACCELERATE_CHAOS_*`` env
        vars when ``spec`` is None). Returns None when no chaos is
        configured — the disabled path is a single falsy check at every
        hook site, like the telemetry/sanitizer null objects."""
        spec = spec if spec is not None else os.environ.get(CHAOS_SPEC_ENV)
        if not spec or not spec.strip():
            return None
        parsed_seed, faults = parse_chaos_spec(spec)
        if seed is None:
            env_seed = os.environ.get(CHAOS_SEED_ENV)
            if env_seed and env_seed.strip():
                try:
                    seed = int(env_seed)
                except ValueError:
                    # same loud-refusal contract as a malformed spec entry:
                    # the serve front end answers this with an error row +
                    # exit 2 instead of a traceback
                    raise ChaosSpecError(
                        f"malformed {CHAOS_SEED_ENV}={env_seed!r} (want an int)"
                    ) from None
            else:
                seed = parsed_seed
        return cls(faults, seed=seed, replica_id=replica_id)

    # -- hook sites ----------------------------------------------------------

    def on_generate(self) -> str | None:
        """Account one received ``/generate`` request and apply its faults.
        Returns ``"err503"`` when the front end should answer 503; ``None``
        to proceed (possibly after an injected delay). ``kill``/``stop``
        never return — the process is gone or frozen."""
        with self._lock:
            self._requests += 1
            n = self._requests
            if n in self._blackouts:
                self._blackout_until = max(
                    self._blackout_until, time.monotonic() + self._blackouts[n]
                )
                self.injected["blackout"] += 1
            kill = n in self._kills
            stop_wake = self._stops.get(n) if n in self._stops else None
            has_stop = n in self._stops
            delay = self._delays.get(n)
            err = n in self._err503
            if kill:
                self.injected["kill"] += 1
            if has_stop:
                self.injected["stop"] += 1
            if delay:
                self.injected["delay"] += 1
            if err:
                self.injected["err503"] += 1
        if kill:
            print(f"chaos: kill -9 self at request {n}", file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        if has_stop:
            self._stop_self(n, stop_wake)
        if delay is not None:
            lo, hi = delay
            seconds = lo if hi is None else self._rng.uniform(lo, hi)
            time.sleep(seconds)
        return "err503" if err else None

    def healthz_blackout(self) -> bool:
        """True while an injected health-check blackout is active — the
        probe should be answered with a torn connection (no payload)."""
        with self._lock:
            return time.monotonic() < self._blackout_until

    def _stop_self(self, ordinal: int, wake_after: float | None) -> None:
        pid = os.getpid()
        print(
            f"chaos: SIGSTOP self at request {ordinal}"
            + (f" (SIGCONT in {wake_after}s)" if wake_after else " (until killed)"),
            file=sys.stderr, flush=True,
        )
        if wake_after:
            # a stopped process cannot wake itself: a detached helper sends
            # the SIGCONT. start_new_session so the helper survives the
            # router SIGKILLing this (now-unresponsive) replica.
            subprocess.Popen(
                ["/bin/sh", "-c", f"sleep {wake_after}; kill -CONT {pid} 2>/dev/null"],
                start_new_session=True,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
        os.kill(pid, signal.SIGSTOP)
