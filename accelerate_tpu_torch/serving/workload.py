"""Seeded, replayable workload suite for the serving fleet (a copy of
``accelerate_tpu/serving/workload.py``: the same spec gives the same bytes,
and so the same ``schedule_digest``, in both packages).

The observability stack (goodput ledger, tail attribution, flight
recorder, the windowed SLO engine of the JAX package's ``metrics/slo.py``)
is only as good as the traffic it is measured against — and until now
there was no reproducible traffic. This module generates deterministic
arrival schedules from one seed: the same ``SPEC`` produces a
byte-identical schedule (asserted at generation time), so an SLO
scorecard is a regression test, not a weather report.

A schedule is a list of ``{"t": <seconds-from-start>, "payload": {...}}``
entries sorted by ``t``; payloads are exactly the request dicts the
``serve``/``route`` JSONL protocol accepts (``prompt`` token ids,
``max_new_tokens``, optional ``session_id``/``priority``/``deadline_ms``).
Scenario catalogue (``serve --trace SPEC`` / ``route --trace SPEC``,
``SPEC = name:seed:duration:rps[:tenants=N]`` — the optional ``tenants=N``
stamps each payload with a seeded tenant id for usage attribution; a
malformed spec is a bring-up refusal — exit 2 — exactly like
``--chaos-spec``):

``bursty-diurnal``    sinusoid-modulated Poisson arrivals (a compressed
                      diurnal cycle: troughs and rush hours in one run)
``longctx-flood``     a storm of long-prompt summarization-shaped
                      requests — prefill pressure, block-pool pressure
``agentic``           many-turn sticky-session chains with shared
                      prefixes — session affinity + radix-cache traffic
``overbudget-storm``  adversarial mix of tight ``deadline_ms`` budgets,
                      ``batch``-class bulk and oversized decodes — the
                      shed/deadline/queue pressure scenario

``replay:<path>`` replays a schedule captured from real traffic: the
route front end records live arrivals (``--trace-record``) into the same
schedule format under ``<logging_dir>/workload/recorded.jsonl``.

Pure stdlib and jax-free, like the rest of the router side.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
import time
from dataclasses import dataclass

__all__ = [
    "SCENARIOS",
    "TraceSpec",
    "TraceSpecError",
    "WORKLOAD_FILENAME",
    "WorkloadRecorder",
    "generate_schedule",
    "load_schedule",
    "parse_trace_spec",
    "run_schedule",
    "schedule_bytes",
    "schedule_digest",
    "write_workload_manifest",
]

#: generator names a ``--trace`` SPEC may request (``replay`` is the
#: capture-driven pseudo-scenario)
SCENARIOS = ("bursty-diurnal", "longctx-flood", "agentic", "overbudget-storm")

#: manifest written next to a traced run's artifacts — `slo report` reads
#: it to label the scorecard's scenario axis
WORKLOAD_FILENAME = "WORKLOAD.json"

#: subdir of logging_dir where --trace-record captures live arrivals
RECORD_SUBDIR = "workload"
RECORD_FILENAME = "recorded.jsonl"

#: schema stamp on manifests and recorded rows
WORKLOAD_SCHEMA = 1


class TraceSpecError(ValueError):
    """Malformed ``--trace`` spec — raised at parse time so a typo'd
    scenario refuses the bring-up loudly instead of silently measuring
    nothing (the ``--chaos-spec`` contract)."""


@dataclass(frozen=True)
class TraceSpec:
    """One parsed ``--trace`` spec. ``path`` is set only for ``replay``.
    ``tenants`` > 0 stamps each payload with a deterministic tenant id
    (``t0``..``t{N-1}``) for usage-attribution scenarios."""

    name: str
    seed: int = 0
    duration_s: float = 10.0
    rps: float = 4.0
    path: str | None = None
    tenants: int = 0

    def as_text(self) -> str:
        if self.name == "replay":
            return f"replay:{self.path}"
        text = f"{self.name}:{self.seed}:{self.duration_s:g}:{self.rps:g}"
        if self.tenants:
            text += f":tenants={self.tenants}"
        return text


def parse_trace_spec(spec: str) -> TraceSpec:
    """Parse ``name:seed:duration:rps`` (or ``replay:<path>``)."""
    if not isinstance(spec, str) or not spec.strip():
        raise TraceSpecError("empty --trace spec")
    spec = spec.strip()
    name, _, rest = spec.partition(":")
    if name == "replay":
        if not rest:
            raise TraceSpecError(
                "replay spec needs a schedule path: replay:<path>"
            )
        return TraceSpec(name="replay", path=rest)
    if name not in SCENARIOS:
        raise TraceSpecError(
            f"unknown workload scenario {name!r}: expected one of "
            f"{SCENARIOS} or replay:<path>"
        )
    parts = rest.split(":") if rest else []
    tenants = 0
    if len(parts) == 4 and parts[3].startswith("tenants="):
        try:
            tenants = int(parts[3][len("tenants="):])
            if tenants < 0:
                raise ValueError
        except ValueError:
            raise TraceSpecError(
                f"--trace spec {spec!r}: tenants= must be a non-negative "
                f"integer"
            ) from None
        parts = parts[:3]
    if len(parts) != 3:
        raise TraceSpecError(
            f"--trace spec {spec!r} must be name:seed:duration:rps"
            f"[:tenants=N]"
        )
    try:
        seed = int(parts[0])
        if seed < 0:
            raise ValueError
    except ValueError:
        raise TraceSpecError(
            f"--trace spec {spec!r}: seed must be a non-negative integer"
        ) from None
    try:
        duration_s = float(parts[1])
        rps = float(parts[2])
        if not (duration_s > 0 and rps > 0):  # also rejects NaN
            raise ValueError
    except ValueError:
        raise TraceSpecError(
            f"--trace spec {spec!r}: duration and rps must be positive numbers"
        ) from None
    return TraceSpec(
        name=name, seed=seed, duration_s=duration_s, rps=rps, tenants=tenants
    )


# ---------------------------------------------------------------------------
# generators — every arrival time and payload field comes from one
# random.Random(seed); nothing reads the clock or global RNG state
# ---------------------------------------------------------------------------


def _prompt(rng: random.Random, length: int) -> list[int]:
    return [rng.randrange(1, 32) for _ in range(length)]


def _poisson_arrivals(rng, duration_s, rate_fn, rate_max):
    """Thinning (Lewis-Shedler) sampler of an inhomogeneous Poisson
    process — deterministic for a given rng state."""
    out, t = [], 0.0
    while True:
        t += rng.expovariate(rate_max)
        if t >= duration_s:
            return out
        if rng.random() <= rate_fn(t) / rate_max:
            out.append(t)


def _gen_bursty_diurnal(rng, spec):
    """Sinusoid-modulated Poisson: one compressed diurnal cycle —
    ``rate(t) = rps * (1 + 0.8 sin(2πt/duration))`` — so one run holds
    both the trough and the rush hour."""
    rate = lambda t: spec.rps * (1.0 + 0.8 * math.sin(2 * math.pi * t / spec.duration_s))  # noqa: E731
    schedule = []
    for i, t in enumerate(
        _poisson_arrivals(rng, spec.duration_s, rate, spec.rps * 1.8)
    ):
        schedule.append({
            "t": round(t, 6),
            "payload": {
                "id": f"bursty-{i}",
                "prompt": _prompt(rng, rng.randint(4, 12)),
                "max_new_tokens": rng.randint(4, 12),
            },
        })
    return schedule


def _gen_longctx_flood(rng, spec):
    """Long-prompt summarization storm: prompts an order of magnitude
    longer than the bursty mix, short answers — prefill and block-pool
    pressure, the TTFT-tail scenario."""
    schedule, t = [], 0.0
    i = 0
    while True:
        t += rng.expovariate(spec.rps)
        if t >= spec.duration_s:
            return schedule
        schedule.append({
            "t": round(t, 6),
            "payload": {
                "id": f"longctx-{i}",
                "prompt": _prompt(rng, rng.randint(40, 72)),
                "max_new_tokens": rng.randint(2, 6),
            },
        })
        i += 1


def _gen_agentic(rng, spec):
    """Many-turn agent chains: a few sticky sessions, each a sequence of
    turns sharing the session's prompt prefix (radix-cache + session-
    affinity traffic). Turn k arrives a think-time gap after turn k-1."""
    n_sessions = max(2, int(round(spec.rps)))
    mean_gap = max(0.05, 2.0 / spec.rps)
    schedule = []
    for s in range(n_sessions):
        base = _prompt(rng, rng.randint(16, 24))  # shared session prefix
        t = rng.uniform(0.0, min(1.0, spec.duration_s / 4))
        turn = 0
        while t < spec.duration_s:
            suffix = _prompt(rng, rng.randint(2, 6))
            schedule.append({
                "t": round(t, 6),
                "payload": {
                    "id": f"agentic-{s}-{turn}",
                    "session_id": f"agent-{s}",
                    "prompt": base + suffix,
                    "max_new_tokens": rng.randint(4, 10),
                },
            })
            turn += 1
            t += rng.expovariate(1.0 / mean_gap)
    schedule.sort(key=lambda e: (e["t"], e["payload"]["id"]))
    return schedule


def _gen_overbudget_storm(rng, spec):
    """Adversarial deadline/over-budget mix: interactive requests with
    tight (sometimes impossible) ``deadline_ms`` budgets interleaved with
    ``batch``-class bulk decodes — the scenario that exercises shed,
    deadline expiry, and queue growth (the ``queued``-dominated breach)."""
    schedule, t, i = [], 0.0, 0
    while True:
        t += rng.expovariate(spec.rps)
        if t >= spec.duration_s:
            return schedule
        roll = rng.random()
        payload = {
            "id": f"storm-{i}",
            "prompt": _prompt(rng, rng.randint(4, 16)),
        }
        if roll < 0.4:  # tight-budget interactive: some budgets impossible
            payload["max_new_tokens"] = rng.randint(4, 8)
            payload["deadline_ms"] = rng.choice((5, 25, 100, 400, 1500))
            payload["priority"] = "interactive"
        elif roll < 0.7:  # bulk batch decode: queue + shed pressure
            payload["max_new_tokens"] = rng.randint(24, 48)
            payload["priority"] = "batch"
        else:  # plain interactive filler
            payload["max_new_tokens"] = rng.randint(8, 16)
        schedule.append({"t": round(t, 6), "payload": payload})
        i += 1


_GENERATORS = {
    "bursty-diurnal": _gen_bursty_diurnal,
    "longctx-flood": _gen_longctx_flood,
    "agentic": _gen_agentic,
    "overbudget-storm": _gen_overbudget_storm,
}


def schedule_bytes(schedule: list[dict]) -> bytes:
    """Canonical serialization — the determinism contract is *byte*
    identity of this form, not merely ``==`` of the structures."""
    return (
        "\n".join(
            json.dumps(entry, sort_keys=True, separators=(",", ":"))
            for entry in schedule
        )
    ).encode()


def schedule_digest(schedule: list[dict]) -> str:
    return hashlib.sha256(schedule_bytes(schedule)).hexdigest()


def generate_schedule(spec: TraceSpec) -> list[dict]:
    """The spec's deterministic schedule. Generated twice from fresh RNGs
    and asserted byte-identical — a generator that sneaks in ambient state
    (clock, global RNG, dict order) fails here, at the source, not as an
    unexplainable scorecard diff two runs later."""
    if spec.name == "replay":
        return load_schedule(spec.path)
    gen = _GENERATORS[spec.name]
    schedule = gen(random.Random(spec.seed), spec)
    again = gen(random.Random(spec.seed), spec)
    assert schedule_bytes(schedule) == schedule_bytes(again), (
        f"workload generator {spec.name!r} is non-deterministic for "
        f"seed {spec.seed}"
    )
    if spec.tenants:
        # tenant assignment is a post-process on the arrival schedule —
        # its own seeded stream, so `tenants=N` changes WHO each request
        # bills, never when it arrives or what it asks for
        rng = random.Random(spec.seed * 1_000_003 + spec.tenants)
        for entry in schedule:
            entry["payload"]["tenant"] = f"t{rng.randrange(spec.tenants)}"
    return schedule


# ---------------------------------------------------------------------------
# record / replay
# ---------------------------------------------------------------------------


def load_schedule(path: str) -> list[dict]:
    """Read a recorded (or hand-written) schedule JSONL; malformed lines
    are skipped, entries are re-sorted by ``t``."""
    schedule = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if (
                    isinstance(row, dict)
                    and isinstance(row.get("t"), (int, float))
                    and isinstance(row.get("payload"), dict)
                ):
                    schedule.append({"t": float(row["t"]), "payload": row["payload"]})
    except OSError as e:
        raise TraceSpecError(f"replay: cannot read schedule {path!r}: {e}") from e
    if not schedule:
        raise TraceSpecError(f"replay: no schedule entries in {path!r}")
    schedule.sort(key=lambda e: e["t"])
    return schedule


class WorkloadRecorder:
    """Capture live traffic into the schedule format (``route
    --trace-record``): each observed payload lands as one
    ``{"t": <offset-from-first>, "payload": ...}`` line under
    ``<logging_dir>/workload/recorded.jsonl``, immediately replayable via
    ``--trace replay:<path>``. Append + flush per row, crash-safe like
    every other trail in the logging dir."""

    def __init__(self, logging_dir: str):
        subdir = os.path.join(logging_dir, RECORD_SUBDIR)
        os.makedirs(subdir, exist_ok=True)
        self.path = os.path.join(subdir, RECORD_FILENAME)
        self._f = open(self.path, "a")
        self._t0: float | None = None
        self.recorded = 0

    def observe(self, payload: dict) -> None:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        if self._f is None or not isinstance(payload, dict):
            return
        # the router stamps trace_id into submitted payloads in place; a
        # replay must mint fresh ids, so strip the one this run minted
        clean = {k: v for k, v in payload.items() if k != "trace_id"}
        try:
            self._f.write(json.dumps({
                "schema": WORKLOAD_SCHEMA,
                "t": round(now - self._t0, 6),
                "payload": clean,
            }) + "\n")
            self._f.flush()
            self.recorded += 1
        except (OSError, ValueError, TypeError):
            pass

    def close(self) -> None:
        f, self._f = self._f, None
        if f is not None:
            try:
                f.close()
            except OSError:
                pass


def write_workload_manifest(
    logging_dir: str, spec: TraceSpec, schedule: list[dict]
) -> str | None:
    """``WORKLOAD.json`` next to the run's artifacts (atomic replace):
    the scenario identity + schedule digest that makes two runs
    comparable — ``slo report`` reads it, and the smoke asserts digest
    equality across repeated runs."""
    if not logging_dir:
        return None
    path = os.path.join(logging_dir, WORKLOAD_FILENAME)
    payload = {
        "schema": WORKLOAD_SCHEMA,
        "ts": time.time(),
        "spec": spec.as_text(),
        "scenario": spec.name,
        "seed": spec.seed,
        "duration_s": spec.duration_s,
        "rps": spec.rps,
        "requests": len(schedule),
        "schedule_sha256": schedule_digest(schedule),
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def run_schedule(schedule, submit, should_stop=None, speed: float = 1.0) -> int:
    """Drive ``submit(payload)`` at the schedule's arrival offsets
    (best-effort sleeps; the *schedule* is the deterministic artifact,
    wall-clock jitter on dispatch is measurement noise like any other).
    ``should_stop()`` (e.g. a preemption flag) aborts between arrivals.
    Payloads are copied before submission — the router stamps trace ids
    into its payloads in place, and the schedule must stay pristine for
    the next replay. Returns the number submitted."""
    t0 = time.monotonic()
    submitted = 0
    for entry in schedule:
        target = t0 + entry["t"] / max(speed, 1e-9)
        while True:
            if should_stop is not None and should_stop():
                return submitted
            remaining = target - time.monotonic()
            if remaining <= 0:
                break
            time.sleep(min(remaining, 0.05))
        submit(dict(entry["payload"]))
        submitted += 1
    return submitted
