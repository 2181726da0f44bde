"""Windowed SLO engine: sliding-window objectives evaluated as
multi-window burn rates, each breach carrying the dominant tail phase.

:mod:`.alerts` compares *lifetime totals* against a threshold at scrape
time — a recompile storm during bring-up keeps ``recompiles_per_hour``
above threshold for the rest of the run, and one bad minute an hour ago
pages forever. This module replaces that evaluation (the old functions
stay importable — ``evaluate_alerts`` is still the right tool for a
point-in-time snapshot) with the production formulation:

* every objective is computed over a **sliding window** (default 300 s;
  3600 s for recompile rate), so evidence ages out;
* a breach is expressed as a **burn rate** — how fast the error budget
  is being consumed relative to the rate that would exactly exhaust it
  (burn 1.0 = on budget, 14 = the classic "page now" multiplier);
* firing requires the burn over **two windows** (the short window and a
  6× long window) to both exceed 1.0 — the long window keeps a single
  bad second from paging, the short window makes recovery visible
  immediately (the standard multi-window, multi-burn-rate construction);
* each breach row names the **dominant tail phase** (``queued`` /
  ``prefill`` / ``swap_in`` / ``device_wait`` …) from the request-trace
  tail attribution, so the alert carries its remedy: ``queued`` means
  "add replicas", ``device_wait`` means "scaling won't help".

Objectives arm through the same ``ACCELERATE_SLO_*`` thresholds as
:mod:`.alerts` (unset = off), extended with per-objective ``_WINDOW_S``
and ``_BUDGET`` suffixes and two new objectives::

    ACCELERATE_SLO_MIN_GOODPUT_PCT            goodput %% over the window
    ACCELERATE_SLO_MAX_TTFT_P99_S             windowed serving TTFT p99
    ACCELERATE_SLO_MAX_TPOT_P99_S             windowed serving TPOT p99
    ACCELERATE_SLO_MAX_ERROR_RATE             shed+expired / outcomes (0-1)
    ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR    windowed recompile rate
    ACCELERATE_SLO_WINDOW_S                   default short window for all
    ACCELERATE_SLO_<OBJ>_WINDOW_S             per-objective short window
    ACCELERATE_SLO_<OBJ>_BUDGET               per-objective error budget

The exporter feeds an engine incrementally and writes the verdict to
``ALERTS.json`` (schema 2, atomic) on every refresh; the supervisor's
scaling policy and ``monitor --once`` consume :func:`evaluate_from_dir`,
the pure-file-read evaluation. Breach rows keep the v1 keys (``rule`` /
``env`` / ``threshold`` / ``observed``) so existing readers keep working,
and add ``burn_rate`` / ``burn_rate_long`` / ``window_s`` / ``budget`` /
``budget_remaining`` / ``dominant_phase``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque

from .alerts import ALERTS_FILENAME

logger = logging.getLogger(__name__)

__all__ = [
    "ALERTS_SCHEMA",
    "SloEngine",
    "configured_objectives",
    "evaluate_from_dir",
    "publish_gauges",
    "write_slo_alerts",
]

#: ``ALERTS.json`` schema version written by :func:`write_slo_alerts`
ALERTS_SCHEMA = 2

#: long window = this × short window (multi-window burn-rate construction)
LONG_WINDOW_FACTOR = 6

#: phases where adding replicas is the wrong remedy — the breach is
#: device- or HBM-bound, and more replicas just add more waiting devices
NON_SCALABLE_PHASES = ("device_wait", "swap", "swap_in", "harvest", "dispatch")

#: (objective, env var, comparison, default short window s, default budget)
#: budget None = derived at evaluation time (goodput/error-rate budgets
#: follow from the threshold itself; p99 objectives default to 0.01 — the
#: "99" in p99 — recompiles to 1.0, i.e. burn = rate/threshold)
_OBJECTIVES: tuple[tuple[str, str, str, float, float | None], ...] = (
    ("min_goodput_pct", "ACCELERATE_SLO_MIN_GOODPUT_PCT", "min", 300.0, None),
    ("max_ttft_p99_s", "ACCELERATE_SLO_MAX_TTFT_P99_S", "max", 300.0, 0.01),
    ("max_tpot_p99_s", "ACCELERATE_SLO_MAX_TPOT_P99_S", "max", 300.0, 0.01),
    ("max_error_rate", "ACCELERATE_SLO_MAX_ERROR_RATE", "max", 300.0, None),
    (
        "max_recompiles_per_hour",
        "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR",
        "max",
        3600.0,
        1.0,
    ),
)


def _env_float(env: str, default: float | None) -> float | None:
    raw = os.environ.get(env)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning("ignoring malformed %s=%r", env, raw)
        return default


def configured_objectives() -> dict[str, dict]:
    """The armed objectives: ``{name: {threshold, window_s, budget, env,
    cmp}}`` from the environment. An objective arms exactly when its
    legacy threshold variable is set — the window/budget suffixes only
    tune an armed objective, they never arm one."""
    default_window = _env_float("ACCELERATE_SLO_WINDOW_S", None)
    objectives: dict[str, dict] = {}
    for name, env, cmp, window_default, budget_default in _OBJECTIVES:
        raw = os.environ.get(env)
        if raw is None or raw == "":
            continue
        try:
            threshold = float(raw)
        except ValueError:
            logger.warning("ignoring malformed %s=%r", env, raw)
            continue
        window_s = _env_float(
            f"{env}_WINDOW_S", default_window if default_window else window_default
        )
        budget = _env_float(f"{env}_BUDGET", budget_default)
        objectives[name] = {
            "threshold": threshold,
            "env": env,
            "cmp": cmp,
            "window_s": max(1.0, float(window_s)),
            "budget": budget,
        }
    return objectives


def _p99(values: list[float]) -> float | None:
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]


class SloEngine:
    """Sliding-window burn-rate evaluator.

    Feed it observations stamped with *event* timestamps (``observe_*``),
    then ask for the verdict (:meth:`evaluate`) or the full per-objective
    scorecard (:meth:`report`). When nothing is armed every ``observe_*``
    is a single attribute-check no-op — the disabled path costs one
    ``if`` (the bench's ``slo_overhead_pct`` row pins this).

    Args:
        objectives: explicit objective table (tests inject synthetic
            configs); default re-reads ``ACCELERATE_SLO_*`` on every
            :meth:`evaluate`, so arming mid-run takes effect.
    """

    def __init__(self, objectives: dict[str, dict] | None = None):
        self._explicit = objectives is not None
        self.objectives = objectives if self._explicit else configured_objectives()
        self.armed = bool(self.objectives)
        # (ts, value) / (ts, ok, err) / (ts,) event streams, pruned past
        # the longest long window on every evaluate
        self._ttfts: deque = deque()
        self._tpots: deque = deque()
        self._goodput: deque = deque()
        self._outcomes: deque = deque()
        self._recompiles: deque = deque()
        self._phases: deque = deque()

    # -- observation side -----------------------------------------------------

    def observe_request(self, ts, ttft_s=None, tpot_s=None, error=False):
        """One completed (or failed) request at event time ``ts``."""
        if not self.armed:
            return
        if isinstance(ttft_s, (int, float)):
            self._ttfts.append((ts, float(ttft_s)))
        if isinstance(tpot_s, (int, float)):
            self._tpots.append((ts, float(tpot_s)))
        self._outcomes.append((ts, 0 if error else 1, 1 if error else 0))

    def observe_outcomes(self, ts, ok=0, errors=0):
        """Delta counts (e.g. between two router totals rows): ``ok``
        delivered vs ``errors`` shed/expired since the previous sample."""
        if not self.armed or (ok <= 0 and errors <= 0):
            return
        self._outcomes.append((ts, max(0, int(ok)), max(0, int(errors))))

    def observe_goodput(self, ts, goodput_pct):
        if not self.armed or not isinstance(goodput_pct, (int, float)):
            return
        self._goodput.append((ts, float(goodput_pct)))

    def observe_recompile(self, ts, n: int = 1):
        if not self.armed:
            return
        for _ in range(max(1, int(n))):
            self._recompiles.append((ts,))

    def observe_phases(self, ts, phases):
        """A tail-attribution sample: ``{phase: pct}`` (from
        :func:`~accelerate_tpu_torch.diagnostics.reqtrace.tail_report`)."""
        if not self.armed or not isinstance(phases, dict) or not phases:
            return
        clean = {
            str(k): float(v)
            for k, v in phases.items()
            if isinstance(v, (int, float)) and v > 0
        }
        if clean:
            self._phases.append((ts, clean))

    # -- evaluation side ------------------------------------------------------

    def _prune(self, now: float):
        if not self.objectives:
            horizon = 3600.0 * LONG_WINDOW_FACTOR
        else:
            horizon = max(
                o["window_s"] for o in self.objectives.values()
            ) * LONG_WINDOW_FACTOR
        cutoff = now - horizon
        for dq in (
            self._ttfts,
            self._tpots,
            self._goodput,
            self._outcomes,
            self._recompiles,
            self._phases,
        ):
            while dq and dq[0][0] < cutoff:
                dq.popleft()

    def dominant_phase(self, now: float, window_s: float = 3600.0) -> str | None:
        """The phase carrying the most tail time over recent attribution
        samples — the "why" attached to every breach row."""
        cutoff = now - window_s
        acc: dict[str, float] = {}
        n = 0
        for ts, phases in self._phases:
            if ts < cutoff:
                continue
            n += 1
            for phase, pct in phases.items():
                acc[phase] = acc.get(phase, 0.0) + pct
        if not n:
            return None
        return max(acc, key=acc.get)

    def _windowed(self, dq, now, window_s):
        cutoff = now - window_s
        return [entry for entry in dq if entry[0] >= cutoff]

    def _burn(self, name, spec, now, window_s):
        """(burn, observed) for one objective over one window; (None, None)
        = abstain (no evidence in the window — a rule only fires on an
        observed violation, never on missing data)."""
        threshold = spec["threshold"]
        if name == "min_goodput_pct":
            samples = self._windowed(self._goodput, now, window_s)
            if not samples:
                return None, None
            mean_g = sum(v for _, v in samples) / len(samples)
            bad = max(0.0, (100.0 - mean_g) / 100.0)
            # allowed badness per the threshold; clamped so a (nonsensical
            # but test-useful) threshold ≥ 100 still yields a finite burn
            allowed = max((100.0 - threshold) / 100.0, 1e-6)
            burn = bad / allowed
            if mean_g < threshold:
                # a windowed mean below the target is by definition burning
                # faster than allowed, even when the target leaves no
                # badness allowance (threshold ≥ 100)
                burn = max(burn, 1.0 + (threshold - mean_g) / max(abs(threshold), 1.0))
            return burn, mean_g
        if name in ("max_ttft_p99_s", "max_tpot_p99_s"):
            dq = self._ttfts if name == "max_ttft_p99_s" else self._tpots
            samples = [v for _, v in self._windowed(dq, now, window_s)]
            if not samples:
                return None, None
            violating = sum(1 for v in samples if v > threshold) / len(samples)
            budget = spec["budget"] if spec["budget"] else 0.01
            return violating / budget, _p99(samples)
        if name == "max_error_rate":
            samples = self._windowed(self._outcomes, now, window_s)
            ok = sum(o for _, o, _e in samples)
            err = sum(e for _, _o, e in samples)
            if ok + err == 0:
                return None, None
            rate = err / (ok + err)
            # the threshold IS the budget: burn 1.0 = erroring exactly at
            # the allowed rate
            budget = spec["budget"] if spec["budget"] else max(threshold, 1e-9)
            return rate / budget, rate
        if name == "max_recompiles_per_hour":
            count = len(self._windowed(self._recompiles, now, window_s))
            if not count:
                return None, None
            # rate over the FULL window (no extrapolation from seconds of
            # evidence — the undercount is the safe direction)
            rate = count / (window_s / 3600.0)
            return rate / max(threshold, 1e-9), rate
        return None, None

    def report(self, now: float | None = None) -> dict[str, dict]:
        """The full scorecard: every armed objective with its short/long
        burn rates, remaining budget fraction, windowed observation, and
        firing verdict."""
        now = time.time() if now is None else now
        if not self._explicit:
            self.objectives = configured_objectives()
            self.armed = bool(self.objectives)
        self._prune(now)
        phase = self.dominant_phase(now)
        out: dict[str, dict] = {}
        for name, spec in self.objectives.items():
            window_s = spec["window_s"]
            burn, observed = self._burn(name, spec, now, window_s)
            burn_long, _ = self._burn(
                name, spec, now, window_s * LONG_WINDOW_FACTOR
            )
            firing = (
                burn is not None
                and burn_long is not None
                and burn > 1.0
                and burn_long > 1.0
            )
            out[name] = {
                "objective": name,
                "env": spec["env"],
                "threshold": spec["threshold"],
                "window_s": window_s,
                "budget": spec["budget"],
                "observed": observed,
                "burn_rate": round(burn, 4) if burn is not None else None,
                "burn_rate_long": (
                    round(burn_long, 4) if burn_long is not None else None
                ),
                "budget_remaining": (
                    round(max(0.0, 1.0 - burn_long), 4)
                    if burn_long is not None
                    else None
                ),
                "firing": firing,
                "dominant_phase": phase,
            }
        return out

    def evaluate(self, now: float | None = None) -> list[dict]:
        """The firing breaches — v1-compatible rows (``rule``/``env``/
        ``threshold``/``observed``) extended with the burn-rate evidence."""
        now = time.time() if now is None else now
        firing = []
        for name, row in self.report(now).items():
            if not row["firing"]:
                continue
            firing.append(
                {
                    "rule": name,
                    "objective": name,
                    "env": row["env"],
                    "threshold": row["threshold"],
                    "observed": (
                        float(row["observed"]) if row["observed"] is not None else None
                    ),
                    "window_s": row["window_s"],
                    "budget": row["budget"],
                    "burn_rate": row["burn_rate"],
                    "burn_rate_long": row["burn_rate_long"],
                    "budget_remaining": row["budget_remaining"],
                    "dominant_phase": row["dominant_phase"],
                }
            )
        # worst first: the supervisor acts on (and monitor leads with) the
        # breach burning budget fastest
        firing.sort(key=lambda f: -(f["burn_rate"] or 0.0))
        return firing


# ---------------------------------------------------------------------------
# file-read evaluation (monitor --once, supervisor policy, slo report)
# ---------------------------------------------------------------------------


def _feed_telemetry(engine: SloEngine, logging_dir: str, max_records: int = 4000):
    """Serving request rows → ttft/tpot samples, compile rows → recompile
    events, each at its own row ``ts`` (bounded backward tail — same
    reader discipline as the monitor)."""
    from ..diagnostics.monitor import _tail_jsonl
    from ..telemetry import schema_compatible, telemetry_segments

    jsonl = os.path.join(logging_dir, "telemetry", "telemetry.jsonl")
    for path in telemetry_segments(jsonl):
        for row in _tail_jsonl(path, max_records=max_records):
            if not schema_compatible(row):
                continue
            ts = row.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            if row.get("type") == "compile":
                engine.observe_recompile(ts)
            elif row.get("type") == "serving" and row.get("kind") == "request":
                engine.observe_request(
                    ts, ttft_s=row.get("ttft_s"), tpot_s=row.get("tpot_s")
                )


def _feed_router_trail(engine: SloEngine, logging_dir: str, max_records: int = 4000):
    """Router totals rows (cumulative counters) → ok/error outcome deltas
    at each row's ``ts``. Returns the newest totals row (queue-depth
    fallback for phase attribution)."""
    from ..diagnostics.monitor import _tail_jsonl

    path = os.path.join(logging_dir, "router", "replicas.jsonl")
    last_totals = None
    prev = None
    for row in _tail_jsonl(path, max_records=max_records):
        if row.get("kind") != "router":
            continue
        last_totals = row
        ts = row.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        delivered = row.get("delivered")
        shed = row.get("shed")
        # prefer the fleet-wide expiry counter (router queue + engine-side
        # evictions inside each replica) — older trails only have the
        # router-queue view
        expired = row.get("fleet_deadline_expired")
        if not isinstance(expired, (int, float)):
            expired = row.get("deadline_expired")
        if not all(isinstance(v, (int, float)) for v in (delivered, shed, expired)):
            continue
        if prev is not None:
            d_ok = delivered - prev[0]
            d_err = (shed - prev[1]) + (expired - prev[2])
            # counters reset on router restart: a negative delta means a
            # new router, not time running backwards — skip the seam
            if d_ok >= 0 and d_err >= 0:
                engine.observe_outcomes(ts, ok=d_ok, errors=d_err)
        prev = (delivered, shed, expired)
    return last_totals


def _feed_phases(engine: SloEngine, logging_dir: str, now: float):
    """Tail attribution from the request traces; falls back to "queued"
    when the router queue is backed up but no traced tail exists yet."""
    from ..diagnostics.reqtrace import tail_from_dir_throttled

    tail = tail_from_dir_throttled(logging_dir)
    attribution = (tail or {}).get("attribution") or {}
    if attribution:
        engine.observe_phases(now, attribution)
        return
    totals = getattr(engine, "_last_router_totals", None)
    if isinstance(totals, dict):
        backlog = 0.0
        for key in ("queue_depth", "replica_queue_depth"):
            v = totals.get(key)
            if isinstance(v, (int, float)):
                backlog += v
        if backlog > 0:
            engine.observe_phases(now, {"queued": 100.0})


def evaluate_from_dir(logging_dir: str, now: float | None = None) -> dict:
    """Windowed evaluation from a ``logging_dir``'s trails alone — the
    monitor/supervisor entry point (pure file reads; works on a wedged or
    dead run, and from any machine that can see the dir).

    Returns ``{"firing": [...], "objectives": report, "snapshot": {...}}``
    — ``snapshot`` holds the legacy point-in-time keys for display."""
    from .goodput import ledger_from_dir_throttled

    now = time.time() if now is None else now
    engine = SloEngine()
    snapshot: dict = {}
    if engine.armed:
        _feed_telemetry(engine, logging_dir)
        engine._last_router_totals = _feed_router_trail(engine, logging_dir)
        ledger = ledger_from_dir_throttled(logging_dir)
        if ledger is not None:
            # the ledger is cumulative; stamp it "now" — it ages out of
            # the window once the trails stop being refreshed
            engine.observe_goodput(now, ledger.get("goodput_pct"))
            snapshot["goodput_pct"] = ledger.get("goodput_pct")
        _feed_phases(engine, logging_dir, now)
    report = engine.report(now)
    firing = engine.evaluate(now)
    return {"firing": firing, "objectives": report, "snapshot": snapshot}


def write_slo_alerts(
    logging_dir: str,
    firing: list[dict],
    objectives: dict[str, dict],
    snapshot: dict | None = None,
) -> str | None:
    """Atomically (re)write ``ALERTS.json`` (schema 2) with the windowed
    verdict — written whenever at least one objective is armed, so a
    resolved breach leaves an empty-``firing`` file rather than a stale
    page. The v1 keys (``firing`` rows, ``rules`` map) keep their shape;
    ``objectives`` adds the full scorecard."""
    if not objectives:
        return None
    path = os.path.join(logging_dir, ALERTS_FILENAME)
    payload: dict = {
        "schema": ALERTS_SCHEMA,
        "ts": time.time(),
        "firing": firing,
        "rules": {name: o["threshold"] for name, o in objectives.items()},
        "objectives": objectives,
    }
    if snapshot:
        payload["snapshot"] = {
            k: v for k, v in snapshot.items() if isinstance(v, (int, float, str))
        }
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return path


def publish_gauges(registry, objectives: dict[str, dict]) -> None:
    """Scrape surface: ``slo_burn_rate{objective=…}`` and
    ``slo_budget_remaining{objective=…}`` per armed objective (absent
    burn = 0.0 — an abstaining objective is not burning budget)."""
    if not objectives:
        return
    burn = registry.gauge(
        "slo_burn_rate",
        "Error-budget burn rate over the objective's short window (1.0 = on budget)",
    )
    remaining = registry.gauge(
        "slo_budget_remaining",
        "Remaining error-budget fraction over the objective's long window",
    )
    for name, row in objectives.items():
        burn.set(row["burn_rate"] if row["burn_rate"] is not None else 0.0, objective=name)
        remaining.set(
            row["budget_remaining"] if row["budget_remaining"] is not None else 1.0,
            objective=name,
        )
