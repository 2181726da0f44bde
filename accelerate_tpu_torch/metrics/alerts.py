"""Threshold alert rules (``ACCELERATE_SLO_*``) over the observability
snapshot — the "page a human" layer.

Three fleet-grade SLOs, each armed by an environment variable (unset =
rule off), evaluated wherever a snapshot exists: the sidecar exporter on
every refresh, and ``accelerate-tpu monitor --once``:

``ACCELERATE_SLO_MIN_GOODPUT_PCT``        goodput %% must be ≥ this
``ACCELERATE_SLO_MAX_TTFT_P99_S``         serving TTFT p99 must be ≤ this
``ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR`` recompile rate must be ≤ this

Firing rules are written to ``{logging_dir}/ALERTS.json`` (atomic replace,
like the heartbeat files) and surfaced through a distinct exit code
(:data:`EXIT_SLO_VIOLATION`) so a cron probe can distinguish "unhealthy
SLO" (3) from "wedged/hung host" (2) from "fine" (0).
"""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger(__name__)

__all__ = [
    "ALERTS_FILENAME",
    "EXIT_SLO_VIOLATION",
    "configured_rules",
    "evaluate_alerts",
    "write_alerts",
]

ALERTS_FILENAME = "ALERTS.json"

#: monitor/exporter exit code when an SLO rule fires (0 healthy, 1 usage
#: error, 2 wedged/hang — see ``commands/monitor.py``)
EXIT_SLO_VIOLATION = 3

#: (rule name, env var, snapshot key, comparison) — "min" fires when the
#: observed value drops BELOW the threshold, "max" when it rises above
_RULES: tuple[tuple[str, str, str, str], ...] = (
    ("min_goodput_pct", "ACCELERATE_SLO_MIN_GOODPUT_PCT", "goodput_pct", "min"),
    ("max_ttft_p99_s", "ACCELERATE_SLO_MAX_TTFT_P99_S", "ttft_p99_s", "max"),
    (
        "max_recompiles_per_hour",
        "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR",
        "recompiles_per_hour",
        "max",
    ),
)


def configured_rules() -> dict[str, float]:
    """The armed rules: ``{rule_name: threshold}`` from the environment
    (malformed values are ignored with a warning, not fatal)."""
    rules: dict[str, float] = {}
    for name, env, _key, _cmp in _RULES:
        raw = os.environ.get(env)
        if raw is None or raw == "":
            continue
        try:
            rules[name] = float(raw)
        except ValueError:
            logger.warning("ignoring malformed %s=%r", env, raw)
    return rules


def evaluate_alerts(snapshot: dict) -> list[dict]:
    """Evaluate the armed rules against ``snapshot`` (keys:
    ``goodput_pct``, ``ttft_p99_s``, ``recompiles_per_hour`` — any may be
    None/absent, in which case that rule abstains: a rule only fires on an
    *observed* violation, never on missing data)."""
    rules = configured_rules()
    firing: list[dict] = []
    for name, env, key, cmp in _RULES:
        if name not in rules:
            continue
        observed = snapshot.get(key)
        if not isinstance(observed, (int, float)):
            continue
        threshold = rules[name]
        violated = observed < threshold if cmp == "min" else observed > threshold
        if violated:
            firing.append(
                {
                    "rule": name,
                    "env": env,
                    "threshold": threshold,
                    "observed": float(observed),
                }
            )
    return firing


def write_alerts(logging_dir: str, firing: list[dict], snapshot: dict | None = None) -> str | None:
    """Atomically (re)write ``ALERTS.json`` with the current verdict —
    written whenever at least one rule is configured, so a resolved alert
    leaves an empty-``firing`` file rather than a stale page. Returns the
    path (None when nothing is armed or the dir is unwritable)."""
    if not configured_rules():
        return None
    path = os.path.join(logging_dir, ALERTS_FILENAME)
    payload = {
        "ts": time.time(),
        "firing": firing,
        "rules": configured_rules(),
    }
    if snapshot is not None:
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
