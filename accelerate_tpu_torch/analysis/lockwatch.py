"""LockWatch's construction-time gate (the disarmed path of
``accelerate_tpu/analysis/lockwatch.py``).

The JAX package's LockWatch wraps the serving front end's locks to record
their acquisition order and hold times when ``ACCELERATE_SANITIZE=1`` arms
it. The port keeps the call sites (:func:`maybe_watch`) and the disarmed
behaviour — the lock comes back untouched, so acquire and release pay
nothing — and does not port the watch itself.
"""

from __future__ import annotations


def maybe_watch(lock, name: str, report_dir: str | None = None):
    """``lock`` itself: the disarmed gate of the JAX package's LockWatch
    (``name`` and ``report_dir`` label a watched lock there)."""
    return lock
