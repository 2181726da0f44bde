"""Bounded-retry wrapper for checkpoint IO (a copy of
``accelerate_tpu/resilience/retry.py``).

GCS-fuse and NFS mounts fail transiently (stale handles, 5xx-backed
EIO, ESTALE after a server failover); a multi-day run must not die because
one ``write()`` hiccuped. Every file operation in the checkpoint path goes
through :func:`run_with_retries`: exponential backoff, bounded attempts,
and a surfaced exception only once the budget is spent.

Defaults come from ``ACCELERATE_FT_IO_ATTEMPTS`` / of
``ACCELERATE_FT_IO_BACKOFF`` (seconds), overridable per call — the
``FaultTolerancePlugin`` exports its knobs through those env vars so the
whole process agrees.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, TypeVar

logger = logging.getLogger(__name__)

T = TypeVar("T")

#: Exception classes considered transient. ValueError/TypeError etc. are
#: programming errors and retrying them only delays the traceback.
TRANSIENT_ERRORS: tuple[type[BaseException], ...] = (OSError, IOError)


def default_attempts() -> int:
    try:
        return max(1, int(os.environ.get("ACCELERATE_FT_IO_ATTEMPTS", 3)))
    except ValueError:
        return 3


def default_backoff() -> float:
    try:
        return max(0.0, float(os.environ.get("ACCELERATE_FT_IO_BACKOFF", 0.5)))
    except ValueError:
        return 0.5


def run_with_retries(
    fn: Callable[[], T],
    what: str = "checkpoint IO",
    attempts: int | None = None,
    backoff: float | None = None,
    transient: tuple[type[BaseException], ...] = TRANSIENT_ERRORS,
    sleep: Callable[[float], Any] = time.sleep,
) -> T:
    """Call ``fn`` up to ``attempts`` times, sleeping ``backoff * 2**i``
    between tries; re-raises the last error once the budget is spent.
    Only ``transient`` exception types are retried."""
    attempts = default_attempts() if attempts is None else max(1, int(attempts))
    backoff = default_backoff() if backoff is None else float(backoff)
    last: BaseException | None = None
    for i in range(attempts):
        try:
            return fn()
        except transient as e:  # noqa: PERF203 — retry loop by design
            last = e
            if i + 1 >= attempts:
                break
            delay = backoff * (2**i)
            logger.warning(
                "%s failed (%s: %s) — retry %d/%d in %.2fs",
                what, type(e).__name__, e, i + 1, attempts - 1, delay,
            )
            if delay > 0:
                sleep(delay)
    assert last is not None
    raise last
