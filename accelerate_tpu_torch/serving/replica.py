"""Engine replica processes: spawn, attach, health-check, drain, kill (a
copy of ``accelerate_tpu/serving/replica.py``).

One replica = one ``python -m accelerate_tpu_torch serve --http <port>``
process (its own engine, its own CUDA context, its own captured graphs).
This module owns the *per-replica* mechanics the router composes: process
lifecycle, the ``/healthz`` state machine probe
(``starting``/``ready``/``draining``), the blocking ``POST /generate``
dispatch, and drain/kill. Pure stdlib — the router side makes no CUDA call,
so it can front replicas from a machine with no card. Several replicas may
share one card: each holds its own context, weights, pools and graph
memory, and the card time-slices them.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from collections import deque
from pathlib import Path

logger = logging.getLogger(__name__)

#: the directory that holds the ``accelerate_tpu_torch`` package: put on a
#: replica's PYTHONPATH, so ``python -m accelerate_tpu_torch`` resolves
#: whatever the caller's working directory
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])

#: replica lifecycle as the router tracks it — the first three mirror the
#: serve front end's /healthz state machine; the rest are router-observed
REPLICA_STATES = ("starting", "ready", "draining", "dead", "terminated")


class ReplicaError(Exception):
    """Transport-level dispatch failure (connection refused/reset, torn
    response): the replica may be dead and the request must be requeued —
    distinct from an application error (HTTP 400), which is a final answer."""


class ReplicaTimeout(ReplicaError):
    """The router's ``request_timeout`` expired with the socket still open.
    A dead replica resets the connection instantly, so a timeout is
    evidence the replica is *slow-but-alive* — the router requeues the
    ticket but must NOT walk the failure path that marks replicas dead."""


class ReplicaHandle:
    """One engine replica as the router sees it.

    ``process`` is the spawned ``subprocess.Popen`` (None for attached
    remote replicas). ``in_flight``/``sessions`` are router-side dispatch
    accounting; health fields (``state``, ``queue_depth``, ``active_slots``)
    mirror the replica's last ``/healthz`` answer.
    """

    def __init__(self, replica_id: int, base_url: str, process=None):
        self.replica_id = int(replica_id)
        self.base_url = base_url.rstrip("/")
        self.process = process
        self.state = "starting"
        self.in_flight = 0
        self.sessions: set = set()
        self.queue_depth = 0
        self.active_slots = 0
        self.num_slots: int | None = None
        # engine-side deadline evictions (cumulative, from /healthz): the
        # router folds the fleet's sum into its totals row for the SLO feed
        self.deadline_expired = 0
        self.last_heartbeat: float | None = None
        self.consecutive_failures = 0
        self.dispatched = 0
        self.completed = 0
        # supervisor state: how many times this identity has been respawned,
        # and whether the current incarnation is a half-open probation probe
        # (the router routes it one request at a time until it proves itself)
        self.restarts = 0
        self.probation = False
        self.probation_successes = 0
        # leading-block hashes of recently dispatched prompts: the router's
        # prefix-affinity signal (this replica's radix cache is likely warm
        # for these) — see Router._pick_replica
        self.recent_prefixes: deque = deque(maxlen=128)

    # -- health --------------------------------------------------------------

    @property
    def pid(self) -> int | None:
        return self.process.pid if self.process is not None else None

    def process_exited(self) -> bool:
        return self.process is not None and self.process.poll() is not None

    def check_health(self, timeout: float = 2.0) -> dict | None:
        """GET ``/healthz``; returns the parsed payload (and refreshes the
        mirrored fields) or None on any failure."""
        try:
            with urllib.request.urlopen(
                f"{self.base_url}/healthz", timeout=timeout
            ) as resp:
                payload = json.loads(resp.read())
        except Exception:
            return None
        if isinstance(payload, dict):
            self.last_heartbeat = time.time()
            self.consecutive_failures = 0
            # A probe that started before a kill can finish after the router
            # marked us dead — its stale "ready" payload must not resurrect
            # a spawned replica (that process is gone for good). Attached
            # replicas may genuinely come back, so they do adopt it.
            if payload.get("state") in REPLICA_STATES and not (
                self.process is not None and self.state in ("dead", "terminated")
            ):
                self.state = payload["state"]
            for field in (
                "queue_depth", "active_slots", "num_slots", "deadline_expired"
            ):
                if isinstance(payload.get(field), int):
                    setattr(self, field, payload[field])
            return payload
        return None

    @property
    def load(self) -> int:
        """Dispatch-ordering key: requests the router has in flight here
        plus what the replica itself reports queued/decoding. Router-side
        ``in_flight`` dominates — it is current even between health ticks."""
        return self.in_flight + self.queue_depth + self.active_slots

    def is_dispatchable(self) -> bool:
        return self.state == "ready" and not self.process_exited()

    # -- dispatch ------------------------------------------------------------

    def generate(self, payload: dict, timeout: float | None = None) -> dict:
        """Blocking ``POST /generate``. An HTTP 400 is a *final* answer (the
        replica rejected the request — re-sending it elsewhere would fail
        identically); transport failures raise :class:`ReplicaError` so the
        router requeues."""
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{self.base_url}/generate", data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            if e.code == 503:
                # "not accepting requests" (starting/draining) — the request
                # is valid, this replica just can't take it: requeue to a
                # survivor instead of handing the client the refusal
                raise ReplicaError(
                    f"replica {self.replica_id}: not accepting requests (503)"
                ) from e
            # an application-level rejection is a completed request
            try:
                return json.loads(e.read())
            except Exception:
                raise ReplicaError(f"replica {self.replica_id}: torn HTTP error body") from e
        except TimeoutError as e:
            raise ReplicaTimeout(
                f"replica {self.replica_id}: request_timeout after {timeout}s "
                "(replica slow but alive)"
            ) from e
        except Exception as e:
            # urllib wraps socket timeouts in URLError("timed out") — the
            # distinction matters: a timeout means slow-but-alive, never a
            # death verdict (see ReplicaTimeout)
            reason = getattr(e, "reason", None)
            if isinstance(e, TimeoutError) or isinstance(reason, TimeoutError):
                raise ReplicaTimeout(
                    f"replica {self.replica_id}: request_timeout after {timeout}s "
                    "(replica slow but alive)"
                ) from e
            raise ReplicaError(f"replica {self.replica_id}: {e}") from e

    # -- lifecycle -----------------------------------------------------------

    def drain(self) -> None:
        """SIGTERM — the serve front end's PreemptionHandler flag: stop
        admission, finish in-flight, exit 0."""
        if self.process is not None and self.process.poll() is None:
            try:
                self.process.send_signal(signal.SIGTERM)
            except OSError:
                pass

    def kill(self) -> None:
        if self.process is not None and self.process.poll() is None:
            try:
                self.process.kill()
            except OSError:
                pass

    def wait(self, timeout: float | None = None) -> int | None:
        if self.process is None:
            return None
        try:
            return self.process.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_replica(
    replica_id: int,
    serve_args: list[str],
    port: int | None = None,
    env: dict | None = None,
    stderr=None,
) -> ReplicaHandle:
    """Launch one ``python -m accelerate_tpu_torch serve --http`` process
    and return its handle (state ``starting`` until ``/healthz`` says
    otherwise).

    ``serve_args`` is the engine-shape tail (``--preset``, ``--num-slots``,
    ``--device``, ...) forwarded verbatim, so every replica serves the
    identical model — the router's dispatch assumes replicas are
    interchangeable."""
    port = port or free_port()
    cmd = [
        sys.executable, "-m", "accelerate_tpu_torch",
        "serve", "--http", str(port), "--replica-id", str(replica_id),
        *serve_args,
    ]
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
    )
    process = subprocess.Popen(
        cmd,
        env=env,
        stdin=subprocess.DEVNULL,
        stdout=subprocess.DEVNULL,
        stderr=stderr if stderr is not None else subprocess.DEVNULL,
    )
    handle = ReplicaHandle(replica_id, f"http://127.0.0.1:{port}", process=process)
    logger.info("spawned replica %d on port %d (pid %d)", replica_id, port, process.pid)
    return handle


def wait_until_ready(
    replicas: list[ReplicaHandle], timeout: float = 120.0, poll: float = 0.25
) -> None:
    """Block until every replica's ``/healthz`` reports ``ready``. A replica
    process dying during bring-up raises immediately — a half-ready fleet
    that silently dispatches to fewer replicas than requested would skew
    every capacity assumption downstream."""
    deadline = time.monotonic() + timeout
    pending = list(replicas)
    while pending:
        for r in list(pending):
            if r.process_exited():
                raise RuntimeError(
                    f"replica {r.replica_id} (pid {r.pid}) exited with "
                    f"{r.process.returncode} during bring-up"
                )
            r.check_health(timeout=2.0)
            if r.state == "ready":
                pending.remove(r)
        if not pending:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"replicas {[r.replica_id for r in pending]} not ready after {timeout}s"
            )
        time.sleep(poll)
