"""Multi-replica request router: least-loaded + session-affinity dispatch
over health-checked engine replicas (a copy of
``accelerate_tpu/serving/router.py``: the same placements, requeues, sheds
and fleet-trail rows).

The engine scales *out* by replication — N engine processes, each with its
own CUDA context and captured graphs, behind this router (scaling *up* by
sharding one engine over a mesh of cards is ROADMAP item 18). The router is
deliberately model-blind and makes no CUDA call: it speaks the serve front
end's HTTP protocol (``POST /generate``, ``GET /healthz``) and owns only
placement, affinity, retry, and drain:

* **least-loaded dispatch** — a request goes to the ``ready`` replica with
  the fewest in-flight + queued + decoding requests;
* **session affinity** — requests carrying a ``session_id`` stick to the
  replica that served the session before, so a multi-turn chat lands where
  its KV prefix is warm; affinity is *advisory* — a dead replica's
  sessions move on;
* **prefix affinity** — a free request (no ``session_id``) prefers the
  ready replica whose recent dispatches share its prompt's leading block
  hash (the first :data:`AFFINITY_PREFIX_TOKENS` token ids), so requests
  with a common system prompt land on the replica whose radix prefix
  cache is already warm for it; falls back to least-loaded. Affinity
  yields once the warm replica is more than ``affinity_load_slack``
  requests busier than the fleet's least-loaded member — the spillover
  replica then records the prefix on its own first dispatch and becomes
  warm too, so a dominant system prompt scales across the fleet instead
  of starving it onto one box;
* **failure requeue** — a transport-level dispatch failure (the replica
  was killed mid-stream) re-enqueues the request at the *front* of the
  queue for a different replica; each request is delivered to its caller
  exactly once, so a kill -9 loses and duplicates nothing;
* **drain** — stop admission, let in-flight requests finish, then SIGTERM
  every spawned replica (the serve front end's PreemptionHandler drain)
  and wait for clean exits;
* **self-healing** (``supervisor=``, :mod:`.supervisor`) — a dead replica
  is respawned with exponential crash-loop backoff, flapping replicas are
  quarantined and rejoin half-open (one probe request at a time), and the
  fleet scales between min/max replicas off its own queue-depth signal;
* **request lifecycle** — a payload ``deadline_ms`` rides the ticket: the
  router answers expired tickets with a deadline-exceeded error row
  instead of dispatching or retrying them, and forwards the *remaining*
  budget so the engine evicts the slot when it runs out; a bounded queue
  (``max_queue_depth=``) sheds ``batch``-class submissions before
  ``interactive`` with explicit over-capacity error rows. All of it is
  guarded: deadline-free, unbounded, unsupervised routing pays a few
  None-checks per dispatch (the telemetry null-path rule).

Per-replica health is appended to ``<logging_dir>/router/replicas.jsonl``
(one row per replica per health tick), in the JAX package's row format —
its ``accelerate-tpu monitor`` fleet panel reads only this file, so fleet
health survives a dead router the same way training health survives a
wedged host.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..analysis.lockwatch import maybe_watch
from ..diagnostics.tracing import ensure_trace_id, get_tracer
from .replica import ReplicaError, ReplicaHandle, ReplicaTimeout
from .usage import DEFAULT_TOP_K, cap_by_key, normalize_tenant

logger = logging.getLogger(__name__)

#: subdirectory of logging_dir holding the router's fleet trail
ROUTER_SUBDIR = "router"
#: schema stamp on every fleet row (readers skip newer-than-known rows)
ROUTER_SCHEMA = 1
#: leading token ids hashed into a request's prefix-affinity key — one
#: engine block at the default block_size, the granularity the radix cache
#: actually shares at
AFFINITY_PREFIX_TOKENS = 16


def _prefix_key(payload) -> tuple | None:
    """Leading-block hash key of a request's prompt (None when the payload
    has no usable prompt, or the prompt is too short to say anything about
    prefix reuse — sub-block prompts hit nothing in the radix cache)."""
    prompt = payload.get("prompt") if isinstance(payload, dict) else None
    if not isinstance(prompt, (list, tuple)) or len(prompt) < AFFINITY_PREFIX_TOKENS:
        return None
    try:
        return tuple(int(t) for t in prompt[:AFFINITY_PREFIX_TOKENS])
    except (TypeError, ValueError):
        return None


@dataclass(eq=False)  # identity semantics: tickets live in per-replica sets
class Ticket:
    """One request's lifetime inside the router. ``result`` is set exactly
    once; ``done`` fires after delivery (and after ``callback`` ran)."""

    payload: dict
    callback: object = None
    attempts: int = 0
    result: dict | None = None
    replica_id: int | None = None
    delivered: bool = False
    #: absolute ``time.monotonic`` expiry, set at submit from the payload's
    #: ``deadline_ms`` (None = no deadline — the zero-cost default path)
    deadline: float | None = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def session_id(self):
        return self.payload.get("session_id") if isinstance(self.payload, dict) else None

    @property
    def priority(self) -> str:
        p = self.payload.get("priority") if isinstance(self.payload, dict) else None
        return p if isinstance(p, str) else "interactive"

    @property
    def tenant(self) -> str:
        """The request's accounting tenant (the usage-ledger dimension) —
        same payload-riding contract as ``priority``, same unknown-safe
        normalization the engine applies."""
        t = self.payload.get("tenant") if isinstance(self.payload, dict) else None
        return normalize_tenant(t)

    @property
    def req_id(self):
        """The caller's request id, echoed on every answer row."""
        return self.payload.get("id") if isinstance(self.payload, dict) else None

    @property
    def trace_id(self):
        """The request's distributed-trace identity (stamped into the
        payload at submit, so it rides the HTTP hop to the replica)."""
        return self.payload.get("trace_id") if isinstance(self.payload, dict) else None


class Router:
    """Dispatch loop + health loop over a fixed replica set.

    Args:
        replicas: :class:`~.replica.ReplicaHandle` list (spawned or attached).
        logging_dir: when set, per-replica JSONL health rows land under
            ``<logging_dir>/router/replicas.jsonl``.
        health_interval: seconds between ``/healthz`` sweeps.
        max_attempts: dispatch attempts per request before it is answered
            with an error (default: one try per replica + 1 retry).
        request_timeout: per-dispatch HTTP timeout (None = wait forever;
            a killed replica resets the connection immediately either way).
            Expiry on a slow-but-alive replica requeues the ticket WITHOUT
            marking the replica dead (:class:`~.replica.ReplicaTimeout`).
        affinity_load_slack: how many requests busier than the fleet's
            least-loaded replica a prefix-warm replica may be before
            affinity yields to load balance (~one slot set's worth).
        supervisor: a :class:`~.supervisor.ReplicaSupervisor` that respawns
            dead replicas with crash-loop backoff and scales the fleet;
            None (default) keeps the fleet fixed.
        max_queue_depth: bounded-queue admission control — when the queue
            holds this many tickets, a new ``interactive`` submission sheds
            the newest queued ``batch``-class ticket (answered with an
            over-capacity error row), and a ``batch`` submission is itself
            rejected; None (default) keeps the queue unbounded.
    """

    def __init__(
        self,
        replicas: list[ReplicaHandle],
        logging_dir: str | None = None,
        health_interval: float = 0.5,
        max_attempts: int | None = None,
        request_timeout: float | None = None,
        affinity_load_slack: int = 8,
        supervisor=None,
        max_queue_depth: int | None = None,
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.logging_dir = logging_dir
        self.health_interval = float(health_interval)
        self.max_attempts = max_attempts or len(replicas) + 2
        self.request_timeout = request_timeout
        self.affinity_load_slack = int(affinity_load_slack)
        self.supervisor = supervisor
        self.max_queue_depth = max_queue_depth
        self._queue: deque[Ticket] = deque()
        # LockWatch (ACCELERATE_SANITIZE=1) wraps the fleet's locks in
        # order-graph shims; disabled, maybe_watch hands the raw lock back
        self._lock = maybe_watch(threading.Lock(), "Router._lock", logging_dir)
        self._work = threading.Condition(self._lock)
        # leaf lock serializing fleet-trail writes: the health tick and
        # _mark_dead both flush rows, and two threads interleaving write()
        # calls on one buffered file tear JSONL lines mid-row
        self._trail_lock = maybe_watch(
            threading.Lock(), "Router._trail_lock", logging_dir
        )
        self._sessions: dict = {}  # session_id -> replica_id
        # tickets currently POSTed to each replica: _mark_dead requeues these
        # (a wedged-but-alive replica never produces the transport error the
        # normal requeue path waits for)
        self._inflight: dict[int, set] = {}
        self._draining = False
        self._health_paused = False  # drain owns replica states once set
        self._stopped = threading.Event()
        self._outstanding = 0  # submitted, not yet delivered
        self._delivered = 0
        self._requeues = 0
        self._rejected = 0
        self._shed = 0
        self._deadline_expired = 0
        self._tokens = 0
        # per-tenant outcome counts (usage-ledger attribution at the fleet
        # seam: which tenant's traffic was delivered / shed / requeued /
        # expired). Written under _lock at the same sites as the scalar
        # counters; exported capped to top-K + "other" like every tenant
        # label surface
        self._by_tenant: dict[str, dict] = {}
        # earliest deadline among queued tickets (None = no deadlines):
        # the dispatch loop runs the expiry sweep only once this instant
        # passes, so deadline-free traffic pays one None-check per
        # iteration (the telemetry null-path rule) and deadline-heavy
        # backlog pays one clock read, not an O(queue) scan
        self._next_deadline: float | None = None
        self._trail = None
        if logging_dir:
            os.makedirs(os.path.join(logging_dir, ROUTER_SUBDIR), exist_ok=True)
            self._trail = open(
                os.path.join(logging_dir, ROUTER_SUBDIR, "replicas.jsonl"), "a"
            )
        self._threads = [
            threading.Thread(target=self._dispatch_loop, name="router-dispatch", daemon=True),
            threading.Thread(target=self._health_loop, name="router-health", daemon=True),
        ]
        for t in self._threads:
            t.start()
        if supervisor is not None:
            supervisor.bind(self)

    def _bump_tenant(self, tenant: str, outcome: str) -> None:
        """One per-tenant outcome count (caller holds ``_lock``, like the
        scalar counter the call sits beside)."""
        row = self._by_tenant.get(tenant)
        if row is None:
            row = self._by_tenant[tenant] = {
                "delivered": 0, "shed": 0, "requeued": 0, "deadline_expired": 0,
            }
        row[outcome] += 1

    # -- admission -----------------------------------------------------------

    def submit(self, payload: dict, callback=None) -> Ticket:
        """Enqueue one request; returns its ticket. While draining, the
        request is answered immediately with an error instead of being
        silently dropped (the caller always gets exactly one answer). A
        malformed ``deadline_ms`` is likewise an error *answer*, never a
        crash; a full bounded queue sheds ``batch`` before ``interactive``
        with explicit over-capacity error rows."""
        # the span's begin timestamp is captured BEFORE the ticket can
        # enter the queue: the event itself is emitted after the lock
        # releases, and by then the dispatcher may already have stamped
        # req/dispatch — an un-pinned begin would sort after it
        submit_ts = time.perf_counter()
        if isinstance(payload, dict):
            # the trace id is BORN here: a well-formed client-supplied
            # "trace_id" survives verbatim, anything else gets a generated
            # one — stamped into the payload so the HTTP dispatch carries
            # it into the replica (and its engine) unchanged
            payload["trace_id"] = ensure_trace_id(payload.get("trace_id"))
        ticket = Ticket(payload=payload, callback=callback)
        req_id = ticket.req_id
        rejected = None
        shed_victim = None
        raw_deadline = (
            payload.get("deadline_ms") if isinstance(payload, dict) else None
        )
        if raw_deadline is not None:
            try:
                deadline_ms = float(raw_deadline)
                if not deadline_ms > 0:  # also rejects NaN
                    raise ValueError
            except (TypeError, ValueError):
                rejected = {
                    "id": req_id,
                    "error": f"malformed deadline_ms {raw_deadline!r}: "
                    "want a positive number of milliseconds",
                }
            else:
                ticket.deadline = time.monotonic() + deadline_ms / 1000.0
        with self._lock:
            if rejected is not None:
                self._rejected += 1
            elif self._draining or self._stopped.is_set():
                self._rejected += 1
                rejected = {
                    "id": req_id,
                    "error": "router is draining: admission stopped",
                }
            elif (
                self.max_queue_depth is not None
                and len(self._queue) >= self.max_queue_depth
            ):
                # load shed, batch-class first: an interactive arrival may
                # displace the NEWEST queued batch ticket (it has waited the
                # least); a batch arrival — or an interactive one with no
                # batch ticket to displace — is itself shed
                if ticket.priority == "interactive":
                    for t in reversed(self._queue):
                        if t.priority == "batch":
                            shed_victim = t
                            break
                self._shed += 1
                self._bump_tenant(
                    (shed_victim or ticket).tenant, "shed"
                )
                if shed_victim is not None:
                    self._queue.remove(shed_victim)
                    self._outstanding += 1
                    self._arm_deadline(ticket.deadline)
                    self._queue.append(ticket)
                    self._work.notify()
                else:
                    self._rejected += 1
                    rejected = {
                        "id": req_id,
                        "error": f"over capacity: queue depth "
                        f"{len(self._queue)} at max_queue_depth "
                        f"{self.max_queue_depth} — request shed",
                    }
            else:
                self._outstanding += 1
                self._arm_deadline(ticket.deadline)
                self._queue.append(ticket)
                self._work.notify()
        tr = get_tracer()
        if tr and ticket.trace_id:  # events land OUTSIDE the dispatch lock
            tr.request_begin(
                ticket.trace_id, "req/submit", ts=submit_ts,
                request=str(req_id), priority=ticket.priority,
            )
            if shed_victim is not None and shed_victim.trace_id:
                tr.request_instant(shed_victim.trace_id, "req/shed")
        if shed_victim is not None:  # answered outside the lock
            self._finish(shed_victim, {
                "id": shed_victim.req_id,
                "error": "over capacity: shed from the queue to admit "
                "interactive traffic (batch class sheds first)",
            })
        if rejected is not None:  # deliver outside the lock
            self._finish(ticket, rejected, count_delivered=False)
        return ticket

    # -- dispatch ------------------------------------------------------------

    def _pick_replica(self, ticket: Ticket) -> ReplicaHandle | None:
        """Session affinity first, then prefix affinity (the replica whose
        recent requests share this prompt's leading block hash — its radix
        cache is warm for the prefix), least-loaded ready replica
        otherwise. Caller holds the lock. A ``probation`` (half-open)
        replica is a candidate only while it holds no in-flight request —
        one probe at a time until it proves itself."""
        candidates = [
            r for r in self.replicas
            if r.is_dispatchable() and (not r.probation or r.in_flight == 0)
        ]
        if not candidates:
            return None
        sid = ticket.session_id
        if sid is not None:
            mapped = self._sessions.get(sid)
            for r in candidates:
                if r.replica_id == mapped:
                    return r
        key = _prefix_key(ticket.payload)
        pool = candidates
        if key is not None:
            # affinity yields under skew: once every warm replica is more
            # than the slack busier than the least-loaded member, spill —
            # the spillover replica's own dispatch records the key, so a
            # dominant prefix warms the fleet instead of starving it
            floor = min(r.load for r in candidates)
            warm = [
                r for r in candidates
                if key in r.recent_prefixes
                and r.load <= floor + self.affinity_load_slack
            ]
            if warm:
                pool = warm  # least-loaded among the warm replicas
        chosen = min(pool, key=lambda r: (r.load, r.replica_id))
        if key is not None:
            # move-to-back on hit: recency must reflect USE, or a dominant
            # prefix dispatched constantly ages out of the window behind
            # 128 one-off prompts and affinity silently stops for exactly
            # the workload it targets
            try:
                chosen.recent_prefixes.remove(key)
            except ValueError:
                pass
            chosen.recent_prefixes.append(key)
        if sid is not None:
            self._sessions[sid] = chosen.replica_id
            chosen.sessions.add(sid)
        return chosen

    def _arm_deadline(self, deadline: float | None) -> None:
        """Fold one ticket's deadline into the earliest-deadline watermark
        (caller holds the lock). The dispatch loop sweeps only once the
        watermark passes — never per-iteration scans."""
        if deadline is not None and (
            self._next_deadline is None or deadline < self._next_deadline
        ):
            self._next_deadline = deadline

    def _expire_queued(self) -> list[Ticket]:
        """Pull every past-deadline ticket out of the queue and recompute
        the earliest-deadline watermark (caller holds the lock; caller
        answers the expired tickets outside it)."""
        now = time.monotonic()
        expired = [
            t for t in self._queue
            if t.deadline is not None and now > t.deadline and not t.delivered
        ]
        if expired:
            gone = set(map(id, expired))
            self._queue = deque(t for t in self._queue if id(t) not in gone)
            self._deadline_expired += len(expired)
            for t in expired:
                self._bump_tenant(t.tenant, "deadline_expired")
        self._next_deadline = min(
            (t.deadline for t in self._queue if t.deadline is not None),
            default=None,
        )
        return expired

    def _deadline_error(self, ticket: Ticket, where: str) -> dict:
        return {"id": ticket.req_id, "error": f"deadline_exceeded: {where}"}

    def _dispatch_loop(self):
        while not self._stopped.is_set():
            failed: list[Ticket] = []
            expired: list[Ticket] = []
            ticket = replica = None
            with self._lock:
                while not self._queue and not self._stopped.is_set():
                    self._work.wait(timeout=0.2)
                if self._stopped.is_set():
                    return
                if (
                    self._next_deadline is not None
                    and time.monotonic() >= self._next_deadline
                ):
                    expired = self._expire_queued()
                if self._queue:
                    ticket = self._queue[0]
                if ticket is not None and ticket.delivered:
                    # a rescued ticket whose wedged dispatch answered late:
                    # already delivered, nothing left to do
                    self._queue.popleft()
                    ticket = None
                if ticket is not None:
                    replica = self._pick_replica(ticket)
                    if replica is None:
                        # A spawned replica's death is permanent; if the
                        # whole fleet is spawned-and-gone, waiting would
                        # hang drain() for its full timeout with the
                        # tickets never answered. Attached replicas can
                        # come back, so a fleet with any attached member
                        # keeps waiting — and so does one whose supervisor
                        # will respawn the dead (tickets with deadlines
                        # still expire while they wait).
                        if all(
                            r.process is not None
                            and r.state in ("dead", "terminated")
                            for r in self.replicas
                        ) and not (
                            self.supervisor is not None
                            and self.supervisor.will_respawn()
                        ):
                            failed = list(self._queue)
                            self._queue.clear()
                    else:
                        self._queue.popleft()
                        replica.in_flight += 1
                        replica.dispatched += 1
                        ticket.replica_id = replica.replica_id
                        ticket.attempts += 1
                        self._inflight.setdefault(replica.replica_id, set()).add(ticket)
            for t in expired:
                self._finish(t, self._deadline_error(
                    t, "expired in the router queue before dispatch"
                ))
            if replica is None:
                for t in failed:
                    self._finish(t, {
                        "id": t.req_id,
                        "error": "every replica is dead: request cannot be served",
                    })
                if ticket is not None:
                    time.sleep(0.05)
                continue
            tr = get_tracer()
            if tr and ticket.trace_id:
                # the flow-arrow TAIL: merge draws router-dispatch →
                # replica-admit once both files land in one timeline
                tr.request_instant(
                    ticket.trace_id, "req/dispatch",
                    replica=replica.replica_id, attempt=ticket.attempts,
                )
                tr.flow(ticket.trace_id, "s")
            threading.Thread(
                target=self._dispatch_one, args=(ticket, replica),
                name=f"router-req-{replica.replica_id}", daemon=True,
            ).start()

    def _dispatch_one(self, ticket: Ticket, replica: ReplicaHandle):
        payload = ticket.payload
        if ticket.deadline is not None:
            # thread the REMAINING budget to the replica: queue wait already
            # spent part of it, and the engine enforces its share (evicting
            # the slot the moment the deadline passes)
            remaining_ms = (ticket.deadline - time.monotonic()) * 1000.0
            payload = dict(payload, deadline_ms=max(remaining_ms, 1.0))
        try:
            result = replica.generate(payload, timeout=self.request_timeout)
        except ReplicaError as e:
            # A request_timeout expiry means slow-but-alive: the ticket is
            # requeued, but neither the failure counter nor the death probe
            # runs — a dead replica resets the connection instantly, so a
            # timeout is never death evidence (the slow replica keeps its
            # `ready` state and its other in-flight work).
            timed_out = isinstance(e, ReplicaTimeout)
            with self._lock:
                replica.in_flight -= 1
                if not timed_out:
                    replica.consecutive_failures += 1
                # if _mark_dead already requeued this ticket (wedged-replica
                # rescue), this dispatch's failure is old news — a second
                # requeue would dispatch the request twice concurrently
                rescued = ticket not in self._inflight.get(replica.replica_id, ())
                self._inflight.get(replica.replica_id, set()).discard(ticket)
                if not rescued:
                    self._requeues += 1
                    self._bump_tenant(ticket.tenant, "requeued")
                stopped = self._stopped.is_set()
            if not timed_out:
                self._note_failure(replica)
            if rescued:
                return
            expired = ticket.deadline is not None and time.monotonic() > ticket.deadline
            if expired:
                # never retry an expired ticket: the caller stopped caring
                # at the deadline, and a retry would burn a replica slot on
                # an answer nobody reads
                with self._lock:
                    self._deadline_expired += 1
                    self._bump_tenant(ticket.tenant, "deadline_expired")
                self._finish(ticket, self._deadline_error(
                    ticket, f"expired after {ticket.attempts} dispatch attempt(s)"
                ))
            elif ticket.attempts >= self.max_attempts:
                self._finish(ticket, {
                    "id": ticket.req_id,
                    "error": f"gave up after {ticket.attempts} dispatch attempts: {e}",
                })
            elif stopped:
                # the dispatch loop is gone — a requeue would be silence;
                # an error row is still exactly one answer
                self._finish(ticket, {
                    "id": ticket.req_id,
                    "error": f"router stopped before the request could be retried: {e}",
                })
            else:
                with self._lock:
                    # front of the queue: a victim of a replica crash has
                    # already waited its turn once
                    self._queue.appendleft(ticket)
                    self._arm_deadline(ticket.deadline)
                    self._work.notify()
                tr = get_tracer()
                if tr and ticket.trace_id:
                    tr.request_instant(
                        ticket.trace_id, "req/requeue",
                        replica=replica.replica_id, attempt=ticket.attempts,
                        timeout=timed_out,
                    )
            return
        cleared_probation = False
        with self._lock:
            replica.in_flight -= 1
            replica.completed += 1
            self._inflight.get(replica.replica_id, set()).discard(ticket)
            if replica.probation:
                # half-open probe served: count it, and promote the replica
                # back to full membership once it has proven itself
                replica.probation_successes += 1
                needed = (
                    self.supervisor.cfg.probation_successes
                    if self.supervisor is not None else 1
                )
                if replica.probation_successes >= needed:
                    replica.probation = False
                    cleared_probation = True
        if cleared_probation and self.supervisor is not None:
            self.supervisor.notify_recovery(replica)
        self._finish(ticket, result)

    def _finish(self, ticket: Ticket, result: dict, count_delivered: bool = True):
        """Deliver exactly once — a retry racing a late first answer must
        not double-deliver."""
        if (
            isinstance(result, dict)
            and ticket.trace_id
            and "trace_id" not in result
        ):
            # router-originated answers (shed/deadline/dead-fleet error
            # rows) carry the trace id too — every answer row is
            # correlatable, not just the ones a replica produced
            result["trace_id"] = ticket.trace_id
        with self._lock:
            if ticket.delivered:
                return
            ticket.delivered = True
            ticket.result = result
            if count_delivered:
                self._delivered += 1
                self._outstanding -= 1
                self._bump_tenant(ticket.tenant, "delivered")
            # token accounting lives under the delivered guard: a late
            # answer from a wedged replica must not double-count
            if isinstance(result, dict) and isinstance(result.get("tokens"), list):
                self._tokens += len(result["tokens"])
        tr = get_tracer()
        if tr and ticket.trace_id:
            # under the delivered guard above we returned on a duplicate,
            # so exactly one end event closes the router-side span
            error = result.get("error") if isinstance(result, dict) else None
            tr.request_end(
                ticket.trace_id, "req/finish", ok=error is None,
                attempts=ticket.attempts, replica=ticket.replica_id,
                **({"error": str(error)[:200]} if error is not None else {}),
            )
        if ticket.callback is not None:
            try:
                ticket.callback(result)
            except Exception:
                logger.warning("router result callback raised", exc_info=True)
        ticket.done.set()

    # -- health --------------------------------------------------------------

    def _note_failure(self, replica: ReplicaHandle):
        """A dispatch failed at the transport level: if the process is gone
        (or an attached replica stopped answering), mark it dead *now* so
        the very next dispatch decision excludes it — waiting for the next
        health tick would bounce the requeued request straight back."""
        # 3s, not 1s: a dead replica refuses the connection instantly, so the
        # timeout only bites a slow-but-alive one — where marking dead is wrong
        if replica.process_exited() or replica.check_health(timeout=3.0) is None:
            self._mark_dead(replica)

    def _mark_dead(self, replica: ReplicaHandle):
        with self._lock:
            if self._health_paused:
                # drain/close owns the fleet now: its SIGTERM exits are
                # expected, and a death verdict racing the teardown would
                # kill a replica that is busy answering its last in-flight
                # requests (found while race-checking the drain path)
                return
            if replica.state == "dead":
                return
            replica.state = "dead"
            for sid in replica.sessions:
                if self._sessions.get(sid) == replica.replica_id:
                    del self._sessions[sid]
            replica.sessions.clear()
            replica.recent_prefixes.clear()  # its radix cache died with it
            # rescue the requests POSTed to it: a killed replica errors the
            # dispatch thread out on its own, but a wedged-alive one keeps
            # the socket open forever — requeue now, and the late dispatch
            # thread (which sees its ticket gone from _inflight) stands down.
            # A late *answer* still wins if it lands first: _finish delivers
            # exactly once either way.
            stranded = self._inflight.get(replica.replica_id, set())
            rescued = len(stranded)
            rescued_trace_ids = [t.trace_id for t in stranded if t.trace_id]
            for t in stranded:
                self._queue.appendleft(t)
                self._requeues += 1
                self._bump_tenant(t.tenant, "requeued")
                # re-arm the expiry watermark: a rescued deadline ticket
                # must be answered, never re-dispatched past its budget
                self._arm_deadline(t.deadline)
            stranded.clear()
            if rescued:
                self._work.notify()
        tr = get_tracer()
        if tr:  # outside the lock, like every other event site
            for tid in rescued_trace_ids:
                tr.request_instant(
                    tid, "req/requeue", replica=replica.replica_id,
                    rescued=True,
                )
        logger.warning(
            "replica %d (pid %s) is dead — %d in-flight request(s) requeued, "
            "sessions released", replica.replica_id, replica.pid, rescued,
        )
        # a spawned replica that is dead to the router is dead for real: a
        # wedged-but-alive process (SIGSTOP, engine deadlock) abandoned here
        # would leak forever — and hold its HBM — since drain() skips dead
        # replicas. SIGKILL works on stopped processes.
        if replica.process is not None and replica.process.poll() is None:
            logger.warning(
                "replica %d (pid %s) process still alive after death verdict "
                "(wedged) — killing", replica.replica_id, replica.pid,
            )
            replica.kill()
        self._write_fleet_rows()
        if self.supervisor is not None:
            self.supervisor.notify_death(replica)

    def _teardown_started(self) -> bool:
        """True once drain/close owns the fleet's states (written and read
        under the lock — race-check RC001 guards it like the rest)."""
        with self._lock:
            return self._health_paused

    def _probe_one(self, replica: ReplicaHandle):
        """One replica's health-tick logic (runs on its own probe thread —
        a sweep must not serialize N probe timeouts, or the fleet trail
        goes stale and monitor reads healthy replicas as dead)."""
        r = replica
        if self._teardown_started() or self._stopped.is_set():
            return  # drain/close started mid-sweep: its exits are expected
        if r.state in ("dead", "terminated"):
            if r.process is None and r.check_health() is not None:
                logger.info("attached replica %d is back", r.replica_id)
            return
        if r.state == "draining":
            # supervisor scale-down: the exit is intentional — record it as
            # `terminated`, never `dead` (which would trigger a respawn)
            if r.process_exited():
                r.state = "terminated"
            return
        if r.process_exited():
            self._mark_dead(r)  # stands down on its own once teardown owns us
        elif r.check_health(timeout=5.0) is None:
            if r.state == "starting" and r.process is not None:
                # bring-up: the HTTP server may not even be bound
                # yet — connection-refused here is not death
                # evidence (process_exited above is), and the
                # bring-up deadline is wait_until_ready's job
                return
            # For a spawned replica the process is the authoritative
            # liveness signal — missed probes there mean wedged, not
            # dead, and a busy box starves /healthz long before the
            # engine stops serving (tiny-shape decode holds the GIL),
            # so give spawned replicas a much longer horizon before
            # the irreversible mark. Attached replicas have no
            # process to ask: three strikes is all the signal there is.
            r.consecutive_failures += 1
            strikes = 3 if r.process is None else 10
            if r.consecutive_failures >= strikes:
                self._mark_dead(r)

    def _health_loop(self):
        while not self._stopped.wait(self.health_interval):
            self._health_sweep()

    def _health_sweep(self):
        """One probe sweep over a lock-held snapshot of the fleet. The
        supervisor appends/replaces replicas under the lock at runtime
        (respawn, scale-up) — iterating the live list lock-free here raced
        those edits (race-check RC001 finding, fixed)."""
        with self._lock:
            if self._health_paused:
                # drain is SIGTERM-ing replicas: their exits are *expected*
                # and must land as `terminated`, not `dead`
                return
            fleet = list(self.replicas)
        probes = [
            threading.Thread(
                target=self._probe_one, args=(r,),
                name=f"router-probe-{r.replica_id}", daemon=True,
            )
            for r in fleet
        ]
        for t in probes:
            t.start()
        for t in probes:
            t.join(timeout=6.0)
        if not self._teardown_started():
            self._write_fleet_rows()

    def _write_fleet_rows(self):
        if self.logging_dir is None:  # no trail configured at all
            return
        now = time.time()
        with self._lock:
            rows = [
                {  # built under the lock; written after releasing it so a
                   # slow disk never stalls admission/dispatch/delivery

                    "schema": ROUTER_SCHEMA,
                    "ts": now,
                    "replica_id": r.replica_id,
                    "state": r.state,
                    "base_url": r.base_url,
                    "pid": r.pid,
                    "queue_depth": r.queue_depth,
                    "active_slots": r.active_slots,
                    "num_slots": r.num_slots,
                    "in_flight": r.in_flight,
                    "dispatched": r.dispatched,
                    "completed": r.completed,
                    "deadline_expired": r.deadline_expired,
                    "sessions": len(r.sessions),
                    "restarts": r.restarts,
                    "probation": r.probation,
                    "heartbeat_age_s": (
                        round(now - r.last_heartbeat, 3)
                        if r.last_heartbeat is not None else None
                    ),
                }
                for r in self.replicas
            ]
            totals = {
                "schema": ROUTER_SCHEMA,
                "kind": "router",  # router-wide totals, one per tick
                "ts": now,
                # explicit Nones: readers that index per-replica keys on
                # every row (state checks, pid maps) stay correct without
                # knowing about aggregate rows
                "replica_id": None,
                "state": None,
                "pid": None,
                "queue_depth": len(self._queue),
                "outstanding": self._outstanding,
                "delivered": self._delivered,
                "requeues": self._requeues,
                "rejected": self._rejected,
                "shed": self._shed,
                "deadline_expired": self._deadline_expired,
                # fleet-wide expiry view: deadlines mostly expire *inside*
                # the replicas (slot evicted, partial answer still delivered)
                # because dispatch is uncapped and the router queue rarely
                # builds — the SLO error-rate feed reads this key so those
                # expiries count as breach evidence too. Replica counters
                # reset on restart; readers treat a negative delta as a seam.
                "fleet_deadline_expired": self._deadline_expired
                + sum(r.deadline_expired for r in self.replicas),
                # summed engine admission backlog: the "queued" pressure
                # signal when the router queue itself is empty
                "replica_queue_depth": sum(r.queue_depth for r in self.replicas),
                # per-tenant outcome attribution (usage ledger at the fleet
                # seam) — capped to top-K + "other" so a hostile tenant-id
                # stream cannot grow the trail rows or the scrape unbounded
                "by_tenant": cap_by_key(
                    self._by_tenant, DEFAULT_TOP_K, weight_field="delivered"
                ),
            }
        if self.supervisor is not None:
            sup = self.supervisor
            for row in rows:
                row.update(sup.row_fields(row["replica_id"]))
            totals.update(sup.stats())
        # totals lead the tick: readers tailing "the newest replica row"
        # (monitor, tests) keep seeing a replica row last
        rows.insert(0, totals)
        # _trail_lock is a leaf lock whose entire purpose is this file:
        # the health tick and _mark_dead both land here, and unsynchronized
        # write() calls from two threads tear JSONL rows mid-line (the
        # trail is the monitor's only view of the fleet). Nothing else is
        # ever acquired under it. The dispatch lock stays released — a
        # slow disk still never stalls admission/dispatch/delivery.
        with self._trail_lock:
            trail = self._trail  # _shutdown nulls it under this same lock
            if trail is None:
                return
            try:
                for row in rows:
                    # tpu-lint: ignore[RC003] — serializing this file IS the lock's job; leaf lock, nothing acquired under it
                    trail.write(json.dumps(row) + "\n")
                trail.flush()  # tpu-lint: ignore[RC003] — same leaf-lock rationale
            except (OSError, ValueError):
                pass

    def write_decision_row(self, fields: dict) -> None:
        """Append a ``kind:"scale_decision"`` row to the fleet trail — the
        supervisor's SLO policy logs every verdict (scale_up / scale_down /
        hold, with the breached objective, burn rate, and dominant phase as
        evidence) so a scaling action is auditable next to the fleet state
        it reacted to. Same None-field convention as the totals rows, same
        leaf-lock discipline."""
        row = {
            "schema": ROUTER_SCHEMA,
            "ts": time.time(),
            "kind": "scale_decision",
            "replica_id": None,
            "state": None,
            "pid": None,
            **fields,
        }
        with self._trail_lock:
            trail = self._trail  # _shutdown nulls it under this same lock
            if trail is None:
                return
            try:
                # tpu-lint: ignore[RC003] — leaf lock, serializing this file is its job
                trail.write(json.dumps(row, default=str) + "\n")
                trail.flush()  # tpu-lint: ignore[RC003] — same leaf-lock rationale
            except (OSError, ValueError):
                pass

    # -- drain / shutdown ----------------------------------------------------

    def stop_admission(self):
        """Flip to draining: every later ``submit`` is answered with an
        admission-stopped error instead of being queued."""
        with self._lock:
            self._draining = True

    def wait_idle(self, timeout: float | None = None, poll: float = 0.05) -> bool:
        """Block until every submitted request has been delivered."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                if self._outstanding == 0 and not self._queue:
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll)

    def drain(self, timeout: float = 300.0) -> bool:
        """Stop admission, answer everything in flight, then SIGTERM the
        spawned replicas and wait for clean exits. Returns True when every
        request was answered and every spawned replica exited."""
        with self._lock:
            self._draining = True
        drained = self.wait_idle(timeout=timeout)
        # From here the replicas' exits are intentional: stop the supervisor
        # FIRST (a respawn racing the kill loop would leak a process), then
        # freeze the health loop so a SIGTERM'd replica is recorded as
        # `terminated`, not `dead`.
        if self.supervisor is not None:
            self.supervisor.stop()
        with self._lock:
            # under the lock: a _mark_dead racing the teardown must see the
            # flag (and stand down) or finish first — never interleave
            self._health_paused = True
            fleet = list(self.replicas)
        for r in fleet:
            if r.state not in ("dead", "terminated"):
                r.state = "draining"
        self._write_fleet_rows()
        for r in fleet:
            r.drain()
        clean = True
        deadline = time.monotonic() + timeout
        for r in fleet:
            if r.state == "dead":
                continue
            if r.process is None:
                # attached replicas have no process to wait on, but this
                # router session is over: a final `terminated` row keeps
                # monitor from reading the last `draining` row as a death
                r.state = "terminated"
                continue
            rc = r.wait(timeout=max(0.1, deadline - time.monotonic()))
            if rc is None:
                logger.warning("replica %d did not exit on SIGTERM; killing", r.replica_id)
                r.kill()
                r.wait(timeout=10.0)
                clean = False
            r.state = "terminated"
        self._write_fleet_rows()
        self._shutdown()
        return drained and clean

    def _shutdown(self):
        self._stopped.set()
        with self._lock:
            self._work.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=10.0)
        with self._trail_lock:
            if self._trail is not None:
                try:
                    self._trail.close()
                except OSError:
                    pass
                self._trail = None

    def close(self):
        """Abrupt teardown (tests, error paths): kill what we spawned."""
        if self.supervisor is not None:
            self.supervisor.stop()  # no respawns behind the kill loop
        self._stopped.set()
        with self._lock:
            self._health_paused = True  # death verdicts stand down from here
            fleet = list(self.replicas)
            self._work.notify_all()
        for r in fleet:
            r.kill()
        for r in fleet:
            r.wait(timeout=10.0)  # reap: a killed child must not linger
        self._shutdown()

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            out = {
                "replicas": len(self.replicas),
                "ready": sum(r.state == "ready" for r in self.replicas),
                "dead": sum(r.state == "dead" for r in self.replicas),
                "probation": sum(r.probation for r in self.replicas),
                "queue_depth": len(self._queue),
                "outstanding": self._outstanding,
                "delivered": self._delivered,
                "requeues": self._requeues,
                "rejected": self._rejected,
                "shed": self._shed,
                "deadline_expired": self._deadline_expired,
                "tokens": self._tokens,
                "sessions": len(self._sessions),
                "by_tenant": cap_by_key(
                    self._by_tenant, DEFAULT_TOP_K, weight_field="delivered"
                ),
                "per_replica": {
                    r.replica_id: {
                        "state": r.state,
                        "dispatched": r.dispatched,
                        "completed": r.completed,
                        "in_flight": r.in_flight,
                        "restarts": r.restarts,
                        "probation": r.probation,
                    }
                    for r in self.replicas
                },
            }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
        return out
