"""Replica supervisor: the fleet owns its own lifecycle, continuously (a
copy of ``accelerate_tpu/serving/supervisor.py``: the same respawn,
backoff, quarantine and scaling decisions).

The router alone *consumes* failure — kill -9 rescue, drain, dead-fleet
fail-fast — but never repairs it: a dead replica stays gone and the fleet
shrinks monotonically. This module closes the loop. When the router
marks a replica dead, the supervisor respawns it through the same
``replica.spawn_replica`` machinery the CLI used at bring-up, under an
**exponential crash-loop backoff**:

* each death arriving within ``rapid_death_s`` of the incarnation's spawn
  bumps a consecutive-death counter; the respawn delay doubles per
  consecutive death (seeded jitter so a pod of supervisors never
  thundering-herds a shared dependency) up to ``backoff_max_s``;
* after ``quarantine_after`` consecutive rapid deaths the replica is
  **quarantined**: it keeps backing off, and when it does respawn it
  rejoins dispatch **half-open** (``probation``) — the router routes it at
  most one request at a time until ``probation_successes`` completions
  prove it, after which the death counter resets and it is a full member
  again. A flapping box therefore converges to near-zero dispatch share
  instead of churning the fleet;
* a respawned process that dies (or never reports ready within
  ``ready_timeout``) re-enters the same loop with a deeper backoff.

The supervisor also **scales** between ``min_replicas`` and
``max_replicas`` off the router's own congestion signals: sustained queue
depth above
``scale_up_queue_per_replica`` per ready replica spawns a new member;
a sustained idle fleet above ``min_replicas`` drains its highest-numbered
member (SIGTERM → the serve front end's own drain path → ``terminated``).
With an ``slo_fn`` wired, scaling becomes **SLO-driven**: a firing breach
whose dominant tail phase is ``queued`` scales up, a device-/swap-bound
breach holds with a ``WRONG_REMEDY`` decision row (capacity is not the
fix), and scale-down requires the error budget to be intact — with every
verdict logged as a ``kind:"scale_decision"`` fleet-trail row carrying the
evidence. ``route`` wires ``slo_fn`` to a throttled
:func:`~..metrics.slo.evaluate_from_dir` over the fleet's logging dir when
an ``ACCELERATE_SLO_*`` objective is armed.

Pure stdlib like the rest of the router side. Disabled
(``Router(supervisor=None)``, the default) the router behaves exactly as
before — the dead-fleet fail-fast tests pin that.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass

from ..analysis.lockwatch import maybe_watch
from ..metrics.slo import NON_SCALABLE_PHASES

logger = logging.getLogger(__name__)


@dataclass
class SupervisorConfig:
    """Knobs for respawn, backoff, quarantine, and autoscale."""

    #: the fleet size the supervisor restores after deaths (scale-down floor)
    min_replicas: int = 1
    #: autoscale ceiling (never spawns past this; == min disables scaling)
    max_replicas: int = 1
    #: respawn dead replicas at all (False = supervision observes only:
    #: a dead replica stays dead)
    respawn: bool = True
    #: first respawn delay; doubles per consecutive rapid death
    backoff_base_s: float = 0.25
    backoff_factor: float = 2.0
    backoff_max_s: float = 30.0
    #: +/- fraction of jitter on every backoff delay (seeded — deterministic
    #: per (seed, replica, death-count))
    jitter: float = 0.25
    #: a death within this many seconds of the incarnation's spawn counts
    #: as *consecutive* (crash loop); later deaths restart the count at 1
    rapid_death_s: float = 5.0
    #: consecutive rapid deaths before the replica is quarantined and its
    #: next incarnation rejoins half-open (probation)
    quarantine_after: int = 3
    #: completed requests a probation replica must serve before it becomes
    #: a full dispatch member again (and its death counter resets)
    probation_successes: int = 1
    #: seconds a respawned replica may sit in ``starting`` before the
    #: supervisor declares the bring-up dead and backs off again
    ready_timeout: float = 120.0
    #: autoscale evaluation period
    scale_interval_s: float = 1.0
    #: scale up when router queue depth exceeds this many requests per
    #: ready replica (0 disables scale-up)
    scale_up_queue_per_replica: int = 8
    #: consecutive idle scale ticks (no queue, nothing outstanding) before
    #: one replica above min_replicas is drained
    scale_down_idle_ticks: int = 30
    #: seeds the backoff jitter RNG
    seed: int = 0


class ReplicaSupervisor:
    """Respawn/backoff/quarantine/scale loop over a :class:`~.router.Router`.

    Args:
        spawn_fn: ``spawn_fn(replica_id) -> ReplicaHandle`` — spawns one
            serve process with the fleet's engine arguments (the route CLI
            builds this closure; tests inject stubs).
        config: :class:`SupervisorConfig`.
        slo_fn: optional ``() -> {"firing": [...], "objectives": {...}}``
            (the :func:`~accelerate_tpu.metrics.slo.evaluate_from_dir`
            shape) — arms the SLO scaling policy: scale up on a breach
            whose dominant tail phase is ``queued``, hold with a
            ``WRONG_REMEDY`` decision row when it is device- or swap-bound
            (more replicas would not help), and scale down only while the
            error budget is intact. Every verdict lands in the fleet trail
            as a ``kind:"scale_decision"`` row with the evidence attached.
    """

    def __init__(
        self, spawn_fn, config: SupervisorConfig | None = None, slo_fn=None
    ):
        self.spawn_fn = spawn_fn
        self.cfg = config or SupervisorConfig()
        self.slo_fn = slo_fn
        self._rng = random.Random(self.cfg.seed)
        self._router = None
        self._lock = maybe_watch(threading.Lock(), "ReplicaSupervisor._lock")
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        #: replica_id -> {"deaths", "restarts", "quarantined", "backoff_s",
        #: "respawn_at", "last_spawn"} — survives handle replacement, so the
        #: fleet trail can show restart counts and quarantine state
        self._meta: dict[int, dict] = {}
        self._pending: dict[int, float] = {}  # replica_id -> respawn_at
        self._idle_ticks = 0
        self._last_scale = 0.0
        self._last_decision_sig: tuple | None = None
        self.respawns = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.decisions = 0

    # -- lifecycle -----------------------------------------------------------

    def bind(self, router) -> None:
        """Attach to a router (the router calls this from ``__init__``)
        and start the supervision thread. Locked even though the thread
        starts below: ``bind`` is reachable from any caller's thread, and
        race-check holds every ``_meta``/``replicas`` touch to the same
        discipline."""
        self._router = router
        now = time.monotonic()
        with router._lock:
            fleet = list(router.replicas)
        with self._lock:
            for r in fleet:
                self._meta[r.replica_id] = self._fresh_meta(now)
        self._thread = threading.Thread(
            target=self._loop, name="replica-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop respawning/scaling (drain and close call this FIRST, so a
        respawn never races the teardown kill loop)."""
        self._stopped.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=10.0)

    def will_respawn(self) -> bool:
        """True while dead replicas will be replaced — the router's
        dead-fleet fail-fast stands down when this holds."""
        return self.cfg.respawn and not self._stopped.is_set()

    # -- death / recovery notifications (called by the router) ---------------

    def notify_death(self, replica) -> None:
        """A replica was marked dead: schedule its respawn with crash-loop
        backoff. Called by ``Router._mark_dead`` outside the router lock."""
        if not self.will_respawn():
            return
        if replica.process is None:
            return  # attached replicas are not ours to respawn
        cfg = self.cfg
        now = time.monotonic()
        with self._lock:
            meta = self._meta.setdefault(replica.replica_id, self._fresh_meta(now))
            rapid = now - meta["last_spawn"] <= cfg.rapid_death_s
            meta["deaths"] = meta["deaths"] + 1 if rapid else 1
            backoff = min(
                cfg.backoff_base_s * cfg.backoff_factor ** (meta["deaths"] - 1),
                cfg.backoff_max_s,
            )
            if cfg.jitter:
                backoff *= 1.0 + cfg.jitter * self._rng.uniform(-1.0, 1.0)
            meta["backoff_s"] = backoff
            meta["quarantined"] = meta["deaths"] >= cfg.quarantine_after
            meta["respawn_at"] = now + backoff
            self._pending[replica.replica_id] = meta["respawn_at"]
        logger.warning(
            "supervisor: replica %d death #%d — respawn in %.2fs%s",
            replica.replica_id, meta["deaths"], backoff,
            " (quarantined: next incarnation rejoins half-open)"
            if meta["quarantined"] else "",
        )

    def notify_recovery(self, replica) -> None:
        """A probation replica served its probe quota: full member again,
        consecutive-death counter resets."""
        with self._lock:
            meta = self._meta.get(replica.replica_id)
            if meta is not None:
                meta["deaths"] = 0
                meta["quarantined"] = False
                meta["backoff_s"] = 0.0
        logger.info(
            "supervisor: replica %d cleared probation — full dispatch member",
            replica.replica_id,
        )

    # -- observability -------------------------------------------------------

    def row_fields(self, replica_id: int) -> dict:
        """Supervisor state merged into this replica's fleet-trail row."""
        now = time.monotonic()
        with self._lock:
            meta = self._meta.get(replica_id)
            if meta is None:
                return {}
            out = {
                "restarts": meta["restarts"],
                "consecutive_deaths": meta["deaths"],
                "quarantined": bool(meta["quarantined"]),
                "backoff_s": round(meta["backoff_s"], 3),
            }
            if replica_id in self._pending:
                out["respawn_in_s"] = round(
                    max(0.0, self._pending[replica_id] - now), 3
                )
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "respawns": self.respawns,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "pending_respawns": len(self._pending),
                "quarantined": sum(
                    1 for m in self._meta.values() if m["quarantined"]
                ),
                "min_replicas": self.cfg.min_replicas,
                "max_replicas": self.cfg.max_replicas,
                "scale_decisions": self.decisions,
            }

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _fresh_meta(now: float) -> dict:
        return {
            "deaths": 0,
            "restarts": 0,
            "quarantined": False,
            "backoff_s": 0.0,
            "respawn_at": None,
            "last_spawn": now,
            # True once THIS supervisor spawned the current incarnation
            # (respawn or scale-up): those bring-ups are ours to deadline;
            # the CLI's initial spawns belong to wait_until_ready
            "supervised_spawn": False,
        }

    def _loop(self) -> None:
        while not self._stopped.wait(0.05):
            router = self._router
            if router is None or router._teardown_started():
                continue  # teardown owns the fleet now
            try:
                self._respawn_due()
                self._reap_stuck_bringups()
                now = time.monotonic()
                if now - self._last_scale >= self.cfg.scale_interval_s:
                    self._last_scale = now
                    self._autoscale()
            except Exception:
                logger.warning("supervisor tick failed", exc_info=True)

    def _respawn_due(self) -> None:
        if not self.will_respawn():
            return
        now = time.monotonic()
        with self._lock:
            due = [rid for rid, at in self._pending.items() if at <= now]
        for rid in due:
            self._respawn_one(rid)

    def _respawn_one(self, replica_id: int) -> None:
        router = self._router
        try:
            handle = self.spawn_fn(replica_id)
        except Exception:
            logger.warning(
                "supervisor: spawning replica %d failed — backing off again",
                replica_id, exc_info=True,
            )
            with self._lock:
                meta = self._meta[replica_id]
                meta["respawn_at"] = time.monotonic() + max(meta["backoff_s"], 1.0)
                self._pending[replica_id] = meta["respawn_at"]
            return
        with self._lock:
            meta = self._meta.setdefault(
                replica_id, self._fresh_meta(time.monotonic())
            )
            meta["restarts"] += 1
            meta["last_spawn"] = time.monotonic()
            meta["supervised_spawn"] = True
            meta["respawn_at"] = None
            self._pending.pop(replica_id, None)
            handle.restarts = meta["restarts"]
            # quarantined history ⇒ half-open rejoin: the router dispatches
            # at most one concurrent probe request until it proves itself
            handle.probation = bool(meta["quarantined"])
            self.respawns += 1
        with router._lock:
            for i, r in enumerate(router.replicas):
                if r.replica_id == replica_id:
                    router.replicas[i] = handle
                    break
            else:
                router.replicas.append(handle)
            router._work.notify_all()
        logger.info(
            "supervisor: respawned replica %d (pid %s, restart #%d%s)",
            replica_id, handle.pid, meta["restarts"],
            ", probation" if handle.probation else "",
        )

    def _reap_stuck_bringups(self) -> None:
        """A respawned replica stuck in ``starting`` past ``ready_timeout``
        never answers /healthz, so the health loop's bring-up grace would
        wait on it forever — the supervisor owns the bring-up deadline for
        its own spawns (``wait_until_ready`` owns the CLI's)."""
        router = self._router
        now = time.monotonic()
        stuck = []
        # snapshot the fleet under ITS lock (never nested inside ours:
        # sequential acquisition keeps the order graph acyclic)
        with router._lock:
            fleet = list(router.replicas)
        with self._lock:
            for r in fleet:
                meta = self._meta.get(r.replica_id)
                if (
                    meta is not None
                    and meta.get("supervised_spawn")
                    and r.state == "starting"
                    and r.process is not None
                    and now - meta["last_spawn"] > self.cfg.ready_timeout
                ):
                    stuck.append(r)
        for r in stuck:
            logger.warning(
                "supervisor: replica %d never reported ready after %.0fs — killing",
                r.replica_id, self.cfg.ready_timeout,
            )
            router._mark_dead(r)  # kills the process and calls notify_death

    # -- SLO scaling policy ---------------------------------------------------

    def _read_slo(self) -> dict | None:
        """One throttled SLO verdict from ``slo_fn`` (route wires a
        windowed :func:`~accelerate_tpu.metrics.slo.evaluate_from_dir`
        closure; tests inject synthetic streams). Errors degrade to None —
        a broken trail must never stall the supervision loop."""
        if self.slo_fn is None:
            return None
        try:
            verdict = self.slo_fn()
        except Exception:
            logger.warning("supervisor: slo_fn failed", exc_info=True)
            return None
        return verdict if isinstance(verdict, dict) else None

    def _decide(
        self, action, reason, breach=None, queue_depth=0, ready_count=0
    ) -> None:
        """Log one scaling verdict to the fleet trail. Holds are throttled
        on their (action, reason, objective) signature — a steady-state
        verdict lands once, not once per scale tick — while actual scale
        actions always land."""
        breach = breach or {}
        sig = (action, reason, breach.get("objective"))
        if action == "hold" and sig == self._last_decision_sig:
            return
        self._last_decision_sig = sig
        router = self._router
        writer = getattr(router, "write_decision_row", None)
        with self._lock:
            self.decisions += 1
        if writer is None:
            return
        writer(
            {
                "action": action,
                "reason": reason,
                "objective": breach.get("objective"),
                "burn_rate": breach.get("burn_rate"),
                "dominant_phase": breach.get("dominant_phase"),
                "budget_remaining": breach.get("budget_remaining"),
                "queue_depth": queue_depth,
                "ready_replicas": ready_count,
            }
        )

    def _budget_intact(self, slo: dict | None) -> bool:
        """True when no objective is firing and every armed objective with
        evidence still has budget left — the only state scale-down is
        allowed in when the SLO policy is armed."""
        if not slo:
            return True
        if slo.get("firing"):
            return False
        for row in (slo.get("objectives") or {}).values():
            remaining = row.get("budget_remaining")
            if isinstance(remaining, (int, float)) and remaining <= 0:
                return False
        return True

    def _scale_up(self, next_id, queue_depth, ready_count, reason, breach=None):
        router = self._router
        self._idle_ticks = 0
        try:
            handle = self.spawn_fn(next_id)
        except Exception:
            logger.warning("supervisor: scale-up spawn failed", exc_info=True)
            return
        with self._lock:
            meta = self._fresh_meta(time.monotonic())
            meta["supervised_spawn"] = True  # this bring-up is ours to deadline
            self._meta[next_id] = meta
            self.scale_ups += 1
        with router._lock:
            router.replicas.append(handle)
        self._decide(
            "scale_up", reason, breach=breach,
            queue_depth=queue_depth, ready_count=ready_count,
        )
        logger.info(
            "supervisor: scaled up — replica %d spawned (%s; queue %d over %d ready)",
            next_id, reason, queue_depth, ready_count,
        )

    def _autoscale(self) -> None:
        cfg = self.cfg
        router = self._router
        with router._lock:
            queue_depth = len(router._queue)
            outstanding = router._outstanding
            ready = [r for r in router.replicas if r.state == "ready"]
            live = [
                r for r in router.replicas
                if r.state in ("starting", "ready", "draining")
            ]
            next_id = 1 + max((r.replica_id for r in router.replicas), default=-1)
        with self._lock:
            planned = len(live) + len(self._pending)
        slo = self._read_slo()
        breach = (slo or {}).get("firing") or None
        if breach:
            # evaluate() sorts worst-first: act on the breach burning
            # budget fastest, and let its dominant tail phase pick the
            # remedy — capacity only fixes *queueing*
            worst = breach[0]
            phase = worst.get("dominant_phase")
            self._idle_ticks = 0
            if phase == "queued":
                if planned < cfg.max_replicas:
                    self._scale_up(
                        next_id, queue_depth, len(ready), "slo_breach", worst
                    )
                else:
                    self._decide(
                        "hold", "at_max_replicas", breach=worst,
                        queue_depth=queue_depth, ready_count=len(ready),
                    )
            elif phase in NON_SCALABLE_PHASES:
                # the tail is device- or HBM-bound: another replica is
                # another waiting device — say so instead of scaling
                self._decide(
                    "hold", "WRONG_REMEDY", breach=worst,
                    queue_depth=queue_depth, ready_count=len(ready),
                )
            else:
                self._decide(
                    "hold", f"phase_{phase or 'unattributed'}", breach=worst,
                    queue_depth=queue_depth, ready_count=len(ready),
                )
            return
        # scale up: sustained congestion per ready member
        if (
            cfg.scale_up_queue_per_replica > 0
            and planned < cfg.max_replicas
            and queue_depth > cfg.scale_up_queue_per_replica * max(len(ready), 1)
        ):
            self._scale_up(next_id, queue_depth, len(ready), "queue_depth")
            return
        # scale down: sustained idleness above the floor — and, when the
        # SLO policy is armed, only with the error budget intact
        if queue_depth == 0 and outstanding == 0 and len(ready) > cfg.min_replicas:
            if not self._budget_intact(slo):
                self._idle_ticks = 0
                self._decide(
                    "hold", "budget_spent",
                    queue_depth=queue_depth, ready_count=len(ready),
                )
                return
            self._idle_ticks += 1
            if self._idle_ticks >= cfg.scale_down_idle_ticks:
                self._idle_ticks = 0
                victim = max(
                    (r for r in ready if r.process is not None),
                    key=lambda r: r.replica_id,
                    default=None,
                )
                if victim is None:
                    return
                with router._lock:
                    if victim.state != "ready" or victim.in_flight:
                        return  # raced a dispatch; try again next tick
                    victim.state = "draining"
                with self._lock:
                    self.scale_downs += 1
                victim.drain()  # SIGTERM → serve's own drain → exit 0
                self._decide(
                    "scale_down",
                    "budget_intact_idle" if self.slo_fn is not None else "idle",
                    queue_depth=queue_depth, ready_count=len(ready),
                )
                logger.info(
                    "supervisor: scaled down — replica %d draining (idle fleet "
                    "above min_replicas=%d)", victim.replica_id, cfg.min_replicas,
                )
        else:
            self._idle_ticks = 0
