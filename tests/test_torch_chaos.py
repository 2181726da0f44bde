"""The port's chaos harness and replica supervisor
(``accelerate_tpu_torch/serving/chaos.py``, ``supervisor.py``) against the
JAX package's (``tests/test_chaos.py:38-300``).

The same specs parse to the same faults and the same malformed specs raise;
the same injector schedule answers the same ordinals; seeded delays are
equal across the two packages. The supervisor runs on a test-driven clock
(each module's ``time`` replaced by a fake one, the supervision thread not
started) against a scripted fleet of stub replicas: the same deaths, ticks
and queue depths must give the same respawns, backoffs (jitter included),
quarantines, probation, scale decisions, trail fields and stats. A short
threaded run (respawn and scale-up on the real clock) closes it. Pure
Python: no model, no subprocess.
"""

import threading
import time

import pytest

pytest.importorskip("torch")

from accelerate_tpu.serving import chaos as jchaos  # noqa: E402
from accelerate_tpu.serving import replica as jreplica  # noqa: E402
from accelerate_tpu.serving import router as jrouter  # noqa: E402
from accelerate_tpu.serving import supervisor as jsup  # noqa: E402
from accelerate_tpu_torch.serving import chaos as tchaos  # noqa: E402
from accelerate_tpu_torch.serving import replica as treplica  # noqa: E402
from accelerate_tpu_torch.serving import router as trouter  # noqa: E402
from accelerate_tpu_torch.serving import supervisor as tsup  # noqa: E402

CHAOS = {"jax": jchaos, "torch": tchaos}
#: (supervisor, router, replica) modules of each package
FLEET = {"jax": (jsup, jrouter, jreplica), "torch": (tsup, trouter, treplica)}


def _faults(mod, spec):
    seed, faults = mod.parse_chaos_spec(spec)
    return seed, [(f.kind, f.at_request, f.arg, f.arg2, f.replica) for f in faults]


# -- chaos spec and injector ---------------------------------------------------


@pytest.mark.parametrize("spec", [
    "seed=7; r0:kill@5; r1:delay@4:0.25; err503@2:3; blackout@0:4; r0:stop@3:2.5",
    "r0:kill@7",
    "r0:stop@2",
    "seed=1;r0:kill@3;r1:delay@2:0.05..0.2",
    "r1:blackout@0:9999, err503@1:1 ,delay@9:0..0.5",
    "",
])
def test_chaos_spec_parses_to_the_same_faults(spec):
    assert _faults(tchaos, spec) == _faults(jchaos, spec)
    if spec.startswith("seed=7"):
        seed, faults = _faults(tchaos, spec)
        by_kind = {f[0]: f for f in faults}
        assert seed == 7 and by_kind["kill"] == ("kill", 5, None, None, 0)
        assert by_kind["delay"][2] == 0.25 and by_kind["err503"][4] is None
        assert by_kind["blackout"][1] == 0 and by_kind["stop"][2] == 2.5


@pytest.mark.parametrize("bad", [
    "explode@3", "kill@-1", "kill@x", "delay@3", "kill@0", "delay@3:0.5..0.1",
    "kill@3:1:2", "seed=abc", "err503@2:1..2", "explode@oops",
])
def test_chaos_spec_malformed_raises_the_same(bad):
    messages = {}
    for name, mod in CHAOS.items():
        with pytest.raises(mod.ChaosSpecError) as info:
            mod.parse_chaos_spec(bad)
        messages[name] = str(info.value)
    assert messages["torch"] == messages["jax"]


def _schedule(mod, spec, replica_id, n):
    _, faults = mod.parse_chaos_spec(spec)
    inj = mod.ChaosInjector(faults, replica_id=replica_id)
    return [inj.on_generate() for _ in range(n)], dict(inj.injected)


def test_injector_scoping_and_503_burst():
    for replica_id in (0, 1):  # r0's kill@9 is scoped away from both answers here
        runs = {name: _schedule(mod, "r0:kill@9; err503@2:2; r1:err503@5:1", replica_id, 6)
                for name, mod in CHAOS.items()}
        assert runs["torch"] == runs["jax"]
    answers, injected = runs["jax"]
    assert answers == [None, "err503", "err503", None, "err503", None]
    assert injected["err503"] == 3 and injected["kill"] == 0


def test_injector_blackout_window_and_startup():
    for mod in CHAOS.values():
        _, faults = mod.parse_chaos_spec("blackout@0:0.15; blackout@1:0.15")
        inj = mod.ChaosInjector(faults, replica_id=0)
        assert inj.healthz_blackout()
        time.sleep(0.2)
        assert not inj.healthz_blackout()
        inj.on_generate()
        assert inj.healthz_blackout()


def test_injector_seeded_delays_equal_across_packages(monkeypatch):
    """The same (spec, seed, replica) draws the same jittered delays in both
    packages; another seed or replica draws others."""
    def draws(mod, seed, replica_id=0):
        slept = []
        monkeypatch.setattr(mod.time, "sleep", slept.append)
        _, faults = mod.parse_chaos_spec("delay@1:0.1..0.5; delay@2:0.1..0.5; r1:delay@3:0.2")
        inj = mod.ChaosInjector(faults, seed=seed, replica_id=replica_id)
        for _ in range(3):
            inj.on_generate()
        return slept

    for seed, replica_id in ((3, 0), (4, 0), (3, 1)):
        assert draws(tchaos, seed, replica_id) == draws(jchaos, seed, replica_id)
    assert draws(tchaos, 3) != draws(tchaos, 4) != draws(tchaos, 3, 1)
    assert all(0.1 <= s < 0.5 for s in draws(tchaos, 3)[:2])
    assert draws(tchaos, 3, 1)[-1] == 0.2


def test_injector_env_fallback(monkeypatch):
    for mod in CHAOS.values():
        monkeypatch.setenv("ACCELERATE_CHAOS_SPEC", "r2:kill@9")
        monkeypatch.delenv("ACCELERATE_CHAOS_SEED", raising=False)
        inj = mod.ChaosInjector.from_spec(None, replica_id=2)
        assert inj is not None and inj._kills == {9}
        monkeypatch.setenv("ACCELERATE_CHAOS_SPEC", "")
        assert mod.ChaosInjector.from_spec(None, replica_id=2) is None
        assert mod.ChaosInjector.from_spec("kill@3", replica_id=0)._kills == {3}
        monkeypatch.setenv("ACCELERATE_CHAOS_SEED", "abc")
        with pytest.raises(mod.ChaosSpecError, match="ACCELERATE_CHAOS_SEED"):
            mod.ChaosInjector.from_spec("kill@3", replica_id=0)


# -- the supervisor on a test-driven clock ---------------------------------------


class _Clock:
    """A module's ``time`` replaced: ``monotonic``/``time`` read ``now``,
    which only the test advances."""

    def __init__(self, now=1000.0):
        self.now = now

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


class FakeProc:
    """Enough of ``subprocess.Popen``: SIGTERM exits cleanly (the serve
    drain contract), ``kill`` exits -9."""

    def __init__(self, pid):
        self.pid = pid
        self.returncode = None

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode

    def kill(self):
        self.returncode = -9

    def send_signal(self, sig):
        self.returncode = 0


def _sup_stub(replica_mod):
    class SupStub(replica_mod.ReplicaHandle):
        """A spawned replica: a fake process and an instant answer."""

        def __init__(self, replica_id, pid):
            super().__init__(replica_id, f"http://stub/{replica_id}", process=FakeProc(pid))
            self.state = "ready"
            self.handled = []

        def check_health(self, timeout=2.0):
            if self.process.poll() is not None:
                return None
            return {"state": self.state, "queue_depth": 0, "active_slots": 0}

        def generate(self, payload, timeout=None):
            if self.process.poll() is not None:
                raise replica_mod.ReplicaError(f"stub {self.replica_id} is down")
            self.handled.append(payload)
            return {"id": payload.get("id"), "tokens": [1], "finish_reason": "length"}

    return SupStub


class _Fleet:
    """What the supervisor reads of a router: the lock, the replicas, the
    queue and the outstanding count, the work condition, the decision rows
    and the teardown flag."""

    def __init__(self, replicas):
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self.replicas = list(replicas)
        self._queue = []
        self._outstanding = 0
        self.decisions = []

    def write_decision_row(self, fields):
        self.decisions.append(dict(fields))

    def _teardown_started(self):
        return False

    def _mark_dead(self, replica):
        """The router's death verdict: kill the process, tell the supervisor."""
        replica.state = "dead"
        replica.kill()
        self.supervisor.notify_death(replica)


def _drive_supervisor(sup_mod, router_mod, replica_mod, monkeypatch, slo_script=()):
    """A scripted fleet life on a fake clock; returns everything the
    supervisor decided, step by step."""
    clock = _Clock()
    monkeypatch.setattr(sup_mod, "time", clock)
    stub, pids = _sup_stub(replica_mod), iter(range(500, 600))
    spawned = []

    def spawn_fn(replica_id):
        handle = stub(replica_id, next(pids))
        spawned.append(handle)
        return handle

    slo = list(slo_script)
    cfg = sup_mod.SupervisorConfig(
        min_replicas=1, max_replicas=3, backoff_base_s=0.25, backoff_factor=2.0,
        backoff_max_s=3.0, jitter=0.25, rapid_death_s=5.0, quarantine_after=3,
        probation_successes=1, ready_timeout=20.0, scale_interval_s=1.0,
        scale_up_queue_per_replica=2, scale_down_idle_ticks=2, seed=11,
    )
    sup = sup_mod.ReplicaSupervisor(spawn_fn, cfg,
                                    slo_fn=(lambda: slo.pop(0) if slo else None)
                                    if slo_script else None)
    fleet = _Fleet([spawn_fn(0)])
    fleet.supervisor = sup
    sup._router = fleet
    sup._meta[0] = sup._fresh_meta(clock.now)
    log = []

    def snap(what):
        log.append({
            "what": what, "t": round(clock.now - 1000.0, 6),
            "spawned": [(h.replica_id, h.pid, h.restarts, h.probation) for h in spawned],
            "rows": {rid: sup.row_fields(rid) for rid in sorted(sup._meta)},
            "stats": sup.stats(), "pending": dict(sorted(sup._pending.items())),
            "states": [(r.replica_id, r.state) for r in fleet.replicas],
            "decisions": len(fleet.decisions),
        })

    # three rapid deaths of replica 0: backoff doubles (jittered), the third
    # quarantines, each respawn lands once its backoff has passed
    for death in range(3):
        clock.now += 1.0
        victim = fleet.replicas[0]
        victim.state = "dead"
        sup.notify_death(victim)
        snap(f"death {death}")
        clock.now += 0.01
        sup._respawn_due()
        snap(f"early tick {death}")
        clock.now += 4.0
        sup._respawn_due()
        snap(f"respawn {death}")
    # the quarantined incarnation proves itself: probation clears
    sup.notify_recovery(fleet.replicas[0])
    fleet.replicas[0].probation = False
    snap("recovered")
    # a late death (past rapid_death_s) restarts the count at 1
    clock.now += 30.0
    fleet.replicas[0].state = "dead"
    sup.notify_death(fleet.replicas[0])
    clock.now += 5.0
    sup._respawn_due()
    snap("late death")
    # a respawned incarnation stuck in `starting` past ready_timeout
    fleet.replicas[0].state = "starting"
    clock.now += 25.0
    sup._reap_stuck_bringups()
    snap("stuck bring-up reaped")
    clock.now += 10.0
    sup._respawn_due()
    fleet.replicas[0].state = "ready"
    # queue pressure scales up; idleness drains the newest member back down
    fleet._queue = list(range(5))
    fleet._outstanding = 5
    for tick in range(2):
        clock.now += 1.0
        sup._autoscale()
        snap(f"pressure tick {tick}")
    for r in fleet.replicas:
        r.state = "ready"
    fleet._queue, fleet._outstanding = [], 0
    for tick in range(6):
        clock.now += 1.0
        sup._autoscale()
        snap(f"idle tick {tick}")
    return {"log": log, "decisions": fleet.decisions}


def test_supervisor_decisions_equal_on_a_driven_clock(monkeypatch):
    out = {name: _drive_supervisor(*mods, monkeypatch) for name, mods in FLEET.items()}
    assert out["torch"] == out["jax"]
    log = {entry["what"]: entry for entry in out["jax"]["log"]}
    backoffs = [log[f"death {i}"]["rows"][0]["backoff_s"] for i in range(3)]
    assert 0 < backoffs[0] < backoffs[1] < backoffs[2]
    assert log["early tick 0"]["stats"]["respawns"] == 0
    assert log["respawn 2"]["stats"]["respawns"] == 3
    assert log["respawn 2"]["spawned"][-1][3] is True  # quarantined: half-open
    assert log["recovered"]["rows"][0]["consecutive_deaths"] == 0
    assert log["late death"]["rows"][0]["restarts"] == 4
    assert log["stuck bring-up reaped"]["stats"]["pending_respawns"] == 1
    assert log["pressure tick 0"]["stats"]["scale_ups"] == 1
    assert log["idle tick 5"]["stats"]["scale_downs"] >= 1
    assert [d["action"] for d in out["jax"]["decisions"]][:1] == ["scale_up"]


def test_supervisor_slo_policy_decisions_equal(monkeypatch):
    """The SLO policy (scale up on a queued breach, WRONG_REMEDY on a
    device-bound one, hold at max, no scale-down with the budget spent)
    decides the same on the same verdicts; ``route`` does not wire it yet
    (ROADMAP item 20), but the policy is ported and held here."""
    queued = {"firing": [{"objective": "max_ttft_p99_s", "burn_rate": 3.0,
                          "dominant_phase": "queued", "budget_remaining": 0.4}]}
    device = {"firing": [{"objective": "max_tpot_p99_s", "burn_rate": 2.0,
                          "dominant_phase": "device_wait", "budget_remaining": 0.1}]}
    spent = {"firing": [], "objectives": {"max_error_rate": {"budget_remaining": 0.0}}}
    script = [queued, device, device, queued, queued, spent, spent] + [None] * 40
    out = {name: _drive_supervisor(*mods, monkeypatch, slo_script=script)
           for name, mods in FLEET.items()}
    assert out["torch"] == out["jax"]
    reasons = [(d["action"], d["reason"]) for d in out["jax"]["decisions"]]
    assert ("hold", "WRONG_REMEDY") in reasons
    assert ("scale_up", "slo_breach") in reasons
    assert tsup.NON_SCALABLE_PHASES == tuple(
        __import__("accelerate_tpu.metrics.slo", fromlist=["x"]).NON_SCALABLE_PHASES)


# -- the supervisor on the real clock ------------------------------------------


def _threaded(sup_mod, router_mod, replica_mod, tmp_path):
    """Respawn after the only replica dies, then scale up under queue
    pressure, through the real router's threads."""
    logdir = tmp_path / router_mod.__name__.split(".")[0]
    stub, pids = _sup_stub(replica_mod), iter(range(700, 800))
    spawned = []

    def spawn_fn(replica_id):
        handle = stub(replica_id, next(pids))
        spawned.append(handle)
        return handle

    sup = sup_mod.ReplicaSupervisor(spawn_fn, sup_mod.SupervisorConfig(
        min_replicas=1, max_replicas=2, backoff_base_s=0.05, backoff_max_s=0.5, jitter=0.0,
        scale_interval_s=0.05, scale_up_queue_per_replica=2, scale_down_idle_ticks=1000))
    router = router_mod.Router([spawn_fn(0)], logging_dir=str(logdir), health_interval=0.05,
                               supervisor=sup)
    try:
        assert router.submit({"id": "a", "prompt": [1]}).done.wait(timeout=20)
        spawned[0].process.kill()
        deadline = time.monotonic() + 20
        while len(spawned) < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        during = router.submit({"id": "b", "prompt": [1]})
        assert during.done.wait(timeout=20)
        spawned[-1].state = "starting"  # hold dispatch: the queue builds
        tickets = [router.submit({"id": i, "prompt": [1]}) for i in range(6)]
        while len(spawned) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        for h in spawned:
            h.state = "ready"
        assert all(t.done.wait(timeout=20) for t in tickets)
        stats = router.stats()
        return {"b": during.result.get("tokens"), "spawned": [h.replica_id for h in spawned],
                "restarts": [h.restarts for h in spawned], "respawns":
                stats["supervisor"]["respawns"], "scale_ups": stats["supervisor"]["scale_ups"]}
    finally:
        router.close()


def test_supervisor_respawns_and_scales_on_the_real_clock(tmp_path):
    out = {name: _threaded(*mods, tmp_path) for name, mods in FLEET.items()}
    assert out["torch"] == out["jax"]
    assert out["jax"] == {"b": [1], "spawned": [0, 0, 1], "restarts": [0, 1, 0],
                          "respawns": 1, "scale_ups": 1}
