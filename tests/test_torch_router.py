"""The port's router (``accelerate_tpu_torch/serving/router.py`` and
``replica.py``) against the JAX package's, on the scripted stub-replica
scenarios of ``tests/test_router.py``.

Each scenario runs twice in this process, once through the JAX ``Router``
over stubs of the JAX ``ReplicaHandle`` and once through the port's over
stubs of the port's, and must give the same placements (which stub handled
which request), the same answers and error rows, the same requeue, shed
and rejection counts and the same fleet-trail rows with timestamps masked.
The JAX test's own expectations are checked on the common outcome. Pure
Python: no model, no subprocess.
"""

import json
import threading
import time

import pytest

pytest.importorskip("torch")

from accelerate_tpu.serving import replica as jreplica  # noqa: E402
from accelerate_tpu.serving import router as jrouter  # noqa: E402
from accelerate_tpu_torch.serving import replica as treplica  # noqa: E402
from accelerate_tpu_torch.serving import router as trouter  # noqa: E402

#: (router module, replica module) of each package
PACKAGES = {"jax": (jrouter, jreplica), "torch": (trouter, treplica)}

#: fleet-trail fields that read a clock
_CLOCK_FIELDS = ("ts", "heartbeat_age_s")


def _stub_class(replica_mod):
    class StubReplica(replica_mod.ReplicaHandle):
        """``generate`` sleeps ``latency`` then answers; ``down`` fails
        dispatch at the transport level and silences health checks (a
        kill -9 as the router sees it)."""

        def __init__(self, replica_id, latency=0.0):
            super().__init__(replica_id, f"http://stub/{replica_id}")
            self.state = "ready"
            self.latency = latency
            self.down = False
            self.handled = []
            self._hlock = threading.Lock()

        def check_health(self, timeout=2.0):
            if self.down:
                return None
            self.last_heartbeat = time.time()
            return {"state": self.state, "queue_depth": 0, "active_slots": 0}

        def generate(self, payload, timeout=None):
            if self.down:
                raise replica_mod.ReplicaError(f"stub {self.replica_id} is down")
            time.sleep(self.latency)
            with self._hlock:
                self.handled.append(payload)
            return {"id": payload.get("id"), "tokens": [1, 2, 3], "finish_reason": "length"}

    return StubReplica


def _router(router_mod, replicas, **kw):
    kw.setdefault("health_interval", 60.0)  # scenarios drive health by hand
    return router_mod.Router(replicas, **kw)


def _ids(stub):
    return sorted(str(p.get("id")) for p in stub.handled)


def _both(scenario, *args):
    """The scenario's outcome through each package; they must be equal."""
    out = {name: scenario(*mods, *args) for name, mods in PACKAGES.items()}
    assert out["torch"] == out["jax"], out
    return out["jax"]


def _masked(rows):
    return [{k: v for k, v in row.items() if k not in _CLOCK_FIELDS} for row in rows]


def _trail(path):
    return [json.loads(line) for line in (path / "router" / "replicas.jsonl").read_text()
            .splitlines()]


# -- placement ----------------------------------------------------------------


def _prefix_affinity(router_mod, replica_mod):
    stub = _stub_class(replica_mod)
    r0, r1 = stub(0, latency=0.3), stub(1, latency=0.3)
    router = _router(router_mod, [r0, r1])
    shared = list(range(router_mod.AFFINITY_PREFIX_TOKENS)) + [7, 7]
    try:
        assert router.submit({"id": "w0", "prompt": shared}).done.wait(timeout=30)
        router.submit({"id": "f1", "prompt": [1, 2]})
        time.sleep(0.1)
        warm = router.submit({"id": "w1", "prompt": shared + [9]})
        cold = router.submit({"id": "c1", "prompt": [500 + i for i in range(20)]})
        assert warm.done.wait(timeout=30) and cold.done.wait(timeout=30)
        assert router.wait_idle(timeout=30)
        return {"r0": _ids(r0), "r1": _ids(r1)}
    finally:
        router.close()


def test_prefix_affinity_prefers_warm_replica():
    out = _both(_prefix_affinity)
    assert out == {"r0": ["f1", "w0", "w1"], "r1": ["c1"]}


def _least_loaded(router_mod, replica_mod):
    stub = _stub_class(replica_mod)
    r0, r1 = stub(0, latency=0.3), stub(1, latency=0.3)
    router = _router(router_mod, [r0, r1])
    try:
        tickets = [router.submit({"id": i, "prompt": [1]}) for i in range(4)]
        assert router.wait_idle(timeout=30)
        return {"tokens": [t.result["tokens"] for t in tickets],
                "counts": (len(r0.handled), len(r1.handled))}
    finally:
        router.close()


def test_least_loaded_placement_splits_across_replicas():
    out = _both(_least_loaded)
    assert out == {"tokens": [[1, 2, 3]] * 4, "counts": (2, 2)}


def _session_affinity(router_mod, replica_mod):
    stub = _stub_class(replica_mod)
    r0, r1 = stub(0, latency=0.3), stub(1, latency=0.3)
    router = _router(router_mod, [r0, r1])
    try:
        assert router.submit({"id": "s1", "prompt": [1], "session_id": "chat-a"}).done.wait(30)
        for i in (1, 2, 3):
            router.submit({"id": f"f{i}", "prompt": [1]})
        time.sleep(0.2)
        sticky = router.submit({"id": "s2", "prompt": [1], "session_id": "chat-a"})
        assert router.wait_idle(timeout=30)
        return {"r0": _ids(r0), "r1": _ids(r1), "sticky": sticky.result["finish_reason"]}
    finally:
        router.close()


def test_session_affinity_beats_least_loaded():
    out = _both(_session_affinity)
    assert "s1" in out["r0"] and "s2" in out["r0"] and out["sticky"] == "length"


# -- failure: death, wedge, timeout --------------------------------------------


def _dead_replica(router_mod, replica_mod):
    stub = _stub_class(replica_mod)
    r0, r1 = stub(0, latency=0.2), stub(1, latency=0.2)
    router = _router(router_mod, [r0, r1])
    try:
        assert router.submit({"id": "w", "prompt": [1], "session_id": "chat-a"}).done.wait(30)
        r0.down = True
        after = [router.submit({"id": f"a{i}", "prompt": [1], "session_id": "chat-a"})
                 for i in range(3)]
        assert router.wait_idle(timeout=30)
        stats = router.stats()
        return {"answers": [t.result["finish_reason"] for t in after],
                "r0": _ids(r0), "r1": _ids(r1), "r0_state": r0.state,
                "r0_sessions": sorted(r0.sessions), "dead": stats["dead"],
                "delivered": stats["delivered"], "requeued": stats["requeues"] >= 1}
    finally:
        router.close()


def test_dead_replica_requeues_and_releases_sessions():
    out = _both(_dead_replica)
    assert out["answers"] == ["length"] * 3 and out["r1"] == ["a0", "a1", "a2"]
    assert out["r0_state"] == "dead" and out["r0_sessions"] == []
    assert out["dead"] == 1 and out["delivered"] == 4 and out["requeued"]


def _wedged(router_mod, replica_mod):
    stub = _stub_class(replica_mod)
    release = threading.Event()

    class WedgedStub(stub):
        wedged = True

        def check_health(self, timeout=2.0):
            return None if self.wedged else super().check_health(timeout)

        def generate(self, payload, timeout=None):
            if self.wedged:
                release.wait(30)  # socket open, no answer, no error
                raise replica_mod.ReplicaError("connection reset at teardown")
            return super().generate(payload, timeout)

    r0, r1 = WedgedStub(0), stub(1)
    router = _router(router_mod, [r0, r1], health_interval=0.05)
    try:
        ticket = router.submit({"id": "stuck", "prompt": [1]})
        assert ticket.done.wait(timeout=30), "stranded request never rescued"
        stats = router.stats()
        return {"tokens": ticket.result["tokens"], "r1": _ids(r1), "r0_state": r0.state,
                "delivered": stats["delivered"], "requeued": stats["requeues"] >= 1}
    finally:
        release.set()
        router.close()


def test_wedged_replica_inflight_rescued():
    out = _both(_wedged)
    assert out == {"tokens": [1, 2, 3], "r1": ["stuck"], "r0_state": "dead",
                   "delivered": 1, "requeued": True}


def _timeout(router_mod, replica_mod):
    stub = _stub_class(replica_mod)

    class SlowStub(stub):
        def generate(self, payload, timeout=None):
            if timeout is not None and self.latency > timeout:
                time.sleep(timeout)
                raise replica_mod.ReplicaTimeout(f"stub {self.replica_id}: request_timeout")
            return super().generate(payload, timeout)

    fast, slow = stub(0, latency=0.05), SlowStub(1, latency=10.0)
    router = _router(router_mod, [fast, slow], request_timeout=0.1)
    try:
        fast.queue_depth = 2
        threading.Timer(0.12, lambda: setattr(fast, "queue_depth", 0)).start()
        ticket = router.submit({"id": "t0", "prompt": [1]})
        assert ticket.done.wait(timeout=30)
        stats = router.stats()
        return {"tokens": ticket.result["tokens"], "fast": _ids(fast), "slow_state": slow.state,
                "slow_failures": slow.consecutive_failures, "dead": stats["dead"],
                "requeued": stats["requeues"] >= 1}
    finally:
        router.close()


def test_request_timeout_requeues_without_marking_dead():
    out = _both(_timeout)
    assert out == {"tokens": [1, 2, 3], "fast": ["t0"], "slow_state": "ready",
                   "slow_failures": 0, "dead": 0, "requeued": True}


# -- deadlines, shedding, admission --------------------------------------------


def _deadline(router_mod, replica_mod):
    stub = _stub_class(replica_mod)
    seen = []

    class Recording(stub):
        def generate(self, payload, timeout=None):
            seen.append(dict(payload))
            return super().generate(payload, timeout)

    r0 = Recording(0)
    r0.state = "starting"  # hold dispatch: tickets really wait in the queue
    router = _router(router_mod, [r0])
    try:
        first = router.submit({"id": "slow", "prompt": [1], "deadline_ms": 60_000})
        doomed = router.submit({"id": "doomed", "prompt": [1], "deadline_ms": 20})
        assert doomed.done.wait(timeout=30)
        r0.state = "ready"
        assert first.done.wait(timeout=30)
        sent = [p for p in seen if p.get("id") == "slow"]
        stats = router.stats()
        return {"doomed": doomed.result["error"], "first": first.result["tokens"],
                "budget_cut": bool(sent) and 0 < sent[0]["deadline_ms"] < 60_000,
                "doomed_sent": any(p.get("id") == "doomed" for p in seen),
                "expired": stats["deadline_expired"], "delivered": stats["delivered"]}
    finally:
        router.close()


def test_deadline_expires_in_queue_and_on_retry():
    out = _both(_deadline)
    assert "deadline_exceeded" in out["doomed"] and out["first"] == [1, 2, 3]
    assert out["budget_cut"] and not out["doomed_sent"]
    assert out["expired"] == 1 and out["delivered"] == 2


def _malformed_deadline(router_mod, replica_mod):
    r0 = _stub_class(replica_mod)(0)
    router = _router(router_mod, [r0])
    try:
        ticket = router.submit({"id": "bad", "prompt": [1], "deadline_ms": "soon"})
        assert ticket.done.wait(timeout=10)
        return {"error": ticket.result["error"], "handled": _ids(r0),
                "rejected": router.stats()["rejected"]}
    finally:
        router.close()


def test_malformed_deadline_answers_error_row():
    out = _both(_malformed_deadline)
    assert "malformed deadline_ms" in out["error"]
    assert out["handled"] == [] and out["rejected"] == 1


def _shed(router_mod, replica_mod):
    r0 = _stub_class(replica_mod)(0)
    r0.state = "starting"
    router = _router(router_mod, [r0], max_queue_depth=2)
    try:
        b1 = router.submit({"id": "b1", "prompt": [1], "priority": "batch"})
        b2 = router.submit({"id": "b2", "prompt": [1], "priority": "batch"})
        i1 = router.submit({"id": "i1", "prompt": [1]})
        assert b2.done.wait(timeout=10)
        i2 = router.submit({"id": "i2", "prompt": [1]})
        assert b1.done.wait(timeout=10)
        i3 = router.submit({"id": "i3", "prompt": [1]})
        b3 = router.submit({"id": "b3", "prompt": [1], "priority": "batch"})
        assert i3.done.wait(timeout=10) and b3.done.wait(timeout=10)
        r0.state = "ready"
        assert router.wait_idle(timeout=30)
        stats = router.stats()
        return {"answers": {t.req_id: t.result.get("error", t.result.get("tokens"))
                            for t in (b1, b2, i1, i2, i3, b3)},
                "handled": _ids(r0), "shed": stats["shed"], "delivered": stats["delivered"],
                "rejected": stats["rejected"], "by_tenant": stats["by_tenant"]}
    finally:
        router.close()


def test_bounded_queue_sheds_batch_before_interactive():
    out = _both(_shed)
    answers = out["answers"]
    for shed in ("b1", "b2", "i3", "b3"):
        assert "over capacity" in answers[shed]
    assert answers["i1"] == answers["i2"] == [1, 2, 3]
    assert out["handled"] == ["i1", "i2"]
    assert out["shed"] == 4 and out["delivered"] == 4


def _stop_admission(router_mod, replica_mod):
    r0 = _stub_class(replica_mod)(0)
    router = _router(router_mod, [r0])
    try:
        router.stop_admission()
        ticket = router.submit({"id": "late", "prompt": [1]})
        assert ticket.done.wait(timeout=10)
        return {"error": ticket.result["error"], "rejected": router.stats()["rejected"],
                "handled": _ids(r0)}
    finally:
        router.close()


def test_stop_admission_answers_instead_of_dropping():
    out = _both(_stop_admission)
    assert "draining" in out["error"] and out["rejected"] == 1 and out["handled"] == []


# -- drain and the fleet trail -------------------------------------------------


def _drain(router_mod, replica_mod, tmp_path):
    logdir = tmp_path / router_mod.__name__.split(".")[0]
    r0 = _stub_class(replica_mod)(0, latency=0.2)
    router = _router(router_mod, [r0], logging_dir=str(logdir))
    tickets = [router.submit({"id": i, "prompt": [1]}) for i in range(2)]
    drained = router.drain(timeout=30)
    return {"drained": drained, "answers": [t.result["finish_reason"] for t in tickets],
            "trail": _masked(_trail(logdir))}


def test_drain_finishes_inflight_before_returning(tmp_path):
    out = _both(_drain, tmp_path)
    assert out["drained"] and out["answers"] == ["length", "length"]
    assert out["trail"][-1]["state"] in ("draining", "terminated")


def _fleet_rows(router_mod, replica_mod, tmp_path):
    """A scripted fleet: one delivered request, one shed, one death with a
    session released; the trail written by hand at three points."""
    logdir = tmp_path / router_mod.__name__.split(".")[0]
    stub = _stub_class(replica_mod)
    r0, r1 = stub(0), stub(1)
    router = _router(router_mod, [r0, r1], logging_dir=str(logdir), max_queue_depth=1)
    try:
        router._write_fleet_rows()
        t = router.submit({"id": "a", "prompt": [1], "session_id": "s", "tenant": "acme"})
        assert t.done.wait(timeout=10)
        router._write_fleet_rows()
        r0.down = True
        router._mark_dead(r0)  # writes the trail itself
        r1.state = "starting"
        router.submit({"id": "q1", "prompt": [1], "priority": "batch"})
        shed = router.submit({"id": "q2", "prompt": [1], "priority": "batch"})
        assert shed.done.wait(timeout=10)
        router._write_fleet_rows()
    finally:
        router.close()
    return _masked(_trail(logdir))


def test_fleet_rows_carry_health_fields(tmp_path):
    rows = _both(_fleet_rows, tmp_path)
    replica_rows = [r for r in rows if r.get("replica_id") is not None]
    assert {"queue_depth", "active_slots", "in_flight", "dispatched", "completed",
            "sessions", "restarts", "probation"} <= set(replica_rows[-1])
    totals = [r for r in rows if r.get("kind") == "router"]
    assert totals[-1]["shed"] == 1 and totals[-1]["rejected"] == 1
    assert totals[-1]["delivered"] == 1 and totals[-1]["queue_depth"] == 1
    assert any(r["state"] == "dead" and r["replica_id"] == 0 for r in replica_rows)


# -- concurrency pins (tests/test_router.py:697-807) ---------------------------


class _InterleaveDetectingTrail:
    """A file double whose ``write`` notices a second thread entering while
    one is mid-write: the torn-JSONL hazard of the fleet trail."""

    def __init__(self):
        self.concurrent_entries = 0
        self.lines = []
        self._busy = False

    def write(self, text):
        if self._busy:
            self.concurrent_entries += 1
        self._busy = True
        time.sleep(0.001)
        self.lines.append(text)
        self._busy = False

    def flush(self):
        pass

    def close(self):
        pass


def _serialized_trail(router_mod, replica_mod, tmp_path):
    logdir = tmp_path / router_mod.__name__.split(".")[0]
    router = _router(router_mod, [_stub_class(replica_mod)(0)], logging_dir=str(logdir))
    trail = _InterleaveDetectingTrail()
    try:
        with router._trail_lock:
            router._trail.close()
            router._trail = trail
        threads = [threading.Thread(target=lambda: [router._write_fleet_rows()
                                                    for _ in range(20)], daemon=True)
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return {"concurrent": trail.concurrent_entries, "lines": len(trail.lines),
                "intact": all(isinstance(json.loads(line), dict) for line in trail.lines)}
    finally:
        router.close()


def test_fleet_trail_writes_serialized_across_threads(tmp_path):
    assert _both(_serialized_trail, tmp_path) == {"concurrent": 0, "lines": 80, "intact": True}


def _stand_down(router_mod, replica_mod, tmp_path):
    logdir = tmp_path / router_mod.__name__.split(".")[0]
    r0 = _stub_class(replica_mod)(0)
    router = _router(router_mod, [r0], logging_dir=str(logdir))
    try:
        with router._lock:
            router._health_paused = True
        t = threading.Thread(target=router._mark_dead, args=(r0,), daemon=True)
        t.start()
        t.join(timeout=30)
        return {"alive": t.is_alive(), "state": r0.state}
    finally:
        router.close()


def test_mark_dead_stands_down_once_teardown_owns_the_fleet(tmp_path):
    assert _both(_stand_down, tmp_path) == {"alive": False, "state": "ready"}


def _sweep_snapshot(router_mod, replica_mod, tmp_path):
    logdir = tmp_path / router_mod.__name__.split(".")[0]
    stub = _stub_class(replica_mod)
    r0, r1 = stub(0), stub(1)
    router = _router(router_mod, [r0, r1], logging_dir=str(logdir))
    probed, entered, release = [], threading.Event(), threading.Event()
    orig_probe = router._probe_one

    def slow_probe(r):
        probed.append(r)
        entered.set()
        release.wait(timeout=30)
        orig_probe(r)

    try:
        router._probe_one = slow_probe
        sweep = threading.Thread(target=router._health_sweep, daemon=True)
        sweep.start()
        assert entered.wait(timeout=30)
        with router._lock:
            router.replicas.append(stub(2))
            router.replicas[0] = stub(0)
        release.set()
        sweep.join(timeout=60)
        return {"alive": sweep.is_alive(), "snapshot": set(probed) == {r0, r1}}
    finally:
        release.set()
        router.close()


def test_health_sweep_survives_concurrent_fleet_edits(tmp_path):
    assert _both(_sweep_snapshot, tmp_path) == {"alive": False, "snapshot": True}


def test_spawn_replica_launches_the_port_cli(monkeypatch):
    """``spawn_replica`` starts ``python -m accelerate_tpu_torch serve --http``
    (never the JAX CLI) with the engine tail forwarded verbatim and the
    package's root on PYTHONPATH."""
    import subprocess

    seen = {}

    class _Popen:
        pid = 4242

        def __init__(self, cmd, env=None, **kw):
            seen["cmd"], seen["env"] = cmd, env

        def poll(self):
            return None

    monkeypatch.setattr(subprocess, "Popen", _Popen)
    handle = treplica.spawn_replica(3, ["--device", "cpu", "--preset", "tiny"], port=5555)
    assert seen["cmd"][1:] == ["-m", "accelerate_tpu_torch", "serve", "--http", "5555",
                               "--replica-id", "3", "--device", "cpu", "--preset", "tiny"]
    assert treplica._PACKAGE_ROOT in seen["env"]["PYTHONPATH"].split(":")
    assert handle.base_url == "http://127.0.0.1:5555" and handle.pid == 4242
