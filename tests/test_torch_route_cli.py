"""``python -m accelerate_tpu_torch route`` end to end on the CPU: real route
processes over two ``serve --http --device cpu --preset tiny`` replicas
(the JAX tests' tiny shape, ``tests/test_router.py:429``).

What a fleet must do, as ``tests/test_router.py`` and ``tests/test_chaos.py``
hold the JAX one to it: routed greedy answers equal one ``serve`` process's
answers on the same seed; a kill -9 mid-stream leaves every request answered
exactly once; a SIGTERM drains and exits 0; ``r0:kill@5`` under
``--respawn`` respawns exactly once; a SIGSTOP wedge is rescued and leaves
no orphan; a malformed ``--chaos-spec`` refuses with exit 2; ``--mesh`` and
an armed SLO objective refuse as not yet ported. Every test carries its own
deadline (``_DEADLINE_S``) and kills what it started when it passes.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent

_TINY_ARGS = [
    "--device", "cpu", "--preset", "tiny", "--num-slots", "2", "--block-size", "8",
    "--max-seq-len", "64", "--prefill-chunk", "8", "--decode-burst", "2",
]
#: seconds each test may take, start to finish
_DEADLINE_S = 120


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_SLO_")}
    env["PYTHONPATH"] = str(REPO)
    env.pop("ACCELERATE_CHAOS_SPEC", None)
    return env


def _cli(*args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch", *args],
        cwd=REPO, env=env or _env(), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
    )


def _route(logdir, *extra, replicas=2):
    return _cli("route", "--replicas", str(replicas), "--logging-dir", str(logdir),
                "--health-interval", "0.2", *extra, *_TINY_ARGS)


class _Run:
    """A started process, its stdout lines collected by a thread, and the
    test's deadline; ``close`` kills it if it is still running."""

    def __init__(self, proc):
        self.proc, self.lines = proc, []
        self.deadline = time.monotonic() + _DEADLINE_S
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            if line.strip():
                self.lines.append(line.strip())

    def send(self, *payloads):
        for p in payloads:
            self.proc.stdin.write(json.dumps(p) + "\n")
        self.proc.stdin.flush()

    def left(self):
        return max(1.0, self.deadline - time.monotonic())

    def results(self, n):
        while len(self.lines) < n and time.monotonic() < self.deadline:
            if self.proc.poll() is not None and len(self.lines) < n:
                time.sleep(0.2)
                break
            time.sleep(0.05)
        return [json.loads(line) for line in self.lines]

    def finish(self):
        self.proc.stdin.close()
        return self.proc.wait(timeout=self.left())

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def _req(i, session=None, n_new=4):
    payload = {"id": i, "prompt": [1 + (i % 5), 7, 3], "max_new_tokens": n_new}
    if session is not None:
        payload["session_id"] = session
    return payload


def _trail(logdir):
    path = Path(logdir) / "router" / "replicas.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _pids(rows):
    return {r["pid"] for r in rows if r.get("pid") and r.get("replica_id") is not None}


def _assert_all_dead(pids, timeout=10.0):
    """Every pid gone (a just-reaped child may linger an instant as a
    zombie, which ``os.kill(pid, 0)`` still finds)."""
    def alive():
        out = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                out.append(pid)
            except OSError:
                continue
        return out

    deadline = time.monotonic() + timeout
    while alive() and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not alive(), f"orphaned process(es) survived the run: {alive()}"


def _ids(rows):
    return sorted(r.get("id") for r in rows)


def test_routed_answers_equal_one_serve_process_and_survive_kill9(tmp_path):
    """Greedy answers through two routed replicas equal one ``serve``
    process's on the same seed (the replicas are interchangeable; the two
    commands run side by side). Then a kill -9 of replica 0 with a second
    wave in flight: every request is still answered exactly once."""
    reqs = [_req(i, n_new=6) for i in range(6)]
    serve = _Run(_cli("serve", *_TINY_ARGS))
    route = _Run(_route(tmp_path))
    try:
        serve.send(*reqs)
        route.send(*reqs)
        ref = {r["id"]: r["tokens"] for r in serve.results(6)}
        assert serve.finish() == 0
        first = route.results(6)
        assert {r["id"]: r.get("tokens") for r in first} == ref
        served_by = {r["replica_id"]: r["completed"] for r in _trail(tmp_path)
                     if r.get("replica_id") is not None}
        pids = {r["replica_id"]: r["pid"] for r in _trail(tmp_path) if r.get("pid")}
        assert len(pids) == 2 and len(served_by) == 2
        route.send(*[_req(i, session=f"chat-{i % 2}", n_new=8) for i in range(6, 14)])
        os.kill(pids[0], signal.SIGKILL)
        parsed = route.results(14)
        assert route.finish() == 0
    finally:
        serve.close()
        route.close()
    assert _ids(parsed) == list(range(14)), f"lost/duplicated: {_ids(parsed)}"
    assert not [r for r in parsed if "error" in r], "requests lost to the kill"
    rows = _trail(tmp_path)
    assert any(r["state"] == "dead" for r in rows)
    _assert_all_dead(_pids(rows))


def test_chaos_kill_respawns_exactly_once_then_sigterm_drains(tmp_path):
    """``r0:kill@5`` with ``--respawn``: every request answered once, one
    respawn of replica 0 (the trail's restart count and the supervisor's
    total), the fleet back to two ready. Then a SIGTERM with requests in
    flight: all answered, exit 0, no orphan. Session ``chat-0`` pins ids 0,
    2, 4, 6, 8 and 10 to replica 0, so its 5th (id 8) kills it; its
    respawned incarnation re-arms ``kill@5`` and sees far fewer."""
    run = _Run(_route(tmp_path, "--respawn", "--min-replicas", "2",
                      "--chaos-spec", "seed=1;r0:kill@5;r1:delay@2:0.05..0.2"))
    try:
        run.send(*[_req(i, session=f"chat-{i % 2}") for i in range(4)])
        assert len(run.results(4)) == 4, f"fleet never answered warmup; rc={run.proc.poll()}"
        run.send(*[_req(i, session=f"chat-{i % 2}", n_new=8) for i in range(4, 12)])
        assert len(run.results(12)) == 12

        def recovered():
            latest = {}
            for r in _trail(tmp_path):
                if r.get("replica_id") is not None:
                    latest[r["replica_id"]] = r
            return (len(latest) == 2 and all(r["state"] == "ready" for r in latest.values())
                    and latest[0].get("restarts") == 1)

        while not recovered() and time.monotonic() < run.deadline:
            time.sleep(0.2)
        assert recovered(), "fleet never recovered to 2 ready replicas"
        # two: least-loaded gives the respawned replica 0 at most two
        run.send(*[_req(i, n_new=8) for i in range(12, 14)])
        time.sleep(0.3)  # let the pipe land in the router before the signal
        run.proc.send_signal(signal.SIGTERM)
        rc = run.proc.wait(timeout=run.left())
    finally:
        run.close()
    assert rc == 0
    parsed = [json.loads(line) for line in run.lines]
    assert _ids(parsed) == list(range(14)), f"lost/duplicated: {_ids(parsed)}"
    assert not [r for r in parsed[:12] if "error" in r]
    assert [r for r in parsed[12:] if "tokens" in r], "drain answered nothing with a completion"
    rows = _trail(tmp_path)
    assert any(r.get("state") == "dead" for r in rows)
    respawns = [r["respawns"] for r in rows if r.get("kind") == "router"]
    assert respawns[-1] == 1, f"respawned {respawns[-1]} times, not once"
    assert max(r.get("restarts", 0) for r in rows if r.get("replica_id") is not None) == 1
    assert rows[-1]["state"] == "terminated"
    _assert_all_dead(_pids(rows))


def test_sigstop_wedge_rescued_and_not_orphaned(tmp_path):
    run = _Run(_route(tmp_path, "--respawn", "--min-replicas", "2",
                      "--health-interval", "0.1", "--chaos-spec", "r0:stop@2"))
    try:
        run.send(*[_req(i, session=f"chat-{i % 2}") for i in range(2)])
        assert len(run.results(2)) == 2
        wedged = _pids(_trail(tmp_path))
        run.send(*[_req(i, session="chat-0", n_new=8) for i in range(2, 6)])
        assert len(run.results(6)) == 6, f"wedged request never rescued; rc={run.proc.poll()}"
        assert run.finish() == 0
    finally:
        run.close()
    parsed = [json.loads(line) for line in run.lines]
    assert _ids(parsed) == list(range(6)) and not [r for r in parsed if "error" in r]
    rows = _trail(tmp_path)
    assert any(r.get("state") == "dead" for r in rows)
    _assert_all_dead(wedged | _pids(rows))


def _refusal(capsys, *argv):
    """Run a command in this process (a refusal happens before any engine
    or replica exists); returns (exit code, the error row)."""
    from accelerate_tpu_torch.commands.accelerate_cli import main
    from accelerate_tpu_torch.metrics.registry import set_active_registry

    try:
        rc = main(list(argv))
    finally:
        set_active_registry(None)  # serve installs a process-wide registry first
    out = capsys.readouterr().out.splitlines()
    return rc, json.loads(out[-1])["error"]


@pytest.mark.parametrize("command", ["route", "serve"])
def test_malformed_chaos_spec_exits_2(tmp_path, command, capsys):
    extra = ["--logging-dir", str(tmp_path)] if command == "route" else ["--http", "0"]
    rc, error = _refusal(capsys, command, "--chaos-spec", "explode@oops", *extra, *_TINY_ARGS)
    assert rc == 2 and "unknown chaos fault" in error
    assert not (tmp_path / "router").exists()  # refused before any replica spawned


@pytest.mark.parametrize("command", ["route", "serve"])
def test_mesh_is_not_yet_ported(command, capsys):
    rc, error = _refusal(capsys, command, "--mesh", *_TINY_ARGS)
    assert rc == 2 and "not yet ported" in error and "ROADMAP item 18" in error


def test_armed_slo_objective_is_not_yet_ported(tmp_path, capsys, monkeypatch):
    """An armed ``ACCELERATE_SLO_*`` objective with ``--logging-dir`` under
    supervision refuses (the JAX route would wire SLO-driven scaling); it
    never scales as if no objective were set."""
    monkeypatch.setenv("ACCELERATE_SLO_MAX_TTFT_P99_S", "0.5")
    rc, error = _refusal(capsys, "route", "--respawn", "--logging-dir", str(tmp_path),
                         *_TINY_ARGS)
    assert rc == 2 and "not yet ported" in error and "ROADMAP item 20" in error
    assert "ACCELERATE_SLO_MAX_TTFT_P99_S" in error
    assert not (tmp_path / "router").exists()
