"""The port's SLO engine, goodput ledger, alert rules, request-trace tail,
monitor, exporter and their commands (copies under
``accelerate_tpu_torch/metrics/`` and ``diagnostics/``) against the JAX
package's on the same trails.

The trails are real: the port's ``serve --trace`` writes a telemetry JSONL
and a request trace on the CPU once per module; a scripted fleet trail
(per-replica rows, router totals, a scale decision) and compile rows are
added beside them. Every reader of both packages then reads the same
directory at the same instant, and the verdicts, burn rates, dominant
phases, goodput buckets, ``ALERTS.json``, ``trace tail`` output, the
monitor's panels and the exporter's OpenMetrics text must be equal. The
windowed engine is also driven on the scripted cases of the JAX package's
``tests/test_slo.py``, and the supervisor, fed by ``route``'s SLO policy
over a trail, must make JAX's scale decisions.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from accelerate_tpu.commands import accelerate_cli as jcli  # noqa: E402
from accelerate_tpu.diagnostics import monitor as jmon  # noqa: E402
from accelerate_tpu.diagnostics import reqtrace as jrt  # noqa: E402
from accelerate_tpu.diagnostics import tracing as jtr  # noqa: E402
from accelerate_tpu.metrics import alerts as jalerts  # noqa: E402
from accelerate_tpu.metrics import exporter as jexp  # noqa: E402
from accelerate_tpu.metrics import goodput as jgood  # noqa: E402
from accelerate_tpu.metrics import slo as jslo  # noqa: E402
from accelerate_tpu.serving import supervisor as jsup  # noqa: E402
from accelerate_tpu_torch.commands import accelerate_cli as tcli  # noqa: E402
from accelerate_tpu_torch.commands import route as troute  # noqa: E402
from accelerate_tpu_torch.diagnostics import monitor as tmon  # noqa: E402
from accelerate_tpu_torch.diagnostics import reqtrace as trt  # noqa: E402
from accelerate_tpu_torch.diagnostics import tracing as ttr  # noqa: E402
from accelerate_tpu_torch.metrics import alerts as talerts  # noqa: E402
from accelerate_tpu_torch.metrics import exporter as texp  # noqa: E402
from accelerate_tpu_torch.metrics import goodput as tgood  # noqa: E402
from accelerate_tpu_torch.metrics import slo as tslo  # noqa: E402
from accelerate_tpu_torch.serving import flight as tflight  # noqa: E402
from accelerate_tpu_torch.serving import supervisor as tsup  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000.0  # fixed instant for the scripted engine cases
E6 = 1e6


@pytest.fixture(autouse=True)
def _no_ambient_slo(monkeypatch):
    for key in list(os.environ):
        if key.startswith("ACCELERATE_SLO_"):
            monkeypatch.delenv(key)


def _write_fleet(logdir, rows):
    os.makedirs(os.path.join(logdir, "router"), exist_ok=True)
    with open(os.path.join(logdir, "router", "replicas.jsonl"), "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


@pytest.fixture(scope="module")
def trail(tmp_path_factory):
    """A logging dir the port's ``serve --trace`` wrote on the CPU, plus a
    scripted fleet trail and compile rows; returns ``(dir, now)``."""
    logdir = tmp_path_factory.mktemp("trail")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch", "serve", "--device", "cpu",
         "--preset", "tiny", "--max-seq-len", "128", "--trace", "bursty-diurnal:7:2:4",
         "--logging-dir", str(logdir)],
        input="", capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    now = time.time()
    with open(logdir / "telemetry" / "telemetry.jsonl", "a") as f:
        for i in range(3):
            f.write(json.dumps({"type": "compile", "label": "decode", "total_s": 1.5,
                                "ts": now - 30 + i, "schema": 1}) + "\n")
    _write_fleet(str(logdir), [
        {"schema": 1, "ts": now - 20, "kind": "router", "delivered": 0, "shed": 0,
         "deadline_expired": 0, "fleet_deadline_expired": 0, "queue_depth": 0,
         "replica_queue_depth": 0, "respawns": 0, "requeues": 0},
        {"schema": 1, "ts": now - 2, "replica_id": 0, "state": "ready", "queue_depth": 3,
         "active_slots": 2, "num_slots": 4, "in_flight": 2, "heartbeat_age_s": 0.1,
         "restarts": 1},
        {"schema": 1, "ts": now - 1, "replica_id": 1, "state": "dead", "queue_depth": 0,
         "active_slots": 0, "num_slots": 4, "in_flight": 0, "heartbeat_age_s": 9.0,
         "restarts": 2},
        {"schema": 1, "ts": now - 1, "kind": "scale_decision", "action": "scale_up",
         "reason": "slo_breach", "objective": "max_error_rate", "burn_rate": 12.5,
         "dominant_phase": "queued", "replicas": 2},
        {"schema": 1, "ts": now - 1, "kind": "router", "delivered": 15, "shed": 1,
         "deadline_expired": 0, "fleet_deadline_expired": 4, "queue_depth": 2,
         "replica_queue_depth": 3, "respawns": 2, "requeues": 3},
        {"schema": 1, "ts": now, "replica_id": 0, "state": "ready", "queue_depth": 1,
         "active_slots": 2, "num_slots": 4, "in_flight": 1, "heartbeat_age_s": 0.2,
         "restarts": 1},
    ])
    return str(logdir), now


ARMED = {
    "ACCELERATE_SLO_MAX_ERROR_RATE": "0.01",
    "ACCELERATE_SLO_MAX_ERROR_RATE_WINDOW_S": "60",
    "ACCELERATE_SLO_MAX_TTFT_P99_S": "0.001",
    "ACCELERATE_SLO_MAX_TTFT_P99_S_WINDOW_S": "600",
    "ACCELERATE_SLO_MIN_GOODPUT_PCT": "99",
    "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR": "10",
}


def _arm(monkeypatch, envs=ARMED):
    for k, v in envs.items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# the windowed engine on the scripted cases of tests/test_slo.py
# ---------------------------------------------------------------------------


def _case_error_rate(slo):
    e = slo.SloEngine()
    e.observe_outcomes(NOW - 120, ok=10, errors=10)
    first = e.evaluate(NOW)
    e.observe_outcomes(NOW - 5, ok=10, errors=10)
    return first, e.evaluate(NOW), e.report(NOW)


def _case_recompile_storm(slo):
    old, fresh = slo.SloEngine(), slo.SloEngine()
    old.observe_recompile(NOW - 190, n=50)
    fresh.observe_recompile(NOW - 5, n=50)
    return old.evaluate(NOW), fresh.evaluate(NOW)


def _case_goodput_101(slo):
    e = slo.SloEngine()
    e.observe_goodput(NOW - 1, 99.0)
    return e.evaluate(NOW), e.report(NOW)


def _case_ttft_burn(slo):
    e = slo.SloEngine()
    for _ in range(95):
        e.observe_request(NOW - 10, ttft_s=0.01)
    for _ in range(5):
        e.observe_request(NOW - 10, ttft_s=0.5)
    return e.report(NOW), e.evaluate(NOW)


def _case_abstention(slo):
    return slo.SloEngine().report(NOW)


def _case_dominant_phase(slo):
    e = slo.SloEngine()
    e.observe_outcomes(NOW - 5, ok=0, errors=10)
    e.observe_goodput(NOW - 5, 97.0)
    e.observe_phases(NOW - 5, {"queued": 80.0, "device_wait": 20.0})
    return e.evaluate(NOW)


def _case_overrides(slo):
    return slo.configured_objectives()


ENGINE_CASES = {
    "error_rate_both_windows": (_case_error_rate, {
        "ACCELERATE_SLO_MAX_ERROR_RATE": "0.01", "ACCELERATE_SLO_MAX_ERROR_RATE_WINDOW_S": "60"}),
    "recompile_storm_ages_out": (_case_recompile_storm, {
        "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR": "10",
        "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR_WINDOW_S": "60"}),
    "goodput_at_101": (_case_goodput_101, {"ACCELERATE_SLO_MIN_GOODPUT_PCT": "101"}),
    "ttft_p99_burn": (_case_ttft_burn, {
        "ACCELERATE_SLO_MAX_TTFT_P99_S": "0.1", "ACCELERATE_SLO_MAX_TTFT_P99_S_WINDOW_S": "60"}),
    "abstention": (_case_abstention, {"ACCELERATE_SLO_MAX_TTFT_P99_S": "0.1"}),
    "dominant_phase_worst_first": (_case_dominant_phase, {
        "ACCELERATE_SLO_MAX_ERROR_RATE": "0.1", "ACCELERATE_SLO_MAX_ERROR_RATE_WINDOW_S": "60",
        "ACCELERATE_SLO_MIN_GOODPUT_PCT": "99"}),
    "window_and_budget_overrides": (_case_overrides, {
        "ACCELERATE_SLO_MAX_TTFT_P99_S": "0.1", "ACCELERATE_SLO_MAX_TTFT_P99_S_WINDOW_S": "42",
        "ACCELERATE_SLO_MAX_TTFT_P99_S_BUDGET": "0.05"}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_windowed_engine_verdicts_match_jax(case, monkeypatch):
    fn, envs = ENGINE_CASES[case]
    _arm(monkeypatch, envs)
    assert fn(tslo) == fn(jslo)
    assert tslo.NON_SCALABLE_PHASES == jslo.NON_SCALABLE_PHASES
    assert tsup.NON_SCALABLE_PHASES is tslo.NON_SCALABLE_PHASES


@pytest.mark.parametrize("rows", [
    # engine-side expiries reach the totals row only as fleet_deadline_expired
    [{"ts": NOW - 20, "delivered": 0, "shed": 0, "deadline_expired": 0,
      "fleet_deadline_expired": 0, "queue_depth": 0, "replica_queue_depth": 0},
     {"ts": NOW - 5, "delivered": 15, "shed": 0, "deadline_expired": 0,
      "fleet_deadline_expired": 5, "queue_depth": 0, "replica_queue_depth": 3}],
    # a router restart resets the counters: a seam, not 40 errors
    [{"ts": NOW - 30, "delivered": 100, "shed": 0, "deadline_expired": 0,
      "fleet_deadline_expired": 40},
     {"ts": NOW - 10, "delivered": 5, "shed": 0, "deadline_expired": 0,
      "fleet_deadline_expired": 0}],
], ids=["fleet_expiry_counter", "counter_reset_seam"])
def test_evaluate_from_dir_on_router_totals_matches_jax(rows, tmp_path, monkeypatch):
    _arm(monkeypatch, {"ACCELERATE_SLO_MAX_ERROR_RATE": "0.01",
                       "ACCELERATE_SLO_MAX_ERROR_RATE_WINDOW_S": "60"})
    _write_fleet(str(tmp_path), [{"schema": 1, "kind": "router", **r} for r in rows])
    t = tslo.evaluate_from_dir(str(tmp_path), now=NOW)
    assert t == jslo.evaluate_from_dir(str(tmp_path), now=NOW)
    assert [f["dominant_phase"] for f in t["firing"]] in ([], ["queued"])


# ---------------------------------------------------------------------------
# the served trail, read by both packages
# ---------------------------------------------------------------------------


def test_slo_verdict_and_alerts_file_match_jax(trail, monkeypatch, tmp_path):
    logdir, now = trail
    _arm(monkeypatch)
    t = tslo.evaluate_from_dir(logdir, now=now)
    j = jslo.evaluate_from_dir(logdir, now=now)
    assert t == j
    rules = {f["rule"] for f in t["firing"]}
    assert {"max_error_rate", "max_ttft_p99_s"} <= rules
    assert all(f.get("dominant_phase") for f in t["firing"])
    payloads = []
    for mod, sub in ((tslo, "port"), (jslo, "jax")):
        d = tmp_path / sub
        d.mkdir()
        path = mod.write_slo_alerts(str(d), t["firing"], t["objectives"],
                                    snapshot=t["snapshot"])
        payload = json.loads(Path(path).read_text())
        payload.pop("ts")
        payloads.append(payload)
    assert payloads[0] == payloads[1]
    # the v1 threshold rules over a snapshot
    snap = {"goodput_pct": 85.0, "ttft_p99_s": 0.4, "recompiles_per_hour": 50.0}
    assert talerts.configured_rules() == jalerts.configured_rules()
    assert talerts.evaluate_alerts(snap) == jalerts.evaluate_alerts(snap)
    assert talerts.evaluate_alerts({"goodput_pct": None}) == []
    for mod, sub in ((talerts, "port1"), (jalerts, "jax1")):
        d = tmp_path / sub
        d.mkdir()
        mod.write_alerts(str(d), mod.evaluate_alerts(snap), snap)
    strip = [json.loads((tmp_path / s / "ALERTS.json").read_text()) for s in ("port1", "jax1")]
    for p in strip:
        p.pop("ts", None)
    assert strip[0] == strip[1]
    assert talerts.EXIT_SLO_VIOLATION == jalerts.EXIT_SLO_VIOLATION == 3


def _synthetic_events():
    return [
        {"ph": "X", "name": "step/dispatch", "ts": 0.0, "dur": 60 * E6},
        {"ph": "X", "name": "compile/compile", "ts": 10 * E6, "dur": 20 * E6},
        {"ph": "X", "name": "checkpoint/save", "ts": 70 * E6, "dur": 5 * E6},
        {"ph": "X", "name": "dataloader/fetch", "ts": 76 * E6, "dur": 3 * E6},
        {"ph": "i", "name": "watchdog/hang", "ts": 95 * E6, "args": {"elapsed_s": 5.0}},
        {"ph": "X", "name": "prepare", "ts": 99 * E6, "dur": 1 * E6},
    ]


def _epoch_events():
    return [
        {"ph": "M", "name": "clock_sync", "args": {"wall_minus_mono_s": 1.0}},
        {"ph": "X", "name": "step/dispatch", "ts": 1000 * E6, "dur": 600 * E6},
        {"ph": "X", "name": "prepare", "ts": 1600 * E6, "dur": 400 * E6},
        {"ph": "M", "name": "clock_sync", "args": {"wall_minus_mono_s": 2.0}},
        {"ph": "X", "name": "step/dispatch", "ts": 50 * E6, "dur": 100 * E6},
    ]


@pytest.mark.parametrize("events", [_synthetic_events, _epoch_events],
                         ids=["exclusive_buckets", "monotonic_epochs"])
def test_goodput_buckets_match_jax(events, trail):
    t = tgood.ledger_from_events(events(), host=0)
    assert t == jgood.ledger_from_events(events(), host=0)
    assert sum(t["buckets_s"].values()) == pytest.approx(t["elapsed_s"], rel=1e-9)
    logdir, _ = trail
    ledger = tgood.ledger_from_dir(logdir)
    assert ledger == jgood.ledger_from_dir(logdir) and ledger["hosts"] == 1
    assert tgood.BUCKETS == jgood.BUCKETS


def test_trace_tail_matches_jax(trail, capsys):
    """``trace tail`` (requests by TTFT and TPOT, iterations, ``--json``)
    over the served trail: the same report and the same text."""
    logdir, _ = trail
    t = trt.tail_report(logdir, k=5)
    assert t == jrt.tail_report(logdir, k=5) and t["total_requests"] == 14
    assert trt.render_tail_report(t) == jrt.render_tail_report(t)
    it = trt.iteration_report(logdir, k=3)
    assert it == jrt.iteration_report(logdir, k=3) and it["iterations"]
    assert trt.ITERATION_PHASES == tflight.ITERATION_PHASES
    for argv in (["trace", "tail", logdir, "-k", "4"],
                 ["trace", "tail", logdir, "--metric", "tpot", "--json"],
                 ["trace", "tail", logdir, "--iterations", "-k", "2"]):
        rc_t = tcli.main(argv)
        out_t = capsys.readouterr().out
        rc_j = jcli.main(argv)
        out_j = capsys.readouterr().out
        assert (rc_t, out_t) == (rc_j, out_j) and rc_t == 0


def test_trace_merge_matches_jax(trail, tmp_path):
    logdir, _ = trail
    paths = ttr.discover_trace_files(logdir)
    assert paths == jtr.discover_trace_files(logdir)
    t = ttr.merge_traces(paths=paths, output_path=str(tmp_path / "t.json"))
    j = jtr.merge_traces(paths=paths, output_path=str(tmp_path / "j.json"))
    jtr.validate_chrome_trace(t)
    assert t["traceEvents"] == j["traceEvents"]
    assert t["metadata"]["request_flows"] == j["metadata"]["request_flows"]


def test_monitor_panels_match_jax(trail, monkeypatch, tmp_path):
    """The status dict and the rendered panels (fleet, router totals,
    scale decisions, goodput, request tail, SLO) at one instant."""
    logdir, now = trail
    _arm(monkeypatch)
    verdict = tslo.evaluate_from_dir(logdir, now=now)
    tslo.write_slo_alerts(logdir, verdict["firing"], verdict["objectives"],
                          snapshot=verdict["snapshot"])
    t = tmon.collect_status(logdir, now=now)
    j = jmon.collect_status(logdir, now=now)
    assert t == j
    assert [r["replica_id"] for r in t["fleet"]] == [0, 1] and t["fleet_dead"] == [1]
    text = tmon.render_status(t)
    assert text == jmon.render_status(j)
    assert "DEAD" in text and "scale_up" in text
    # a scripted digest divergence between two hosts, read by the copied readers
    d = tmp_path / "diagnostics"
    d.mkdir()
    for host, digest in ((0, "aa"), (1, "bb"), (2, "aa")):
        (d / f"collectives_host_{host}.json").write_text(json.dumps(
            {"host": host, "digests": {"step": {"digest": digest, "collectives": 3}}}))
    assert tmon.collect_status(str(tmp_path), now=now)["collective_divergence"] == \
        jmon.collect_status(str(tmp_path), now=now)["collective_divergence"]
    assert tmon.HEARTBEAT_SUBDIR == "diagnostics"


def test_monitor_once_and_reports_match_jax(trail, monkeypatch, capsys, tmp_path):
    """``monitor --once`` exit codes (2 on a dead replica), ``slo report``
    and ``usage report`` over the served trail, both CLIs."""
    logdir, _ = trail
    _arm(monkeypatch)
    rc_t = tcli.main(["monitor", logdir, "--once"])
    out_t = capsys.readouterr().out
    rc_j = jcli.main(["monitor", logdir, "--once"])
    out_j = capsys.readouterr().out
    assert rc_t == rc_j == 2
    assert "SLO max_error_rate" in out_t and "SLO max_error_rate" in out_j
    # a healthy fleet with a firing objective: exit 3, and 0 once it resolves
    healthy = tmp_path / "healthy"
    (healthy / "traces").mkdir(parents=True)
    (healthy / "traces" / "host_0.trace.json").write_text(
        "[\n" + json.dumps({"name": "step/dispatch", "ph": "X", "ts": 0.0, "dur": 5 * E6,
                            "pid": 0, "tid": 1}) + ",\n"
        + json.dumps({"name": "prepare", "ph": "X", "ts": 5 * E6, "dur": 5 * E6,
                      "pid": 0, "tid": 1}) + ",\n")
    for pct, code in (("90", 3), ("10", 0)):
        monkeypatch.setenv("ACCELERATE_SLO_MIN_GOODPUT_PCT", pct)
        for var in ("ACCELERATE_SLO_MAX_ERROR_RATE", "ACCELERATE_SLO_MAX_TTFT_P99_S",
                    "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR"):
            monkeypatch.delenv(var, raising=False)
        # each run (re)writes ALERTS.json, which the next run's panel reads:
        # both start from the same directory
        (healthy / "ALERTS.json").unlink(missing_ok=True)
        assert tcli.main(["monitor", str(healthy), "--once"]) == code
        out_t = capsys.readouterr().out
        (healthy / "ALERTS.json").unlink()
        assert jcli.main(["monitor", str(healthy), "--once"]) == code
        out_j = capsys.readouterr().out
        assert out_t == out_j
    _arm(monkeypatch)
    for argv in (["slo", "report", logdir, "--json"], ["usage", "report", logdir, "--json"]):
        rc_t = tcli.main(argv)
        t = json.loads(capsys.readouterr().out)
        rc_j = jcli.main(argv)
        j = json.loads(capsys.readouterr().out)
        assert rc_t == rc_j
        for report in (t, j):
            report.pop("generated_at", None)
            report.pop("ts", None)
        assert t == j


def _without_exemplar_times(text):
    """An exemplar carries the wall time its sample was observed at (each
    exporter stamps its own); everything else must be equal."""
    return re.sub(r"( # \{[^}]*\} \S+) \S+$", r"\1", text, flags=re.M)


def test_exporter_openmetrics_text_matches_jax(trail, monkeypatch):
    """The sidecar exporter over the served trail (telemetry rows, the
    fleet trail's router rows, goodput, the windowed SLO gauges): one
    refresh at one instant renders the same OpenMetrics text, and a
    second refresh consumes only what was appended."""
    logdir, now = trail
    _arm(monkeypatch)
    t = texp.LoggingDirExporter(logdir)
    j = jexp.LoggingDirExporter(logdir)
    t.refresh(now=now)
    j.refresh(now=now)
    text = _without_exemplar_times(t.render())
    assert text == _without_exemplar_times(j.render())
    assert "serving_router_requeues_total" in text and "slo_burn_rate" in text
    t.refresh(now=now + 1)
    j.refresh(now=now + 1)
    assert _without_exemplar_times(t.render()) == _without_exemplar_times(j.render())
    server = texp.serve_exporter(t, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        import urllib.request

        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            assert "openmetrics-text" in resp.headers["Content-Type"]
            assert b"serving_router_requeues_total" in resp.read()
    finally:
        server.shutdown()
        thread.join(timeout=10)


# ---------------------------------------------------------------------------
# the supervisor fed by route's SLO policy
# ---------------------------------------------------------------------------


class _FakeProcess:
    def poll(self):
        return None


class _FakeHandle:
    def __init__(self, replica_id, state="ready"):
        self.replica_id = replica_id
        self.state = state
        self.in_flight = 0
        self.process = _FakeProcess()
        self.drained = False

    def drain(self):
        self.drained = True


class _FakeRouter:
    def __init__(self, n_ready=2):
        self._lock = threading.Lock()
        self._queue = []
        self._outstanding = 0
        self.replicas = [_FakeHandle(i) for i in range(n_ready)]
        self.decision_rows = []

    def write_decision_row(self, fields):
        self.decision_rows.append(dict(fields))


def _jax_route_slo_fn(logging_dir):
    """JAX ``route``'s inline policy (``commands/route.py:249-260``)."""
    cache = {"ts": 0.0, "verdict": None}

    def slo_fn():
        now = time.monotonic()
        if now - cache["ts"] >= 2.0:
            cache["ts"] = now
            cache["verdict"] = jslo.evaluate_from_dir(logging_dir)
        return cache["verdict"]

    return slo_fn


def _decide(sup_mod, slo_fn, ticks):
    router = _FakeRouter()
    spawned = []

    def spawn_fn(replica_id):
        handle = _FakeHandle(replica_id, state="starting")
        spawned.append(handle)
        return handle

    cfg = sup_mod.SupervisorConfig(min_replicas=1, max_replicas=3, scale_down_idle_ticks=1)
    sup = sup_mod.ReplicaSupervisor(spawn_fn, cfg, slo_fn=slo_fn)
    sup._router = router
    for _ in range(ticks):
        sup._autoscale()
    rows = [{k: v for k, v in r.items() if k != "ts"} for r in router.decision_rows]
    return rows, [h.replica_id for h in spawned], [h.drained for h in router.replicas]


@pytest.mark.parametrize("breach", [True, False], ids=["queued_breach", "budget_intact"])
def test_supervisor_with_route_slo_fn_matches_jax(breach, tmp_path, monkeypatch, capsys):
    """A fleet trail whose error-rate breach is attributed to queueing
    scales up with evidence; an intact budget on an idle fleet scales
    down. ``route``'s policy over the trail decides as JAX's does."""
    _arm(monkeypatch, {"ACCELERATE_SLO_MAX_ERROR_RATE": "0.01",
                       "ACCELERATE_SLO_MAX_ERROR_RATE_WINDOW_S": "60"})
    now = time.time()
    expired = 5 if breach else 0
    _write_fleet(str(tmp_path), [
        {"schema": 1, "kind": "router", "ts": now - 20, "delivered": 0, "shed": 0,
         "deadline_expired": 0, "fleet_deadline_expired": 0, "queue_depth": 0,
         "replica_queue_depth": 0},
        {"schema": 1, "kind": "router", "ts": now - 5, "delivered": 15, "shed": 0,
         "deadline_expired": 0, "fleet_deadline_expired": expired, "queue_depth": 0,
         "replica_queue_depth": 3 if breach else 0},
    ])
    t = _decide(tsup, troute.slo_policy_fn(str(tmp_path)), ticks=2)
    assert "SLO scaling policy armed (max_error_rate)" in capsys.readouterr().err
    j = _decide(jsup, _jax_route_slo_fn(str(tmp_path)), ticks=2)
    assert t == j
    rows = t[0]
    if breach:
        assert rows[0]["action"] == "scale_up" and rows[0]["dominant_phase"] == "queued"
    else:
        assert any(r["action"] == "scale_down" for r in rows) or any(t[2])
