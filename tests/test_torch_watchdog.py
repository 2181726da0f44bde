"""The port's hang watchdog held against the JAX package's: a step stalled
past a small floor fires ``HANG_REPORT_<host>.json`` with JAX's keys (the
stalled thread's stack, the open spans naming the stalled phase, the
telemetry tail), the heartbeat it writes is read by the port's ``monitor``
(``collect_status``) as JAX's is, a grace phase (a checkpoint save) defers
the deadline, a healthy loop never fires, ``preempt_on_hang`` raises the
preemption flag, and ``Accelerator(diagnostics=...)`` wires the watchdog to
the optimizer's steps."""

import json
import os
import time

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from accelerate_tpu.diagnostics.monitor import collect_status as jcollect_status  # noqa: E402
from accelerate_tpu.diagnostics.watchdog import Watchdog as JWatchdog  # noqa: E402
from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    AcceleratorState,
    DiagnosticsPlugin,
    GradientState,
)
from accelerate_tpu_torch.diagnostics import tracing as ttracing  # noqa: E402
from accelerate_tpu_torch.diagnostics.monitor import collect_status  # noqa: E402
from accelerate_tpu_torch.diagnostics.watchdog import Watchdog, get_active_watchdog  # noqa: E402
from accelerate_tpu_torch.resilience.preemption import PreemptionHandler  # noqa: E402
from accelerate_tpu_torch.telemetry import TelemetryRecorder  # noqa: E402


@pytest.fixture(autouse=True)
def _reset():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    wd = get_active_watchdog()
    if wd is not None:
        wd.stop()
    ttracing.set_active_tracer(None)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _wait_for(cond, seconds: float = 5.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


def test_a_stalled_step_fires_a_report_with_jax_keys_and_monitor_reads_it(tmp_path):
    tel = TelemetryRecorder(logging_dir=None)
    tel.record_event("marker", note="pre-hang")
    tracer = ttracing.Tracer(logging_dir=str(tmp_path), host=0)
    ttracing.set_active_tracer(tracer)
    wd = Watchdog(logging_dir=str(tmp_path), multiplier=3.0, floor_seconds=0.3,
                  check_interval_seconds=0.05, telemetry=tel, host=0).start()
    try:
        for _ in range(3):
            time.sleep(0.02)
            wd.step_completed()
        with tracer.span("collective/wedged_allreduce", op="all_reduce"):
            assert _wait_for(lambda: os.path.exists(wd.report_path)), "watchdog never fired"
        report = json.load(open(wd.report_path))
        assert report["stalled_phase"] == "collective/wedged_allreduce"
        frames = [f for frames in report["open_spans"].values() for f in frames]
        assert any(f["name"] == "collective/wedged_allreduce" for f in frames)
        stacks = "\n".join("\n".join(s) for s in report["threads"].values())
        assert "test_torch_watchdog" in stacks and "sleep" in stacks
        assert any(r.get("kind") == "marker" for r in report["telemetry_tail"])
        assert report["elapsed_s"] > report["deadline_s"] >= 0.3
        assert report["step"] == 3 and report["device_memory"] is None  # no card here
        # JAX's watchdog reports the same keys
        jwd = JWatchdog(logging_dir=None, host=0)
        assert set(report) == set(jwd.build_report(1.0, 0.5))
        # the heartbeat says fired, and both monitors name the host wedged
        hb = json.load(open(tmp_path / "diagnostics" / "heartbeat_0.json"))
        assert hb["fired"] is True and hb["step"] == 3
        status, jstatus = collect_status(str(tmp_path)), jcollect_status(str(tmp_path))
        assert status["wedged"] == jstatus["wedged"] == [0]
        assert status["hosts"][0]["step"] == jstatus["hosts"][0]["step"] == 3
        assert [r["stalled_phase"] for r in status["hang_reports"]] == [
            "collective/wedged_allreduce"]
    finally:
        wd.stop()
        tracer.close()
        tel.close()


def test_a_grace_phase_defers_the_deadline(tmp_path):
    wd = Watchdog(logging_dir=str(tmp_path), floor_seconds=0.2, check_interval_seconds=0.05,
                  host=0).start()
    try:
        # no tracer: the span still touches the watchdog (watchdog-only mode)
        with ttracing.trace_span("checkpoint/save"):
            time.sleep(0.8)  # ≫ floor, but grace_seconds (1800) governs
        assert not wd.fired and not os.path.exists(wd.report_path)
    finally:
        wd.stop()


def test_a_healthy_loop_never_fires(tmp_path):
    wd = Watchdog(logging_dir=str(tmp_path), multiplier=5.0, floor_seconds=0.4,
                  check_interval_seconds=0.05, host=0).start()
    try:
        t_end = time.time() + 1.2
        while time.time() < t_end:
            time.sleep(0.02)
            wd.step_completed()
        assert not wd.fired and not os.path.exists(wd.report_path)
        assert wd.ema_step_s is not None and wd.ema_step_s < 0.4
    finally:
        wd.stop()


def test_preempt_on_hang_raises_the_preemption_flag(tmp_path):
    handler = PreemptionHandler(handle_signals=False)
    handler.install()
    wd = Watchdog(logging_dir=str(tmp_path), floor_seconds=0.2, check_interval_seconds=0.05,
                  preempt_on_hang=True, host=0).start()
    try:
        assert _wait_for(lambda: handler.preemption_requested)
        assert handler.reason.startswith("watchdog-hang")
    finally:
        wd.stop()
        handler.uninstall()


def test_the_accelerator_wires_the_watchdog_to_its_steps(tmp_path):
    plugin = DiagnosticsPlugin(watchdog_floor_seconds=30.0, watchdog_check_seconds=0.05,
                               heartbeat_interval_seconds=0.0)
    acc = Accelerator(cpu=True, project_dir=str(tmp_path), diagnostics=plugin)
    assert get_active_watchdog() is acc.watchdog and ttracing.get_tracer() is acc.tracer
    module = torch.nn.Linear(4, 2)
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    for _ in range(3):
        with acc.accumulate(model):
            acc.backward(model(torch.ones(2, 4)).sum())
            opt.step()
            opt.zero_grad()
    assert acc.watchdog.step_count == 3
    hb = json.load(open(tmp_path / "diagnostics" / "heartbeat_0.json"))
    assert hb["step"] == 3 and hb["fired"] is False
    acc.end_training()
    assert get_active_watchdog() is None
    assert collect_status(str(tmp_path))["hosts"][0]["step"] == 3
    # the prepare span and the step spans reached the trace file
    names = {e.get("name") for e in ttracing.parse_trace_file(
        os.path.join(tmp_path, "traces", "host_0.trace.json"))}
    assert "prepare" in names
