"""The port's fault tolerance held against the JAX package's: the retry
wrapper, the plugins and their environment, the preemption handler (its
signals, sentinel and maintenance poller), the emergency save, the
deferral of that save to the accumulation window's end, and — across real
processes — SIGTERM, exit 143 and the sentinel, then a relaunch with
``ACCELERATE_AUTO_RESUME=true`` that skips a corrupt newest checkpoint and
continues the uninterrupted run's losses bit for bit.

The subprocess loop trains the port's tiny llama at f32 on the CPU; it
imports no JAX.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu.resilience import manifest as jmanifest  # noqa: E402
from accelerate_tpu.resilience.retry import run_with_retries as jretry  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu.test_utils import RegressionModel  # noqa: E402
from accelerate_tpu.utils import dataclasses as jdc  # noqa: E402
from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    AcceleratorState,
    DiagnosticsPlugin,
    FaultTolerancePlugin,
    GradientState,
    ProjectConfiguration,
)
from accelerate_tpu_torch.resilience import manifest as tmanifest  # noqa: E402
from accelerate_tpu_torch.resilience import preemption as tpreemption  # noqa: E402
from accelerate_tpu_torch.resilience.retry import run_with_retries  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    handler = tpreemption.get_active_handler()
    if handler is not None:
        handler.uninstall()
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


# -- retries -------------------------------------------------------------------


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retries_back_off_and_give_up_as_jax_does(fails):
    runs = {}
    for name, fn in (("port", run_with_retries), ("jax", jretry)):
        calls, sleeps = [0], []

        def flaky():
            calls[0] += 1
            if calls[0] <= fails:
                raise OSError("stale NFS handle")
            return "ok"

        try:
            result = fn(flaky, attempts=4, backoff=0.25, sleep=sleeps.append)
        except OSError as e:
            result = f"raised {e}"
        runs[name] = (result, calls[0], sleeps)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == ("raised stale NFS handle" if fails >= 4 else "ok")


def test_retries_do_not_catch_programming_errors():
    calls = [0]

    def buggy():
        calls[0] += 1
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        run_with_retries(buggy, attempts=5, backoff=0.0)
    assert calls[0] == 1


# -- the plugins ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["FaultTolerancePlugin", "DiagnosticsPlugin",
                                  "ProjectConfiguration"])
def test_plugins_have_jax_fields_and_read_the_same_environment(monkeypatch, name):
    env = {"ACCELERATE_FT_SHARDED_IO": "false", "ACCELERATE_FT_IO_ATTEMPTS": "7",
           "ACCELERATE_FT_CONSENSUS_INTERVAL": "16", "ACCELERATE_AUTO_RESUME": "0",
           "ACCELERATE_FT_IO_BACKOFF": "0.25", "ACCELERATE_WATCHDOG": "0",
           "ACCELERATE_WATCHDOG_FLOOR_SECONDS": "3", "ACCELERATE_WATCHDOG_MULTIPLIER": "0.5",
           "ACCELERATE_WATCHDOG_PREEMPT": "1"}
    port_cls = {"FaultTolerancePlugin": FaultTolerancePlugin,
                "DiagnosticsPlugin": DiagnosticsPlugin,
                "ProjectConfiguration": ProjectConfiguration}[name]
    jax_cls = getattr(jdc, name)
    assert ([(f.name, f.default) for f in dataclasses.fields(port_cls)]
            == [(f.name, f.default) for f in dataclasses.fields(jax_cls)])
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    kwargs = {"project_dir": "/x"} if name == "ProjectConfiguration" else {}
    assert dataclasses.asdict(port_cls(**kwargs)) == dataclasses.asdict(jax_cls(**kwargs))
    if name == "FaultTolerancePlugin":
        monkeypatch.delenv("ACCELERATE_FT_IO_ATTEMPTS")
        plugin = port_cls(io_attempts=9)
        plugin.export_io_env()
        assert os.environ["ACCELERATE_FT_IO_ATTEMPTS"] == "9"


# -- the handler ---------------------------------------------------------------


def test_preemption_handler_flag_sentinel_and_uninstall(tmp_path):
    previous = signal.getsignal(signal.SIGTERM)
    handler = tpreemption.PreemptionHandler(handle_sigint=False)
    try:
        assert handler.install()
        assert tpreemption.get_active_handler() is handler
        assert not handler.preemption_requested and not handler.consensus()
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.preemption_requested and handler.reason == "SIGTERM"
        assert handler.consensus()  # no process group: the local flag
        sentinel = handler.write_sentinel(str(tmp_path), "/ck/checkpoint_3", step=7)
        payload = json.loads(open(sentinel).read())
        assert payload["reason"] == "SIGTERM" and payload["step"] == 7
        assert os.path.basename(sentinel) == jmanifest.SENTINEL_NAME
    finally:
        handler.uninstall()
    assert tpreemption.get_active_handler() is None
    assert signal.getsignal(signal.SIGTERM) == previous


def test_maintenance_poller_raises_the_flag():
    """The poller's read of the metadata endpoint is replaced by one that
    answers a maintenance event, so nothing leaves the host."""
    import time

    handler = tpreemption.PreemptionHandler(monitor_maintenance=True, poll_seconds=0.01,
                                            handle_signals=False)
    answers = iter(["NONE", "TERMINATE_ON_HOST_MAINTENANCE"])
    handler._read_maintenance_event = lambda: next(answers, "NONE")
    handler.install()
    try:
        for _ in range(500):
            if handler.preemption_requested:
                break
            time.sleep(0.01)
        assert handler.reason == "maintenance-event:TERMINATE_ON_HOST_MAINTENANCE"
    finally:
        handler.uninstall()
    assert tpreemption.GCE_MAINTENANCE_URL.startswith("http://metadata.google.internal/")


# -- the emergency save and its deferral -----------------------------------------


class _Regression(torch.nn.Module):
    """``y = a·x + b`` with the JAX package's ``RegressionModel`` loss."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(1.0))
        self.b = torch.nn.Parameter(torch.tensor(2.0))

    def forward(self, x, y):
        from accelerate_tpu_torch.modules import ModelOutput

        pred = self.a * x + self.b
        return ModelOutput(loss=((pred - y) ** 2).mean())


def _exit_index(make_step, raise_flag, n: int = 8, flag_at: int = 1):
    """The micro-batch whose ``backward`` exits, with the flag raised after
    micro-batch ``flag_at``."""
    for i in range(n):
        if i == flag_at + 1:
            raise_flag()
        try:
            make_step()
        except SystemExit as e:
            return i, e.code
    return None, None


@pytest.mark.parametrize("accumulation", [1, 2, 4])
def test_emergency_save_defers_to_the_window_end_as_jax_does(tmp_path, accumulation):
    x = np.arange(16, dtype=np.float32)
    y = 2 * x + 3
    # JAX
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    jacc = JAccelerator(gradient_accumulation_steps=accumulation,
                        project_config=jdc.ProjectConfiguration(
                            project_dir=str(tmp_path / "jax"), automatic_checkpoint_naming=True),
                        fault_tolerance=jdc.FaultTolerancePlugin(handle_signals=False))
    jmodel, jopt = jacc.prepare(RegressionModel(a=1.0, b=2.0), optax.sgd(0.01))

    def jstep():
        with jacc.accumulate(jmodel):
            jacc.backward(jmodel(x=x, y=y).loss)
            jopt.step()
            jopt.zero_grad()

    try:
        jexit = _exit_index(jstep, lambda: jacc._preemption_handler.request_preemption("test"))
    finally:
        jacc._preemption_handler.uninstall()
        JAccState._reset_state(reset_partial_state=True)
        JGradState._reset_state()
    # the port
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accumulation,
                      project_config=ProjectConfiguration(
                          project_dir=str(tmp_path / "port"), automatic_checkpoint_naming=True),
                      fault_tolerance=FaultTolerancePlugin(handle_signals=False))
    module = _Regression()
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.01))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def step():
        with acc.accumulate(model):
            acc.backward(model(x=tx, y=ty).loss)
            opt.step()
            opt.zero_grad()

    exit_at = _exit_index(step, lambda: acc._preemption_handler.request_preemption("test"))
    assert exit_at == jexit and exit_at[1] == 143
    for root in ("jax", "port"):
        ckdir = tmp_path / root / "checkpoints"
        names = sorted(os.listdir(ckdir))
        assert names == ["PREEMPTED.json", "checkpoint_0"], names
        sentinel = json.loads((ckdir / "PREEMPTED.json").read_text())
        assert sentinel["reason"] == "test"
        assert tmanifest.validate_checkpoint(str(ckdir / "checkpoint_0")) == (True, "ok")
        assert jmanifest.validate_checkpoint(str(ckdir / "checkpoint_0")) == (True, "ok")
    assert tpreemption.get_active_handler() is None


def test_emergency_save_records_the_preemption_row(tmp_path):
    from accelerate_tpu_torch.telemetry import TelemetryRecorder, set_active_recorder

    recorder = TelemetryRecorder(logging_dir=str(tmp_path))
    set_active_recorder(recorder)
    try:
        acc = Accelerator(cpu=True, project_dir=str(tmp_path),
                          fault_tolerance=FaultTolerancePlugin(exit_code=7,
                                                               handle_signals=False))
        module = _Regression()
        model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.01))
        acc._preemption_handler.request_preemption("manual")
        with pytest.raises(SystemExit) as exc:
            acc.backward(model(x=torch.ones(4), y=torch.ones(4)).loss)
        assert exc.value.code == 7
    finally:
        recorder.close()
    rows = [json.loads(line) for line in open(tmp_path / "telemetry" / "telemetry.jsonl")]
    assert [r["type"] for r in rows] == ["checkpoint", "event"]
    assert rows[1]["kind"] == "preemption" and rows[1]["reason"] == "manual"
    assert rows[1]["checkpoint"] == os.path.join(str(tmp_path), "checkpoints")


# -- across processes: SIGTERM, then auto-resume ---------------------------------

_LOOP = textwrap.dedent(
    """
    import json, os, signal, sys
    import numpy as np, torch
    from accelerate_tpu_torch import Accelerator, ProjectConfiguration, set_seed
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    mode, project_dir, out_path = sys.argv[1:4]
    torch.set_num_threads(1)
    set_seed(0)
    ids = np.random.default_rng(5).integers(0, 256, size=(32, 16)).astype(np.int64)

    class Rows(torch.utils.data.Dataset):
        def __len__(self):
            return len(ids)

        def __getitem__(self, i):
            row = torch.from_numpy(ids[i])
            return {"input_ids": row, "labels": row.clone()}

    acc = Accelerator(cpu=True, fault_tolerance=mode != "straight",
                      project_config=ProjectConfiguration(
                          project_dir=project_dir, automatic_checkpoint_naming=True,
                          total_limit=2))
    module = LlamaForCausalLM.from_config(LlamaConfig.tiny(), seed=0, device="cpu")
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.9 ** s)
    model, opt, dl, sched = acc.prepare(
        module, opt, torch.utils.data.DataLoader(Rows(), batch_size=4), sched)
    report = {"resumed_at": dl.position, "losses": []}
    for i, batch in enumerate(dl):
        if mode == "train" and i == 5:
            os.kill(os.getpid(), signal.SIGTERM)  # the notice; backward acts on it
        with acc.accumulate(model):
            out = model(**batch)
            acc.backward(out.loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        report["losses"].append(float(out.loss.detach()))
        with open(out_path, "w") as f:
            json.dump(report, f)
        if mode == "train" and i == 1:
            acc.save_state()                  # checkpoint_0, sync
        if mode == "train" and i == 3:
            acc.save_state(async_save=True)   # checkpoint_1, written while training goes on
    acc.end_training()
    print("FINISHED", flush=True)
    """
)


def _run_loop(tmp_path, mode: str, env_extra=None):
    script = tmp_path / "loop.py"
    script.write_text(_LOOP)
    out = tmp_path / f"{mode}.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("ACCELERATE_AUTO_RESUME", None)
    env.update(env_extra or {})
    proc = subprocess.run([sys.executable, str(script), mode, str(tmp_path / "proj"), str(out)],
                          env=env, capture_output=True, text=True, timeout=300)
    return proc, json.loads(out.read_text())


def test_sigterm_emergency_save_then_auto_resume_skips_a_corrupt_newest(tmp_path):
    straight, ref = _run_loop(tmp_path, "straight")
    assert straight.returncode == 0 and "FINISHED" in straight.stdout, straight.stderr[-2000:]
    assert len(ref["losses"]) == 8
    proc, trained = _run_loop(tmp_path, "train")
    assert proc.returncode == 143, proc.stderr[-3000:]
    assert "FINISHED" not in proc.stdout
    # five steps ran; the sixth batch's backward took the emergency save
    assert trained["losses"] == ref["losses"][:5]
    ckdir = tmp_path / "proj" / "checkpoints"
    names = sorted(os.listdir(ckdir))
    # total_limit 2: the async checkpoint_1 and the emergency checkpoint_2
    assert names == ["PREEMPTED.json", "checkpoint_1", "checkpoint_2"], names
    sentinel = json.loads((ckdir / "PREEMPTED.json").read_text())
    assert sentinel["reason"] == "SIGTERM" and sentinel["checkpoint"].endswith("checkpoint_2")
    for ck in ("checkpoint_1", "checkpoint_2"):
        assert tmanifest.validate_checkpoint(str(ckdir / ck)) == (True, "ok")
        assert jmanifest.validate_checkpoint(str(ckdir / ck)) == (True, "ok")
    # corrupt the newest: auto-resume must fall back to the async checkpoint
    model_file = ckdir / "checkpoint_2" / "shard_00000" / "model.safetensors"
    data = bytearray(model_file.read_bytes())
    data[-4:] = b"\xff\xff\xff\xff"
    model_file.write_bytes(bytes(data))
    proc, resumed = _run_loop(tmp_path, "resume", {"ACCELERATE_AUTO_RESUME": "true"})
    assert proc.returncode == 0 and "FINISHED" in proc.stdout, proc.stderr[-3000:]
    assert "skipping invalid checkpoint" in proc.stderr
    assert resumed["resumed_at"] == 4
    assert resumed["losses"] == ref["losses"][4:]
    assert not (ckdir / "PREEMPTED.json").exists()  # consumed by the resume
