"""The port's ``save_state`` / ``load_state`` held against the JAX package's.

Both loops start from the same JAX-initialised tiny llama (carried across by
``params_from_jax``) and read the same numpy batches through a prepared
``DataLoader``, with AdamW (optax's defaults spelled out for torch) and a
scheduler (an optax schedule ``1e-3 · 0.9^step`` against ``LambdaLR`` over
``0.9^step``). Each trains 3 optimizer steps, saves, and trains 3 more; a
fresh ``Accelerator`` then loads the checkpoint and trains the same 3
steps. The loader's position comes back from the checkpoint, with no
``skip_first_batches``.

Tolerances: the port's resumed losses equal its uninterrupted ones bit for
bit; against JAX's resumed losses, f32 1e-4 relative, bf16 2e-2, and fp16
1e-3 with the skipped steps and the scales equal (as in
``test_torch_precision.py``). The directory layout is compared by name
(the files hold the port's parameter names), and each package's manifest
validator is run on the other's checkpoints.

The sharded tests run 2 gloo ranks (``debug_launcher``, their functions in
``tests/torch_ckpt_workers.py``, which imports no JAX).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import torch_ckpt_workers as workers  # noqa: E402
from torch.utils.data import DataLoader  # noqa: E402

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu import ProjectConfiguration as JProjectConfiguration  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.resilience import manifest as jmanifest  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu.utils import dataclasses as jdc  # noqa: E402
from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    AcceleratorState,
    GradientState,
    GradScalerKwargs,
    ProjectConfiguration,
    debug_launcher,
)
from accelerate_tpu_torch import checkpointing as tckpt  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.resilience import manifest as tmanifest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ, STEPS = 4, 16, workers.STEPS  # 3 optimizer steps before the save, 3 after

#: the resume cases: precision, accumulation, the JAX tolerance, handlers
CASES = {
    "f32": dict(mixed_precision="no", accumulation=1, tol=1e-4),
    "bf16": dict(mixed_precision="bf16", accumulation=1, tol=2e-2),
    # 2^20 backs off to 2^17 over the first steps (skips), then grows every 2
    "fp16": dict(mixed_precision="fp16", accumulation=1, tol=1e-3,
                 scaler=dict(init_scale=2.0 ** 20, growth_interval=2)),
    "accumulation_2": dict(mixed_precision="no", accumulation=2, tol=1e-4),
}

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _configs():
    jcfg = jllama.LlamaConfig.tiny()
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    return jcfg, tcfg


def _init_params():
    jcfg, _ = _configs()
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jllama.init_llama_params(jax.random.PRNGKey(0), jcfg))


def _ids(accumulation: int) -> np.ndarray:
    rows = 2 * STEPS * accumulation * BATCH
    return np.random.default_rng(7).integers(0, 256, size=(rows, SEQ)).astype(np.int32)


# -- the JAX loop --------------------------------------------------------------


def _jax_run(case: dict, project_dir: str, save: bool, resume: bool) -> list[tuple]:
    """JAX's loop: ``(loss, skipped, scale)`` a micro-batch. ``save``: train
    all of it, saving after STEPS optimizer steps; ``resume``: load that save
    and train the rest."""
    jcfg, _ = _configs()
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    handlers = [jdc.GradScalerKwargs(**case["scaler"])] if "scaler" in case else []
    acc = JAccelerator(mixed_precision=case["mixed_precision"], kwargs_handlers=handlers,
                       gradient_accumulation_steps=case["accumulation"],
                       project_config=JProjectConfiguration(project_dir=project_dir))
    model = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    opt = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-3)
    model, opt, dl, sched = acc.prepare(
        model, opt, DataLoader(workers.Rows(_ids(case["accumulation"])), batch_size=BATCH),
        lambda step: 1e-3 * 0.9 ** step)
    rows = _loop(acc, model, opt, dl, sched, case, project_dir, save, resume,
                 lambda loss: loss.item())
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    return rows


# -- the port's loop -----------------------------------------------------------


def _port_run(case: dict, project_dir: str, save: bool, resume: bool, init=None,
              **accelerator_kwargs) -> list[tuple]:
    _, tcfg = _configs()
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    handlers = [GradScalerKwargs(**case["scaler"])] if "scaler" in case else []
    acc = Accelerator(cpu=True, mixed_precision=case["mixed_precision"],
                      kwargs_handlers=handlers, gradient_accumulation_steps=case["accumulation"],
                      project_config=ProjectConfiguration(project_dir=project_dir),
                      **accelerator_kwargs)
    module = tllama.LlamaForCausalLM(tcfg, device="cpu")
    module.load_state_dict(tllama.params_from_jax(_init_params() if init is None else init,
                                                  tcfg))
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.9 ** step)
    model, opt, dl, sched = acc.prepare(
        module, opt, DataLoader(workers.Rows(_ids(case["accumulation"])), batch_size=BATCH),
        sched)
    return _loop(acc, model, opt, dl, sched, case, project_dir, save, resume,
                 lambda loss: float(loss.detach()))


def _loop(acc, model, opt, dl, sched, case, project_dir, save, resume, value):
    path = os.path.join(project_dir, "mid")
    if resume:
        acc.load_state(path)
    micro = STEPS * case["accumulation"]
    rows = []
    for batch in dl:
        with acc.accumulate(model):
            out = model(**batch)
            acc.backward(out.loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        scaler = acc.scaler
        rows.append((value(out.loss), opt.step_was_skipped,
                     scaler.get_scale() if scaler is not None else None))
        if save and len(rows) == micro:
            acc.save_state(path)
        if resume and len(rows) == micro:
            break
    return rows


def _resume_runs(name: str, tmp_path) -> dict:
    case = CASES[name]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    return {
        "jax_straight": _jax_run(case, jdir, save=True, resume=False),
        "jax_resumed": _jax_run(case, jdir, save=False, resume=True),
        "port_straight": _port_run(case, tdir, save=True, resume=False),
        "port_resumed": _port_run(case, tdir, save=False, resume=True),
    }


@pytest.mark.parametrize("name", list(CASES))
def test_resumed_losses_equal_the_uninterrupted_run_and_match_jax(tmp_path, name):
    case = CASES[name]
    runs = _resume_runs(name, tmp_path)
    micro = STEPS * case["accumulation"]
    straight, resumed = runs["port_straight"], runs["port_resumed"]
    assert len(straight) == 2 * micro and len(resumed) == micro
    # bit for bit: every loss, skip and scale after the resume
    assert resumed == straight[micro:]
    jresumed = runs["jax_resumed"]
    assert len(jresumed) == micro
    for got, ref in zip(resumed, jresumed):
        assert abs(got[0] - ref[0]) <= case["tol"] * abs(ref[0]), (resumed, jresumed)
    # JAX's own resume is faithful too (the comparison is of like with like)
    for got, ref in zip(jresumed, runs["jax_straight"][micro:]):
        assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0])
    if "scaler" in case:
        assert [r[1:] for r in straight] == [r[1:] for r in runs["jax_straight"]]
        assert [r[1:] for r in resumed] == [r[1:] for r in jresumed]
        skipped = [r[1] for r in straight]
        assert any(skipped[:micro]) and not all(skipped), skipped


# -- the directory layout ------------------------------------------------------


def _names(root: str) -> set[str]:
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            out.add(os.path.relpath(os.path.join(dirpath, name), root).replace(os.sep, "/"))
    return out


def _layout_saves(acc, model, opt, sched, dl, sharded: bool) -> list:
    """Three automatic saves (total_limit 2), a load of the newest, one more
    save: the iteration counter and the rotation both show in the names."""
    steps = []
    for _ in range(3):
        acc.save_state(sharded=sharded)
        steps.append(sorted(_names(os.path.join(acc.project_dir, "checkpoints"))))
    acc.load_state()
    acc.save_state(sharded=sharded)
    acc.save_state(os.path.join(acc.project_dir, "explicit"), sharded=sharded)
    steps.append(acc.save_iteration)
    return steps


@pytest.mark.parametrize("sharded", [False, True], ids=["gathered", "sharded"])
def test_checkpoint_directory_names_equal_jax(tmp_path, sharded):
    jcfg, tcfg = _configs()
    config = dict(automatic_checkpoint_naming=True, total_limit=2)
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jacc = JAccelerator(project_config=JProjectConfiguration(project_dir=jdir, **config))
    jobjs = jacc.prepare(jllama.LlamaForCausalLM.from_config(jcfg, seed=0),
                         optax.inject_hyperparams(optax.adamw)(learning_rate=1e-3),
                         lambda step: 1e-3,
                         DataLoader(workers.Rows(_ids(1)), batch_size=BATCH))
    jsteps = _layout_saves(jacc, *jobjs, sharded=sharded)
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(project_dir=tdir, **config))
    module = tllama.LlamaForCausalLM.from_config(tcfg, seed=0, device="cpu")
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3)
    model, opt, sched, dl = acc.prepare(module, opt,
                                        torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0),
                                        DataLoader(workers.Rows(_ids(1)), batch_size=BATCH))
    # one step, so the optimizer has its moments (optax's exist at init)
    acc.backward(model(**next(iter(dl))).loss)
    opt.step()
    opt.zero_grad()
    tsteps = _layout_saves(acc, model, opt, sched, dl, sharded=sharded)
    assert tsteps == jsteps
    assert _names(tdir) == _names(jdir)
    assert "checkpoints/checkpoint_3/manifest.json" in _names(tdir)


# -- manifests both ways -------------------------------------------------------


def _two_port_checkpoints(root: str, sharded: bool = False) -> list[str]:
    _, tcfg = _configs()
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=root, automatic_checkpoint_naming=True))
    module = tllama.LlamaForCausalLM.from_config(tcfg, seed=0, device="cpu")
    model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3))
    return [acc.save_state(sharded=sharded) for _ in range(2)]


def _two_jax_checkpoints(root: str) -> list[str]:
    jcfg, _ = _configs()
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    acc = JAccelerator(project_config=JProjectConfiguration(
        project_dir=root, automatic_checkpoint_naming=True))
    acc.prepare(jllama.LlamaForCausalLM.from_config(jcfg, seed=0), optax.adamw(1e-3))
    out = [acc.save_state() for _ in range(2)]
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    return out


def _damage(checkpoint: str, how: str) -> None:
    path = os.path.join(checkpoint, "model.safetensors")
    data = bytearray(open(path, "rb").read())
    if how == "flip":
        data[len(data) // 2] ^= 0xFF
    else:
        data = data[: len(data) - 16]
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("how", ["flip", "truncate"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_validator_accepts_the_others_checkpoints(tmp_path, writer, how):
    root = str(tmp_path)
    made = _two_port_checkpoints(root) if writer == "port" else _two_jax_checkpoints(root)
    for path in made:
        assert jmanifest.validate_checkpoint(path) == (True, "ok")
        assert tmanifest.validate_checkpoint(path) == (True, "ok")
    ckdir = os.path.join(root, "checkpoints")
    assert jmanifest.find_latest_valid_checkpoint(ckdir) == made[-1]
    assert tmanifest.find_latest_valid_checkpoint(ckdir) == made[-1]
    _damage(made[-1], how)
    reason = "checksum mismatch" if how == "flip" else "size mismatch"
    assert reason in jmanifest.validate_checkpoint(made[-1])[1]
    assert tmanifest.validate_checkpoint(made[-1]) == jmanifest.validate_checkpoint(made[-1])
    assert jmanifest.find_latest_valid_checkpoint(ckdir) == made[0]
    assert tmanifest.find_latest_valid_checkpoint(ckdir) == made[0]


def test_port_reads_the_jax_sharded_manifest_format(tmp_path):
    """A port sharded checkpoint's manifest has JAX's piece-table shape, and
    JAX's own merge of piece tables reads the port's tables."""
    from accelerate_tpu.resilience.distributed import merge_piece_tables

    made = _two_port_checkpoints(str(tmp_path), sharded=True)
    manifest = tmanifest.read_manifest(made[-1])
    assert manifest["kind"] == "sharded" and manifest["host_count"] == 1
    with open(os.path.join(made[-1], "shard_00000", "piece_table.json")) as f:
        table = json.load(f)
    assert merge_piece_tables([table["model_0"]]) == manifest["arrays"]["model_0"]
    entry = manifest["arrays"]["model_0"]["lm_head.weight"]
    assert entry["dtype"] == "float32" and entry["pieces"] == [{
        "piece": "lm_head.weight::p0", "offsets": [[0, d] for d in entry["global_shape"]],
        "file": "shard_00000/model.safetensors"}]


# -- async saves ---------------------------------------------------------------


def test_async_save_snapshots_at_the_call(tmp_path):
    """Mutate every weight and moment in place right after an async save:
    the checkpoint holds the values at the call."""
    _, tcfg = _configs()
    acc = Accelerator(cpu=True, project_dir=str(tmp_path))
    module = tllama.LlamaForCausalLM.from_config(tcfg, seed=0, device="cpu")
    model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3))
    ids = torch.from_numpy(_ids(1)[:BATCH])
    acc.backward(model(input_ids=ids, labels=ids).loss)
    opt.step()
    opt.zero_grad()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    moments = [opt.state[p]["exp_avg"].clone() for p in module.parameters()]
    out = acc.save_state(str(tmp_path / "ck"), async_save=True)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(1.0)
            opt.state[p]["exp_avg"].add_(1.0)
    tckpt.wait_for_checkpoint()
    assert tmanifest.validate_checkpoint(out) == (True, "ok")
    acc.load_state(out)
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p, m in zip(module.parameters(), moments):
        assert torch.equal(opt.state[p]["exp_avg"], m)
        assert opt.state[p]["step"].device.type == "cpu"


def test_rotation_never_deletes_a_pending_async_checkpoint(tmp_path):
    for i in range(4):
        (tmp_path / f"checkpoint_{i}").mkdir()
    pending = str(tmp_path / "checkpoint_0")
    tckpt._ASYNC_SAVE["pending_dirs"].add(pending)
    try:
        tckpt._rotate_checkpoints(str(tmp_path), total_limit=2)
    finally:
        tckpt._ASYNC_SAVE["pending_dirs"].discard(pending)
    remaining = sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint_"))
    # the pending one survives though it is the oldest; three others go
    assert remaining == ["checkpoint_0"]


def test_a_failed_async_write_is_never_committed(tmp_path, monkeypatch):
    """A write whose retries run out raises at the next join point and
    leaves only the ``.tmp``; the retries are bounded by the plugin's
    ``io_attempts``."""
    monkeypatch.setenv("ACCELERATE_FT_IO_ATTEMPTS", "2")
    monkeypatch.setenv("ACCELERATE_FT_IO_BACKOFF", "0")
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        raise OSError("disk gone")

    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(4, 4)
    acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    monkeypatch.setattr(tckpt, "save_safetensors", failing)
    out = acc.save_state(str(tmp_path / "ck"), async_save=True)
    with pytest.raises(OSError, match="disk gone"):
        tckpt.wait_for_checkpoint()
    assert len(calls) == 2
    assert not os.path.exists(out) and os.path.isdir(out + ".tmp")
    with pytest.raises(OSError, match="disk gone"):
        acc.save_state(str(tmp_path / "sync"))


_ATEXIT_SCRIPT = textwrap.dedent(
    """
    import sys, torch
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(8, 8)
    acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    acc.save_state(sys.argv[1], async_save=True)
    sys.exit(0)   # no wait_for_checkpoint: the atexit drain must commit
    """
)


def test_atexit_drain_commits_an_inflight_async_save(tmp_path):
    script = tmp_path / "exiter.py"
    script.write_text(_ATEXIT_SCRIPT)
    ckpt = str(tmp_path / "ck")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script), ckpt], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert os.path.isdir(ckpt) and not os.path.isdir(ckpt + ".tmp")
    assert tmanifest.validate_checkpoint(ckpt) == (True, "ok")
    assert jmanifest.validate_checkpoint(ckpt) == (True, "ok")


# -- what rides beside the tensors ----------------------------------------------


def test_registered_objects_rng_and_telemetry_round_trip(tmp_path):
    from accelerate_tpu_torch.telemetry import TelemetryRecorder, set_active_recorder
    from accelerate_tpu_torch.utils import random as trandom

    class Counter:
        def __init__(self):
            self.n = 0

        def state_dict(self):
            return {"n": self.n}

        def load_state_dict(self, sd):
            self.n = sd["n"]

    recorder = TelemetryRecorder(logging_dir=str(tmp_path))
    set_active_recorder(recorder)
    try:
        acc = Accelerator(cpu=True, project_dir=str(tmp_path))
        counter = Counter()
        counter.n = 5
        acc.register_for_checkpointing(counter)
        with pytest.raises(ValueError, match="state_dict"):
            acc.register_for_checkpointing(object())
        trandom.set_seed(11)
        out = acc.save_state(str(tmp_path / "ck"))
        draws = (torch.rand(3), np.random.rand(3), torch.rand(3, generator=trandom.get_generator()))
        counter.n = 0
        acc.load_state(out)
        assert counter.n == 5
        again = (torch.rand(3), np.random.rand(3),
                 torch.rand(3, generator=trandom.get_generator()))
        for a, b in zip(draws, again):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert os.path.exists(os.path.join(out, "custom_checkpoint_0.pkl"))
    finally:
        recorder.close()
    rows = [json.loads(line) for line in open(tmp_path / "telemetry" / "telemetry.jsonl")]
    kinds = [r["kind"] for r in rows if r["type"] == "checkpoint"]
    assert kinds == ["save", "restore"]
    save = next(r for r in rows if r["type"] == "checkpoint")
    assert save["bytes"] > 0 and save["seconds"] > 0 and save["async"] is False
    assert set(save) == {"type", "kind", "seconds", "bytes", "shard_count", "async", "path",
                         "ts", "schema"}


@pytest.mark.parametrize("safe_serialization", [True, False], ids=["safetensors", "bin"])
def test_optimizer_file_carries_param_groups_and_step_returns_to_its_device(
        tmp_path, safe_serialization):
    """The optimizer's tensors sit in the array file, its ``param_groups``
    in the file's metadata; ``step`` comes back where the live optimizer
    keeps it (the host, for a plain AdamW), though ``load_state_dict``
    leaves it where it was saved. ``safe_serialization=False`` writes
    ``.bin`` files, which load the same."""
    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(module.parameters(), lr=2e-3, betas=(0.8, 0.9))
    model, opt = acc.prepare(module, opt)
    acc.backward(model(torch.ones(2, 4)).sum())
    opt.step()
    out = acc.save_state(str(tmp_path / "ck"), safe_serialization=safe_serialization)
    ext = ".safetensors" if safe_serialization else ".bin"
    assert os.path.exists(os.path.join(out, "optimizer" + ext))
    meta = json.loads(tckpt.read_metadata(os.path.join(out, "optimizer"))["optimizer"])
    assert meta["param_groups"][0]["lr"] == 2e-3
    assert sorted(tckpt.load_array_dict(os.path.join(out, "optimizer"))) == [
        f"state.{i}.{k}" for i in range(2) for k in ("exp_avg", "exp_avg_sq", "step")]
    AcceleratorState._reset_state(reset_partial_state=True)
    fresh = Accelerator(cpu=True)
    module2 = torch.nn.Linear(4, 3)
    m2, o2 = fresh.prepare(module2, torch.optim.AdamW(module2.parameters(), lr=1.0))
    fresh.load_state(out)
    assert o2.param_groups[0]["lr"] == 2e-3 and o2.param_groups[0]["betas"] == (0.8, 0.9)
    for p, q in zip(module.parameters(), module2.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(opt.state[p]["exp_avg_sq"], o2.state[q]["exp_avg_sq"])
        assert o2.state[q]["step"].device.type == "cpu" and float(o2.state[q]["step"]) == 1.0
    # the loaded state is the optimizer's own: a step moves it, not the file
    acc2_loss = m2(torch.ones(2, 4)).sum()
    fresh.backward(acc2_loss)
    o2.step()
    assert tckpt.load_array_dict(os.path.join(out, "optimizer"))["state.0.step"].item() == 1.0


# -- sharded saves across processes --------------------------------------------


def _sharded_runs(tmp_path, sharded: bool) -> dict:
    """2 ranks train STEPS steps, save and train STEPS more; the checkpoint
    is then resumed into 2 ranks and into 1."""
    init = _init_params()
    _, tcfg = _configs()
    cfg = dataclasses.asdict(tcfg)
    ids = _ids(2)  # 2 × STEPS global batches of 8 rows
    ckpt = str(tmp_path / "ck")
    out = {mode: debug_launcher(workers.sharded_train,
                                (init, cfg, ids, ckpt, sharded, mode.rstrip("12")),
                                num_processes=int(mode[-1]) if mode != "save" else 2,
                                timeout=240)
           for mode in ("save", "resume2", "resume1")}
    out["manifest"] = tmanifest.read_manifest(ckpt)
    out["names"] = _names(ckpt)
    return out


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "gathered"])
def test_two_rank_save_restores_into_one_and_two_processes(tmp_path, sharded):
    runs = _sharded_runs(tmp_path, sharded)
    saved = runs["save"]
    assert len(saved) == 2 and saved[0]["losses"] == saved[1]["losses"]
    after = saved[0]["losses"][STEPS:]
    two, one = runs["resume2"], runs["resume1"]
    # the ranks' averaged losses continue the saving run's, bit for bit
    assert two[0]["losses"] == after and two[1]["losses"] == after
    for r in two + one:
        assert r["position"] == STEPS and r["step_device"] == "cpu"
    # one process reads both ranks' global batches: the same trajectory
    np.testing.assert_allclose(one[0]["losses"], after, rtol=1e-5)
    np.testing.assert_allclose(one[0]["weights"], two[0]["weights"], rtol=0, atol=1e-5)
    manifest, names = runs["manifest"], runs["names"]
    assert manifest["host_count"] == 2
    assert {"random_states_0.pkl", "random_states_1.pkl"} <= names
    if sharded:
        assert manifest["kind"] == "sharded"
        # rank 0 writes the replicated tensors; rank 1's files hold none
        assert {"shard_00000/model.safetensors", "shard_00001/model.safetensors",
                "shard_00001/piece_table.json"} <= names
        pieces = {p["file"] for e in manifest["arrays"]["model_0"].values()
                  for p in e["pieces"]}
        assert pieces == {"shard_00000/model.safetensors"}
    else:
        assert manifest["kind"] == "gathered" and "model.safetensors" in names


# -- save_model and load_checkpoint_and_dispatch --------------------------------


@pytest.mark.parametrize("max_shard_size", ["10GB", "20KB"], ids=["one_file", "shards"])
def test_save_model_reloads_through_load_checkpoint_and_dispatch(tmp_path, max_shard_size):
    from accelerate_tpu_torch.big_modeling import init_empty_weights, load_checkpoint_and_dispatch

    _, tcfg = _configs()
    acc = Accelerator(cpu=True)
    module = tllama.LlamaForCausalLM(tcfg, device="cpu")
    module.load_state_dict(tllama.params_from_jax(_init_params(), tcfg))
    model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-2))
    ids = torch.from_numpy(_ids(1)[:BATCH]).long()
    for _ in range(2):
        acc.backward(model(input_ids=ids, labels=ids).loss)
        opt.step()
        opt.zero_grad()
    out = str(tmp_path / "weights")
    acc.save_model(model, out, max_shard_size=max_shard_size)
    files = sorted(os.listdir(out))
    if max_shard_size == "10GB":
        assert files == ["model.safetensors"]
    else:
        assert "model.safetensors.index.json" in files and len(files) > 3
    with torch.no_grad():
        ref = model(input_ids=ids).logits
    with init_empty_weights():
        empty = tllama.LlamaForCausalLM(tcfg, device="cpu")
    loaded = load_checkpoint_and_dispatch(empty, out, device_map={"": "cpu"},
                                          main_device="cpu")
    with torch.no_grad():
        got = loaded(input_ids=ids).logits
    assert torch.equal(got, ref)
    assert acc.get_state_dict(model).keys() == module.state_dict().keys()
    acc.save({"note": 1}, str(tmp_path / "obj.pkl"))
    assert (tmp_path / "obj.pkl").exists()
