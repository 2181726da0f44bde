"""The port's data-parallel training loop at 2 gloo ranks, held against the
JAX package's ``Accelerator(mesh_plugin=MeshPlugin(dp=2))`` loop on its
8-device CPU mesh.

Both start from the same JAX-initialised tiny llama (``params_from_jax``)
and read the same global batches: JAX reads 8 rows a step from one loader;
the port's two ranks read 4 each from the prepared ``DataLoader``
(round-robin shards), and ``backward`` averages their gradients over the
gloo group. The port's step loss is the mean of the ranks' local losses.
Rank 1 starts from perturbed weights, so the final weights equal JAX's
only if ``prepare`` broadcast rank 0's. Optimizer: ``optax.adamw(1e-3)``
against ``torch.optim.AdamW(1e-3, betas=(0.9, 0.999), eps=1e-8,
weight_decay=1e-4)`` (optax's defaults spelled out).

Tolerances at f32: losses and clip norms 1e-4 relative, weights 1e-4
absolute after 4 optimizer steps; eval logits 1e-4 absolute; the ranks'
weights bitwise equal; index orders exact.

The ranks run once per test session (``debug_launcher``: a ``FileStore``
under a fresh temporary directory, a deadline, one OpenMP thread a rank);
their results are shared by the tests of this file across xdist workers
through a file lock.
"""

import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402
import torch_dist_workers as workers  # noqa: E402
from torch.utils.data import DataLoader  # noqa: E402

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu.utils.dataclasses import MeshPlugin as JMeshPlugin  # noqa: E402
from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    AcceleratorState,
    GradientState,
    MeshPlugin,
    debug_launcher,
)
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

RANKS, PER_RANK = 2, 4
TRAIN_ROWS, EVAL_ROWS, SEQ = 32, 37, 32  # 4 steps of 8 global rows; 37 = 4 × 8 + 5


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _setup():
    jcfg = jllama.LlamaConfig.tiny()
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    cfg_kwargs = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields}
    init = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jllama.init_llama_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    train_ids = rng.integers(0, jcfg.vocab_size, size=(TRAIN_ROWS, SEQ)).astype(np.int32)
    eval_ids = rng.integers(0, jcfg.vocab_size, size=(EVAL_ROWS, 16)).astype(np.int32)
    return jcfg, cfg_kwargs, init, train_ids, eval_ids


@pytest.fixture
def port_loops(tmp_path_factory):
    """Each rank's result of ``workers.train_loops`` (one launch a session)."""
    _, cfg_kwargs, init, train_ids, eval_ids = _setup()
    return workers.shared_result(tmp_path_factory, "torch_train_loops_2", lambda: debug_launcher(
        workers.train_loops, (init, cfg_kwargs, train_ids, eval_ids, PER_RANK),
        num_processes=RANKS, timeout=240))


def _jax_loop(accumulation: int) -> dict:
    """JAX's loop on a dp=2 mesh over the same global batches."""
    jcfg, _, _, train_ids, eval_ids = _setup()
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    try:
        acc = JAccelerator(gradient_accumulation_steps=accumulation,
                           mesh_plugin=JMeshPlugin(dp=2, devices=jax.devices()[:RANKS]))
        model, opt, train = acc.prepare(
            jllama.LlamaForCausalLM.from_config(jcfg, seed=0), optax.adamw(1e-3),
            DataLoader(workers.Rows(train_ids), batch_size=RANKS * PER_RANK))
        losses, norms = [], []
        for batch in train:
            batch = {k: v for k, v in batch.items() if k != "idx"}
            with acc.accumulate(model):
                out = model(**batch)
                acc.backward(out.loss)
                norm = acc.clip_grad_norm_(model, 1.0) if accumulation == 1 else None
                opt.step()
                opt.zero_grad()
            losses.append(out.loss.item())
            if norm is not None:
                norms.append(float(norm))
        result = {"losses": losses, "norms": norms,
                  "weights": jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                                    model.params)}
        if accumulation == 1:
            evals = acc.prepare(DataLoader(workers.Rows(eval_ids), batch_size=RANKS * PER_RANK))
            idx, logits = [], []
            for batch in evals:
                last = model(input_ids=batch["input_ids"]).logits[:, -1]
                idx.append(np.asarray(acc.gather_for_metrics(batch["idx"])))
                logits.append(np.asarray(acc.gather_for_metrics(last)))
            result["eval_idx"] = np.concatenate(idx)
            result["eval_logits"] = np.concatenate(logits)
        return result
    finally:
        JAccState._reset_state(reset_partial_state=True)
        JGradState._reset_state()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("variant,accumulation", [("plain", 1), ("accumulate_2", 2)])
def test_data_parallel_loop_matches_the_jax_dp2_loop(port_loops, variant, accumulation):
    ref = _jax_loop(accumulation)
    ranks = [r[variant] for r in port_loops]
    losses = np.mean([r["losses"] for r in ranks], axis=0)
    assert len(losses) == len(ref["losses"]) == TRAIN_ROWS // (RANKS * PER_RANK)
    for got, want in zip(losses, ref["losses"]):
        assert _rel(got, want) < 1e-4, (losses, ref["losses"])
    for name, w in ranks[0]["weights"].items():  # the ranks hold one model
        np.testing.assert_array_equal(ranks[1]["weights"][name], w, err_msg=name)
    cfg = tllama.LlamaConfig(**_setup()[1])
    want = tllama.params_from_jax(ref["weights"], cfg)
    for name, w in ranks[0]["weights"].items():
        np.testing.assert_allclose(w, want[name].numpy(), rtol=0, atol=1e-4, err_msg=name)
    # the sync pattern, and the scheduler stepping once a process an update
    steps = len(losses) // accumulation
    assert ranks[0]["syncs"] == [(i + 1) % accumulation == 0 for i in range(len(losses))]
    assert ranks[0]["scheduler_steps"] == steps * RANKS


def test_clip_grad_norm_returns_the_norm_of_the_averaged_gradients(port_loops):
    """``clip_grad_norm_`` after ``backward`` sees the all-reduced gradients:
    every rank's norm equals JAX's global norm over the global batch."""
    ref = _jax_loop(1)
    for rank in port_loops:
        norms = rank["plain"]["norms"]
        assert len(norms) == len(ref["norms"]) == 4
        for got, want in zip(norms, ref["norms"]):
            assert _rel(got, want) < 1e-4, (norms, ref["norms"])
    assert ref["norms"][0] > 1.0  # the clip was active


def test_gather_for_metrics_returns_the_eval_set_once_in_jax_order(port_loops):
    """37 rows, 4 a rank a step: the last step's 8 gathered rows hold 5 real
    ones and 3 repeats, which ``gather_for_metrics`` drops."""
    ref = _jax_loop(1)
    for rank in port_loops:
        got = rank["plain"]
        assert got["eval_idx"].shape == (EVAL_ROWS,)
        np.testing.assert_array_equal(got["eval_idx"], ref["eval_idx"])
        np.testing.assert_array_equal(got["eval_idx"], np.arange(EVAL_ROWS))
        np.testing.assert_allclose(got["eval_logits"], ref["eval_logits"], rtol=0, atol=1e-4)


def test_mesh_plugin_takes_a_dp_axis_only():
    with pytest.raises(ValueError, match="item 18"):
        MeshPlugin(tp=2)
    with pytest.raises(ValueError, match="not yet ported"):
        Accelerator(cpu=True, mesh_plugin=object())
    acc = Accelerator(cpu=True, mesh_plugin=MeshPlugin(dp=1))
    assert acc.state.backend is None and acc.mesh is None and str(acc.distributed_type) == "NO"
    AcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(ValueError, match="dp=2"):
        Accelerator(cpu=True, mesh_plugin=MeshPlugin(dp=2))


def test_without_a_group_the_collectives_are_the_single_process_shortcut():
    acc = Accelerator(cpu=True)
    t = torch.arange(6.0).reshape(3, 2)
    assert acc.gather(t) is t
    torch.testing.assert_close(acc.reduce(t, scale=2.0), t * 2.0)
    assert acc.pad_across_processes(t) is t
    assert acc.gather_for_metrics(["a", "b"]) == ["a", "b"]
    assert acc.state.consensus_any(True) and not acc.state.consensus_any(False)
    with acc.split_between_processes([1, 2, 3]) as part:
        assert part == [1, 2, 3]
    with acc.main_process_first():
        pass
    acc.wait_for_everyone()
    assert acc.on_main_process(lambda: 7)() == 7 and acc.on_process(lambda: 8, process_index=1)() is None


def test_debug_launcher_raises_on_a_failing_rank_and_on_its_deadline():
    with pytest.raises(RuntimeError, match="exit codes"):
        debug_launcher(workers.fail_on_rank, (1,), num_processes=2, timeout=120)
    with pytest.raises(TimeoutError, match="still running"):
        debug_launcher(workers.sleep, (60,), num_processes=2, timeout=5)


def test_fp16_overflow_on_one_rank_after_a_clip_skips_the_step_on_every_rank():
    """A clip mid-accumulation checks each rank's gradients before the sync
    step's average; the average then carries rank 1's overflow to rank 0.
    The ranks share the flag, so both skip the step, back off the scale and
    keep finite weights."""
    ranks = debug_launcher(workers.fp16_overflow_after_a_clip, (), num_processes=2,
                           timeout=120)
    assert [r["skipped"] for r in ranks] == [True, True], ranks
    assert all(r["finite"] and r["scale"] == 512.0 for r in ranks), ranks


def test_reset_destroys_the_group_the_state_brought_up(tmp_path):
    """``_reset_state`` takes the group down with the singleton; one process
    under the launch environment brings a gloo group up at world size 1,
    where the collectives give the single-process results exactly."""
    import torch.distributed as dist

    from accelerate_tpu_torch.utils.environment import patch_environment

    env = dict(ACCELERATE_COORDINATOR_ADDR="file://" + str(tmp_path / "store"),
               ACCELERATE_NUM_PROCESSES=1, ACCELERATE_PROCESS_ID=0)
    with patch_environment(**env):
        acc = Accelerator(cpu=True)
    assert acc.state.backend == "gloo" and dist.is_initialized()
    assert str(acc.distributed_type) == "NO" and acc.mesh.mesh_dim_names == ("dp",)
    t = torch.arange(6.0).reshape(3, 2)
    torch.testing.assert_close(acc.gather(t), t, rtol=0, atol=0)
    torch.testing.assert_close(acc.reduce(t, reduction="mean", scale=3.0), t * 3.0, rtol=0, atol=0)
    torch.manual_seed(0)
    model, ref = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    ref.load_state_dict(model.state_dict())
    x = torch.arange(6.0).reshape(2, 3)
    prepared = acc.prepare(model)  # the weights' broadcast, and the all-reduce in backward
    acc.backward(prepared(x).square().sum())
    ref(x).square().sum().backward()
    for p, q in zip(model.parameters(), ref.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0)
    AcceleratorState._reset_state(reset_partial_state=True)
    assert not dist.is_initialized()


def test_notebook_launcher_checks_the_cards_and_runs_one_process_inline():
    from accelerate_tpu_torch import notebook_launcher
    from accelerate_tpu_torch.state import PartialState

    AcceleratorState._reset_state(reset_partial_state=True)
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA device"):
        notebook_launcher(lambda: None, num_processes=cards + 1)
    with pytest.raises(ValueError, match="item 23"):
        notebook_launcher(lambda: None, num_nodes=2)
    assert notebook_launcher(lambda x: x * 2, args=(21,), mixed_precision="bf16") == 42
    PartialState(cpu=True)
    with pytest.raises(ValueError, match="already initialized"):
        notebook_launcher(lambda: None)


def test_logger_logs_on_the_main_process_only_unless_asked(caplog):
    import logging

    from accelerate_tpu_torch import get_logger

    Accelerator(cpu=True)
    logger = get_logger("accelerate_tpu_torch.test")
    with caplog.at_level(logging.INFO, logger="accelerate_tpu_torch.test"):
        logger.info("on main")
        logger.info("everywhere", main_process_only=False)
        logger.info("in order", in_order=True)
    assert [r.getMessage() for r in caplog.records] == ["on main", "everywhere", "[rank 0] in order"]
