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
import functools
import importlib
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


#: the repairs' cases at dp 2: key -> (family, config overrides of
#: ``tiny()``). Each holds the port's step to JAX's where a rank's local
#: reduction differs from the global batch's: the batch-norm statistics
#: (C6), the routing's capacity, slots and load-balancing means with a
#: capacity factor that drops tokens (C7), and the token loss's mean with
#: ignored labels on one rank's rows only (C8)
REPAIRS = {
    "c6_resnet": ("resnet", {}),
    "c7_mixtral": ("mixtral", {"capacity_factor": 0.5}),
    "c7_mixtral_remat": ("mixtral", {"capacity_factor": 0.5, "remat": True}),
    "c8_llama": ("llama", {}),
    "c8_gpt2": ("gpt2", {}),
}
REPAIR_STEPS = 3


@functools.lru_cache(maxsize=None)
def _repair_setup(key: str):
    """The case's JAX config, port config kwargs, JAX-initialised weights
    and its ``REPAIR_STEPS`` global batches of ``RANKS × PER_RANK`` rows.
    C8's labels are -100 on the first third of the positions of the rows
    rank 0 reads (the first ``PER_RANK`` of every global batch) only."""
    family, overrides = REPAIRS[key]
    cls, cfg_cls = workers.FAMILIES[family]
    jmod = importlib.import_module(f"accelerate_tpu.models.{family}")
    jcfg = dataclasses.replace(getattr(jmod, cfg_cls).tiny(), **overrides)
    tmod = importlib.import_module(f"accelerate_tpu_torch.models.{family}")
    fields = {f.name for f in dataclasses.fields(getattr(tmod, cfg_cls))}
    cfg_kwargs = {k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields}
    init = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  getattr(jmod, cls).from_config(jcfg, seed=0).params)
    rows = REPAIR_STEPS * RANKS * PER_RANK
    rng = np.random.default_rng(11)
    if family == "resnet":
        data = {"pixel_values": rng.normal(size=(rows, 16, 16, 3)).astype(np.float32),
                "labels": rng.integers(0, jcfg.num_classes, size=rows).astype(np.int32)}
    else:
        ids = rng.integers(0, jcfg.vocab_size, size=(rows, SEQ)).astype(np.int32)
        labels = ids.copy()
        if key.startswith("c8"):
            rank0 = (np.arange(rows) % (RANKS * PER_RANK)) < PER_RANK
            labels[rank0, :SEQ // 3] = -100
        data = {"input_ids": ids, "labels": labels}
    return jcfg, cfg_kwargs, init, data


#: the forwards that span the batch (:func:`workers.batch_forwards`): a
#: family's ``FORWARD_ROWS`` rows, ``FORWARD_SPLIT`` on rank 0 and the rest
#: on rank 1; key -> the repair case whose config and weights it takes
FORWARDS = {"resnet": "c6_resnet", "gpt2": "c8_gpt2", "mixtral": "c7_mixtral"}
FORWARD_ROWS, FORWARD_SPLIT = 4, 3


@functools.lru_cache(maxsize=None)
def _forward_rows(key: str) -> dict:
    jcfg = _repair_setup(FORWARDS[key])[0]
    rng = np.random.default_rng(13)
    if key == "resnet":
        return {"pixel_values": rng.normal(size=(FORWARD_ROWS, 16, 16, 3)).astype(np.float32),
                "labels": rng.integers(0, jcfg.num_classes, size=FORWARD_ROWS).astype(np.int32)}
    ids = rng.integers(0, jcfg.vocab_size, size=(FORWARD_ROWS, SEQ)).astype(np.int32)
    return {"input_ids": ids, "labels": ids.copy()}


@pytest.fixture
def port_loops(tmp_path_factory):
    """Each rank's result of ``workers.train_loops`` (one launch a session)."""
    _, cfg_kwargs, init, train_ids, eval_ids = _setup()
    cases = [{"key": k, "family": REPAIRS[k][0], "cfg": _repair_setup(k)[1],
              "init": _repair_setup(k)[2], "data": _repair_setup(k)[3]} for k in REPAIRS]
    forwards = [{"key": k, "family": REPAIRS[r][0], "cfg": _repair_setup(r)[1],
                 "init": _repair_setup(r)[2], "rows": _forward_rows(k), "split": FORWARD_SPLIT}
                for k, r in FORWARDS.items()]
    return workers.shared_result(tmp_path_factory, "torch_train_loops_2", lambda: debug_launcher(
        workers.train_loops, (init, cfg_kwargs, train_ids, eval_ids, PER_RANK, cases,
                              REPAIR_STEPS, forwards),
        num_processes=RANKS, timeout=300))


def _jax_repair_loop(key: str) -> dict:
    """JAX's loop for a repair's case on a dp=2 mesh over the same global
    batches: the losses and the final weights."""
    jcfg, _, _, data = _repair_setup(key)
    family = REPAIRS[key][0]
    jmod = importlib.import_module(f"accelerate_tpu.models.{family}")
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    try:
        acc = JAccelerator(mesh_plugin=JMeshPlugin(dp=2, devices=jax.devices()[:RANKS]))
        model, opt, train = acc.prepare(
            getattr(jmod, workers.FAMILIES[family][0]).from_config(jcfg, seed=0),
            optax.sgd(workers.FAMILY_LR, momentum=workers.FAMILY_MOMENTUM),
            DataLoader(workers.Arrays(data), batch_size=RANKS * PER_RANK))
        losses = []
        for batch in train:
            out = model(**batch)
            acc.backward(out.loss)
            opt.step()
            opt.zero_grad()
            losses.append(out.loss.item())
        return {"losses": losses, "weights": jax.tree_util.tree_map(np.asarray, model.params)}
    finally:
        JAccState._reset_state(reset_partial_state=True)
        JGradState._reset_state()


def _check_repair(port_loops, key: str):
    ref = _jax_repair_loop(key)
    family = REPAIRS[key][0]
    tmod = importlib.import_module(f"accelerate_tpu_torch.models.{family}")
    cfg = getattr(tmod, workers.FAMILIES[family][1])(**_repair_setup(key)[1])
    want = tmod.params_from_jax(ref["weights"], cfg)
    for rank in port_loops:
        got = rank["cases"][key]
        print(f"{key}: port losses {got['losses']} (rank), JAX {ref['losses']}")
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=0, atol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(got["weights"][k], v.numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)


def test_c6_resnet_batch_norm_statistics_span_the_global_batch_at_dp2(port_loops):
    """JAX normalises over its global batch; each rank's statistics are the
    all-reduced sums of both ranks' rows."""
    _check_repair(port_loops, "c6_resnet")


def test_c7_mixtral_routes_over_the_global_batch_at_dp2(port_loops):
    """A capacity factor of 0.5 drops tokens: the capacity, the slots (the
    global exclusive count in JAX's flattened order) and the load-balancing
    means are the global batch's."""
    drops = sum(rank["cases"]["c7_mixtral"]["drops"] for rank in port_loops)
    print(f"c7_mixtral: {drops} (token, choice) assignments dropped over the run")
    assert drops > 0
    _check_repair(port_loops, "c7_mixtral")


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_c8_token_loss_is_the_global_batch_mean_at_dp2(port_loops, family):
    """Ignored labels on one rank's rows only: every rank's loss is the mean
    over the global batch's valid tokens, and its gradient the rank's part
    of the global sum, as JAX's."""
    _check_repair(port_loops, f"c8_{family}")


def test_c7_mixtral_routes_over_the_global_batch_under_remat_at_dp2(port_loops):
    """The layers' recompute in the backward routes as their forward did:
    over the global batch, with the groups the prepared model's call bound."""
    assert sum(rank["cases"]["c7_mixtral_remat"]["drops"] for rank in port_loops) > 0
    _check_repair(port_loops, "c7_mixtral_remat")


def _jax_forward_loss(key: str, rows: int) -> float:
    """JAX's loss of the family's first ``rows`` rows on one device."""
    jcfg, _, init, _ = _repair_setup(FORWARDS[key])
    family = REPAIRS[FORWARDS[key]][0]
    jmod = importlib.import_module(f"accelerate_tpu.models.{family}")
    jmodel = getattr(jmod, workers.FAMILIES[family][0]).from_config(jcfg, seed=0)
    batch = {k: jnp.asarray(v[:rows]) for k, v in _forward_rows(key).items()}
    return float(jmodel.apply_fn(jax.tree_util.tree_map(jnp.asarray, init), **batch)["loss"])


@pytest.mark.parametrize("key", sorted(FORWARDS))
def test_a_prepared_forward_spans_a_batch_split_unevenly(port_loops, key):
    """3 rows on rank 0 and 1 on rank 1: every rank's loss is JAX's over the
    4 rows (ResNet's batch statistics, Mixtral's capacity, slots and
    means, the token mean: each from the ranks' own counts)."""
    want = _jax_forward_loss(key, FORWARD_ROWS)
    for rank in port_loops:
        np.testing.assert_allclose(rank["forwards"][key]["uneven"], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("key", sorted(FORWARDS))
def test_an_unwrapped_module_on_one_rank_computes_over_its_own_rows(port_loops, key):
    """Rank 0 alone calls the unwrapped module, rank 1 nothing: the call
    makes no collective and its loss is JAX's over rank 0's rows alone."""
    got = port_loops[0]["forwards"][key]["rank_local"]
    np.testing.assert_allclose(got, _jax_forward_loss(key, FORWARD_SPLIT), rtol=0, atol=1e-5)


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
    # the fsdp, cp and tp axes are ported (tests/test_torch_sharding.py);
    # the pipelined stacks are not
    assert MeshPlugin(dp=1, tp=2).axis_sizes(2)["tp"] == 2
    with pytest.raises(ValueError, match="item 18"):
        MeshPlugin(pp=2)
    with pytest.raises(ValueError, match="not yet ported"):
        Accelerator(cpu=True, mesh_plugin=object())
    acc = Accelerator(cpu=True, mesh_plugin=MeshPlugin(dp=1))
    assert acc.state.backend is None and acc.mesh is None and str(acc.distributed_type) == "NO"
    AcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(ValueError, match=r"'dp': 2.*!= device count 1"):  # JAX's words
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
