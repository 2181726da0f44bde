"""What each gloo rank runs in the port's multi-process tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_operations.py``).

``debug_launcher`` spawns the ranks, which import their function by name:
so they live here, in a module that imports torch and the port only (a rank
that imported a test file would import JAX as well). Each function returns
plain numpy and Python values for the test to hold against the JAX
package's results.
"""

from __future__ import annotations

import fcntl
import os
import pickle
import random
import time

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, IterableDataset


class Rows(Dataset):
    """``{"input_ids", "labels", "idx"}`` rows of a numpy id matrix."""

    def __init__(self, ids: np.ndarray):
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        row = torch.from_numpy(self.ids[i])
        return {"input_ids": row, "labels": row.clone(), "idx": torch.tensor(i)}


class Arrays(Dataset):
    """Rows of a dict of equally long numpy arrays, as tensors."""

    def __init__(self, arrays: dict):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, i):
        return {k: torch.from_numpy(np.array(v[i])) for k, v in self.arrays.items()}


#: the zoo's families: (model class, config class)
FAMILIES = {
    "llama": ("LlamaForCausalLM", "LlamaConfig"),
    "gpt2": ("GPT2LMHeadModel", "GPT2Config"),
    "opt": ("OPTForCausalLM", "OPTConfig"),
    "gpt_neox": ("GPTNeoXForCausalLM", "GPTNeoXConfig"),
    "mixtral": ("MixtralForCausalLM", "MixtralConfig"),
    "bert": ("BertForSequenceClassification", "BertConfig"),
    "vit": ("ViTForImageClassification", "ViTConfig"),
    "resnet": ("ResNetForImageClassification", "ResNetConfig"),
    "t5": ("T5ForConditionalGeneration", "T5Config"),
}


def family_model(family: str, cfg_kwargs: dict, init: dict):
    """The family's port model on the CPU with JAX's weights."""
    import importlib

    mod = importlib.import_module(f"accelerate_tpu_torch.models.{family}")
    cls, cfg_cls = FAMILIES[family]
    cfg = getattr(mod, cfg_cls)(**cfg_kwargs)
    model = getattr(mod, cls)(cfg, device="cpu")
    model.load_state_dict(mod.params_from_jax(init, cfg))
    return model


def _counting_drops(drops: list):
    """Mixtral's ``moe_ffn`` wrapped to add this rank's dropped
    assignments (a choice whose slot lies past the capacity) to ``drops``,
    recomputed with the port's own routing helpers on the same inputs."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.models import mixtral as mm

    inner = mm.moe_ffn

    def moe_ffn(config, w, x, *args, **kwargs):
        route = kwargs.get("route", args[1] if len(args) > 1 else None)
        with torch.no_grad():
            b, s, h = x.shape
            probs = torch.softmax(x.reshape(-1, h).float() @ w["router"].float().t(), dim=-1)
            idx = mm.top_k_routes(probs, config.num_experts_per_tok)[1]
            capacity, pos, _ = mm.expert_slots(config, F.one_hot(idx, config.num_local_experts),
                                               idx, (b, s), route)
            drops.append(int((pos >= capacity).sum()))
        return inner(config, w, x, *args, **kwargs)

    mm.moe_ffn = moe_ffn


#: the families' loops step SGD with momentum (``optax.sgd(FAMILY_LR,
#: momentum=FAMILY_MOMENTUM)`` in JAX): its update is linear in the
#: gradient, so a wrong gradient scale or reduction shows in the weights,
#: where AdamW's per-element normalisation hides the one and turns float
#: rounding near a ReLU kink or in a near-zero gradient into gaps of the
#: learning rate's size
FAMILY_LR, FAMILY_MOMENTUM = 1e-2, 0.9


def family_dp_loop(family: str, cfg_kwargs: dict, init: dict, data: dict, batch_size: int,
                   steps: int) -> dict:
    """One family through the 5-line loop at f32 on the plain data-parallel
    mesh, ``batch_size`` rows a rank a step: its step losses, final weights
    and (Mixtral) the assignments its routing dropped on this rank."""
    from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState

    AcceleratorState._reset_state()  # the process group stays up
    GradientState._reset_state()
    acc = Accelerator(cpu=True)
    model = family_model(family, cfg_kwargs, init)
    opt = torch.optim.SGD(model.parameters(), lr=FAMILY_LR, momentum=FAMILY_MOMENTUM)
    model, opt, train = acc.prepare(model, opt, DataLoader(Arrays(data), batch_size=batch_size))
    drops: list = []
    if family == "mixtral":
        _counting_drops(drops)
    losses = []
    for i, batch in enumerate(train):
        if i == steps:
            break
        out = model(**batch)
        acc.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(float(out.loss.detach()))
    return {"losses": losses, "drops": sum(drops),
            "weights": {k: v.numpy().copy() for k, v in model.state_dict().items()}}


class Stream(IterableDataset):
    """The numbers ``0..n-1`` as a stream with a length."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(range(self.n))


def shared_result(tmp_path_factory, key: str, produce):
    """``produce()`` once a test session, its result shared by every xdist
    worker of the session through a file lock (the pattern pytest-xdist
    documents for session fixtures)."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if "PYTEST_XDIST_WORKER" in os.environ else base
    path = root / f"{key}.pkl"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:  # written by this session
                    return pickle.load(f)
            result = produce()
            with open(path, "wb") as f:
                pickle.dump(result, f)
            return result
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def fail_on_rank(rank: int):
    """Exit non-zero on ``rank``; the other ranks return."""
    from accelerate_tpu_torch import PartialState

    if PartialState(cpu=True).process_index == rank:
        raise SystemExit(3)


def sleep(seconds: float):
    time.sleep(seconds)


def _np(tree):
    from accelerate_tpu_torch.operations import recursively_apply

    return recursively_apply(lambda t: t.detach().cpu().numpy(), tree)


def collectives(inputs: list[dict]) -> dict:
    """Every eager collective and process helper on this rank's share of
    ``inputs`` (one dict a rank), and the batches a ``dispatch_batches``
    loader gives this rank (process 0 reads the global batches of a stream
    and broadcasts them); the results as numpy."""
    from accelerate_tpu_torch import Accelerator, DataLoaderConfiguration, DistributedType
    from accelerate_tpu_torch import operations as ops

    acc = Accelerator(cpu=True)
    state = acc.state
    rank, world = acc.process_index, acc.num_processes
    mine = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in inputs[rank].items()}
    out = {
        "backend": state.backend,
        "distributed_type": str(acc.distributed_type),
        "rank": rank,
        "world": world,
        "mesh": (acc.mesh.mesh_dim_names, acc.mesh.size()),
        "gather": _np(acc.gather(mine["rows"])),
        "gather_nested": _np(ops.gather({"a": mine["rows"], "b": [mine["ints"]]})),
        "gather_object": ops.gather_object(mine["objects"]),
        "broadcast": _np(ops.broadcast([mine["rows"].clone(), mine["ints"].clone()],
                                       from_process=world - 1)),
        "broadcast_object_list": ops.broadcast_object_list(list(mine["objects"][:1]) or [None],
                                                           from_process=0),
        "reduce_sum": _np(ops.reduce(mine["rows"], reduction="sum", scale=2.0)),
        "reduce_mean": _np(ops.reduce(mine["rows"], reduction="mean", scale=0.5)),
        "accelerator_reduce": _np(acc.reduce(mine["rows"])),
        "pad": _np(ops.pad_across_processes(mine["ragged"], dim=0, pad_index=-1)),
        "pad_first": _np(ops.pad_across_processes(mine["ragged"], dim=0, pad_index=-1,
                                                  pad_first=True)),
        "pad_dim1": _np(ops.pad_across_processes(mine["ragged"].T.contiguous(), dim=1)),
        "sizes": ops.gather_sizes_across_processes(len(mine["ragged"])),
        "consensus_none": state.consensus_any(False),
        "consensus_last": state.consensus_any(rank == world - 1),
    }
    assert out["distributed_type"] == (DistributedType.MULTI_CPU if world > 1 else "NO")
    for pad in (False, True):
        with acc.split_between_processes(inputs[0]["items"], apply_padding=pad) as part:
            out[f"split_list_{pad}"] = part
        with acc.split_between_processes({"x": inputs[0]["items"],
                                          "t": torch.from_numpy(inputs[0]["table"])},
                                         apply_padding=pad) as part:
            out[f"split_dict_{pad}"] = _np(part)
    # the main process's body has run when another process's starts
    marker = os.path.join(os.path.dirname(
        os.environ["ACCELERATE_COORDINATOR_ADDR"].removeprefix("file://")), "main_first")
    with acc.main_process_first():
        if acc.is_main_process:
            open(marker, "w").close()
        out["main_ran_first"] = os.path.exists(marker)
    acc.wait_for_everyone()
    out["on_main"] = acc.on_main_process(lambda: rank)()
    out["on_last"] = acc.on_last_process(lambda: rank)()
    out["on_process_1"] = acc.on_process(lambda: rank, process_index=1)()
    out["is_last_process"] = acc.is_last_process
    # every host generator, and a sampler's, from the main process
    from accelerate_tpu_torch import synchronize_rng_states

    torch.manual_seed(100 + rank)
    np.random.seed(100 + rank)
    random.seed(100 + rank)
    gen = torch.Generator().manual_seed(200 + rank)
    synchronize_rng_states(["torch", "numpy", "python", "generator"], generator=gen)
    out["rng_after_sync"] = [torch.rand(1).item(), float(np.random.rand()), random.random(),
                             torch.rand(1, generator=gen).item()]
    for even in (True, False):
        dl = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
            dispatch_batches=True, even_batches=even)).prepare(
                DataLoader(Stream(DISPATCH_STREAM), batch_size=DISPATCH_BATCH))
        out[f"dispatch_even_{even}"] = [b.tolist() for b in dl]
    return out


#: the stream and per-rank batch of the dispatcher case
DISPATCH_STREAM, DISPATCH_BATCH = 11, 2


def collective_inputs(world: int) -> list[dict]:
    """One dict of operands a rank, from a numpy seed: payloads of uneven
    sizes for gather_object and pad_across_processes."""
    rng = np.random.default_rng(world)
    return [{"rows": rng.normal(size=(2, 3)).astype(np.float32),
             "ints": rng.integers(0, 2**40, size=(3,)),
             "objects": [f"rank {r}"] + [{"k": "x" * (40 * r), "r": r}] * r,
             "ragged": rng.integers(0, 9, size=(r + 1, 3)),
             "items": list(range(7)), "table": np.arange(14).reshape(7, 2)}
            for r in range(world)]


def collectives_result(tmp_path_factory, world: int) -> list[dict]:
    """Each rank's result of :func:`collectives` at ``world`` gloo ranks,
    launched once a test session."""
    from accelerate_tpu_torch import debug_launcher

    return shared_result(tmp_path_factory, f"torch_collectives_{world}", lambda: debug_launcher(
        collectives, (collective_inputs(world),), num_processes=world, timeout=240))


def batch_forwards(cases: list[dict]) -> dict:
    """Each case's loss (``key``, ``family``, ``cfg``, ``init``, ``rows``: a
    dict of equally long numpy arrays, ``split``) at f32, twice: the
    prepared model on every rank, rank 0 taking the first ``split`` rows and
    the others the rest (an uneven batch), then the unwrapped module on
    rank 0 alone over its rows while the other ranks call nothing."""
    from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState

    AcceleratorState._reset_state()  # the process group stays up
    GradientState._reset_state()
    acc = Accelerator(cpu=True)
    out, modules = {}, {}
    for c in cases:
        model = acc.prepare(family_model(c["family"], c["cfg"], c["init"]))
        n, split = len(next(iter(c["rows"].values()))), c["split"]
        lo, hi = (0, split) if acc.process_index == 0 else (split, n)
        with torch.no_grad():
            loss = model(**{k: torch.from_numpy(v[lo:hi]) for k, v in c["rows"].items()}).loss
        out[c["key"]] = {"uneven": float(loss)}
        modules[c["key"]] = acc.unwrap_model(model)
    if acc.process_index == 0:
        for c in cases:
            with torch.no_grad():
                loss = modules[c["key"]](**{k: torch.from_numpy(v[:c["split"]])
                                            for k, v in c["rows"].items()}).loss
            out[c["key"]]["rank_local"] = float(loss)
    return out


def train_loops(init: dict, cfg_kwargs: dict, train_ids: np.ndarray, eval_ids: np.ndarray,
                batch_size: int, cases: tuple = (), steps: int = 0,
                forwards: tuple = ()) -> dict:
    """The tiny llama through ``prepare(model, opt, loader, sched)`` at f32,
    two loops: plain with a clip (1.0) and an eval pass through
    ``gather_for_metrics``, then two micro-steps a sync. ``batch_size`` rows
    a rank a step. Returns each loop's local losses, clip norms, the final
    weights, the scheduler's count and the gathered eval rows; and under
    ``"cases"`` each case's :func:`family_dp_loop` (``key``, ``family``,
    ``cfg``, ``init``, ``data``) of ``steps`` steps, and under
    ``"forwards"`` :func:`batch_forwards` of ``forwards``."""
    from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState
    from accelerate_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig(**cfg_kwargs)
    result = {}
    for name, accumulation in (("plain", 1), ("accumulate_2", 2)):
        AcceleratorState._reset_state()  # the process group stays up
        GradientState._reset_state()
        acc = Accelerator(cpu=True, gradient_accumulation_steps=accumulation)
        model = tllama.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(tllama.params_from_jax(init, cfg))
        if acc.process_index:  # prepare() must hand every rank the main process's weights
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
        train = DataLoader(Rows(train_ids), batch_size=batch_size)
        model, opt, train, sched = acc.prepare(model, opt, train, sched)
        losses, norms, syncs = [], [], []
        for batch in train:
            batch = {k: v for k, v in batch.items() if k != "idx"}
            with acc.accumulate(model):
                out = model(**batch)
                acc.backward(out.loss)
                syncs.append(acc.sync_gradients)
                if accumulation == 1:
                    norms.append(float(acc.clip_grad_norm_(model, 1.0)))
                opt.step()
                sched.step()
                opt.zero_grad()
            losses.append(float(out.loss.detach()))
        loop = {"losses": losses, "norms": norms, "syncs": syncs,
                "weights": {k: v.numpy() for k, v in model.state_dict().items()},
                "scheduler_steps": sched.scheduler.last_epoch}
        if accumulation == 1:
            evals = acc.prepare(DataLoader(Rows(eval_ids), batch_size=batch_size))
            idx, logits = [], []
            for batch in evals:
                with torch.no_grad():
                    last = model(input_ids=batch["input_ids"]).logits[:, -1]
                idx.append(acc.gather_for_metrics(batch["idx"]).numpy())
                logits.append(acc.gather_for_metrics(last).numpy())
            loop["eval_idx"] = np.concatenate(idx)
            loop["eval_logits"] = np.concatenate(logits)
        result[name] = loop
    result["cases"] = {c["key"]: family_dp_loop(c["family"], c["cfg"], c["init"], c["data"],
                                                batch_size, steps) for c in cases}
    result["forwards"] = batch_forwards(list(forwards))
    return result


def fp16_overflow_after_a_clip() -> dict:
    """Two fp16 micro-batches a step on a ``Linear(4, 2)``, clipped after
    each: the first clip unscales and checks this rank's gradients before
    the sync step's all-reduce. Rank 1's second micro-batch overflows (an
    inf loss factor), so its gradients are non-finite before the average
    and every rank's after it. Returns this rank's ``step_was_skipped``,
    whether its weights stayed finite, and the scale after the step."""
    from accelerate_tpu_torch import Accelerator, GradScalerKwargs

    acc = Accelerator(cpu=True, mixed_precision="fp16", gradient_accumulation_steps=2,
                      kwargs_handlers=[GradScalerKwargs(init_scale=1024.0)])
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    model, opt = acc.prepare(model, opt)
    x = torch.ones(3, 4)
    for micro in range(2):
        with acc.accumulate(model):
            factor = float("inf") if (micro == 1 and acc.process_index == 1) else 1.0
            acc.backward(model(x).float().sum() * factor)
            acc.clip_grad_norm_(model.parameters(), 1.0)
            opt.step()
            opt.zero_grad()
    return {"skipped": opt.step_was_skipped,
            "finite": all(bool(torch.isfinite(p).all()) for p in model.parameters()),
            "scale": acc.scaler.get_scale()}
