"""What each gloo rank runs in the port's sharded tests
(``tests/test_torch_sharding.py``, ``tests/test_torch_context_parallel.py``,
``tests/test_torch_ring_flash.py``).

``debug_launcher`` spawns the ranks, which import their function by name:
so they live here, in a module that imports torch and the port only. Each
function returns plain numpy and Python values for the test to hold
against the JAX package's results.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch
from torch.utils.data import DataLoader

from torch_dist_workers import FAMILY_LR, FAMILY_MOMENTUM, Arrays, Rows, family_model

#: the meshes the sharded loop runs on, by name (the JAX test builds the same)
MESHES = {
    "fsdp2": dict(dp=1, fsdp=2),
    "fsdp4": dict(dp=1, fsdp=4),
    "fsdp2_tp2": dict(dp=1, fsdp=2, tp=2),
    "dp2_cp2": dict(dp=2, cp=2),
}

_AXES = ("dp", "fsdp", "cp", "tp")

def _coords(state) -> tuple:
    return tuple(state.axis_index(a) for a in _AXES)


def _local(t) -> np.ndarray:
    from accelerate_tpu_torch.parallel.sharding import local

    return local(t).detach().float().cpu().numpy().copy()


def sharded_loops(init: dict, cfg_kwargs: dict, ids: np.ndarray, global_batch: int,
                  steps: int, meshes: list[str]) -> dict:
    """The tiny llama through the 5-line loop on each named mesh, ``steps``
    optimizer steps at f32 with an FSDP plugin. For each mesh: this rank's
    mesh coordinates, its local shard and spec of every parameter right
    after ``prepare``, the step losses, the final whole weights, the local
    AdamW state shards after the loop and the state-placement check."""
    from accelerate_tpu_torch import (
        Accelerator,
        AcceleratorState,
        FullyShardedDataParallelPlugin,
        GradientState,
        MeshPlugin,
    )
    from accelerate_tpu_torch.models import llama as tllama
    from accelerate_tpu_torch.parallel.sharding import opt_state_sharding_like, placement_spec

    cfg = tllama.LlamaConfig(**cfg_kwargs)
    out = {}
    for name in meshes:
        AcceleratorState._reset_state()  # the process group stays up
        GradientState._reset_state()
        acc = Accelerator(cpu=True, mesh_plugin=MeshPlugin(**MESHES[name]),
                          fsdp_plugin=FullyShardedDataParallelPlugin())
        model = tllama.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(tllama.params_from_jax(init, cfg))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        per_rank = global_batch // acc.state.data_parallel_size
        train = DataLoader(Rows(ids), batch_size=per_rank)
        model, opt, train = acc.prepare(model, opt, train)
        params = dict(model.module.named_parameters())
        result = {
            "coords": _coords(acc.state),
            "prepared": {n: _local(p) for n, p in params.items()},
            "specs": {n: placement_spec(p) for n, p in params.items()},
            "decided": {n: pl.spec for n, pl in model.placements.items()},
            "fsdp_managed": sorted(model.fsdp_managed),
        }
        losses = []
        for i, batch in enumerate(train):
            if i == steps:
                break
            batch = {k: v for k, v in batch.items() if k != "idx"}
            out_ = model(**batch)
            acc.backward(out_.loss)
            opt.step()
            opt.zero_grad()
            losses.append(float(out_.loss.detach()))
        result["losses"] = losses
        result["weights"] = {k: v.numpy().copy()
                             for k, v in acc.get_state_dict(model).items()}
        result["opt_state"] = {n: {k: _local(v) for k, v in opt.state[p].items()
                                   if k != "step"}
                               for n, p in model.module.named_parameters()}
        result["opt_check"] = opt_state_sharding_like(opt.optimizer)
        if acc.state.mesh_sizes["tp"] > 1:
            result["vocab_parallel"] = _vocab_parallel_cross_entropy()
        # an Accelerator built again over the same group and mesh makes no
        # new DeviceMesh and no new communicator
        mesh, groups = acc.state.mesh, dict(acc.state.groups)
        AcceleratorState._reset_state()
        again = Accelerator(cpu=True, mesh_plugin=MeshPlugin(**MESHES[name]),
                            fsdp_plugin=FullyShardedDataParallelPlugin())
        result["mesh_reused"] = again.state.mesh is mesh and all(
            again.state.groups[k] is g for k, g in groups.items())
        out[name] = result
    return out


def _vocab_parallel_cross_entropy() -> dict:
    """The chunked cross-entropy on this ``tp`` rank's columns of a seeded
    head (``vocab_shard``) against the plain one over the whole head, on
    the same inputs: the largest gaps of the loss, of ``x``'s gradient and
    of the rank's head columns' gradient."""
    from accelerate_tpu_torch.ops.layers import fused_cross_entropy
    from accelerate_tpu_torch.parallel.sharding import tensor_parallel_group

    group, rank = tensor_parallel_group()
    n = torch.distributed.get_world_size(group)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 8, generator=gen)
    head = torch.randn(8, 32, generator=gen)
    labels = torch.randint(0, 32, (2, 16), generator=gen)
    labels[0, :3] = -100
    cols = slice(rank * 32 // n, (rank + 1) * 32 // n)
    xs, hs = x.clone().requires_grad_(), head[:, cols].clone().requires_grad_()
    got = fused_cross_entropy(xs, hs, labels, chunk_tokens=8,  # 4 checkpointed chunks
                              vocab_shard=(cols.start, group))
    got.backward()
    xw, hw = x.clone().requires_grad_(), head.clone().requires_grad_()
    want = fused_cross_entropy(xw, hw, labels, chunk_tokens=8)
    want.backward()
    return {"loss": float((got - want).abs()),
            "dx": float((xs.grad - xw.grad).abs().max()),
            "dhead": float((hs.grad - hw.grad[:, cols]).abs().max())}


def family_loops(cases: list[dict], global_batch: int, steps: int) -> dict:
    """Each case (``key``, ``family``, ``cfg``: config kwargs, ``init``:
    JAX's weights, ``data``: the arrays of ``steps`` global batches,
    ``meshes``) through the 5-line loop on each of its meshes
    (:func:`family_loop`); results by ``(key, mesh)``."""
    return {(case["key"], mesh): family_loop(case, mesh, global_batch, steps)
            for case in cases for mesh in case["meshes"]}


def family_loop(case: dict, mesh: str, global_batch: int, steps: int) -> dict:
    """One family on one mesh, ``steps`` optimizer steps at f32 with an
    FSDP plugin: this rank's mesh coordinates, its local shard and spec of
    every parameter after ``prepare``, the FSDP2 units (whether each is an
    FSDP module and how often it was called), the shapes of the inputs the
    module's forward took, the step losses, the final whole weights and the
    local momentum buffers. A ``ValueError`` of the forward is returned as
    ``{"error": message}``."""
    from torch.distributed.fsdp import FSDPModule

    from accelerate_tpu_torch import (
        Accelerator,
        AcceleratorState,
        FullyShardedDataParallelPlugin,
        GradientState,
        MeshPlugin,
    )
    from accelerate_tpu_torch.parallel.sharding import opt_state_sharding_like, placement_spec

    AcceleratorState._reset_state()  # the process group stays up
    GradientState._reset_state()
    acc = Accelerator(cpu=True, mesh_plugin=MeshPlugin(**MESHES[mesh]),
                      fsdp_plugin=FullyShardedDataParallelPlugin())
    model = family_model(case["family"], case["cfg"], case["init"])
    opt = torch.optim.SGD(model.parameters(), lr=FAMILY_LR, momentum=FAMILY_MOMENTUM)
    per_rank = global_batch // acc.state.data_parallel_size
    train = DataLoader(Arrays(case["data"]), batch_size=per_rank)
    model, opt, train = acc.prepare(model, opt, train)
    params = dict(model.module.named_parameters())
    units = model.module.fsdp_units()
    calls = [0] * len(units)
    for i, unit in enumerate(units):
        unit.register_forward_pre_hook(lambda m, a, i=i: calls.__setitem__(i, calls[i] + 1))
    seen = {}

    def record(module, args, kwargs):
        bound = inspect.signature(module.forward).bind(*args, **kwargs).arguments
        seen.setdefault("shapes", {k: tuple(v.shape) for k, v in bound.items()
                                   if isinstance(v, torch.Tensor)})

    model.module.register_forward_pre_hook(record, with_kwargs=True)
    result = {
        "coords": _coords(acc.state),
        "prepared": {n: _local(p) for n, p in params.items()},
        "specs": {n: placement_spec(p) for n, p in params.items()},
        "decided": {n: pl.spec for n, pl in model.placements.items()},
        "fsdp_managed": sorted(model.fsdp_managed),
        "fsdp_units": [isinstance(u, FSDPModule) for u in units],
        "batch_shapes": None,
    }
    losses = []
    try:
        for i, batch in enumerate(train):
            if i == steps:
                break
            result["batch_shapes"] = result["batch_shapes"] or {
                k: tuple(v.shape) for k, v in batch.items()}
            out_ = model(**batch)
            acc.backward(out_.loss)
            opt.step()
            opt.zero_grad()
            losses.append(float(out_.loss.detach()))
    except ValueError as e:
        return {"coords": result["coords"], "error": str(e)}
    result["losses"] = losses
    result["output_keys"] = sorted(out_.keys())
    result["unit_calls"] = calls
    result["forward_shapes"] = seen["shapes"]
    result["weights"] = {k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()}
    result["opt_state"] = {n: {k: _local(v) for k, v in opt.state[p].items() if k != "step"}
                           for n, p in model.module.named_parameters()}
    result["opt_check"] = opt_state_sharding_like(opt.optimizer)
    return result


def one_rank_bf16_loops(cases: list[dict], batch: int, steps: int) -> dict:
    """Each case's 5-line loop in bf16 over f32 masters (AdamW) at one
    rank, twice from the same weights and batches: on
    ``MeshPlugin(dp=1, fsdp=-1)`` with an FSDP plugin (FSDP2 gathers each
    unit in bf16), then group-less (the plain prepared model, which casts
    every leaf itself). Their step losses by key."""
    from accelerate_tpu_torch import (
        Accelerator,
        AcceleratorState,
        FullyShardedDataParallelPlugin,
        GradientState,
        MeshPlugin,
    )

    out = {}
    for case in cases:
        for sharded in (True, False):
            AcceleratorState._reset_state()  # the process group stays up
            GradientState._reset_state()
            mesh = (dict(mesh_plugin=MeshPlugin(dp=1, fsdp=-1),
                         fsdp_plugin=FullyShardedDataParallelPlugin()) if sharded else {})
            acc = Accelerator(cpu=True, mixed_precision="bf16", **mesh)
            model = family_model(case["family"], case["cfg"], case["init"])
            opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
            model, opt, train = acc.prepare(model, opt,
                                            DataLoader(Arrays(case["data"]), batch_size=batch))
            losses = []
            for i, rows in enumerate(train):
                if i == steps:
                    break
                loss = model(**rows).loss
                acc.backward(loss)
                opt.step()
                opt.zero_grad()
                losses.append(float(loss.detach()))
            out[(case["key"], "fsdp" if sharded else "group_less")] = losses
    return out


#: the context-parallel attention cases at cp 4: (mode, causal, kv heads)
CP_CASES = [(mode, causal, n_kv)
            for mode in ("ring", "ulysses", "allgather", "ring_flash", "ring_einsum")
            for causal in (True, False) for n_kv in (4, 2)]


def cp_case(mode: str, causal: bool, n_kv: int, b=2, s=64, h=4, d=16) -> dict:
    """One case's whole arrays from a fixed seed: ``q [b, s, h, d]``, ``k``
    and ``v`` with ``n_kv`` heads (GQA below ``h``), a kv padding mask with
    every row's first key valid, and the output cotangent ``do``."""
    rng = np.random.default_rng(11 + n_kv)
    mask = rng.random((b, s)) > 0.2
    mask[:, 0] = True
    return dict(mode=mode, causal=causal,
                q=rng.normal(size=(b, s, h, d)).astype(np.float32),
                k=rng.normal(size=(b, s, n_kv, d)).astype(np.float32),
                v=rng.normal(size=(b, s, n_kv, d)).astype(np.float32),
                mask=mask.astype(np.int32),
                do=rng.normal(size=(b, s, h, d)).astype(np.float32))


def cp_attention_cases(cases: list[dict]) -> list[dict]:
    """Each case's context-parallel attention on this rank's chunk of the
    sequence at a ``cp`` extent of the process count: ``q``, ``k``, ``v``
    ``[b, s, h, d]``, ``mask [b, s]`` and the output cotangent ``do`` are
    the whole arrays, cut here. ``case["mode"]`` is a ``cp_mode`` (through
    the attention dispatcher, as a model calls it) or ``"ring_flash"``
    (the flash ring on the plain chunk kernels) or ``"ring_einsum"`` (the
    einsum ring). Returns this rank's index and its chunk of the output and
    of the gradients of ``sum(out * do)``."""
    from accelerate_tpu_torch import Accelerator, ContextParallelPlugin, MeshPlugin
    from accelerate_tpu_torch.ops.attention import attention, get_attention_context
    from accelerate_tpu_torch.parallel.context import ring_attention_local

    acc = Accelerator(cpu=True, mesh_plugin=MeshPlugin(dp=1, cp=acc_world()),
                      context_parallel_plugin=ContextParallelPlugin(mode="ring"))
    n, idx = acc.state.mesh_sizes["cp"], acc.state.axis_index("cp")
    group = get_attention_context().axis("cp")[0]
    ctx = get_attention_context()
    out = []
    for case in cases:
        s = case["q"].shape[1]
        lo, hi = idx * s // n, (idx + 1) * s // n
        q, k, v = (torch.from_numpy(np.ascontiguousarray(case[x][:, lo:hi])).requires_grad_()
                   for x in "qkv")
        mask = torch.from_numpy(np.ascontiguousarray(case["mask"][:, lo:hi]))
        do = torch.from_numpy(np.ascontiguousarray(case["do"][:, lo:hi]))
        mode = case["mode"]
        if mode in ("ring", "ulysses", "allgather"):
            with _cp_mode(mode):
                o = attention(q, k, v, segment_mask=mask, causal=case["causal"])
        else:  # the ring bodies take K and V at Q's head count, as JAX's do
            rep = q.shape[2] // k.shape[2]
            o = ring_attention_local(q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2),
                                     mask, group=group, causal=case["causal"],
                                     use_flash=mode == "ring_flash", impl="plain")
        (o * do).sum().backward()
        out.append({"idx": idx, "o": o.detach().numpy(), "dq": q.grad.numpy(),
                    "dk": k.grad.numpy(), "dv": v.grad.numpy(),
                    "ctx": (ctx.cp_mode, dict(ctx.mesh))})
    return out


def acc_world() -> int:
    import os

    return int(os.environ["ACCELERATE_NUM_PROCESSES"])


def _cp_mode(mode: str):
    from accelerate_tpu_torch.ops.attention import attention_context

    return attention_context(cp_mode=mode)


def sharded_checkpoint(init: dict, cfg_kwargs: dict, mesh: str, save_dir: str | None,
                       load_dir: str | None, sharded: bool = True) -> dict:
    """The tiny llama prepared on ``mesh`` (no optimizer step): with
    ``save_dir`` its state saved there (``sharded``), with ``load_dir`` a
    checkpoint loaded into it first. Returns the whole weights."""
    from accelerate_tpu_torch import (
        Accelerator,
        FullyShardedDataParallelPlugin,
        MeshPlugin,
    )
    from accelerate_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig(**cfg_kwargs)
    acc = Accelerator(cpu=True, mesh_plugin=MeshPlugin(**MESHES[mesh]),
                      fsdp_plugin=FullyShardedDataParallelPlugin())
    model = tllama.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(init, cfg))
    model = acc.prepare(model)
    if load_dir is not None:
        acc.load_state(load_dir)
    if save_dir is not None:
        acc.save_state(save_dir, sharded=sharded)
    weights = {k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()}
    acc.state.destroy_process_group()
    return weights
