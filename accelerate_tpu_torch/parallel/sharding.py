"""The placement planner: FSDP, tensor-parallel and replicated parameters
(port of ``accelerate_tpu/parallel/sharding.py``).

The JAX package decides each parameter's ``PartitionSpec`` and lets GSPMD
place it. The decision is copied here as pure logic
(:func:`explain_partition_spec`, :func:`partition_spec_for`,
:func:`_validated`, with the port's own :class:`PartitionSpec` tuple), in
this order of priority:

1. the model's partition rules (path regex → spec), matched against JAX's
   leaf names: the port's ``layers.<i>.<leaf>`` parameters are stacked back
   into JAX's ``[layers, ...]`` leaves and projections transposed to JAX's
   ``[in, out]`` (:func:`jax_leaves`);
2. the FSDP policy: the largest dim that the ``fsdp`` extent divides, for
   a parameter of at least ``min_num_params`` elements;
3. replicated.

:func:`shard_params` then places each parameter of the module as its
decision says, in the port's layout (a stacked leaf's spec drops its
leading ``[layers]`` entry; a transposed one swaps its dims as the port
holds them): the dims on
``fsdp`` through FSDP2's ``fully_shard`` (each layer, then the root, with a
``shard_placement_fn`` that returns the decided dim), the dims on ``tp``
through DTensor's ``distribute_tensor`` over the mesh's ``tp`` axis, and
every other parameter a ``Replicate()`` DTensor on that axis, left out of
FSDP2. The tensor-parallel compute (:func:`local`, :func:`tp_enter`,
:func:`tp_leave`, :func:`vocab_parallel_embedding`) runs the port's own ops
on each rank's shard (heads, vocabulary rows or hidden units), with
Megatron's two collectives around each block.
"""

from __future__ import annotations

import importlib
import logging
import re
from dataclasses import dataclass
import numpy as np
import torch
import torch.distributed as dist

from ..utils.dataclasses import FullyShardedDataParallelPlugin

logger = logging.getLogger(__name__)


class PartitionSpec(tuple):
    """One entry a dim: a mesh axis name, a tuple of them, or ``None``
    (the dim is not sharded) — JAX's ``PartitionSpec`` as a plain tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

#: (param path, axis repr) pairs already warned about: the divisibility
#: fallback warns ONCE per site, not once per step
_DIVISIBILITY_WARNED: set[tuple[str, str]] = set()


@dataclass(frozen=True)
class PlacementDecision:
    """One parameter's placement, with the *why* attached.

    ``dropped`` lists rule entries the divisibility validation discarded:
    ``(dim, axis_repr, extent)`` triples, ``extent`` 0 when the axis is
    absent from the mesh entirely."""

    spec: PartitionSpec
    #: "rule" (a partition rule matched), "fsdp" (size policy), or
    #: "replicated" (no rule, policy declined or found no divisible dim)
    source: str
    rule_index: int | None
    dropped: tuple[tuple[int, str, int], ...]


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis: extent}`` of a mapping or of an object with a ``.shape``
    mapping (JAX's ``Mesh``, a virtual mesh)."""
    return dict(mesh) if isinstance(mesh, dict) else dict(mesh.shape)


def explain_partition_spec(
    path_str: str,
    shape: tuple[int, ...],
    mesh,
    plugin: FullyShardedDataParallelPlugin | None,
    rules: list[tuple[str, PartitionSpec]] | None,
) -> PlacementDecision:
    """Decide one parameter's PartitionSpec (over JAX's leaf ``path_str``
    and shape) and say why. ``mesh`` only needs its axis extents
    (:func:`mesh_sizes`)."""
    # GPipe stage placement: layer-stacked params (leading [layers] axis,
    # path under "layers") split their stack over the pp axis, as an
    # overlay on whatever rule/policy decides for the other dims
    sizes = mesh_sizes(mesh)
    pp_size = sizes.get("pp", 1)
    stacked = (
        pp_size > 1
        and re.search(r"(^|\.)layers(\.|$)", path_str) is not None
        and len(shape) >= 1
        and shape[0] % pp_size == 0
    )

    def overlay(spec: PartitionSpec) -> PartitionSpec:
        if not stacked:
            return spec
        entries = list(tuple(spec)) + [None] * (len(shape) - len(tuple(spec)))
        if entries[0] is None:
            entries[0] = "pp"
        return P(*entries)

    if rules:
        for i, (pattern, spec) in enumerate(rules):
            if re.search(pattern, path_str):
                validated, dropped = _validated(spec, shape, sizes)
                return PlacementDecision(overlay(validated), "rule", i, dropped)
    if plugin is None or not plugin.shards_params:
        return PlacementDecision(overlay(P()), "replicated", None, ())
    fsdp_size = sizes.get("fsdp", 1)
    if fsdp_size <= 1:
        return PlacementDecision(overlay(P()), "replicated", None, ())
    n_elements = int(np.prod(shape)) if shape else 0
    if n_elements < max(plugin.min_num_params, 2):
        return PlacementDecision(overlay(P()), "replicated", None, ())
    # shard the largest divisible dim over fsdp (dim 0 is reserved for the
    # stage split when the pp overlay applies)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for dim in order:
        if stacked and dim == 0:
            continue
        if shape[dim] % fsdp_size == 0:
            spec = [None] * len(shape)
            spec[dim] = "fsdp"
            return PlacementDecision(overlay(P(*spec)), "fsdp", None, ())
    return PlacementDecision(overlay(P()), "replicated", None, ())


def partition_spec_for(
    path_str: str,
    shape: tuple[int, ...],
    mesh,
    plugin: FullyShardedDataParallelPlugin | None,
    rules: list[tuple[str, PartitionSpec]] | None,
) -> PartitionSpec:
    """Decide the PartitionSpec for one parameter. A rule entry the
    divisibility validation discards is warned about once per (param,
    axis): silently replicating a dim a rule asked to shard is the
    surprise ``shard-check``'s SP003 names."""
    return _warn_dropped(path_str, shape,
                         explain_partition_spec(path_str, shape, mesh, plugin, rules)).spec


def _warn_dropped(path_str: str, shape, decision: PlacementDecision) -> PlacementDecision:
    for dim, axis, extent in decision.dropped:
        key = (path_str, axis)
        if key in _DIVISIBILITY_WARNED:
            continue
        _DIVISIBILITY_WARNED.add(key)
        if extent:
            logger.warning(
                "partition rule for %r asks to shard dim %d (size %s) over "
                "axis %s (extent %d), which does not divide — falling back "
                "to unsharded for that dim (shard-check names this SP003)",
                path_str, dim, shape[dim] if dim < len(shape) else "?",
                axis, extent,
            )
        else:
            logger.warning(
                "partition rule for %r names axis %s, which is not a mesh "
                "axis — entry ignored (shard-check names this SP003; lint "
                "rule TPU012 catches the literal)",
                path_str, axis,
            )
    return decision


def _validated(
    spec: PartitionSpec, shape: tuple[int, ...], mesh
) -> tuple[PartitionSpec, tuple[tuple[int, str, int], ...]]:
    """Drop axes that don't divide the dim (defensive against bad rules).
    Returns the surviving spec plus the dropped entries as
    ``(dim, axis_repr, extent)`` — extent 0 for an axis the mesh lacks."""
    sizes = mesh_sizes(mesh)
    out = []
    dropped: list[tuple[int, str, int]] = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        known = True
        for ax in axes:
            if ax not in sizes:
                known = False
                continue
            extent *= sizes[ax]
        if known and i < len(shape) and shape[i] % extent == 0:
            out.append(entry)
        else:
            out.append(None)
            dropped.append((i, repr(entry), extent if known else 0))
    return P(*out), tuple(dropped)


# ---------------------------------------------------------------------------
# the port's parameters as JAX's leaves
# ---------------------------------------------------------------------------

_STACKED = re.compile(r"^(.*\blayers)\.(\d+)\.(.*)$")


@dataclass(frozen=True)
class ParamPlacement:
    """A port parameter's decision: its JAX leaf (``jax_path``,
    ``jax_shape``), whether it is one layer of a stacked leaf, ``perm``
    (the port's dim ``d`` is JAX's dim ``perm[d]``; ``None`` for the same
    order) and :attr:`spec`, the decision in the port's layout."""

    name: str
    jax_path: str
    jax_shape: tuple
    stacked: bool
    perm: tuple | None
    decision: PlacementDecision

    @property
    def spec(self) -> tuple:
        """One entry a dim of the port's tensor."""
        entries = list(tuple(self.decision.spec))
        entries += [None] * (len(self.jax_shape) - len(entries))
        if self.stacked:
            entries = entries[1:]
        if self.perm is not None:
            entries = [entries[j] for j in self.perm]
        return tuple(entries)

    @property
    def layer(self) -> int | None:
        """The layer index of a stacked leaf's parameter."""
        m = re.search(r"\blayers\.(\d+)\.", self.name)
        return int(m.group(1)) if self.stacked and m else None

    def dim_of(self, axis: str) -> int | None:
        """The port dim sharded over ``axis`` (alone or with other axes)."""
        for d, entry in enumerate(self.spec):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                return d
        return None


def _family_perm(family, leaf: str, ndim: int) -> tuple | None:
    """The dims of a zoo family's leaf as JAX's (``perm[d]`` is JAX's dim of
    the port's dim ``d``): the family's ``jax_layout`` where it has one,
    else ``(1, 0)`` for a 2-D leaf of ``JAX_TRANSPOSED``."""
    if hasattr(family, "jax_layout"):
        return family.jax_layout(leaf, ndim)
    if leaf in getattr(family, "JAX_TRANSPOSED", ()) and ndim == 2:
        return (1, 0)
    return None


def jax_leaves(module: torch.nn.Module) -> dict[str, tuple[str, tuple, bool, tuple | None]]:
    """``name -> (jax_path, jax_shape, stacked, perm)`` of every parameter.
    A zoo family names its parameters as JAX does (its
    ``jax_param_name``), holds some leaves in another dim order than JAX's
    (``JAX_TRANSPOSED``, ``jax_layout``), and keeps one ``layers.<i>.<leaf>``
    a layer, which JAX stacks into ``layers.<leaf>`` of ``[L, ...]`` (as
    ``factory_shapes`` stacks them). Any other module's names and shapes
    are its own."""
    family = importlib.import_module(type(module).__module__)
    zoo = hasattr(family, "JAX_TRANSPOSED")
    jax_name = getattr(family, "jax_param_name", lambda n: n)
    counts: dict[str, int] = {}
    rows = []
    for name, p in module.named_parameters():
        path = jax_name(name)
        shape = tuple(p.shape)
        perm = _family_perm(family, path.rsplit(".", 1)[-1], len(shape)) if zoo else None
        if perm is not None:
            shape = tuple(shape[perm.index(j)] for j in range(len(shape)))
        m = _STACKED.match(path) if zoo else None
        if m is not None:
            path = f"{m.group(1)}.{m.group(3)}"
            counts[path] = counts.get(path, 0) + 1
        rows.append((name, path, shape, m is not None, perm))
    return {name: (path, (counts[path], *shape) if stacked else shape, stacked, perm)
            for name, path, shape, stacked, perm in rows}


def infer_param_sharding(
    module: torch.nn.Module,
    mesh,
    plugin: FullyShardedDataParallelPlugin | None = None,
    rules: list[tuple[str, PartitionSpec]] | None = None,
) -> dict[str, ParamPlacement]:
    """Every parameter's :class:`ParamPlacement` (the port of the JAX
    function that maps the param tree to ``NamedSharding`` s), decided over
    JAX's leaf; ``mesh`` gives the extents of all six of JAX's axes."""
    out = {}
    for name, (path, shape, stacked, perm) in jax_leaves(module).items():
        decision = _warn_dropped(path, shape,
                                 explain_partition_spec(path, shape, mesh, plugin, rules))
        out[name] = ParamPlacement(name, path, shape, stacked, perm, decision)
    return out


# ---------------------------------------------------------------------------
# placing the parameters
# ---------------------------------------------------------------------------


def _dtensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    return DTensor, Replicate, Shard, distribute_tensor


def shard_params(module: torch.nn.Module, placements: dict[str, ParamPlacement], mesh,
                 mp_dtype: torch.dtype | None = None, tensor_parallel: bool = True) -> set[str]:
    """Place ``module``'s parameters in place as ``placements`` say, on the
    sharded ``DeviceMesh`` (axes ``dp``, ``fsdp``, ``cp``, ``tp``):

    * a dim on ``tp``: ``distribute_tensor`` over ``mesh["tp"]`` with
      ``Shard(dim)``; every other parameter a ``Replicate()`` DTensor there;
    * a dim on ``fsdp``: FSDP2's ``fully_shard`` over ``mesh["fsdp"]``,
      each layer (``module.fsdp_units()``, else ``module.layers``, where it
      has them) and then the root,
      its ``shard_placement_fn`` returning ``Shard(dim)`` for the decided
      dim; the other parameters are FSDP2's ``ignored_params``. Under a
      compute dtype (``mp_dtype``) FSDP2 gathers the parameters in it and
      reduces the gradients in f32.

    Returns the names of the parameters FSDP2 holds. Module code reads a
    parameter through :func:`local` (the rank's shard of a ``tp`` one).
    ``tensor_parallel=False`` (a model whose forward takes no shards; the
    ``tp`` extent must then be 1) leaves the ``tp`` step out: its
    parameters stay plain tensors outside FSDP2."""
    from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

    DTensor, Replicate, Shard, distribute_tensor = _dtensor()
    tp_mesh = mesh["tp"]
    params = dict(module.named_parameters())
    for name, placement in (placements.items() if tensor_parallel else ()):
        p = params[name]
        tp_dim = placement.dim_of("tp")
        target = [Shard(tp_dim)] if tp_dim is not None else [Replicate()]
        owner, leaf = _owner(module, name)
        with torch.no_grad():
            new = torch.nn.Parameter(distribute_tensor(p.data, tp_mesh, target),
                                     requires_grad=p.requires_grad)
        setattr(owner, leaf, new)
    params = dict(module.named_parameters())
    fsdp_dims = {id(params[n]): pl.dim_of("fsdp") for n, pl in placements.items()
                 if pl.dim_of("fsdp") is not None}
    managed = {n for n, p in params.items() if id(p) in fsdp_dims}
    if not managed:
        return managed
    ignored = {p for p in params.values() if id(p) not in fsdp_dims}
    mp = (MixedPrecisionPolicy(param_dtype=mp_dtype, reduce_dtype=torch.float32,
                               cast_forward_inputs=False)
          if mp_dtype is not None else MixedPrecisionPolicy())
    kwargs = dict(mesh=mesh["fsdp"], mp_policy=mp, ignored_params=ignored,
                  shard_placement_fn=lambda p: Shard(fsdp_dims[id(p)]))
    units = (module.fsdp_units() if hasattr(module, "fsdp_units")
             else getattr(module, "layers", None) or [])
    for layer in units:
        if any(id(p) in fsdp_dims for p in layer.parameters()):
            fully_shard(layer, **kwargs)
    fully_shard(module, **kwargs)
    return managed


def _owner(module: torch.nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def placement_spec(p: torch.Tensor) -> tuple | None:
    """The spec a placed parameter has, one entry a dim (an axis name or
    ``None``), read from its DTensor placements; ``None`` for a plain
    tensor. :func:`shard_params` must give every parameter the spec of its
    :class:`ParamPlacement` (the axes of extent 1 that the mesh lacks,
    ``pp`` and ``ep``, aside)."""
    DTensor, _, Shard, _ = _dtensor()
    if not isinstance(p, DTensor):
        return None
    spec = [None] * p.dim()
    for axis, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
        if isinstance(pl, Shard):
            spec[pl.dim] = axis
    return tuple(spec)


def opt_state_sharding_like(optimizer: torch.optim.Optimizer) -> dict[str, int]:
    """State and check that the optimizer's state follows its parameters
    (the port of the JAX function that builds the optimizer state's
    shardings from the parameters'): every state tensor of a parameter's
    shape is a DTensor on the parameter's mesh with the parameter's
    placements (``torch.optim``'s ``zeros_like`` makes it so), and the
    scalars (``step``) are the parameter's or plain. Returns how many state
    tensors of each kind were checked, ``{"sharded": n, "scalar": m}``;
    raises ``ValueError`` on the first that does not follow."""
    DTensor = _dtensor()[0]
    counts = {"sharded": 0, "scalar": 0}
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key, v in optimizer.state.get(p, {}).items():
                if not isinstance(v, torch.Tensor):
                    continue
                if v.dim() == 0 or tuple(v.shape) != tuple(p.shape):
                    counts["scalar"] += 1
                    continue
                if isinstance(p, DTensor) != isinstance(v, DTensor) or (
                        isinstance(p, DTensor) and (v.placements != p.placements
                                                    or v.device_mesh != p.device_mesh)):
                    raise ValueError(
                        f"optimizer state {key!r} of a {tuple(p.shape)} parameter does not "
                        f"follow the parameter's placement ({getattr(v, 'placements', None)} "
                        f"against {getattr(p, 'placements', None)})")
                counts["sharded"] += 1
    return counts


def clip_grad_norm_sharded(params, max_norm: float, norm_type: float = 2.0) -> torch.Tensor:
    """``clip_grad_norm_`` over DTensor gradients: the global p-norm of the
    whole gradients (each DTensor's shards summed over the mesh dims it is
    sharded on, one all-reduce a group of gradients placed alike), every
    gradient scaled by ``min(1, max_norm / (norm + 1e-6))``. Returns the
    pre-clip norm (a plain tensor, equal on every rank)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import Partial

    Shard = _dtensor()[2]
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    p = float(norm_type)
    if p == float("inf"):
        raise ValueError("clip_grad_norm_ with norm_type=inf is not yet ported on a sharded mesh")
    buckets: dict = {}
    for g in grads:
        part = local(g).float().abs().pow(p).sum()
        key = ((g.device_mesh, tuple(isinstance(x, Shard) for x in g.placements))
               if isinstance(g, DTensor) else None)
        buckets[key] = buckets.get(key, 0) + part
    total = 0
    for key, part in buckets.items():
        if key is not None:
            mesh, sharded = key
            placements = [Partial() if s else _dtensor()[1]() for s in sharded]
            part = DTensor.from_local(part, mesh, placements, run_check=False).full_tensor()
        total = total + part
    norm = total ** (1.0 / p)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_([local(g) for g in grads], coef.to(grads[0].dtype))
    return norm


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a plain tensor as it is)."""
    DTensor = _dtensor()[0]
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# tensor-parallel compute on each rank's shard
# ---------------------------------------------------------------------------


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor parameter (its ``to_local()``, whose
    gradient becomes the DTensor's), a plain tensor as it is: the port's
    own ops (the flash kernels, ``dense``, the cross-entropy) take plain
    tensors."""
    DTensor = _dtensor()[0]
    return t.to_local() if isinstance(t, DTensor) else t


class _TPEnter(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce of the gradient over
    ``tp`` (each rank's column shard sees the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _TPLeave(torch.autograd.Function):
    """Megatron's ``g``: all-reduce of the row shards' partial sums over
    ``tp``, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` entering column-parallel projections (no-op without a group)."""
    return x if group is None else _TPEnter.apply(x, group)


def tp_leave(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``tp`` of row-parallel partial products (no-op without
    a group)."""
    return x if group is None else _TPLeave.apply(x, group)


class _GatherSplit(torch.autograd.Function):
    """Every ``tp`` rank's part of a replicated activation concatenated on
    ``dim``; the gradient (equal on every rank, as a replicated
    activation's is) is cut back to this rank's part: the output of a
    column-parallel product that the next op takes whole."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.rank], None, None


def tp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ``tp`` ranks' column-parallel outputs whole on ``dim`` (no-op
    without a group)."""
    return x if group is None else _GatherSplit.apply(x, dim % x.dim(), group)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """A ``tp``-sharded weight's dim-0 shards whole, differentiably: each
    rank then reads other rows of it than its own, and the gradient is
    reduce-scattered back (the sum of every rank's over this rank's rows)."""
    if group is None:
        return t
    from .context import _AllGatherSeq

    return _AllGatherSeq.apply(t[None], group)[0]


def tp_sharded(t: torch.Tensor) -> bool:
    """Whether a parameter is a DTensor with a dim on the ``tp`` axis: the
    placement its decision gave it (a rule entry that the extent does not
    divide was dropped, and the leaf is whole)."""
    DTensor, _, Shard, _ = _dtensor()
    return isinstance(t, DTensor) and any(
        isinstance(pl, Shard) and name == "tp"
        for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements))


@dataclass(frozen=True)
class TPShard:
    """What a block's forward needs of tensor parallelism: the ``tp``
    group (None off a ``tp`` mesh of extent above 1), this rank's index
    and the group's size, and the names of the leaves the block holds as
    ``tp`` shards (:func:`tp_sharded`, read from the placed parameters).
    A leaf not in ``sharded`` is whole on every rank, and the products
    that read it run whole, with no collective."""

    group: object = None
    rank: int = 0
    size: int = 1
    sharded: frozenset = frozenset()

    def on(self, name: str) -> bool:
        return self.group is not None and name in self.sharded

    def enter(self, x, name: str):
        """``x`` entering the column-parallel product with leaf ``name``."""
        return tp_enter(x, self.group) if self.on(name) else x

    def leave(self, x, name: str):
        """The row-parallel product with leaf ``name`` summed over ``tp``."""
        return tp_leave(x, self.group) if self.on(name) else x

    def gather(self, x, name: str, dim: int = -1):
        """The column-parallel product with leaf ``name`` whole on ``dim``."""
        return tp_gather(x, dim, self.group) if self.on(name) else x

    def heads(self, n: int, name: str) -> int:
        """This rank's count of ``n`` heads of the projection ``name``."""
        if not self.on(name):
            return n
        if n % self.size:
            raise ValueError(f"{n} heads do not split over a 'tp' extent of {self.size}")
        return n // self.size

    def fused_heads(self, w, name: str, parts: int = 3):
        """This rank's rows of each of the ``parts`` equal blocks of a fused
        projection (``w_qkv [3h, ...]``, ``[q | k | v]``) that JAX's rule
        splits contiguously over ``tp``, so that a rank's shard is not its
        heads (at ``tp`` 2 rank 0 holds all of q and half of k): the
        shards are gathered whole (:func:`gather_rows`, whose gradient is
        reduce-scattered back) and this rank's heads' rows of q, k and v
        taken. Whole leaves are returned as they are."""
        if not self.on(name):
            return w
        full = gather_rows(w, self.group)
        n = full.shape[0] // parts
        size = n // self.size
        return torch.cat([full[j * n + self.rank * size:j * n + (self.rank + 1) * size]
                          for j in range(parts)])


#: off a ``tp`` mesh: every leaf whole
NO_TP = TPShard()


def tp_shard(named) -> TPShard:
    """The :class:`TPShard` of a block whose placed parameters ``named``
    (``(name, tensor)`` pairs) yields."""
    group, rank = tensor_parallel_group()
    if group is None:
        return NO_TP
    return TPShard(group, rank, dist.get_world_size(group),
                   frozenset(n for n, t in named if tp_sharded(t)))


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor, vocab_size: int,
                             rank: int, group) -> torch.Tensor:
    """Rows of an embedding table whose vocabulary is sharded over ``tp``
    (``table`` this rank's ``[vocab / tp, h]`` rows): ``ids`` already hold
    the rows JAX's gather reads (``table_rows``), each rank looks up the
    ids in its own range and zeros the rest, and the ranks' rows are summed
    (:func:`tp_leave`). Without a group, or of a whole table (a vocabulary
    that ``tp`` does not divide), a plain lookup."""
    if group is None or table.shape[0] == vocab_size:
        return torch.nn.functional.embedding(ids, table)
    rows = table.shape[0]
    start = rank * rows
    off = ids - start
    inside = (off >= 0) & (off < rows)
    emb = torch.nn.functional.embedding(off.clamp(0, rows - 1), table)
    emb = emb * inside[..., None].to(emb.dtype)
    return tp_leave(emb, group)


def tensor_parallel_group():
    """``(group, rank)`` of the ``tp`` axis of the attention context's
    mesh: ``(None, 0)`` off a sharded mesh, and where the extent is 1 (the
    collectives are then skipped)."""
    from ..ops.attention import get_attention_context

    return get_attention_context().axis("tp")
