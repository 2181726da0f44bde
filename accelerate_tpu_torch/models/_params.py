"""Parameter trees of the zoo's families (the port's counterpart of the JAX
pytrees the families of ``accelerate_tpu/models/`` keep).

A family describes its parameters once, as a nested spec: a dict is a
submodule, a list a ``ModuleList``, a :class:`Leaf` a parameter with its
shape and its initialiser. :func:`build` makes the modules (uninitialised)
from it, :func:`init_state_dict` draws a state dict from a
``torch.Generator``, and :func:`state_dict_from_jax` carries a JAX pytree
over: JAX's layer-stacked ``[L, ...]`` leaves become one submodule a layer,
and a family's ``convert`` puts each leaf in the port's layout (projections
``[out, in]``, as ``nn.Linear`` and :func:`~..ops.fp8.dense` take them; the
transpose of JAX's ``[in, out]``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn

from ..big_modeling import init_device
from ..parallel.pipeline import remat_wrap
from ..parallel.sharding import TPShard, local, tp_shard


@dataclass(frozen=True)
class Leaf:
    """One parameter: its shape and its initialiser, ``"ones"``,
    ``"zeros"`` or the standard deviation of a normal draw."""

    shape: tuple
    init: str | float


def build(module: nn.Module, spec: dict, dtype, device) -> None:
    """Register ``spec``'s parameters (uninitialised) and submodules on
    ``module``. A submodule made from a dict records its leaves' names in
    ``leaf_names``, the order its weights are handed over in; one that is
    an item of a list is a :class:`Layer` (a list of such lists a
    :class:`Stage` of them), which runs its block when called."""
    for name, sub in spec.items():
        if isinstance(sub, Leaf):
            module.register_parameter(
                name, nn.Parameter(torch.empty(sub.shape, dtype=dtype, device=device)))
        elif isinstance(sub, dict):
            module.add_module(name, _child(sub, dtype, device, nn.Module))
        else:
            module.add_module(name, nn.ModuleList(
                _child(s, dtype, device, Layer) if isinstance(s, dict)
                else Stage(_child(b, dtype, device, Layer) for b in s) for s in sub))


def _child(spec: dict, dtype, device, cls) -> nn.Module:
    child = cls()
    build(child, spec, dtype, device)
    child.leaf_names = tuple(n for n, s in spec.items() if isinstance(s, Leaf))
    return child


def flatten(spec, prefix: str = ""):
    """``(dotted name, leaf)`` of every leaf of a spec or a tree, in order."""
    items = spec.items() if isinstance(spec, dict) else enumerate(spec)
    for name, sub in items:
        key = f"{prefix}{name}"
        if isinstance(sub, (dict, list)):
            yield from flatten(sub, key + ".")
        else:
            yield key, sub


def _draw(generator: torch.Generator, leaf: Leaf, dtype, device) -> torch.Tensor:
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    x = torch.randn(leaf.shape, generator=generator, device=device, dtype=torch.float32)
    return (x * float(leaf.init)).to(dtype)


def init_state_dict(generator: torch.Generator, spec: dict, dtype=torch.float32,
                    device=None) -> dict[str, torch.Tensor]:
    """Random weights for ``spec``, drawn in f32 on ``device`` from
    ``generator`` (which must live there) and cast to ``dtype``: the
    distributions of the JAX initialisers, not their bits."""
    device = torch.device(device) if device is not None else generator.device
    return {name: _draw(generator, leaf, dtype, device) for name, leaf in flatten(spec)}


def as_tensor(a) -> torch.Tensor:
    """A numpy (or ml_dtypes bf16) array as a writable CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def state_dict_from_jax(np_params, convert, stacked=("layers",)) -> dict[str, torch.Tensor]:
    """A JAX pytree (numpy leaves) as the port's state dict. A subtree
    whose key is in ``stacked`` holds ``[L, ...]`` leaves, un-stacked into
    ``<key>.<i>.<leaf>``. ``convert(leaf_name, array)`` returns the leaf in
    the port's layout."""

    def walk(tree, prefix):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for name, sub in items:
            key = f"{prefix}{name}"
            if isinstance(sub, dict) and name in stacked:
                n = len(next(iter(sub.values())))
                for i in range(n):
                    for leaf, arr in sub.items():
                        yield f"{key}.{i}.{leaf}", leaf, np.asarray(arr)[i]
            elif isinstance(sub, (dict, list, tuple)):
                yield from walk(sub, key + ".")
            else:
                yield key, str(name), np.asarray(sub)

    return {key: as_tensor(convert(leaf, arr)) for key, leaf, arr in walk(np_params, "")}


def jax_param_name(name: str) -> str:
    """The JAX name of a port parameter (a spec family's: the same, JAX's
    layer-stacked leaves expanded to ``layers.<i>.<leaf>`` as JAX's device
    maps expand them)."""
    return name


def buffer_device(device: torch.device) -> torch.device:
    """Where a model's computed tables (RoPE) go: its device, or the host
    when it is built on the meta device (``init_empty_weights``)."""
    return torch.device("cpu") if device.type == "meta" else device


def transposed(names):
    """A ``convert`` for :func:`state_dict_from_jax` that transposes the
    2-D leaves named in ``names`` (JAX's ``[in, out]`` projections) and
    keeps every other leaf."""
    names = frozenset(names)

    def convert(leaf, arr):
        return arr.T if leaf in names and arr.ndim == 2 else arr

    return convert


def weights(layer: nn.Module) -> dict[str, torch.Tensor]:
    """A layer's leaves by name, read at call time, so a ``functional_call``
    that swapped in compute-dtype copies hands those over; of a DTensor,
    this rank's shard (:func:`~..parallel.sharding.local`)."""
    return {n: local(getattr(layer, n)) for n in layer.leaf_names}


def layer_tp(layer: nn.Module) -> TPShard:
    """The layer's :class:`~..parallel.sharding.TPShard`: which of its
    leaves are ``tp`` shards, read from their placement."""
    return tp_shard((n, getattr(layer, n)) for n in layer.leaf_names)


def _positional(fn, names, nargs, tp, *flat):
    return fn(dict(zip(names, flat[nargs:])), *flat[:nargs], tp=tp)


class Layer(nn.Module):
    """One layer of a spec family: its leaves, and a ``forward`` that runs
    the family's block on them, ``layer(fn, remat, *args)`` =
    ``fn(weights(layer), *args, tp=layer_tp(layer))``, rematerialised as
    ``remat`` says (:func:`~..parallel.pipeline.remat_wrap`). The training
    forward calls each layer as a module, so FSDP2's hooks gather a sharded
    layer's weights around it. Under remat the weights go in as positional
    tensors, so ``torch.utils.checkpoint`` keeps the very tensors the
    forward used (the compute-dtype copies under mixed precision) for the
    recompute."""

    def forward(self, fn, remat, *args):
        w = weights(self)
        if not remat:
            return fn(w, *args, tp=layer_tp(self))
        return remat_wrap(_positional, remat)(fn, tuple(w), len(args), layer_tp(self), *args,
                                              *w.values())


def _stage_positional(fn, names, nargs, tps, *flat):
    ws, at = [], nargs
    for keys in names:
        ws.append(dict(zip(keys, flat[at:at + len(keys)])))
        at += len(keys)
    return fn(ws, *flat[:nargs], tps=tps)


class Stage(nn.Module):
    """Layers run as one (ResNet's stages, which JAX rematerialises whole):
    ``stage(fn, remat, *args)`` = ``fn([weights(b) for b in stage], *args,
    tps=[...])``, each layer's weights positional under remat, as
    :class:`Layer` hands them over. FSDP2 gathers the stage's weights
    around the call. The layers are its children ``0``, ``1``, ... (a
    ``ModuleList``'s names; FSDP2 takes no ``ModuleList`` as a unit)."""

    def __init__(self, layers):
        super().__init__()
        for j, layer in enumerate(layers):
            self.add_module(str(j), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, j: int) -> nn.Module:
        return self._modules[str(j)]

    def forward(self, fn, remat, *args):
        ws = [weights(b) for b in self]
        flat = [t for w in ws for t in w.values()]
        call = remat_wrap(_stage_positional, remat)
        return call(fn, tuple(tuple(w) for w in ws), len(args), [layer_tp(b) for b in self],
                    *args, *flat)


class SpecModel(nn.Module):
    """A model whose parameters a spec describes (``_spec(config)``). Build
    one with :meth:`from_config` (random weights from a seed) or construct
    it and ``load_state_dict`` (e.g. a family's ``params_from_jax``): the
    constructor leaves the weights uninitialised. ``device`` defaults to
    the card."""

    #: the sharded step: FSDP2 gathers each layer's weights when the layer
    #: is called (:meth:`fsdp_units`), the forward runs on this rank's
    #: ``tp`` shards, and under ``cp`` it holds the chunk of the inputs that
    #: ``sequence_inputs`` names (none: every ``cp`` rank takes the whole
    #: batch, as JAX computes a family that does not route through its
    #: attention dispatcher)
    supports_context_parallel = True
    supports_tensor_parallel = True
    sequence_inputs: tuple = ()

    def fsdp_units(self) -> list[nn.Module]:
        """The modules FSDP2 wraps one by one: every :class:`Stage`, and
        every :class:`Layer` outside one; the other leaves go under the
        root's."""
        staged = {id(b) for m in self.modules() if isinstance(m, Stage) for b in m}
        return [m for m in self.modules()
                if isinstance(m, Stage) or (isinstance(m, Layer) and id(m) not in staged)]

    def _tp(self) -> TPShard:
        """The :class:`~..parallel.sharding.TPShard` of the model's own
        top-level leaves."""
        return tp_shard(self._parameters.items())

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        build(self, self._spec(config), dtype, init_device(device))

    @classmethod
    def from_config(cls, config, seed: int = 0, dtype=torch.float32, device=None):
        """Random weights from ``seed``; under ``init_empty_weights`` the
        meta-built model, with no draw."""
        model = cls(config, dtype=dtype, device=device)
        if model.device.type == "meta":
            return model
        device = model.device
        generator = torch.Generator(device=device).manual_seed(seed)
        params = dict(model.named_parameters())
        with torch.no_grad():  # leaf by leaf: the draws of init_state_dict, one at a time
            for name, leaf in flatten(cls._spec(config)):
                params[name].copy_(_draw(generator, leaf, dtype, device))
        return model

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype
