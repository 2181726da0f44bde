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


@dataclass(frozen=True)
class Leaf:
    """One parameter: its shape and its initialiser, ``"ones"``,
    ``"zeros"`` or the standard deviation of a normal draw."""

    shape: tuple
    init: str | float


def build(module: nn.Module, spec: dict, dtype, device) -> None:
    """Register ``spec``'s parameters (uninitialised) and submodules on
    ``module``. A submodule made from a dict records its leaves' names in
    ``leaf_names``, the order :func:`apply_layer` hands them over in."""
    for name, sub in spec.items():
        if isinstance(sub, Leaf):
            module.register_parameter(
                name, nn.Parameter(torch.empty(sub.shape, dtype=dtype, device=device)))
        elif isinstance(sub, dict):
            module.add_module(name, _child(sub, dtype, device))
        else:
            module.add_module(name, nn.ModuleList(
                _child(s, dtype, device) if isinstance(s, dict)
                else _list_child(s, dtype, device) for s in sub))


def _child(spec: dict, dtype, device) -> nn.Module:
    child = nn.Module()
    build(child, spec, dtype, device)
    child.leaf_names = tuple(n for n, s in spec.items() if isinstance(s, Leaf))
    return child


def _list_child(spec: list, dtype, device) -> nn.ModuleList:
    return nn.ModuleList(_child(s, dtype, device) for s in spec)


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
    that swapped in compute-dtype copies hands those over."""
    return {n: getattr(layer, n) for n in layer.leaf_names}


def _positional(fn, names, nargs, *flat):
    return fn(dict(zip(names, flat[nargs:])), *flat[:nargs])


def apply_layer(fn, remat, layer: nn.Module, *args):
    """``fn(weights(layer), *args)``, rematerialised as ``remat`` says
    (:func:`~..parallel.pipeline.remat_wrap`). Under remat the weights go
    in as positional tensors, so ``torch.utils.checkpoint`` keeps the very
    tensors the forward used (the compute-dtype copies under mixed
    precision) for the recompute."""
    w = weights(layer)
    if not remat:
        return fn(w, *args)
    return remat_wrap(_positional, remat)(fn, tuple(w), len(args), *args, *w.values())


class SpecModel(nn.Module):
    """A model whose parameters a spec describes (``_spec(config)``). Build
    one with :meth:`from_config` (random weights from a seed) or construct
    it and ``load_state_dict`` (e.g. a family's ``params_from_jax``): the
    constructor leaves the weights uninitialised. ``device`` defaults to
    the card."""

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
