"""Model containers (port of ``accelerate_tpu/modules.py``): the output
object and the prepared model that carries the mixed-precision contract.

The JAX ``Model`` / ``Model.from_flax`` have no PyTorch meaning: an
``nn.Module`` is the model, and ``Accelerator.prepare`` wraps it in a
:class:`PreparedModel`.
"""

from __future__ import annotations

import torch
from torch.func import functional_call


class ModelOutput(dict):
    """Dict with attribute access (``out.logits`` / ``out.loss``), the
    transformers-style output object."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


def _cast_floats(tree, dtype):
    """Every floating tensor in a (nested) tuple / list / dict cast to
    ``dtype``; everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, _cast_floats(v, dtype)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


def _upcast_half(tree):
    """bf16 / fp16 tensors in the output back to f32, as the JAX package
    returns them."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype in (torch.bfloat16, torch.float16) else tree
    if isinstance(tree, dict):
        return type(tree)((k, _upcast_half(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_upcast_half(v) for v in tree)
    return tree


class PreparedModel:
    """What ``Accelerator.prepare`` returns for a model (port of
    ``PreparedModel``'s mixed-precision contract).

    The module keeps f32 master weights, which the optimizer updates. Under
    a compute dtype (``"bf16"``) each call runs
    ``torch.func.functional_call`` with every floating parameter and every
    floating input cast to it, so the whole model runs in bf16 — residual
    stream and norm outputs included, as the JAX package runs it — and
    bf16 outputs come back as f32. The casts are differentiable, so the
    gradients land on the f32 masters in f32. (``torch.autocast`` would
    keep the residual stream in f32 and round elsewhere, so it is not
    used.) Attributes not found here are read from the module."""

    def __init__(self, module: torch.nn.Module, compute_dtype: torch.dtype | None = None):
        self.module = module
        self.compute_dtype = compute_dtype

    def __getattr__(self, name):
        if name == "module":  # not set yet (e.g. during unpickling)
            raise AttributeError(name)
        return getattr(self.module, name)

    def __call__(self, *args, **kwargs):
        if self.compute_dtype is None:
            return self.module(*args, **kwargs)
        params = {name: p.to(self.compute_dtype)
                  for name, p in self.module.named_parameters() if p.is_floating_point()}
        args = _cast_floats(args, self.compute_dtype)
        kwargs = _cast_floats(kwargs, self.compute_dtype)
        return _upcast_half(functional_call(self.module, params, args, kwargs))

    forward = __call__

    @property
    def training(self) -> bool:
        return self.module.training

    def train(self, mode: bool = True) -> "PreparedModel":
        self.module.train(mode)
        return self

    def eval(self) -> "PreparedModel":
        return self.train(False)

    def unwrap(self) -> torch.nn.Module:
        return self.module

    def state_dict(self, *args, **kwargs):
        return self.module.state_dict(*args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True):
        return self.module.load_state_dict(state_dict, strict=strict)


def extract_model_from_parallel(model, keep_fp32_wrapper: bool = True):
    """The module under a :class:`PreparedModel` (port of the JAX helper)."""
    if isinstance(model, PreparedModel):
        return model.unwrap()
    return model
