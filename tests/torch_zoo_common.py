"""Helpers of the zoo's CPU tests (``tests/test_torch_models_*.py``): a JAX
model and its port on the same weights, and the 5-line loop run by both
packages on the same batches.

The JAX loop runs as its own tests run it, on the 8-device virtual CPU
mesh; the port's on the CPU through its plain attention path
(``Accelerator(cpu=True)``). ``optax.adamw(1e-3)`` is held against
``torch.optim.AdamW(1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)``:
optax's defaults, spelled out.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.state import AcceleratorState as JAccState
from accelerate_tpu.state import GradientState as JGradState
from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState


def np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def port_config(tcls, jcfg):
    """The port's config with the JAX config's field values (the port has
    every field but ``pipeline_microbatches``, ROADMAP item 18)."""
    fields = {f.name for f in dataclasses.fields(tcls)}
    return tcls(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})


def port_model(tmodule, tcls, tcfg, np_params):
    """``tcls`` on the CPU with the JAX params carried across."""
    model = tcls(tcfg, device="cpu")
    model.load_state_dict(tmodule.params_from_jax(np_params, tcfg))
    return model


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def reset_states():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()


def jax_loop(jmodel, batches, mixed_precision=None):
    """The JAX Accelerator loop; returns the initial params and the losses."""
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    accelerator = JAccelerator(mixed_precision=mixed_precision)
    model, opt = accelerator.prepare(jmodel, optax.adamw(1e-3))
    init = np_tree(model.params)
    losses = []
    for batch in batches:
        out = model(**{k: jnp.asarray(v) for k, v in batch.items()})
        accelerator.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(out.loss.item())
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    return init, losses


def port_loop(model, batches, mixed_precision=None):
    """The port's 5-line loop; returns the losses."""
    accelerator = Accelerator(cpu=True, mixed_precision=mixed_precision)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    model, opt = accelerator.prepare(model, opt)
    losses = []
    for batch in batches:
        out = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
        accelerator.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(float(out.loss.detach()))
    return losses


def assert_grads_close(port_model_, jax_grads, tmodule, tcfg, rtol=1e-4):
    """Each gradient within ``rtol`` of its leaf's largest JAX value, that
    scale floored at 1e-6: a leaf whose true gradient is zero (a key bias,
    which shifts every score of a query alike) holds rounding noise of
    ~1e-11 in both packages."""
    ref = tmodule.params_from_jax(np_tree(jax_grads), tcfg)
    for name, p in port_model_.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=rtol * max(float(np.abs(r).max()), 1e-6), err_msg=name)
