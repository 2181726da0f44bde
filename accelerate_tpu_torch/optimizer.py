"""Optimizer wrapper (port of ``AcceleratedOptimizer`` from
``accelerate_tpu/optimizer.py``) around a ``torch.optim.Optimizer``.

It steps and clears only at a gradient-sync step, so gradients accumulate
in ``.grad`` across the micro-batches of ``Accelerator.accumulate``. The
JAX package defers the forward, backward, clip and update into one compiled
step (``lazy.py``); the port runs them eagerly through autograd and keeps
that step's contract: one forward, backward, clip and update per
``optimizer.step``, and no host sync inside the loop (``step`` reads no
device value). The fp16 ``LossScaler`` is not ported.
"""

from __future__ import annotations

import torch

from .state import GradientState


class AcceleratedOptimizer:
    def __init__(self, optimizer: torch.optim.Optimizer):
        if isinstance(optimizer, AcceleratedOptimizer):
            raise ValueError("optimizer is already prepared")
        self.optimizer = optimizer
        self.gradient_state = GradientState()
        self._step_was_skipped = False

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def parameters(self):
        """Every parameter the optimizer updates, group by group."""
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True):
        """A no-op while gradients accumulate; clears at a sync step."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    def step(self, closure=None):
        """Update at a sync step, else nothing. A step with no gradient at
        all is skipped and says so in :attr:`step_was_skipped`."""
        if not self.gradient_state.sync_gradients:
            self._step_was_skipped = False
            return None
        if all(p.grad is None for p in self.parameters()):
            self._step_was_skipped = True
            return None
        self._step_was_skipped = False
        return self.optimizer.step(closure)

    @property
    def step_was_skipped(self) -> bool:
        return self._step_was_skipped

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)
