"""LR scheduler wrapper (port of ``AcceleratedScheduler`` from
``accelerate_tpu/scheduler.py``) around a ``torch.optim.lr_scheduler``: it
steps only when the optimizer stepped."""

from __future__ import annotations

from .state import GradientState, PartialState


class AcceleratedScheduler:
    def __init__(self, scheduler, optimizers, step_with_optimizer: bool = True,
                 split_batches: bool = False):
        self.scheduler = scheduler
        self.optimizers = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        self.split_batches = split_batches
        self.step_with_optimizer = step_with_optimizer
        self.gradient_state = GradientState()

    def step(self, *args, **kwargs):
        if not self.step_with_optimizer:
            self.scheduler.step(*args, **kwargs)
            return
        if not self.gradient_state.sync_gradients:
            return  # nothing happens mid-accumulation
        if any(opt.step_was_skipped for opt in self.optimizers):
            return
        # ×num_processes per step unless split_batches: each process sees
        # 1/num_processes of the batches (one process in this slice)
        for _ in range(1 if self.split_batches else PartialState().num_processes):
            self.scheduler.step(*args, **kwargs)

    def get_last_lr(self):
        return self.scheduler.get_last_lr()

    def state_dict(self):
        return self.scheduler.state_dict()

    def load_state_dict(self, state_dict):
        self.scheduler.load_state_dict(state_dict)
