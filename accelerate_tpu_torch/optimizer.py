"""Optimizer wrapper (port of ``AcceleratedOptimizer`` from
``accelerate_tpu/optimizer.py``) around a ``torch.optim.Optimizer``, and the
fp16 dynamic :class:`LossScaler`.

It steps and clears only at a gradient-sync step, so gradients accumulate
in ``.grad`` across the micro-batches of ``Accelerator.accumulate``. The
JAX package defers the forward, backward, clip and update into one compiled
step (``lazy.py``); the port runs them eagerly through autograd and keeps
that step's contract: one forward, backward, clip and update per
``optimizer.step``. Outside fp16, ``step`` reads no device value. Under
fp16 it follows JAX's *split* path, which "syncs on the finite flag": the
gradients are unscaled, checked for a non-finite value, and that one flag
is read on the host once an optimizer step to decide whether to update
(``step/finite_flag`` in the trace).
"""

from __future__ import annotations

import torch

from .diagnostics.tracing import trace_span
from .diagnostics.watchdog import get_active_watchdog
from .state import GradientState


class LossScaler:
    """Dynamic fp16 loss scaler with ``torch.cuda.amp.GradScaler``'s
    schedule (port of JAX's ``LossScaler``): the scale and the
    consecutive-good-step counter are device scalars (f32 and int32) on the
    training device. A non-finite gradient backs the scale off by
    ``backoff_factor`` and the step is skipped; after ``growth_interval``
    consecutive finite steps it grows by ``growth_factor``."""

    def __init__(self, init_scale: float = 65536.0, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000,
                 device: torch.device | str = "cpu"):
        if growth_factor <= 1.0:
            raise ValueError("growth_factor must be > 1.0")
        if not 0.0 < backoff_factor < 1.0:
            raise ValueError("backoff_factor must be in (0, 1)")
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.device = torch.device(device)
        self._scale = torch.tensor(float(init_scale), dtype=torch.float32, device=self.device)
        self._good_steps = torch.zeros((), dtype=torch.int32, device=self.device)

    @property
    def scale(self) -> torch.Tensor:
        """The current scale, an f32 device scalar."""
        return self._scale

    def get_scale(self) -> float:
        return float(self._scale)

    def next_state(self, scale, good_steps, step_ok):
        """The GradScaler update rule on device scalars (``step_ok`` a bool
        tensor): ``(new_scale, new_good_steps)``."""
        good = torch.where(step_ok, good_steps + 1, torch.zeros_like(good_steps))
        grow = good >= self.growth_interval
        new_scale = torch.where(step_ok, torch.where(grow, scale * self.growth_factor, scale),
                                scale * self.backoff_factor)
        return new_scale, torch.where(grow, torch.zeros_like(good), good).to(torch.int32)

    def update(self, step_ok) -> None:
        """Advance the schedule by one optimizer step whose gradients were
        finite (``step_ok``, a bool or a bool device scalar) or not."""
        ok = torch.as_tensor(step_ok, device=self.device)
        self._scale, self._good_steps = self.next_state(self._scale, self._good_steps, ok)

    def state_dict(self) -> dict:
        """JAX's keys (and ``GradScaler``'s ``_growth_tracker``)."""
        return {
            "scale": self.get_scale(),
            "growth_factor": self.growth_factor,
            "backoff_factor": self.backoff_factor,
            "growth_interval": self.growth_interval,
            "_growth_tracker": int(self._good_steps),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.growth_factor = float(sd.get("growth_factor", self.growth_factor))
        self.backoff_factor = float(sd.get("backoff_factor", self.backoff_factor))
        self.growth_interval = int(sd.get("growth_interval", self.growth_interval))
        self._scale = torch.tensor(float(sd["scale"]), dtype=torch.float32, device=self.device)
        self._good_steps = torch.tensor(int(sd.get("_growth_tracker", 0)), dtype=torch.int32,
                                        device=self.device)


class AcceleratedOptimizer:
    def __init__(self, optimizer: torch.optim.Optimizer, scaler: LossScaler | None = None):
        if isinstance(optimizer, AcceleratedOptimizer):
            raise ValueError("optimizer is already prepared")
        self.optimizer = optimizer
        #: the fp16 loss scaler, shared by the accelerator's optimizers (None
        #: outside fp16)
        self.scaler = scaler
        self.gradient_state = GradientState()
        self._step_was_skipped = False
        #: the fp16 non-finite flag (f32 ``[1]``, nonzero once a non-finite
        #: gradient was seen), made when the gradients are unscaled: ``None``
        #: while they are still loss-scaled
        self._found_inf = None

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def parameters(self):
        """Every parameter the optimizer updates, group by group."""
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad for p in self.parameters() if p.grad is not None]

    def zero_grad(self, set_to_none: bool = True):
        """A no-op while gradients accumulate; clears at a sync step."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)
            self._found_inf = None

    def unscale_gradients(self):
        """Divide loss-scaled fp16 gradients back to true units and check
        them for a non-finite value, once: a second call before the step (or
        none under another precision) does nothing."""
        if self.scaler is None or self._found_inf is not None:
            return
        grads = self._grads()
        if not grads:
            return
        self._found_inf = torch.zeros(1, dtype=torch.float32, device=grads[0].device)
        self._unscale(grads)

    def _unscale(self, grads: list[torch.Tensor]) -> None:
        """Multiply ``grads`` by ``1 / scale`` in place and flag a non-finite
        value into :attr:`_found_inf`: one multi-tensor kernel, the one
        ``torch.amp.GradScaler`` uses."""
        if grads:
            torch._amp_foreach_non_finite_check_and_unscale_(
                grads, self._found_inf, torch.reciprocal(self.scaler.scale))

    def step(self, closure=None):
        """Update at a sync step, else nothing. A step with no gradient at
        all is skipped and says so in :attr:`step_was_skipped`. Under fp16
        the gradients are unscaled, checked, and the scale updated; a
        non-finite gradient skips the update and clears the gradients. A
        sync step tells the hang watchdog, when one runs, that a step
        landed."""
        out = self._step(closure)
        wd = get_active_watchdog()
        if wd is not None and self.gradient_state.sync_gradients:
            wd.step_completed()
        return out

    def _step(self, closure):
        if not self.gradient_state.sync_gradients:
            self._step_was_skipped = False
            return None
        if all(p.grad is None for p in self.parameters()):
            self._step_was_skipped = True
            return None
        if self.scaler is not None:
            self.unscale_gradients()
            flag = self._found_inf[0] == 0
            self.scaler.update(flag)
            # the fp16 step's one host read
            with trace_span("step/finite_flag"), \
                    torch.profiler.record_function("step/finite_flag"):
                ok = bool(flag)
            if not ok:
                self._step_was_skipped = True
                self.optimizer.zero_grad(set_to_none=True)
                self._found_inf = None
                return None
        self._step_was_skipped = False
        self._found_inf = None
        return self.optimizer.step(closure)

    @property
    def step_was_skipped(self) -> bool:
        return self._step_was_skipped

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)
