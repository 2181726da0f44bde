"""The ``Accelerator`` (port of the subset of ``accelerate_tpu/accelerator.py``
that the 5-line training loop uses)::

    accelerator = Accelerator(mixed_precision="bf16")
    model, opt = accelerator.prepare(model, torch.optim.AdamW(model.parameters(), ...))
    out = model(**batch); accelerator.backward(out.loss); opt.step(); opt.zero_grad()

One process on one device: the card unless ``cpu=True``. The JAX
package's deferred graph (``lazy.py``) is replaced by eager autograd with
the same contract (see :mod:`.optimizer`). The plugins (FSDP, DeepSpeed,
Megatron-LM, mesh, context parallel), fp16 and fp8 are not ported yet and
raise; data loaders, collectives and checkpointing are later slices.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .modules import PreparedModel, extract_model_from_parallel
from .ops.flash_attention import HEAD_DIMS
from .optimizer import AcceleratedOptimizer
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import GradientAccumulationPlugin

_COMPUTE_DTYPES = {"bf16": torch.bfloat16}


def check_kernel_head_dim(model, device: torch.device) -> None:
    """On a CUDA device, refuse a model whose attention head dim the flash
    kernels (B1-B3, ``csrc/flash_attention.cu``) do not take, before any
    step: a ``ValueError`` naming the head dims they take. The CPU runs the
    plain attention, which takes any head dim. A model without
    ``config.head_dim`` passes."""
    head_dim = getattr(getattr(model, "config", None), "head_dim", None)
    if device.type == "cuda" and head_dim is not None and head_dim not in HEAD_DIMS:
        raise ValueError(
            f"the model's head_dim {head_dim} is not taken by the flash-attention "
            f"kernels on the card (they take head dims {HEAD_DIMS})"
        )


class Accelerator:
    """Create once, ``prepare()`` the model, optimizer and scheduler, train."""

    def __init__(
        self,
        device_placement: bool = True,
        split_batches: bool = False,
        mixed_precision: str | None = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        deepspeed_plugin=None,
        fsdp_plugin=None,
        megatron_lm_plugin=None,
        mesh_plugin=None,
        context_parallel_plugin=None,
        gradient_accumulation_plugin: GradientAccumulationPlugin | None = None,
        step_scheduler_with_optimizer: bool = True,
    ):
        plugins = {
            "deepspeed_plugin": deepspeed_plugin,
            "fsdp_plugin": fsdp_plugin,
            "megatron_lm_plugin": megatron_lm_plugin,
            "mesh_plugin": mesh_plugin,
            "context_parallel_plugin": context_parallel_plugin,
        }
        for name, plugin in plugins.items():
            if plugin is not None:
                raise ValueError(f"{name} is not yet ported: the port runs one process on "
                                 "one device")
        if gradient_accumulation_plugin is not None and gradient_accumulation_steps != 1:
            raise ValueError("pass gradient_accumulation_steps or a "
                             "gradient_accumulation_plugin, not both")
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu)
        if gradient_accumulation_plugin is None:
            env_steps = int(os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", 1))
            steps = gradient_accumulation_steps if gradient_accumulation_steps > 1 else env_steps
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.split_batches = split_batches
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.step = 0
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []

    # -- state views ---------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def distributed_type(self):
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def compute_dtype(self) -> torch.dtype | None:
        return _COMPUTE_DTYPES.get(self.mixed_precision)

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @sync_gradients.setter
    def sync_gradients(self, value: bool):
        self.gradient_state._set_sync_gradients(value)

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    def wait_for_everyone(self):
        self.state.wait_for_everyone()

    def print(self, *args, **kwargs):
        self.state.print(*args, **kwargs)

    # -- prepare -------------------------------------------------------------

    def prepare(self, *args, device_placement: list[bool] | None = None):
        """Wrap models, then optimizers, then schedulers (a scheduler needs
        the prepared optimizers); anything else passes through. Order is
        preserved."""
        if device_placement is None:
            device_placement = [None] * len(args)
        prepared = []
        for obj, placement in zip(args, device_placement):
            if isinstance(obj, (torch.nn.Module, PreparedModel)):
                obj = self.prepare_model(obj, device_placement=placement)
            elif isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                obj = self.prepare_optimizer(obj)
            prepared.append(obj)
        result = [
            self.prepare_scheduler(obj)
            if isinstance(obj, (torch.optim.lr_scheduler.LRScheduler, AcceleratedScheduler))
            else obj
            for obj in prepared
        ]
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model, device_placement: bool | None = None,
                      evaluation_mode: bool = False) -> PreparedModel:
        """The module moved to :attr:`device` (in place, so an optimizer
        built on its parameters keeps them) and wrapped with the compute
        dtype. On the card a head dim the flash kernels do not take raises
        here (:func:`check_kernel_head_dim`)."""
        if isinstance(model, PreparedModel):
            return model
        check_kernel_head_dim(model, self.device)
        if device_placement if device_placement is not None else self.device_placement:
            model.to(self.device)
        prepared = PreparedModel(model, compute_dtype=self.compute_dtype)
        prepared.train(not evaluation_mode)
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if isinstance(optimizer, AcceleratedOptimizer):
            return optimizer
        wrapped = AcceleratedOptimizer(optimizer)
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        if isinstance(scheduler, AcceleratedScheduler):
            return scheduler
        wrapped = AcceleratedScheduler(
            scheduler, self._optimizers,
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.split_batches,
        )
        self._schedulers.append(wrapped)
        return wrapped

    # -- the training step ---------------------------------------------------

    def backward(self, loss, **kwargs):
        """``(loss / gradient_accumulation_steps).backward()``: gradients
        accumulate into ``.grad`` of the f32 master weights."""
        if not isinstance(loss, torch.Tensor):
            raise TypeError(
                "backward() expects the loss tensor produced by a prepared model "
                f"call; got {type(loss).__name__}. Compute the loss from model "
                "outputs (e.g. model(**batch).loss)."
            )
        (loss / self.gradient_accumulation_steps).backward(**kwargs)

    def _do_sync(self):
        if self.gradient_state.sync_with_dataloader and self.gradient_state.end_of_dataloader:
            self.step = 0
            self.gradient_state._set_sync_gradients(True)
        else:
            self.step += 1
            self.gradient_state._set_sync_gradients(
                (self.step % self.gradient_state.num_steps) == 0
            )

    @contextlib.contextmanager
    def accumulate(self, *models):
        """One micro-batch of gradient accumulation: gradients sync (and the
        optimizer steps) every ``gradient_accumulation_steps`` calls."""
        self._do_sync()
        with contextlib.ExitStack() as stack:
            if not self.sync_gradients:
                for m in models:
                    stack.enter_context(self.no_sync(m))
            yield

    @contextlib.contextmanager
    def no_sync(self, model):
        """Marks the step as not syncing. With one process there is no
        gradient all-reduce to suppress; the context keeps the API and the
        ``sync_gradients`` bookkeeping."""
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)

    def _parameters(self, parameters) -> list[torch.Tensor]:
        if isinstance(parameters, PreparedModel):
            return list(parameters.module.parameters())
        if isinstance(parameters, AcceleratedOptimizer):
            return parameters.parameters()
        if isinstance(parameters, torch.nn.Module):
            return list(parameters.parameters())
        if isinstance(parameters, torch.Tensor):
            return [parameters]
        return list(parameters)

    def clip_grad_norm_(self, parameters, max_norm, norm_type=2):
        """Scale the gradients by ``min(1, max_norm / (norm + 1e-6))`` and
        return the pre-clip global norm as a tensor (no host sync)."""
        return torch.nn.utils.clip_grad_norm_(self._parameters(parameters), max_norm,
                                              norm_type=norm_type)

    def clip_grad_value_(self, parameters, clip_value):
        torch.nn.utils.clip_grad_value_(self._parameters(parameters), clip_value)

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        return extract_model_from_parallel(model, keep_fp32_wrapper)

    def __repr__(self):
        return f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r})"
