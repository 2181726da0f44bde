"""The ``Accelerator`` (port of the subset of ``accelerate_tpu/accelerator.py``
that the 5-line training loop and its evaluation use)::

    accelerator = Accelerator(mixed_precision="bf16")
    model, opt, train_dl, eval_dl, sched = accelerator.prepare(model, opt, train_dl, eval_dl, sched)
    for batch in train_dl:
        with accelerator.accumulate(model):
            loss = model(**batch).loss; accelerator.backward(loss); opt.step(); sched.step(); opt.zero_grad()
    for batch in eval_dl:
        preds = accelerator.gather_for_metrics(model(**batch).logits.argmax(-1))

One process a device: the card unless ``cpu=True``. Under a launch
environment the state brings a process group up (NCCL on the card, gloo on
the CPU) and the loop is data-parallel: each process reads its shard of
every loader, and ``backward`` averages the gradients across the group at
each sync step (:meth:`Accelerator._all_reduce_gradients`). The JAX
package's deferred graph (``lazy.py``) is replaced by eager autograd with
the same contract (see :mod:`.optimizer`). Precision: ``"bf16"`` and
``"fp16"`` run the model in that dtype over f32 master weights, fp16 with
the dynamic loss scaler (:attr:`Accelerator.scaler`; ``GradScalerKwargs``
in ``kwargs_handlers``); ``"fp8"`` runs bf16 with scaled-fp8 projections
(``FP8RecipeKwargs``); :meth:`Accelerator.autocast` opens a full-precision
island. The plugins (FSDP, DeepSpeed, Megatron-LM, context parallel), a
mesh with axes other than ``dp`` and the profiling and DDP handlers are not
ported yet and raise; checkpointing is a later slice.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

from . import operations as ops
from .data_loader import DataLoaderShard, prepare_data_loader, skip_first_batches
from .diagnostics.tracing import trace_span
from .modules import PreparedModel, extract_model_from_parallel
from .ops.flash_attention import HEAD_DIM_RULE, takes_head_dim
from .ops.fp8 import FP8RecipeKwargs
from .optimizer import AcceleratedOptimizer, LossScaler
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    MeshPlugin,
)

#: fp8 keeps bf16 for everything but the projections, which
#: ``ops.fp8.dense`` runs as fp8 products under the model's recipe; int8 has
#: no entry (f32 compute), as in the JAX package
_COMPUTE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp8": torch.bfloat16}

#: the kwargs handlers of the JAX package the port has no counterpart of
#: yet, by the ROADMAP item that brings them
_UNPORTED_HANDLERS = {"ProfileKwargs": 23, "DistributedDataParallelKwargs": 18}


def check_kernel_head_dim(model, device: torch.device) -> None:
    """On a CUDA device, refuse a model whose attention head dim the flash
    kernels (B1-B3, ``csrc/flash_attention.cu``) do not take, before any
    step: a ``ValueError`` naming the rule their head dims follow. The CPU
    runs the plain attention, which takes any head dim. A model without
    ``config.head_dim`` passes."""
    head_dim = getattr(getattr(model, "config", None), "head_dim", None)
    if device.type == "cuda" and head_dim is not None and not takes_head_dim(head_dim):
        raise ValueError(
            f"the model's head_dim {head_dim} is not taken by the flash-attention "
            f"kernels on the card (they take a head dim that is {HEAD_DIM_RULE})"
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
        dataloader_config: DataLoaderConfiguration | None = None,
        deepspeed_plugin=None,
        fsdp_plugin=None,
        megatron_lm_plugin=None,
        mesh_plugin: MeshPlugin | None = None,
        context_parallel_plugin=None,
        rng_types: list[str] | None = None,
        gradient_accumulation_plugin: GradientAccumulationPlugin | None = None,
        step_scheduler_with_optimizer: bool = True,
        even_batches: bool = True,
        use_seedable_sampler: bool = False,
        kwargs_handlers: list | None = None,
    ):
        plugins = {
            "deepspeed_plugin": deepspeed_plugin,
            "fsdp_plugin": fsdp_plugin,
            "megatron_lm_plugin": megatron_lm_plugin,
            "context_parallel_plugin": context_parallel_plugin,
        }
        for name, plugin in plugins.items():
            if plugin is not None:
                raise ValueError(f"{name} is not yet ported: the port runs data parallelism "
                                 "only (ROADMAP item 18)")
        if mesh_plugin is not None and not isinstance(mesh_plugin, MeshPlugin):
            raise ValueError(f"mesh_plugin of type {type(mesh_plugin).__name__} is not yet "
                             "ported: pass a MeshPlugin with a dp axis only")
        if gradient_accumulation_plugin is not None and gradient_accumulation_steps != 1:
            raise ValueError("pass gradient_accumulation_steps or a "
                             "gradient_accumulation_plugin, not both")
        self.scaler_handler = None
        self.init_handler = None
        self.fp8_recipe_handler = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, GradScalerKwargs):
                self.scaler_handler = handler
            elif isinstance(handler, InitProcessGroupKwargs):
                self.init_handler = handler
            elif isinstance(handler, FP8RecipeKwargs):
                self.fp8_recipe_handler = handler
            elif isinstance(handler, AutocastKwargs):
                pass  # read by autocast(autocast_handler=...), as in the JAX package
            else:
                name = type(handler).__name__
                item = _UNPORTED_HANDLERS.get(name)
                raise ValueError(f"kwargs handler {name} is not yet ported"
                                 + (f" (ROADMAP item {item})" if item else ""))
        # only the fields set away from their defaults, as in the JAX package:
        # the default timeout leaves mesh.PROCESS_GROUP_TIMEOUT in force
        init_kwargs = self.init_handler.to_kwargs() if self.init_handler else {}
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu,
                                      mesh_plugin=mesh_plugin, **init_kwargs)
        self.dataloader_config = dataloader_config or DataLoaderConfiguration(
            split_batches=split_batches, even_batches=even_batches,
            use_seedable_sampler=use_seedable_sampler)
        self.rng_types = rng_types
        if gradient_accumulation_plugin is None:
            env_steps = int(os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", 1))
            steps = gradient_accumulation_steps if gradient_accumulation_steps > 1 else env_steps
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin=gradient_accumulation_plugin)
        self.device_placement = device_placement
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        # fp16: the dynamic loss scaler, shared by every prepared optimizer;
        # GradScalerKwargs(enabled=False) opts out
        self._loss_scale = None
        if self.mixed_precision == "fp16" and (self.scaler_handler is None
                                               or self.scaler_handler.enabled):
            h = self.scaler_handler or GradScalerKwargs()
            self._loss_scale = LossScaler(init_scale=h.init_scale, growth_factor=h.growth_factor,
                                          backoff_factor=h.backoff_factor,
                                          growth_interval=h.growth_interval, device=self.device)
        self.step = 0
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[DataLoaderShard] = []

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
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def mesh(self):
        return self.state.mesh

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @even_batches.setter
    def even_batches(self, value: bool):
        self.dataloader_config.even_batches = value

    @property
    def use_seedable_sampler(self) -> bool:
        return self.dataloader_config.use_seedable_sampler

    @property
    def non_blocking(self) -> bool:
        return self.dataloader_config.non_blocking

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def compute_dtype(self) -> torch.dtype | None:
        return _COMPUTE_DTYPES.get(self.mixed_precision)

    @property
    def scaler(self) -> LossScaler | None:
        """The fp16 :class:`~.optimizer.LossScaler` (None outside fp16)."""
        return self._loss_scale

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

    def on_main_process(self, function):
        return self.state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.on_local_main_process(function)

    def on_last_process(self, function):
        return self.state.on_last_process(function)

    def on_process(self, function=None, process_index=None):
        return self.state.on_process(function, process_index)

    def on_local_process(self, function=None, local_process_index=None):
        return self.state.on_local_process(function, local_process_index)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.local_main_process_first():
            yield

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.split_between_processes(inputs, apply_padding=apply_padding)

    # -- prepare -------------------------------------------------------------

    def prepare(self, *args, device_placement: list[bool] | None = None):
        """Wrap models, optimizers and data loaders, then schedulers (a
        scheduler needs the prepared optimizers); anything else passes
        through. Order is preserved."""
        if device_placement is None:
            device_placement = [None] * len(args)
        prepared = []
        for obj, placement in zip(args, device_placement):
            if isinstance(obj, (torch.nn.Module, PreparedModel)):
                obj = self.prepare_model(obj, device_placement=placement)
            elif isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                obj = self.prepare_optimizer(obj)
            elif isinstance(obj, torch.utils.data.DataLoader):
                obj = self.prepare_data_loader(obj, device_placement=placement)
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
        dtype. While a process group is up, every process's parameters and
        buffers are replaced by the main process's, once. On the card a
        head dim the flash kernels do not take raises here
        (:func:`check_kernel_head_dim`)."""
        if isinstance(model, PreparedModel):
            return model
        check_kernel_head_dim(model, self.device)
        if device_placement if device_placement is not None else self.device_placement:
            model.to(self.device)
        if self.state.backend is not None:
            with torch.no_grad():
                ops.broadcast([t.data for t in model.parameters()] + list(model.buffers()))
        prepared = PreparedModel(model, compute_dtype=self.compute_dtype)
        if self.mixed_precision == "fp8":
            prepared.fp8_recipe = self.fp8_recipe_handler or FP8RecipeKwargs()
        prepared.train(not evaluation_mode)
        self._models.append(prepared)
        return prepared

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if isinstance(optimizer, AcceleratedOptimizer):
            return optimizer
        wrapped = AcceleratedOptimizer(optimizer, scaler=self._loss_scale)
        self._optimizers.append(wrapped)
        return wrapped

    def prepare_data_loader(self, data_loader, device_placement: bool | None = None,
                            slice_fn_for_dispatch=None) -> DataLoaderShard:
        """The loader rebuilt over this process's shard, its batches placed
        on :attr:`device` (:func:`.data_loader.prepare_data_loader`)."""
        if isinstance(data_loader, DataLoaderShard):
            return data_loader
        config = self.dataloader_config
        prepared = prepare_data_loader(
            data_loader,
            num_processes=self.num_processes,
            process_index=self.process_index,
            split_batches=config.split_batches,
            put_on_device=device_placement if device_placement is not None else self.device_placement,
            rng_types=self.rng_types,
            dispatch_batches=config.dispatch_batches,
            even_batches=config.even_batches,
            slice_fn_for_dispatch=slice_fn_for_dispatch,
            use_seedable_sampler=config.use_seedable_sampler,
            non_blocking=config.non_blocking,
            prefetch_batches=config.prefetch_batches,
        )
        self._dataloaders.append(prepared)
        return prepared

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
        accumulate into ``.grad`` of the f32 master weights. Under fp16 the
        loss is first multiplied by the scaler's scale (the ``loss`` the
        caller holds stays unscaled), and where a clip already unscaled the
        gradients mid-accumulation, this micro-batch's scaled contribution is
        unscaled before it is added, as JAX's ``_accumulate_grads`` does. At
        a sync step with a process group up, the gradients are then averaged
        across the group (still scaled, as in JAX: the unscale comes after),
        so the clip, the optimizer step and ``zero_grad`` after it see
        synced gradients."""
        if not isinstance(loss, torch.Tensor):
            raise TypeError(
                "backward() expects the loss tensor produced by a prepared model "
                f"call; got {type(loss).__name__}. Compute the loss from model "
                "outputs (e.g. model(**batch).loss)."
            )
        if self._loss_scale is None:
            (loss / self.gradient_accumulation_steps).backward(**kwargs)
        else:
            self._backward_scaled(loss, **kwargs)
        if self.sync_gradients and self.state.backend is not None:
            self._all_reduce_gradients()

    def _backward_scaled(self, loss, **kwargs):
        unscaled = [o for o in self._optimizers if o._found_inf is not None]
        held = [[p.grad for p in o.parameters()] for o in unscaled]
        for o in unscaled:
            for p in o.parameters():
                p.grad = None
        ((loss / self.gradient_accumulation_steps) * self._loss_scale.scale).backward(**kwargs)
        for o, old in zip(unscaled, held):
            params = o.parameters()
            # the new contribution is unscaled and checked into the same flag
            o._unscale([p.grad for p in params if p.grad is not None])
            for p, g in zip(params, old):
                if g is not None:
                    p.grad = g if p.grad is None else g.add_(p.grad)

    def _all_reduce_gradients(self):
        """Average every prepared model's gradients across the group, one
        in-place all-reduce a gradient (each follows its contiguous
        parameter's layout). NCCL averages in the all-reduce (``AVG``,
        which launches its kernel at world size 1 too); gloo sums and the
        gradients are divided by the world size. Called by every process at
        the same point, and every process must hold the same gradients
        (``None`` on all or on none). An explicit all-reduce, not DDP:
        ``PreparedModel`` calls the module through ``functional_call``,
        which would skip DDP's ``forward``."""
        world = self.num_processes
        nccl = self.state.backend == "nccl"
        op = dist.ReduceOp.AVG if nccl else dist.ReduceOp.SUM
        grads = [p.grad for m in self._models for p in m.module.parameters() if p.grad is not None]
        # the span for the trace files; the profiler range so a profile
        # attributes the all-reduce's kernels to it
        with trace_span("collective/all_reduce_gradients", tensors=len(grads)), \
                torch.profiler.record_function("collective/all_reduce_gradients"):
            for g in grads:
                dist.all_reduce(g, op=op)
            if not nccl and world > 1 and grads:
                torch._foreach_div_(grads, world)
            # a clip mid-accumulation checked this process's gradients
            # before the average: every process takes any one's flag
            for o in self._optimizers:
                if o._found_inf is not None:
                    dist.all_reduce(o._found_inf, op=dist.ReduceOp.MAX)

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
        """No gradient all-reduce inside the context: gradients accumulate
        locally, and the next sync step's ``backward`` averages the sum."""
        old = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(old)

    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables, even_batches=None):
        """Even batches are the data contract here (every process takes the
        same number of steps); the context only sets ``even_batches`` for the
        loaders prepared inside it."""
        if even_batches is None:
            yield
            return
        old = self.even_batches
        self.even_batches = even_batches
        try:
            yield
        finally:
            self.even_batches = old

    # -- collectives ---------------------------------------------------------

    def gather(self, tensor):
        """Every process's tensors concatenated on dim 0 (:func:`.operations.gather`)."""
        return ops.gather(tensor)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """:meth:`gather`, with the rows the last batch repeated to even out
        the processes dropped (``GradientState.remainder``), so an eval loop
        sees each sample once. Objects without a batch dimension go through
        ``gather_object``."""
        if use_gather_object or ops.find_batch_size(input_data) is None:
            return ops.gather_object(input_data if isinstance(input_data, list) else [input_data])
        data = ops.gather(input_data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            data = ops.recursively_apply(lambda t: t[:remainder] if t.ndim > 0 else t, data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        return ops.reduce(tensor, reduction=reduction, scale=scale)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return ops.pad_across_processes(tensor, dim=dim, pad_index=pad_index,
                                        pad_first=pad_first)

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

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

    def _optimizers_of(self, params: list[torch.Tensor]) -> list[AcceleratedOptimizer]:
        ids = {id(p) for p in params}
        return [o for o in self._optimizers if any(id(p) in ids for p in o.parameters())]

    def clip_grad_norm_(self, parameters, max_norm, norm_type=2):
        """Scale the gradients by ``min(1, max_norm / (norm + 1e-6))`` and
        return the pre-clip global norm as a tensor (no host sync). Under
        fp16 the gradients are unscaled first, so the clip and the norm are
        in true gradient units."""
        params = self._parameters(parameters)
        for opt in self._optimizers_of(params):
            opt.unscale_gradients()
        return torch.nn.utils.clip_grad_norm_(params, max_norm, norm_type=norm_type)

    def clip_grad_value_(self, parameters, clip_value):
        """Clamp every gradient into ``[-clip_value, clip_value]``, unscaled
        first under fp16."""
        params = self._parameters(parameters)
        for opt in self._optimizers_of(params):
            opt.unscale_gradients()
        torch.nn.utils.clip_grad_value_(params, clip_value)

    def unscale_gradients(self, optimizer=None):
        """Unscale the fp16 gradients of ``optimizer`` (every prepared
        optimizer by default) in place; idempotent until the next step."""
        for opt in [optimizer] if optimizer is not None else self._optimizers:
            opt.unscale_gradients()

    @contextlib.contextmanager
    def autocast(self, autocast_handler: AutocastKwargs | None = None):
        """With ``AutocastKwargs(enabled=False)``, suspend both precision
        policies of every prepared model, the compute dtype and the fp8
        recipe, for the context: a full-precision island inside a
        mixed-precision run. Calls made inside it run at f32; the policies
        are read when a model is called, so the island binds there."""
        if autocast_handler is None or getattr(autocast_handler, "enabled", True):
            yield
            return
        saved = [(m, m.compute_dtype, m.fp8_recipe) for m in self._models]
        for m, _, _ in saved:
            m.compute_dtype = None
            m.fp8_recipe = None
        try:
            yield
        finally:
            for m, dtype, recipe in saved:
                m.compute_dtype = dtype
                m.fp8_recipe = recipe

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        return extract_model_from_parallel(model, keep_fp32_wrapper)

    def __repr__(self):
        return (f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r}, "
                f"num_processes={self.num_processes})")
