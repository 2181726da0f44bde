"""The ``Accelerator`` (port of the subset of ``accelerate_tpu/accelerator.py``
that the 5-line training loop, its evaluation and its state use)::

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
island.

The loop's state (:mod:`.checkpointing`): ``save_state`` / ``load_state``
(sync, ``async_save=True``, ``sharded=True``) under ``project_dir`` with
``ProjectConfiguration``'s rotation, ``register_for_checkpointing``,
``save_model``. ``fault_tolerance=`` (:class:`FaultTolerancePlugin`) arms
the preemption handler: a SIGTERM takes ONE emergency save at the next
step boundary and exits with the plugin's code; a relaunch with
``ACCELERATE_AUTO_RESUME=true`` resumes in ``prepare`` from the newest
checkpoint that validates. ``log_with=`` picks the trackers
(:mod:`.tracking`: ``init_trackers``, ``log``, ``end_training``);
``diagnostics=`` (:class:`DiagnosticsPlugin`) the tracer and the hang
watchdog. The plugins (FSDP, DeepSpeed, Megatron-LM, context parallel), a
mesh with axes other than ``dp``, ``telemetry=``, ``sanitize=`` and the
profiling and DDP handlers are not ported yet and raise.
"""

from __future__ import annotations

import contextlib
import logging
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
    DiagnosticsPlugin,
    FaultTolerancePlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    MeshPlugin,
    ProjectConfiguration,
)
from .utils.environment import parse_flag_from_env

logger = logging.getLogger(__name__)

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
        log_with=None,
        project_dir: str | None = None,
        project_config: ProjectConfiguration | None = None,
        gradient_accumulation_plugin: GradientAccumulationPlugin | None = None,
        step_scheduler_with_optimizer: bool = True,
        even_batches: bool = True,
        use_seedable_sampler: bool = False,
        kwargs_handlers: list | None = None,
        fault_tolerance: FaultTolerancePlugin | bool | None = None,
        diagnostics: DiagnosticsPlugin | bool | None = None,
    ):
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
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
        self.flag_tensor = None
        self._models: list[PreparedModel] = []
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[DataLoaderShard] = []
        self._custom_objects: list = []
        self._training_started = False

        from .tracking import filter_trackers

        self.log_with = filter_trackers(log_with, self.logging_dir)
        self.trackers = []
        self._init_diagnostics(diagnostics)
        self._init_fault_tolerance(fault_tolerance)

    def _init_diagnostics(self, diagnostics):
        """The tracer and the hang watchdog (``diagnostics=`` or
        ``ACCELERATE_DIAGNOSTICS=1``). The newest Accelerator owns the
        process-wide tracer and watchdog: a stale one is stopped."""
        from .diagnostics.tracing import NULL_TRACER, Tracer, get_tracer, set_active_tracer
        from .diagnostics.watchdog import Watchdog, get_active_watchdog
        from .telemetry import get_active_recorder

        if diagnostics is None:
            diagnostics = parse_flag_from_env("ACCELERATE_DIAGNOSTICS")
        if diagnostics is True:
            diagnostics = DiagnosticsPlugin()
        elif diagnostics is False:
            diagnostics = None
        self.diagnostics_plugin: DiagnosticsPlugin | None = diagnostics
        self.tracer = NULL_TRACER
        self.watchdog = None
        if diagnostics is None:
            return
        stale_watchdog = get_active_watchdog()
        if stale_watchdog is not None:
            stale_watchdog.stop()
        stale_tracer = get_tracer()
        if stale_tracer:
            stale_tracer.close()
        if diagnostics.tracing:
            self.tracer = Tracer(logging_dir=self.logging_dir,
                                 buffer_events=diagnostics.trace_buffer_events)
            set_active_tracer(self.tracer)
        if diagnostics.watchdog:
            recorder = get_active_recorder()
            self.watchdog = Watchdog(
                logging_dir=self.logging_dir,
                multiplier=diagnostics.watchdog_multiplier,
                floor_seconds=diagnostics.watchdog_floor_seconds,
                check_interval_seconds=diagnostics.watchdog_check_seconds,
                ema_alpha=diagnostics.watchdog_ema_alpha,
                heartbeat_interval_seconds=diagnostics.heartbeat_interval_seconds,
                grace_seconds=diagnostics.watchdog_grace_seconds,
                telemetry_tail=diagnostics.watchdog_telemetry_tail,
                preempt_on_hang=diagnostics.preempt_on_hang,
                telemetry=recorder if recorder else None,
            )
            self.watchdog.start()

    def _init_fault_tolerance(self, fault_tolerance):
        """The preemption handler (``fault_tolerance=``,
        ``ACCELERATE_FAULT_TOLERANCE=1``, or — so a relaunch is
        preemption-safe too — ``ACCELERATE_AUTO_RESUME=1``)."""
        if fault_tolerance is None and (parse_flag_from_env("ACCELERATE_FAULT_TOLERANCE")
                                        or parse_flag_from_env("ACCELERATE_AUTO_RESUME")):
            fault_tolerance = True
        if fault_tolerance is True:
            fault_tolerance = FaultTolerancePlugin()
        elif fault_tolerance is False:
            fault_tolerance = None
        self.fault_tolerance_plugin: FaultTolerancePlugin | None = fault_tolerance
        self._preemption_handler = None
        self._ft_boundary_count = 0
        self._ft_deferred_boundaries = 0
        if fault_tolerance is not None:
            fault_tolerance.export_io_env()
            from .resilience.preemption import PreemptionHandler

            self._preemption_handler = PreemptionHandler(
                handle_sigint=fault_tolerance.handle_sigint,
                monitor_maintenance=fault_tolerance.monitor_maintenance,
                poll_seconds=fault_tolerance.maintenance_poll_seconds,
                handle_signals=fault_tolerance.handle_signals,
            )
            self._preemption_handler.install()

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

    @property
    def project_dir(self) -> str | None:
        return self.project_configuration.project_dir

    @property
    def logging_dir(self) -> str | None:
        return self.project_configuration.logging_dir

    @property
    def save_iteration(self) -> int:
        return self.project_configuration.iteration

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
        through. Order is preserved. Under auto-resume the newest valid
        checkpoint is then loaded into what is prepared
        (:meth:`_maybe_auto_resume`)."""
        with trace_span("prepare", n_objects=len(args)):
            return self._prepare_inner(*args, device_placement=device_placement)

    def _prepare_inner(self, *args, device_placement: list[bool] | None = None):
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
        self._maybe_auto_resume()
        return result[0] if len(result) == 1 else tuple(result)

    # -- fault tolerance -----------------------------------------------------

    @property
    def preemption_requested(self) -> bool:
        """Has a SIGTERM/SIGINT/maintenance event raised the LOCAL
        preemption flag? (The processes agree in :meth:`check_preemption`.)"""
        return (self._preemption_handler is not None
                and self._preemption_handler.preemption_requested)

    def check_preemption(self):
        """The step-boundary preemption check (called from ``backward``; an
        eval loop may call it itself). Every ``consensus_interval``
        boundaries the flag is all-reduced across the processes; on
        agreement ONE emergency ``save_state()`` runs and the process exits
        with the plugin's code and a sentinel file.

        Mid-accumulation (gradients already accumulated) the save is
        DEFERRED to the window's end, as in the JAX package, bounded at
        ``max(2 × window, 4)`` deferrals. The batch whose ``backward``
        triggered the check never trains: the resume is within ONE
        optimizer step of the signal."""
        handler = self._preemption_handler
        if handler is None:
            return
        plugin = self.fault_tolerance_plugin
        self._ft_boundary_count += 1
        if self.num_processes > 1:
            if self._ft_boundary_count % plugin.consensus_interval != 0:
                return
            preempt = handler.consensus()
        else:
            preempt = handler.preemption_requested
        if not preempt:
            return
        # a clean window boundary: no accumulated gradients (the same on
        # every process: all run the same schedule)
        clean = all(p.grad is None for o in self._optimizers for p in o.parameters())
        if not clean:
            self._ft_deferred_boundaries += 1
            if self._ft_deferred_boundaries <= max(2 * self.gradient_accumulation_steps, 4):
                return
            logger.warning("emergency save forced mid-accumulation after %d deferrals "
                           "(the partial gradient window is dropped)",
                           self._ft_deferred_boundaries)
        self._emergency_save_and_exit()

    def _emergency_save_and_exit(self):
        from .telemetry import get_active_recorder

        handler = self._preemption_handler
        plugin = self.fault_tolerance_plugin
        reason = handler.reason or "preemption"
        logger.warning("preemption consensus (%s): emergency checkpoint", reason)
        if self.watchdog is not None:
            # the save may take longer than a step deadline
            self.watchdog.stop()
        checkpoint = None
        if plugin.save_on_preemption:
            if self.project_dir is None:
                logger.warning("emergency save skipped: no project_dir configured on "
                               "this Accelerator")
            else:
                try:
                    # synchronous on purpose: durability outranks step time
                    # when the machine is about to go
                    checkpoint = self.save_state(async_save=False)
                except Exception:
                    logger.error("emergency save FAILED", exc_info=True)
        recorder = get_active_recorder()
        if recorder:
            recorder.record_event("preemption", reason=reason, checkpoint=checkpoint,
                                  step=self.step)
        if self.tracer:
            self.tracer.instant("preemption", reason=reason)
            self.tracer.close()
        sentinel_dir = (os.path.join(self.project_dir, "checkpoints")
                        if self.project_dir is not None else os.getcwd())
        if self.is_main_process:
            handler.write_sentinel(sentinel_dir, checkpoint, self.step)
        handler.uninstall()
        logger.warning("exiting cleanly after preemption (checkpoint=%s, exit_code=%d)",
                       checkpoint, plugin.exit_code)
        raise SystemExit(plugin.exit_code)

    def _maybe_auto_resume(self):
        """Under ``FaultTolerancePlugin(auto_resume=True)`` or
        ``ACCELERATE_AUTO_RESUME=true``, load the newest checkpoint under
        ``{project_dir}/checkpoints`` whose manifest validates into what is
        prepared. It runs again on every ``prepare`` until the first
        ``backward`` (a script may prepare its objects over several calls),
        and never after. With several processes the main process picks the
        checkpoint and broadcasts its choice."""
        if self._training_started:
            return
        plugin_resume = (self.fault_tolerance_plugin is not None
                         and self.fault_tolerance_plugin.auto_resume)
        if not (plugin_resume or parse_flag_from_env("ACCELERATE_AUTO_RESUME")):
            return
        if self.project_dir is None:
            return
        from .resilience.manifest import SENTINEL_NAME, find_latest_valid_checkpoint

        checkpoints_dir = os.path.join(self.project_dir, "checkpoints")
        if self.num_processes > 1:
            choice = [find_latest_valid_checkpoint(checkpoints_dir)
                      if self.is_main_process else None]
            latest = ops.broadcast_object_list(choice)[0]
        else:
            latest = find_latest_valid_checkpoint(checkpoints_dir)
        if latest is None:
            if not getattr(self, "_auto_resume_warned", False):
                self._auto_resume_warned = True
                logger.warning("auto-resume is on but no valid checkpoint_* exists under "
                               "%s; starting fresh", checkpoints_dir)
            return
        logger.info("auto-resuming from %s", latest)
        self.load_state(latest)
        sentinel = os.path.join(checkpoints_dir, SENTINEL_NAME)
        if self.is_main_process and os.path.exists(sentinel):
            # consumed: this run IS the resume the sentinel asked for
            try:
                os.remove(sentinel)
            except OSError:
                pass

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
        self._training_started = True  # freezes auto-resume (_maybe_auto_resume)
        if self._preemption_handler is not None:
            # a step boundary: the previous step is applied, this one has
            # not staged yet — the one consistent point to emergency-save
            self.check_preemption()
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

    # -- the trigger ---------------------------------------------------------

    def set_trigger(self):
        """Raise this process's trigger; :meth:`check_trigger` on every
        process then sees it."""
        self.flag_tensor = torch.ones((), dtype=torch.int32, device=self.device)

    def check_trigger(self) -> bool:
        """Did any process :meth:`set_trigger`? A collective under a process
        group; a raised trigger is cleared when seen."""
        flag = (self.flag_tensor if self.flag_tensor is not None
                else torch.zeros((), dtype=torch.int32, device=self.device))
        triggered = bool(ops.reduce(flag, reduction="sum") >= 1)
        if triggered:
            self.flag_tensor = None
        return triggered

    # -- memory --------------------------------------------------------------

    def free_memory(self, *objects):
        """Drop the prepared references and return ``objects`` as ``None``s
        (``a, b = accelerator.free_memory(a, b)``), then collect garbage and
        empty the card's cache (:func:`.utils.memory.release_memory`)."""
        from .utils.memory import release_memory

        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        self.step = 0
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    def get_state_dict(self, model, unwrap: bool = True):
        """The model's ``state_dict`` (the f32 masters under a compute dtype)."""
        return extract_model_from_parallel(model).state_dict()

    # -- checkpointing (:mod:`.checkpointing`) -------------------------------

    def register_for_checkpointing(self, *objects):
        """Add objects with ``state_dict``/``load_state_dict`` to what
        ``save_state`` / ``load_state`` carry (``custom_checkpoint_<i>.pkl``)."""
        for obj in objects:
            if not (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict")):
                raise ValueError(f"{obj} must define state_dict/load_state_dict to be registered")
        self._custom_objects.extend(objects)

    def save_state(self, output_dir: str | None = None, **save_model_func_kwargs):
        """:func:`.checkpointing.save_accelerator_state` (``async_save=``,
        ``sharded=``, ``safe_serialization=``); returns the directory."""
        from .checkpointing import save_accelerator_state

        return save_accelerator_state(self, output_dir, **save_model_func_kwargs)

    def load_state(self, input_dir: str | None = None, **load_model_func_kwargs):
        """:func:`.checkpointing.load_accelerator_state`; returns the directory."""
        from .checkpointing import load_accelerator_state

        return load_accelerator_state(self, input_dir, **load_model_func_kwargs)

    def save_model(self, model, save_directory: str, max_shard_size="10GB",
                   safe_serialization: bool = True):
        """The weights as ``model.safetensors`` (or shards with an index)
        for ``load_checkpoint_and_dispatch``."""
        from .checkpointing import save_model_weights

        return save_model_weights(self, model, save_directory, max_shard_size,
                                  safe_serialization)

    def save(self, obj, f, safe_serialization: bool = False):
        """Pickle ``obj`` to ``f`` on the main process."""
        from .checkpointing import save_object

        if self.is_main_process:
            save_object(obj, f, safe_serialization=safe_serialization)

    # -- tracking (:mod:`.tracking`) -----------------------------------------

    def init_trackers(self, project_name: str, config: dict | None = None,
                      init_kwargs: dict | None = None):
        from .tracking import init_trackers

        self.trackers = init_trackers(self.log_with, project_name, self.logging_dir, config,
                                      init_kwargs or {})

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if getattr(tracker, "name", None) == name:
                return tracker.tracker if unwrap else tracker
        from .tracking import GeneralTracker

        return GeneralTracker(_blank=True)

    def log(self, values: dict, step: int | None = None, log_kwargs: dict | None = None):
        for tracker in self.trackers:
            tracker.log(values, step=step, **(log_kwargs or {}).get(tracker.name, {}))

    def end_training(self):
        """Finish the trackers, stop the watchdog and the tracer, uninstall
        the preemption handler, and land and commit a trailing async save."""
        from .checkpointing import _join_writer_then_barrier

        for tracker in self.trackers:
            tracker.finish()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.tracer.close()
        if self._preemption_handler is not None:
            self._preemption_handler.uninstall()
        # the barriered join is the only place a multi-process commit is safe
        _join_writer_then_barrier(self)
        self.wait_for_everyone()

    def __repr__(self):
        return (f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r}, "
                f"num_processes={self.num_processes})")
