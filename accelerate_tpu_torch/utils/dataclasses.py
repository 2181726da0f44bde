"""Enums and plugins the training loop reads (port of the subset of
``accelerate_tpu/utils/dataclasses.py`` that the port runs: precision and
its kwargs handlers, gradient accumulation, the data loader's
configuration, a data-parallel mesh, the project layout and the fault
tolerance and diagnostics plugins). The other plugins and launch configs
are later slices; passing one to ``Accelerator`` raises "not yet
ported"."""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field, fields
from datetime import timedelta
from typing import Any

from .environment import parse_flag_from_env, str_to_bool


class BaseEnum(str, enum.Enum):
    def __str__(self) -> str:  # so f-strings / env writes produce bare values
        return self.value

    @classmethod
    def list(cls) -> list[str]:
        return [e.value for e in cls]


class DistributedType(BaseEnum):
    """Execution environment, decided by the device count as the JAX
    package decides it (``accelerate_tpu/state.py``): ``NO`` for one
    device, whether or not a process group is up. The JAX values map so:

    * ``TPU`` (one process driving several chips through a mesh) and
      ``MULTI_HOST_TPU`` (``jax.distributed`` across hosts) become
      ``MULTI_GPU``: one process a card, an NCCL process group;
    * ``CPU_MESH`` (a forced host-platform mesh for tests) becomes
      ``MULTI_CPU``: several CPU processes under a gloo process group.
    """

    NO = "NO"
    MULTI_GPU = "MULTI_GPU"
    MULTI_CPU = "MULTI_CPU"


class RNGType(BaseEnum):
    """The host generators ``synchronize_rng_state`` can broadcast."""

    TORCH = "torch"
    NUMPY = "numpy"
    PYTHON = "python"
    GENERATOR = "generator"


class PrecisionType(BaseEnum):
    NO = "no"
    FP32 = "fp32"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"
    INT8 = "int8"


#: precisions the port runs: "no"/"fp32" keep f32 compute; "bf16" and
#: "fp16" run the model in that dtype over f32 master weights (fp16 with the
#: dynamic loss scaler, :class:`~accelerate_tpu_torch.optimizer.LossScaler`);
#: "fp8" runs bf16 with the projections as scaled-fp8 products
#: (:mod:`~accelerate_tpu_torch.ops.fp8`); "int8" runs at f32, as the JAX
#: package runs it (its ``compute_dtype`` has no int8 entry: int8 is a
#: loading format, not a compute dtype)
PORTED_PRECISIONS = ("no", "fp32", "bf16", "fp16", "fp8", "int8")


def validate_mixed_precision(mixed_precision: str) -> str:
    """The canonical precision name; raises ``ValueError`` for an unknown
    name."""
    value = PrecisionType(mixed_precision).value
    if value not in PORTED_PRECISIONS:
        raise ValueError(
            f"mixed_precision={value!r} is not yet ported (this slice runs "
            f"{', '.join(PORTED_PRECISIONS)})"
        )
    return value


@dataclass
class KwargsHandler:
    """Base for kwargs-passthrough dataclasses."""

    def to_dict(self) -> dict[str, Any]:
        return dict(self.__dict__)

    def to_kwargs(self) -> dict[str, Any]:
        """The fields that differ from their defaults."""
        default = self.__class__()
        return {k: v for k, v in self.to_dict().items() if getattr(default, k) != v}


@dataclass
class AutocastKwargs(KwargsHandler):
    """``enabled=False`` makes ``Accelerator.autocast(autocast_handler=...)``
    suspend the compute dtype and the fp8 recipe for the context: a
    full-precision island inside a mixed-precision run. ``cache_enabled``
    belongs to ``torch.autocast`` and is accepted for parity; the port casts
    weights itself (:class:`~accelerate_tpu_torch.modules.PreparedModel`)."""

    enabled: bool = True
    cache_enabled: bool | None = None


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """Process-group bring-up: ``coordinator_address``, ``num_processes``
    and ``process_id`` as the launch environment names them, and
    ``timeout``, how long a collective waits for its peers before the group
    fails it (``torch.distributed.init_process_group``'s ``timeout``)."""

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    timeout: timedelta = field(default_factory=lambda: timedelta(seconds=1800))


@dataclass
class GradScalerKwargs(KwargsHandler):
    """The fp16 dynamic loss scaler's schedule: the scale starts at
    ``init_scale``, backs off by ``backoff_factor`` on a non-finite
    gradient and grows by ``growth_factor`` after ``growth_interval``
    consecutive finite steps (:class:`~accelerate_tpu_torch.optimizer.LossScaler`).
    Read only under ``mixed_precision="fp16"``; ``enabled=False`` turns the
    scaling off."""

    init_scale: float = 65536.0
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """Gradient accumulation over ``num_steps`` micro-batches under
    ``Accelerator.accumulate``. The JAX ``fuse_in_step`` (the micro-batch
    loop inside one compiled step) is not ported."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False
    fuse_in_step: bool = False

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {self.num_steps}")
        if self.fuse_in_step:
            raise ValueError("GradientAccumulationPlugin(fuse_in_step=True) is not yet ported")


#: the mesh axes of the JAX package (``MESH_AXIS_ORDER``); the port runs a
#: ``dp`` axis only
MESH_AXIS_ORDER = ("dp", "pp", "fsdp", "ep", "cp", "tp")


@dataclass
class MeshPlugin(KwargsHandler):
    """The mesh's shape (port of ``MeshPlugin``). The port takes the data
    axis only: ``dp`` is the process count (``-1``: every process); any
    other axis above 1 raises, since sharded and pipelined parallelism are
    ROADMAP item 18. ``ACCELERATE_MESH_<AXIS>`` overrides a field, as in
    the JAX package."""

    dp: int = -1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    cp: int = 1
    tp: int = 1
    devices: Any = None
    allow_split_physical_axes: bool = False

    def __post_init__(self):
        for ax in MESH_AXIS_ORDER:
            env = os.environ.get(f"ACCELERATE_MESH_{ax.upper()}")
            if env is not None:
                setattr(self, ax, int(env))
        wide = {ax: getattr(self, ax) for ax in MESH_AXIS_ORDER[1:] if getattr(self, ax) != 1}
        if wide:
            raise ValueError(
                f"MeshPlugin axes {wide} are not yet ported: the port runs a data-parallel "
                "'dp' axis only (sharded and pipelined meshes are ROADMAP item 18)"
            )
        if self.devices is not None:
            raise ValueError("MeshPlugin(devices=...) is not yet ported: the port's mesh "
                             "is one card a process")

    def axis_sizes(self, num_devices: int) -> dict[str, int]:
        """``{"dp": num_devices}``; a fixed ``dp`` must equal the count."""
        if self.dp not in (-1, num_devices):
            raise ValueError(f"mesh shape dp={self.dp} != device count {num_devices}")
        return {ax: (num_devices if ax == "dp" else 1) for ax in MESH_AXIS_ORDER}


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """How ``Accelerator.prepare`` rebuilds a data loader (port of
    ``DataLoaderConfiguration``). Every flag is also reachable as
    ``ACCELERATE_<NAME>``; an explicit non-default argument wins over the
    environment. ``use_stateful_dataloader`` is kept for the API: every
    prepared loader has ``state_dict`` and ``load_state_dict``."""

    split_batches: bool = False
    dispatch_batches: bool | None = None
    even_batches: bool = True
    use_seedable_sampler: bool = False
    non_blocking: bool = False
    use_stateful_dataloader: bool = False
    #: batches collated ahead on a host thread; 0 (the default, unlike the
    #: JAX package's 2) collates on the loop's thread, as fast on the card
    prefetch_batches: int = 0

    def __post_init__(self):
        defaults = {f.name: f.default for f in fields(self)}
        for name in ("split_batches", "even_batches", "use_seedable_sampler",
                     "non_blocking", "use_stateful_dataloader", "dispatch_batches"):
            env = os.environ.get(f"ACCELERATE_{name.upper()}")
            if env is not None and getattr(self, name) == defaults[name]:
                setattr(self, name, bool(str_to_bool(env)))
        env = os.environ.get("ACCELERATE_PREFETCH_BATCHES")
        if env is not None and self.prefetch_batches == defaults["prefetch_batches"]:
            self.prefetch_batches = int(env)


@dataclass
class ProjectConfiguration:
    """Checkpoint and artifact layout (port of ``ProjectConfiguration``):
    ``save_state`` writes under ``{project_dir}/checkpoints``, trackers and
    diagnostics under ``logging_dir`` (``project_dir`` by default)."""

    project_dir: str | None = None
    logging_dir: str | None = None
    automatic_checkpoint_naming: bool = False
    total_limit: int | None = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: str | None = None) -> None:
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


@dataclass
class FaultTolerancePlugin(KwargsHandler):
    """Preemption-safe checkpointing and auto-resume (port of
    ``FaultTolerancePlugin``). Given to ``Accelerator(fault_tolerance=...)``
    it installs SIGTERM/SIGINT handlers (``handle_signals``): a preemption
    notice triggers ONE emergency ``save_state()`` at the next step
    boundary, then an exit with ``exit_code`` and a ``PREEMPTED.json``
    sentinel beside the checkpoints. ``prepare()`` resumes from the newest
    checkpoint whose manifest validates (``auto_resume``; also forced by
    ``ACCELERATE_AUTO_RESUME=1``). ``sharded_io`` switches ``save_state``
    to the per-process piece format; checkpoint IO retries ``io_attempts``
    times with ``io_backoff_seconds`` of exponential backoff, exported as
    ``ACCELERATE_FT_IO_ATTEMPTS`` / ``_BACKOFF`` so the background writer
    agrees. ``consensus_interval`` is the step cadence of the cross-process
    flag all-reduce: every process must use the same value."""

    auto_resume: bool = True
    save_on_preemption: bool = True
    handle_signals: bool = True
    handle_sigint: bool = True
    monitor_maintenance: bool = False
    maintenance_poll_seconds: float = 30.0
    consensus_interval: int = 1
    sharded_io: bool = True
    io_attempts: int = 3
    io_backoff_seconds: float = 0.5
    exit_code: int = 143  # 128 + SIGTERM: honest to the launcher's restart logic

    def __post_init__(self):
        env = os.environ
        if "ACCELERATE_AUTO_RESUME" in env:
            self.auto_resume = parse_flag_from_env("ACCELERATE_AUTO_RESUME", self.auto_resume)
        if "ACCELERATE_FT_SHARDED_IO" in env:
            self.sharded_io = parse_flag_from_env("ACCELERATE_FT_SHARDED_IO", self.sharded_io)
        if "ACCELERATE_FT_MONITOR_MAINTENANCE" in env:
            self.monitor_maintenance = parse_flag_from_env(
                "ACCELERATE_FT_MONITOR_MAINTENANCE", self.monitor_maintenance)
        if "ACCELERATE_FT_CONSENSUS_INTERVAL" in env:
            self.consensus_interval = int(env["ACCELERATE_FT_CONSENSUS_INTERVAL"])
        if "ACCELERATE_FT_IO_ATTEMPTS" in env:
            self.io_attempts = int(env["ACCELERATE_FT_IO_ATTEMPTS"])
        if "ACCELERATE_FT_IO_BACKOFF" in env:
            self.io_backoff_seconds = float(env["ACCELERATE_FT_IO_BACKOFF"])
        self.consensus_interval = max(1, int(self.consensus_interval))

    def export_io_env(self):
        """Publish the retry knobs where the checkpoint writers (the async
        background thread included) read their defaults."""
        os.environ["ACCELERATE_FT_IO_ATTEMPTS"] = str(self.io_attempts)
        os.environ["ACCELERATE_FT_IO_BACKOFF"] = str(self.io_backoff_seconds)


@dataclass
class DiagnosticsPlugin(KwargsHandler):
    """Tracing and the hang watchdog (port of ``DiagnosticsPlugin``).

    * ``tracing``: per-process Chrome/Perfetto span timelines under
      ``{logging_dir}/traces/host_<n>.trace.json``.
    * ``watchdog``: a deadline of ``max(watchdog_multiplier · EMA(step
      time), watchdog_floor_seconds)`` armed around each step; on expiry
      ``HANG_REPORT_<host>.json`` (thread stacks, open spans, the card's
      memory, the telemetry tail) and, with ``preempt_on_hang``, the
      emergency save. Heartbeat files under ``{logging_dir}/diagnostics``
      feed the ``monitor`` command.

    Env overrides: ``ACCELERATE_TRACING``, ``ACCELERATE_WATCHDOG``,
    ``ACCELERATE_WATCHDOG_MULTIPLIER``, ``_FLOOR_SECONDS``,
    ``_CHECK_SECONDS``, ``_GRACE_SECONDS`` and ``_PREEMPT``."""

    tracing: bool = True
    watchdog: bool = True
    watchdog_multiplier: float = 5.0
    watchdog_floor_seconds: float = 120.0
    watchdog_check_seconds: float = 5.0
    watchdog_ema_alpha: float = 0.2
    #: deadline while the open phase is compile/*, checkpoint/* or prepare
    #: (host-local, legitimately unbounded by step time)
    watchdog_grace_seconds: float = 1800.0
    watchdog_telemetry_tail: int = 50
    preempt_on_hang: bool = False
    heartbeat_interval_seconds: float = 5.0
    trace_buffer_events: int = 16

    def __post_init__(self):
        env = os.environ
        if "ACCELERATE_TRACING" in env:
            self.tracing = parse_flag_from_env("ACCELERATE_TRACING", self.tracing)
        if "ACCELERATE_WATCHDOG" in env:
            self.watchdog = parse_flag_from_env("ACCELERATE_WATCHDOG", self.watchdog)
        if "ACCELERATE_WATCHDOG_MULTIPLIER" in env:
            self.watchdog_multiplier = float(env["ACCELERATE_WATCHDOG_MULTIPLIER"])
        if "ACCELERATE_WATCHDOG_FLOOR_SECONDS" in env:
            self.watchdog_floor_seconds = float(env["ACCELERATE_WATCHDOG_FLOOR_SECONDS"])
        if "ACCELERATE_WATCHDOG_CHECK_SECONDS" in env:
            self.watchdog_check_seconds = float(env["ACCELERATE_WATCHDOG_CHECK_SECONDS"])
        if "ACCELERATE_WATCHDOG_GRACE_SECONDS" in env:
            self.watchdog_grace_seconds = float(env["ACCELERATE_WATCHDOG_GRACE_SECONDS"])
        if "ACCELERATE_WATCHDOG_PREEMPT" in env:
            self.preempt_on_hang = parse_flag_from_env("ACCELERATE_WATCHDOG_PREEMPT",
                                                       self.preempt_on_hang)
        self.watchdog_multiplier = max(1.0, float(self.watchdog_multiplier))
        self.watchdog_floor_seconds = max(0.0, float(self.watchdog_floor_seconds))
