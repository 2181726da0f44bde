"""Enums and plugins the training loop reads (port of the subset of
``accelerate_tpu/utils/dataclasses.py`` that the port runs: precision and
its kwargs handlers, gradient accumulation, the data loader's
configuration and a data-parallel mesh). The other plugins and launch
configs are later slices; passing one to ``Accelerator`` raises "not yet
ported"."""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field, fields
from datetime import timedelta
from typing import Any

from .environment import str_to_bool


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
