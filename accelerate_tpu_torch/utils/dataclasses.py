"""Enums and plugins the training loop reads (port of the subset of
``accelerate_tpu/utils/dataclasses.py`` that slice 2 needs). The other
plugins and launch configs are later slices; passing one to
``Accelerator`` raises "not yet ported"."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any


class BaseEnum(str, enum.Enum):
    def __str__(self) -> str:  # so f-strings / env writes produce bare values
        return self.value

    @classmethod
    def list(cls) -> list[str]:
        return [e.value for e in cls]


class DistributedType(BaseEnum):
    """Execution environment. One process on one device is all the port
    runs yet; process groups (NCCL on the card, gloo on the CPU) are a
    later slice."""

    NO = "NO"


class PrecisionType(BaseEnum):
    NO = "no"
    FP32 = "fp32"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"
    INT8 = "int8"


#: precisions the port runs: "no"/"fp32" keep f32 compute, "bf16" runs the
#: model in bf16 over f32 master weights
PORTED_PRECISIONS = ("no", "fp32", "bf16")


def validate_mixed_precision(mixed_precision: str) -> str:
    """The canonical precision name; raises ``ValueError`` for an unknown
    name and for fp16 (its dynamic loss scaler), fp8 and int8, which are
    not ported yet."""
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
