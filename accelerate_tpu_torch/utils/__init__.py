from .dataclasses import DistributedType, GradientAccumulationPlugin, PrecisionType
from .device import resolve_device
from .random import set_seed

__all__ = [
    "DistributedType",
    "GradientAccumulationPlugin",
    "PrecisionType",
    "resolve_device",
    "set_seed",
]
