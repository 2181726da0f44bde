from .dataclasses import (
    DataLoaderConfiguration,
    DistributedType,
    GradientAccumulationPlugin,
    MeshPlugin,
    PrecisionType,
    RNGType,
)
from .device import resolve_device
from .environment import get_int_from_env, parse_flag_from_env, patch_environment, str_to_bool
from .random import set_seed, synchronize_rng_state, synchronize_rng_states

__all__ = [
    "DataLoaderConfiguration",
    "DistributedType",
    "GradientAccumulationPlugin",
    "MeshPlugin",
    "PrecisionType",
    "RNGType",
    "get_int_from_env",
    "parse_flag_from_env",
    "patch_environment",
    "resolve_device",
    "set_seed",
    "str_to_bool",
    "synchronize_rng_state",
    "synchronize_rng_states",
]
