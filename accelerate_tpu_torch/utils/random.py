"""RNG control (port of ``set_seed``, the framework key and
``synchronize_rng_state(s)`` from ``accelerate_tpu/utils/random.py``).
The port draws from explicit ``torch.Generator``s; ``set_seed`` seeds the
global generators that user code and PyTorch's own initialisers read, and
the framework generator (:func:`get_generator`, JAX's framework key) that
checkpoint RNG bundles carry."""

from __future__ import annotations

import random

import numpy as np
import torch

#: the framework generator (a CPU ``torch.Generator``): seeded by
#: ``set_seed``, drawn from by code that takes no generator of its own, and
#: carried in checkpoint RNG bundles (JAX's ``_JAX_KEY``)
_GENERATOR: torch.Generator | None = None


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> int:
    """Seed Python, numpy, torch and, where a card is present, every CUDA
    generator; returns the seed used. ``device_specific`` offsets the seed
    by the process index; ``deterministic`` asks PyTorch for deterministic
    algorithms."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    global _GENERATOR
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    _GENERATOR = torch.Generator().manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    return seed


def get_generator() -> torch.Generator:
    """The framework generator (seeded from entropy if ``set_seed`` was
    never called)."""
    global _GENERATOR
    if _GENERATOR is None:
        _GENERATOR = torch.Generator()
        _GENERATOR.seed()
    return _GENERATOR


def generator_state() -> torch.Tensor | None:
    """The framework generator's state for checkpoint bundles (None if it
    was never made)."""
    return None if _GENERATOR is None else _GENERATOR.get_state()


def set_generator_state(state) -> None:
    if state is not None:
        get_generator().set_state(state)


def synchronize_rng_state(rng_type: str | None = None, generator=None) -> None:
    """Give every process the main process's host RNG state (port of
    ``synchronize_rng_state``): ``"torch"`` (the CPU generator), ``"numpy"``,
    ``"python"``, or ``"generator"`` (``generator``, e.g. a sampler's
    ``torch.Generator``). A collective when a process group is up: every
    process must call it at the same point."""
    from ..operations import broadcast_object_list
    from ..state import PartialState
    from .dataclasses import RNGType

    if PartialState().num_processes == 1 or rng_type is None:
        return
    rng_type = RNGType(rng_type)
    if rng_type == RNGType.TORCH:
        get, put = torch.get_rng_state, torch.set_rng_state
    elif rng_type == RNGType.NUMPY:
        get, put = np.random.get_state, np.random.set_state
    elif rng_type == RNGType.PYTHON:
        get, put = random.getstate, random.setstate
    elif generator is not None:
        get, put = generator.get_state, generator.set_state
    else:
        return
    payload = broadcast_object_list([get()])
    put(payload[0])


def synchronize_rng_states(rng_types, generator=None) -> None:
    for rng_type in rng_types:
        synchronize_rng_state(rng_type=rng_type, generator=generator)
