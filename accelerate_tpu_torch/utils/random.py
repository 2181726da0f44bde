"""RNG control (port of ``set_seed`` from ``accelerate_tpu/utils/random.py``).
The port draws from explicit ``torch.Generator``s; ``set_seed`` seeds the
global generators that user code and PyTorch's own initialisers read."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> int:
    """Seed Python, numpy, torch and, where a card is present, every CUDA
    generator; returns the seed used. ``device_specific`` offsets the seed
    by the process index; ``deterministic`` asks PyTorch for deterministic
    algorithms."""
    if device_specific:
        from ..state import PartialState

        seed += PartialState().process_index
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
    if deterministic:
        torch.use_deterministic_algorithms(True)
    return seed
