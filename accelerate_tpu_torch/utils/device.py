"""Device resolution: every entry point runs on the card unless asked not to."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without CUDA present raises
    instead of quietly running on the CPU: the caller must say
    ``device="cpu"`` to get the plain PyTorch paths."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' (serve: "
            "--device cpu) to run the plain PyTorch paths on the CPU"
        )
    return device
