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


def device_hbm_bytes(device=None) -> int | None:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``), or
    ``None`` on the CPU, which reports no device memory limit (port of
    ``accelerate_tpu/mesh.py:device_hbm_bytes``): the default budget of
    ``serve --auto-blocks``. ``device`` defaults to the current CUDA device
    when there is one."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(device)
    return int(total)
