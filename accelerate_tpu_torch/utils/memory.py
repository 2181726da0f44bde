"""Out-of-memory retries (port of ``accelerate_tpu/utils/memory.py``).

``find_executable_batch_size`` halves the batch size when the function
runs the card out of memory: a ``torch.OutOfMemoryError`` (the caching
allocator's), or a CUDA, cuBLAS or cuDNN error whose message says it could
not allocate. Where the JAX package reads the device's ``memory_stats``,
:func:`get_device_memory_info` reads ``torch.cuda.mem_get_info`` and the
allocator's ``memory_stats``.
"""

from __future__ import annotations

import functools
import gc
import inspect
import logging

import torch

logger = logging.getLogger(__name__)

#: what the CUDA runtime, the caching allocator, cuBLAS and cuDNN say when
#: an allocation fails (the reference's list)
_OOM_MESSAGES = (
    "CUDA out of memory.",
    "cuDNN error: CUDNN_STATUS_NOT_SUPPORTED.",
    "DefaultCPUAllocator: can't allocate memory",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "CUDA error: out of memory",
)


def release_memory(*objects):
    """Drop the references in ``objects`` (returned as ``None``s, for
    ``a, b = release_memory(a, b)``), collect garbage and hand the caching
    allocator's free blocks back to the card."""
    objects = [None] * len(objects)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return objects


def should_reduce_batch_size(exception: BaseException) -> bool:
    """Does ``exception`` say the device ran out of memory?"""
    if isinstance(exception, torch.OutOfMemoryError):
        return True
    if isinstance(exception, RuntimeError) and len(exception.args) == 1:
        return any(m in str(exception.args[0]) for m in _OOM_MESSAGES)
    return False


def find_executable_batch_size(function=None, starting_batch_size: int = 128):
    """Decorator: call ``function(batch_size, *args, **kwargs)``, halving
    ``batch_size`` each time it runs out of memory, until it fits (raises
    at 0). The failed try's exception, and with it the frames that hold its
    tensors, is dropped before the memory is released and the next size
    runs: a retry made inside the ``except`` block would keep them alive."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)

    batch_size = starting_batch_size

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        nonlocal batch_size
        gc.collect()
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < 1 or params[0] != "batch_size":
            raise TypeError(f"{function.__name__} must take `batch_size` as its first argument")
        while True:
            if batch_size == 0:
                raise RuntimeError("no executable batch size found: reached zero")
            oom = False
            try:
                return function(batch_size, *args, **kwargs)
            except Exception as e:  # noqa: BLE001 — re-raised unless an OOM
                if not should_reduce_batch_size(e):
                    raise
                oom = True
                # the traceback holds the failed try's frames and tensors
                e.__traceback__ = None
            if oom:
                logger.info("batch size %d exhausted device memory; retrying with %d",
                            batch_size, batch_size // 2)
                release_memory()
                batch_size //= 2

    return wrapper


def get_device_memory_info(device=None) -> dict:
    """The card's memory: ``bytes_in_use`` / ``peak_bytes_in_use`` (the
    caching allocator's allocated bytes), ``bytes_reserved``, and
    ``bytes_free`` / ``bytes_limit`` from ``cudaMemGetInfo``; ``{}``
    without a card."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_reserved": stats.get("reserved_bytes.all.current"),
        "bytes_free": free,
        "bytes_limit": total,
        "num_ooms": stats.get("num_ooms"),
    }
