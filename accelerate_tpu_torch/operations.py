"""Collective operations over nested tensors (port of
``accelerate_tpu/operations.py``).

The JAX package exchanges host values across processes through
``jax.experimental.multihost_utils``. Here each process holds its own
tensors and the collectives are ``torch.distributed``'s, over the process
group :class:`~.state.PartialState` brought up: NCCL on the card, gloo on
the CPU. They run whenever a group is up, at world size 1 too, and give
there exactly what the single-process shortcut gives; without a group each
returns its input as the JAX package does with one process.

Named deviations from the JAX package:

* results stay tensors on their device, as the reference returns them,
  not host numpy;
* JAX's in-``jit`` helpers (``jops``: ``psum``, ``ppermute``, the ring
  shift) have no eager counterpart; they come with the ring (ROADMAP item
  18).

Each eager collective runs in a ``collective/<name>`` span, and under
``ACCELERATE_DEBUG_MODE=1`` the processes first check that they agree on
the operand's shapes and dtypes (:func:`verify_operation`).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from .diagnostics.tracing import traced


class DistributedOperationException(Exception):
    """Raised in debug mode when processes disagree on an operand's structure."""


def _traced_collective(function: Callable):
    """A span around an eager collective: where a multi-process hang sits,
    the open span names the operation."""
    return traced(f"collective/{function.__name__}")(function)


def _state():
    from .state import PartialState

    return PartialState()


def _group_up() -> bool:
    return _state().backend is not None


# ---------------------------------------------------------------------------
# nested-structure plumbing
# ---------------------------------------------------------------------------


def is_torch_tensor(x: Any) -> bool:
    return isinstance(x, torch.Tensor)


def _is_namedtuple(data) -> bool:
    return isinstance(data, tuple) and hasattr(data, "_fields")


def recursively_apply(func: Callable, data: Any, *args, test_type: Callable[[Any], bool] = is_torch_tensor,
                      error_on_other_type: bool = False, **kwargs):
    """``func`` applied to every leaf that passes ``test_type`` in nested
    lists, tuples (named too) and mappings; other leaves are kept unless
    ``error_on_other_type``."""
    if isinstance(data, (list, tuple)):
        mapped = (recursively_apply(func, o, *args, test_type=test_type,
                                    error_on_other_type=error_on_other_type, **kwargs)
                  for o in data)
        return type(data)(*mapped) if _is_namedtuple(data) else type(data)(mapped)
    if isinstance(data, Mapping):
        return type(data)({
            k: recursively_apply(func, v, *args, test_type=test_type,
                                 error_on_other_type=error_on_other_type, **kwargs)
            for k, v in data.items()
        })
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to {func.__name__}")
    return data


def _leaves(data: Any) -> list:
    out = []
    recursively_apply(out.append, data, test_type=lambda x: not isinstance(x, (list, tuple, Mapping)))
    return out


def send_to_device(tensor: Any, device=None, non_blocking: bool = False, skip_keys=None):
    """Every tensor of a nested structure moved to ``device``
    (``non_blocking`` for a copy from pinned memory); keys in ``skip_keys``
    of a top-level mapping stay where they are."""
    if skip_keys and isinstance(tensor, Mapping):
        if isinstance(skip_keys, str):
            skip_keys = [skip_keys]
        return type(tensor)({k: v if k in skip_keys else send_to_device(v, device, non_blocking)
                             for k, v in tensor.items()})
    return recursively_apply(lambda t: t.to(device, non_blocking=non_blocking), tensor)


def listify(data: Any):
    """Every tensor as nested Python lists."""
    return recursively_apply(lambda t: t.tolist(), data)


def convert_to_fp32(tensor: Any):
    """bf16 and fp16 tensors upcast to f32."""
    return recursively_apply(
        lambda t: t.float() if t.dtype in (torch.bfloat16, torch.float16) else t, tensor)


def find_batch_size(data: Any) -> int | None:
    """Dim 0 of the first tensor with one, else ``None``."""
    for leaf in _leaves(data):
        if isinstance(leaf, torch.Tensor) and leaf.ndim > 0:
            return leaf.shape[0]
    return None


def slice_tensors(data: Any, tensor_slice: slice, process_index=None, num_processes=None):
    """Every tensor sliced along dim 0."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def concatenate(data: list[Any], dim: int = 0):
    """A list of same-structure nested tensors concatenated leafwise."""
    if isinstance(data[0], (tuple, list)):
        return type(data[0])(concatenate([d[i] for d in data], dim=dim) for i in range(len(data[0])))
    if isinstance(data[0], Mapping):
        return type(data[0])({k: concatenate([d[k] for d in data], dim=dim) for k in data[0]})
    if not isinstance(data[0], torch.Tensor):
        raise TypeError(f"Cannot concatenate {type(data[0])}")
    return torch.cat(data, dim=dim)


# ---------------------------------------------------------------------------
# debug-mode verification
# ---------------------------------------------------------------------------


def verify_operation(function: Callable):
    """Under ``ACCELERATE_DEBUG_MODE`` every process must pass an operand of
    the same shapes and dtypes, or :class:`DistributedOperationException`
    names each process's."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        state = _state()
        if not state.debug or state.backend is None:
            return function(*args, **kwargs)
        tensor = kwargs.get("tensor", args[0] if args else None)
        meta = recursively_apply(lambda t: (tuple(t.shape), str(t.dtype)), tensor)
        all_meta = gather_object([meta])
        if not all(m == all_meta[0] for m in all_meta):
            raise DistributedOperationException(
                f"Mismatch between processes in {function.__name__}: "
                + "; ".join(f"process {i}: {m}" for i, m in enumerate(all_meta))
            )
        return function(*args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------------
# eager collectives
# ---------------------------------------------------------------------------

#: ``all_gather_single`` where this torch has it, else its older name
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@verify_operation
@_traced_collective
def gather(tensor: Any):
    """Every process's tensors concatenated on dim 0 in process order (a
    0-d tensor counts as one row); each process gets the whole."""
    if not _group_up():
        return tensor
    world = _state().num_processes

    def _gather(t):
        t = t.reshape(1) if t.ndim == 0 else t.contiguous()
        out = t.new_empty((world * t.shape[0],) + tuple(t.shape[1:]))
        _all_gather_into(out, t)
        return out

    return recursively_apply(_gather, tensor)


@_traced_collective
def gather_object(object: list[Any]) -> list[Any]:
    """Every process's list of picklable objects, concatenated in process
    order; the payloads may differ in size."""
    state = _state()
    if state.backend is None:
        return list(object)
    out = [None] * state.num_processes
    dist.all_gather_object(out, list(object))
    return [x for part in out for x in part]


@verify_operation
@_traced_collective
def broadcast(tensor: Any, from_process: int = 0):
    """Every tensor replaced, in place where it is contiguous, by
    ``from_process``'s; returns the result."""
    if not _group_up():
        return tensor

    def _bcast(t):
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src=from_process)
        if buf is not t:
            t.copy_(buf)
        return t

    return recursively_apply(_bcast, tensor)


@_traced_collective
def broadcast_object_list(object_list: list[Any], from_process: int = 0) -> list[Any]:
    """``object_list`` filled in place with ``from_process``'s picklable objects."""
    if _group_up():
        dist.broadcast_object_list(object_list, src=from_process)
    return object_list


@verify_operation
@_traced_collective
def reduce(tensor: Any, reduction: str = "mean", scale: float = 1.0):
    """Every process's tensors summed elementwise, times ``scale``, divided
    by the process count under ``"mean"``; each process gets the result.
    Without a group: the tensor times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    state = _state()
    if state.backend is None:
        return recursively_apply(lambda t: t * scale, tensor)

    def _reduce(t):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        out = out * scale
        return out / state.num_processes if reduction == "mean" else out

    return recursively_apply(_reduce, tensor)


def gather_sizes_across_processes(size: int) -> list[int]:
    """Every process's value of one Python int, in process order."""
    state = _state()
    if state.backend is None:
        return [size]
    t = torch.tensor([size], dtype=torch.int64, device=state.device)
    return [int(s) for s in gather(t).tolist()]


@verify_operation
@_traced_collective
def pad_across_processes(tensor: Any, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Every tensor padded with ``pad_index`` along ``dim`` to the largest
    size any process holds there (at the front with ``pad_first``), so a
    :func:`gather` can concatenate them."""
    if not _group_up():
        return tensor

    def _pad(t):
        if dim >= t.ndim:
            return t
        sizes = gather_sizes_across_processes(t.shape[dim])
        max_size = max(sizes)
        if max_size == t.shape[dim]:
            return t
        shape = list(t.shape)
        shape[dim] = max_size
        out = t.new_full(shape, pad_index)
        index = slice(max_size - t.shape[dim], max_size) if pad_first else slice(0, t.shape[dim])
        out[(slice(None),) * dim + (index,)] = t
        return out

    return recursively_apply(_pad, tensor)


def pad_input_tensors(tensor: Any, batch_size: int, num_processes: int, dim: int = 0):
    """A batch padded, by repeating its last row, to a multiple of
    ``num_processes`` along ``dim``."""
    remainder = batch_size % num_processes
    if remainder == 0:
        return tensor
    missing = num_processes - remainder

    def _pad(t):
        if t.ndim == 0 or t.shape[dim] != batch_size:
            return t
        last = t.narrow(dim, batch_size - 1, 1)
        return torch.cat([t] + [last] * missing, dim=dim)

    return recursively_apply(_pad, tensor)
