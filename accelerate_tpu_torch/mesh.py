"""Process groups and the data-parallel mesh (port of
``accelerate_tpu/mesh.py``).

The JAX package calls ``jax.distributed.initialize`` and builds a named
``Mesh`` over every chip one process drives. Here each process drives one
device, so bring-up is ``torch.distributed.init_process_group`` (NCCL on the
card, gloo on the CPU) and the mesh is a one-axis ``DeviceMesh`` named
``dp``. The launch contract is the JAX package's
(``ACCELERATE_COORDINATOR_ADDR``, ``ACCELERATE_NUM_PROCESSES``,
``ACCELERATE_PROCESS_ID``); torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` are read as well.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .utils.dataclasses import MeshPlugin
from .utils.device import device_hbm_bytes
from .utils.environment import get_int_from_env

__all__ = [
    "PROCESS_GROUP_TIMEOUT",
    "build_mesh",
    "device_hbm_bytes",
    "device_topology",
    "initialize_distributed",
]

#: how long a collective may wait for its peers before the group fails it,
#: unless ``InitProcessGroupKwargs(timeout=...)`` names another
PROCESS_GROUP_TIMEOUT = datetime.timedelta(minutes=10)


def _init_method(address: str) -> str:
    """``host:port`` becomes ``tcp://host:port``; a URL (``tcp://``,
    ``file://``, ``env://``) is used as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_process_index: int | None = None,
    cpu: bool = False,
    timeout: datetime.timedelta = PROCESS_GROUP_TIMEOUT,
) -> str | None:
    """Bring the process group up and return its backend, or ``None`` when
    no coordinator is named (one process, no group). Already up: returns
    the group's backend.

    On the card the backend is NCCL: ``torch.cuda.set_device`` to the local
    index first, and that device passed as ``device_id``. A failed NCCL
    bring-up raises; it never falls back to gloo or the CPU. ``cpu=True``
    takes gloo."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None:
        coordinator_address = os.environ.get("ACCELERATE_COORDINATOR_ADDR")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', 29500)}"
    if coordinator_address is None:
        return None
    if num_processes is None:
        num_processes = get_int_from_env(["ACCELERATE_NUM_PROCESSES", "WORLD_SIZE"], 1)
    if process_id is None:
        process_id = get_int_from_env(["ACCELERATE_PROCESS_ID", "RANK"], 0)
    kwargs = {}
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL process group needs a CUDA device; pass cpu=True "
                               "for a gloo group on the CPU")
        if local_process_index is None:
            local_process_index = get_int_from_env(
                ["LOCAL_RANK", "ACCELERATE_LOCAL_PROCESS_ID"],
                process_id % torch.cuda.device_count())
        torch.cuda.set_device(local_process_index)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local_process_index)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id, timeout=timeout,
                            **kwargs)
    return backend


def device_topology() -> dict:
    """The process group's view of the devices (port of ``device_topology``):
    one device a process."""
    up = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "num_devices": dist.get_world_size() if up else 1,
        "local_device_count": torch.cuda.device_count() if cuda else 1,
        "process_count": dist.get_world_size() if up else 1,
        "process_index": dist.get_rank() if up else 0,
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
    }


def build_mesh(plugin: MeshPlugin | None = None, device_type: str = "cuda"):
    """The one-axis ``DeviceMesh`` named ``dp`` over every process of the
    group (port of ``build_mesh``); the group must be up."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    sizes = (plugin or MeshPlugin()).axis_sizes(world)
    return init_device_mesh(device_type, (sizes["dp"],), mesh_dim_names=("dp",))
