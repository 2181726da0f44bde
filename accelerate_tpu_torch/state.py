"""Process / accelerator state singletons (port of
``accelerate_tpu/state.py``).

Same Borg contract as the JAX package: every instance of a class shares one
``__dict__``, so library helpers see the state without a handle, and
``_reset_state`` clears it between independent setups (the tests need
this). Each process drives one device: the card unless the caller asks for
the CPU. Under a launch environment (``ACCELERATE_COORDINATOR_ADDR`` and
friends, or torchrun's) the constructor brings a process group up
(:func:`.mesh.initialize_distributed`): NCCL on the card, gloo on the CPU.
``_reset_state`` destroys the group, so the singleton and the group never
disagree.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axes_group, build_mesh, device_topology, initialize_distributed
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MeshPlugin,
    validate_mixed_precision,
)
from .utils.environment import parse_choice_from_env, parse_flag_from_env


class PartialState:
    """The device, the process group and the process-control primitives."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False, mesh_plugin: MeshPlugin | None = None,
                 sharded: bool = False, _from_accelerator: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            # a new Accelerator over the same group states its own mesh; a
            # bare PartialState() (a helper's) reads the current one
            if _from_accelerator or mesh_plugin is not None or sharded:
                self._set_mesh(mesh_plugin or MeshPlugin(), sharded)
            return
        cpu = cpu or parse_flag_from_env("ACCELERATE_USE_CPU")
        if not cpu and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass Accelerator(cpu=True) to train "
                "on the CPU through the plain PyTorch paths"
            )
        self.debug = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        #: (axis extents, sharded) -> (DeviceMesh, groups), for the life of
        #: the process group (:meth:`_reset_state` clears it with the group)
        self._meshes = {}
        #: "nccl" or "gloo" while a process group is up, else None
        self.backend = initialize_distributed(
            coordinator_address=kwargs.pop("coordinator_address", None),
            num_processes=kwargs.pop("num_processes", None),
            process_id=kwargs.pop("process_id", None),
            cpu=cpu,
            **({"timeout": kwargs.pop("timeout")} if "timeout" in kwargs else {}),
        )
        topo = device_topology()
        self.num_processes = topo["process_count"]
        self.process_index = topo["process_index"]
        if cpu:
            self.device = torch.device("cpu")
            self.local_process_index = self.process_index  # the ranks share one host
        else:
            self.device = torch.device("cuda", torch.cuda.current_device())
            # under a group, the card initialize_distributed set is the local rank's
            self.local_process_index = self.device.index if self.backend else 0
        self._set_mesh(mesh_plugin or MeshPlugin(), sharded)
        if self.num_processes == 1:
            self.distributed_type = DistributedType.NO
        else:
            self.distributed_type = DistributedType.MULTI_CPU if cpu else DistributedType.MULTI_GPU

    def _set_mesh(self, plugin: MeshPlugin, sharded: bool):
        """The mesh's extents (``mesh_sizes``, all six of JAX's axes), the
        ``DeviceMesh`` and the groups a sharded step reduces over. The mesh
        is sharded when an ``fsdp``, ``cp`` or ``tp`` extent is above 1, one
        of them is the axis that takes the remaining processes (``-1``,
        whatever extent that gives), or the caller asks for it (an FSDP or
        context-parallel plugin); it then needs a process group, and raises
        without one. Called again (a new Accelerator), it takes the mesh of
        those extents over the same group, made once."""
        sizes = plugin.axis_sizes(self.num_processes)  # a fixed extent must match
        axes = ("fsdp", "cp", "tp")
        sharded = bool(sharded or any(sizes[a] > 1 or getattr(plugin, a) == -1 for a in axes))
        if sharded and self.backend is None:
            raise ValueError(
                f"a sharded mesh ({ {a: n for a, n in sizes.items() if n != 1} or sizes}) needs "
                "a process group: launch with ACCELERATE_COORDINATOR_ADDR, "
                "ACCELERATE_NUM_PROCESSES and ACCELERATE_PROCESS_ID (or accelerate-tpu-torch "
                "launch), at world size 1 too"
            )
        self.mesh_plugin = plugin
        self.mesh_sizes = sizes
        self.sharded = sharded
        self.mesh, self.groups = None, {}
        if self.backend is None:
            return
        # made once a process group for each mesh: an Accelerator built again
        # over the same group makes no new communicator
        key = (tuple(sizes.values()), sharded)
        if key not in self._meshes:
            mesh = build_mesh(plugin, self.device.type, sharded)
            #: the groups the gradients reduce over: ``data`` spans the ranks
            #: that read different data (every rank off a sharded mesh;
            #: dp × fsdp × cp on one), ``replica`` those that hold the same
            #: parameter shards (dp × cp); ``batch`` the ranks that hold
            #: other rows of the batch (dp × fsdp), which a loss or a batch
            #: statistic that every ``cp`` rank computes whole spans; ``cp``
            #: and ``tp`` the attention's. On a sharded mesh None where one
            #: rank spans them
            groups = {"data": dist.group.WORLD, "batch": dist.group.WORLD}
            if sharded:
                groups = {"data": axes_group(mesh, ("dp", "fsdp", "cp")),
                          "batch": axes_group(mesh, ("dp", "fsdp")),
                          "replica": axes_group(mesh, ("dp", "cp")),
                          "cp": axes_group(mesh, ("cp",)),
                          "tp": axes_group(mesh, ("tp",))}
            self._meshes[key] = (mesh, groups)
        self.mesh, self.groups = self._meshes[key]

    def axis_index(self, axis: str) -> int:
        """This process's coordinate on a mesh axis (0 off the mesh)."""
        if self.mesh is None or axis not in (self.mesh.mesh_dim_names or ()):
            return 0 if axis != "dp" else self.process_index
        return self.mesh.get_local_rank(axis)

    @property
    def data_parallel_size(self) -> int:
        """The ways the global batch splits: ``dp × fsdp`` (JAX's
        ``batch_axes``); the ``cp`` ranks split the sequence and the ``tp``
        ranks read the same rows."""
        return self.mesh_sizes["dp"] * self.mesh_sizes["fsdp"]

    @property
    def data_parallel_rank(self) -> int:
        return self.axis_index("dp") * self.mesh_sizes["fsdp"] + self.axis_index("fsdp")

    # -- lifecycle -----------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return "distributed_type" in self.__dict__

    @classmethod
    def _reset_state(cls):
        """Clear the shared state and destroy the process group, if one is up."""
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        cls._shared_state.clear()

    def destroy_process_group(self):
        self._reset_state()

    # -- identity ------------------------------------------------------------

    @property
    def use_distributed(self) -> bool:
        return self.distributed_type != DistributedType.NO

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    # -- process control -----------------------------------------------------

    def wait_for_everyone(self):
        """A barrier across the group (``dist.barrier``); nothing without one."""
        if self.backend is not None:
            dist.barrier()

    def consensus_any(self, flag: bool) -> bool:
        """Does ANY process assert ``flag``? One all-reduce (MAX) of one int.
        A collective while a group is up: every process must call it at the
        same point."""
        if self.backend is None:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    @contextlib.contextmanager
    def main_process_first(self):
        """The main process runs the body before the others (the
        download-then-load idiom)."""
        if not self.is_main_process:
            self.wait_for_everyone()
        yield
        if self.is_main_process:
            self.wait_for_everyone()

    @contextlib.contextmanager
    def local_main_process_first(self):
        """The local main process of each host runs the body first; the
        processes of one host share it."""
        if not self.is_local_main_process:
            self.wait_for_everyone()
        yield
        if self.is_local_main_process:
            self.wait_for_everyone()

    def _on(self, predicate: Callable[[], bool], function: Callable):
        @functools.wraps(function)
        def inner(*args, **kwargs):
            if predicate():
                return function(*args, **kwargs)

        return inner

    def on_main_process(self, function: Callable = None):
        if function is None:
            return self.on_main_process
        return self._on(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable = None):
        if function is None:
            return self.on_local_main_process
        return self._on(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable):
        return self._on(lambda: self.is_last_process, function)

    def on_process(self, function: Callable = None, process_index: int = None):
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return self._on(lambda: self.process_index == process_index, function)

    def on_local_process(self, function: Callable = None, local_process_index: int = None):
        if function is None:
            return functools.partial(self.on_local_process,
                                     local_process_index=local_process_index)
        return self._on(lambda: self.local_process_index == local_process_index, function)

    @contextlib.contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of a list, tuple, dict of those,
        numpy array or tensor: ``ceil(len / num_processes)`` items each, the
        last share short unless ``apply_padding`` repeats the last item."""
        if self.num_processes == 1:
            yield inputs
            return
        length = len(inputs)
        num_per = math.ceil(length / self.num_processes)
        start = self.process_index * num_per
        end = min(start + num_per, length)

        def _slice(obj):
            sliced = obj[start:end]
            if apply_padding and len(sliced) < num_per and len(obj) > 0:
                pad = [obj[-1]] * (num_per - len(sliced))
                if isinstance(sliced, list):
                    sliced = sliced + pad
                elif isinstance(sliced, tuple):
                    sliced = sliced + tuple(pad)
                elif isinstance(sliced, torch.Tensor):
                    sliced = torch.cat([sliced, torch.stack(pad)])
                else:
                    sliced = np.concatenate([sliced, np.stack(pad)])
            return sliced

        if isinstance(inputs, dict):
            yield {k: _slice(v) for k, v in inputs.items()}
        else:
            yield _slice(inputs)

    def print(self, *args, **kwargs):
        if self.is_main_process:
            print(*args, **kwargs)

    def __repr__(self) -> str:
        return (
            f"Distributed environment: {self.distributed_type}\n"
            f"Backend: {self.backend}\n"
            f"Num processes: {self.num_processes}\n"
            f"Process index: {self.process_index}\n"
            f"Local process index: {self.local_process_index}\n"
            f"Device: {self.device}\n"
        )


class AcceleratorState:
    """Adds the mixed-precision decision on top of :class:`PartialState`."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: str | None = None, cpu: bool = False,
                 mesh_plugin: MeshPlugin | None = None, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            if mixed_precision is not None and mixed_precision != self._mixed_precision:
                raise ValueError(
                    "AcceleratorState already initialized with "
                    f"mixed_precision={self._mixed_precision!r}; call "
                    "AcceleratorState._reset_state() to change it."
                )
            return
        if mixed_precision is None:
            mixed_precision = parse_choice_from_env("ACCELERATE_MIXED_PRECISION", "no")
        self._mixed_precision = validate_mixed_precision(mixed_precision)
        self._partial = PartialState(cpu=cpu, mesh_plugin=mesh_plugin, _from_accelerator=True,
                                     **kwargs)

    @property
    def initialized(self) -> bool:
        return "_partial" in self.__dict__

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False):
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()
        from .ops.attention import set_attention_context

        set_attention_context(None)

    @property
    def mixed_precision(self) -> str:
        return self._mixed_precision

    def __getattr__(self, name: str):
        # the topology / process-control surface is PartialState's
        if name in ("_shared_state", "__dict__", "_partial"):
            raise AttributeError(name)
        partial = self.__dict__.get("_partial")
        if partial is not None and hasattr(partial, name):
            return getattr(partial, name)
        raise AttributeError(f"AcceleratorState has no attribute {name!r}")

    def __repr__(self):
        return self._partial.__repr__() + f"Mixed precision: {self.mixed_precision}\n"


class GradientState:
    """Gradient-accumulation bookkeeping shared by the Accelerator, the
    prepared data loaders and the optimizer and scheduler wrappers:
    ``sync_gradients``, ``num_steps``, ``end_of_dataloader``, ``remainder``."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: GradientAccumulationPlugin | None = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = [None]
            self.plugin_kwargs = (
                gradient_accumulation_plugin.to_dict()
                if gradient_accumulation_plugin is not None
                else {}
            )
        if (gradient_accumulation_plugin is not None
                and self.plugin_kwargs != gradient_accumulation_plugin.to_dict()):
            self.plugin_kwargs = gradient_accumulation_plugin.to_dict()

    @property
    def initialized(self) -> bool:
        return "sync_gradients" in self.__dict__

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()

    @property
    def num_steps(self) -> int:
        return self.plugin_kwargs.get("num_steps", 1)

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", False)

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        """The active prepared loader is on its last batch."""
        if not self.in_dataloader:
            return False
        return self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        """Samples of the global last batch that are real (the rest repeat
        the epoch's first samples); -1 outside a loader."""
        if not self.in_dataloader:
            return -1
        return self.active_dataloader.remainder

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def _add_dataloader(self, dataloader):
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader):
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    def __repr__(self):
        return (
            f"Sync gradients: {self.sync_gradients}\n"
            f"At end of current dataloader: {self.end_of_dataloader}\n"
            f"Extra samples added: {self.remainder}\n"
            f"Gradient accumulation plugin: {self.plugin_kwargs}\n"
        )
