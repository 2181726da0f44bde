"""Process / accelerator state singletons (port of
``accelerate_tpu/state.py``, single process).

Same Borg contract as the JAX package: every instance of a class shares one
``__dict__``, so library helpers see the state without a handle, and
``_reset_state`` clears it between independent setups (the tests need
this). One process drives one device here: the card unless the caller asks
for the CPU. Process groups and NCCL (``mesh.py:initialize_distributed``)
are a later slice.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from .utils.dataclasses import DistributedType, GradientAccumulationPlugin, validate_mixed_precision


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


class PartialState:
    """The device and the process-control primitives."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        if cpu or _env_flag("ACCELERATE_USE_CPU"):
            self.device = torch.device("cpu")
        elif torch.cuda.is_available():
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            raise RuntimeError(
                "no CUDA device is available: pass Accelerator(cpu=True) to train "
                "on the CPU through the plain PyTorch paths"
            )
        self.num_processes = 1
        self.process_index = 0
        self.local_process_index = 0
        self.distributed_type = DistributedType.NO

    @property
    def initialized(self) -> bool:
        return "distributed_type" in self.__dict__

    @classmethod
    def _reset_state(cls):
        cls._shared_state.clear()

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

    def wait_for_everyone(self):
        """A barrier across processes: with one process, nothing to wait for."""

    def print(self, *args, **kwargs):
        if self.is_main_process:
            print(*args, **kwargs)

    def __repr__(self) -> str:
        return (
            f"Distributed environment: {self.distributed_type}\n"
            f"Num processes: {self.num_processes}\n"
            f"Process index: {self.process_index}\n"
            f"Local process index: {self.local_process_index}\n"
            f"Device: {self.device}\n"
        )


class AcceleratorState:
    """Adds the mixed-precision decision on top of :class:`PartialState`."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: str | None = None, cpu: bool = False):
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
            mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION", "no")
        self._mixed_precision = validate_mixed_precision(mixed_precision)
        self._partial = PartialState(cpu=cpu)

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
    """Gradient-accumulation bookkeeping shared by the Accelerator and the
    optimizer and scheduler wrappers: ``sync_gradients``, ``num_steps``,
    ``end_of_dataloader``."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin: GradientAccumulationPlugin | None = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
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
        """The prepared data loader is a later slice, so no loop runs
        inside one yet."""
        if not self.in_dataloader:
            return False
        return self.active_dataloader.end_of_dataloader

    def _set_sync_gradients(self, sync_gradients: bool):
        self.sync_gradients = sync_gradients

    def __repr__(self):
        return (
            f"Sync gradients: {self.sync_gradients}\n"
            f"At end of current dataloader: {self.end_of_dataloader}\n"
            f"Gradient accumulation plugin: {self.plugin_kwargs}\n"
        )
