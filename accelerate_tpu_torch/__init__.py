"""PyTorch/CUDA port of ``accelerate_tpu`` for one NVIDIA H100.

The JAX package beside it (``accelerate_tpu/``) stays the reference; this
package mirrors its structure and names module for module, in PyTorch
idiom (``nn.Module`` models, plain functions on tensors for the ops, an
explicit ``device`` and an explicit ``torch.Generator`` for every draw).

Ported so far:

* the training path — the 5-line ``Accelerator`` loop over the llama
  forward, with the flash-attention forward and backward written by hand in
  CUDA for ``sm_90a`` (``csrc/flash_attention.cu``; f32, bf16 and f16), its
  precision policies (bf16; fp16 with the dynamic loss scaler; fp8
  projections on the card's fp8 tensor cores; ``autocast`` islands), named
  selective remat and the HF llama loader, data-parallel under a
  process group (NCCL on the card, gloo on the CPU) with the prepared
  ``DataLoader`` and the collectives (``operations``, ``data_loader``,
  ``mesh``, ``launchers``);
* the loop's state — ``save_state`` / ``load_state`` (sync, async,
  sharded) with the JAX package's directory contract and manifests,
  preemption with an emergency save and auto-resume, the trackers, the
  hang watchdog and ``find_executable_batch_size`` (``checkpointing``,
  ``resilience``, ``tracking``, ``diagnostics.watchdog``,
  ``utils.memory``);
* ``generate()`` — the llama's dense KV cache (its prefill through the
  flash forward kernel) and greedy speculative decoding;
* the serving path — the paged llama step, the continuous-batching engine
  and ``serve`` over stdin JSONL, with the block-table paged-attention
  kernel (``csrc/paged_attention.cu``), the fleet (``route``) and its
  observability commands (``monitor``, ``trace``, ``slo``, ``usage``,
  ``metrics``).

Importing the package needs neither a GPU, ``nvcc`` nor ``triton``: a
kernel is compiled (by :mod:`._build`) and loaded only when a CUDA tensor
first reaches it.
"""

from .accelerator import Accelerator
from .data_loader import prepare_data_loader, skip_first_batches
from .generation import generate
from .launchers import debug_launcher, notebook_launcher
from .logging import get_logger
from .operations import (
    broadcast,
    broadcast_object_list,
    gather,
    gather_object,
    pad_across_processes,
    reduce,
    send_to_device,
)
from .ops.fp8 import FP8RecipeKwargs
from .optimizer import LossScaler
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import (
    AutocastKwargs,
    DataLoaderConfiguration,
    DiagnosticsPlugin,
    DistributedType,
    FaultTolerancePlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    MeshPlugin,
    ProjectConfiguration,
)
from .utils.device import resolve_device
from .utils.memory import find_executable_batch_size, release_memory
from .utils.random import set_seed, synchronize_rng_state, synchronize_rng_states

__version__ = "0.2.0"

__all__ = [
    "Accelerator",
    "AcceleratorState",
    "AutocastKwargs",
    "DataLoaderConfiguration",
    "DiagnosticsPlugin",
    "DistributedType",
    "FP8RecipeKwargs",
    "FaultTolerancePlugin",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "GradientState",
    "InitProcessGroupKwargs",
    "LossScaler",
    "MeshPlugin",
    "PartialState",
    "ProjectConfiguration",
    "broadcast",
    "broadcast_object_list",
    "debug_launcher",
    "find_executable_batch_size",
    "gather",
    "gather_object",
    "generate",
    "get_logger",
    "notebook_launcher",
    "pad_across_processes",
    "prepare_data_loader",
    "reduce",
    "release_memory",
    "resolve_device",
    "send_to_device",
    "set_seed",
    "skip_first_batches",
    "synchronize_rng_state",
    "synchronize_rng_states",
]

