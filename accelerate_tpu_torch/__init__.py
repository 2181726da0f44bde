"""PyTorch/CUDA port of ``accelerate_tpu`` for one NVIDIA H100.

The JAX package beside it (``accelerate_tpu/``) stays the reference; this
package mirrors its structure and names module for module, in PyTorch
idiom (``nn.Module`` models, plain functions on tensors for the ops, an
explicit ``device`` and an explicit ``torch.Generator`` for every draw).

Ported so far:

* the training path — the 5-line ``Accelerator`` loop over the llama
  forward, with the flash-attention forward and backward written by hand in
  CUDA for ``sm_90a`` (``csrc/flash_attention.cu``);
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
from .generation import generate
from .state import AcceleratorState, GradientState, PartialState
from .utils.dataclasses import GradientAccumulationPlugin
from .utils.device import resolve_device
from .utils.random import set_seed

__version__ = "0.2.0"

__all__ = [
    "Accelerator",
    "AcceleratorState",
    "GradientAccumulationPlugin",
    "GradientState",
    "PartialState",
    "generate",
    "resolve_device",
    "set_seed",
]

