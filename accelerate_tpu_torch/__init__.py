"""PyTorch/CUDA port of ``accelerate_tpu`` for one NVIDIA H100.

The JAX package beside it (``accelerate_tpu/``) stays the reference; this
package mirrors its structure and names module for module, in PyTorch
idiom (``nn.Module`` models, plain functions on tensors for the ops, an
explicit ``device`` and an explicit ``torch.Generator`` for every draw).

Ported so far: the serving path — the paged llama step, the
continuous-batching engine and ``serve`` over stdin JSONL — with the
block-table paged-attention kernel written by hand in CUDA for ``sm_90a``
(``csrc/paged_attention.cu``, built by :mod:`._build` at first use).

Importing the package needs neither a GPU, ``nvcc`` nor ``triton``: the
kernel is compiled and loaded only when a CUDA tensor first reaches it.
"""

from .utils.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
