"""Ops of the port: :mod:`.layers`, :mod:`.fp8` (KV helpers) and
:mod:`.paged_attention` (the CUDA kernel's dispatcher and its ``launches``
counter — import the module, not the function, to read the counter)."""
