"""Ops of the port: :mod:`.layers`, :mod:`.fp8` (KV helpers),
:mod:`.attention` (the dispatch the models call), :mod:`.flash_attention`
(the flash kernels' autograd.Function and their ``fwd_launches`` /
``bwd_dq_launches`` / ``bwd_dkv_launches`` counters) and
:mod:`.paged_attention` (the paged kernel's dispatcher and its ``launches``
counter) — import the module, not the function, to read a counter."""
