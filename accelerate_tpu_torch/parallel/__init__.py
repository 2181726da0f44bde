"""Parallel-training helpers (port of ``accelerate_tpu/parallel/``). This
slice ports the rematerialisation policies of :mod:`.pipeline`; the
pipeline stages, ring attention and the sharding plans are ROADMAP item
18."""
