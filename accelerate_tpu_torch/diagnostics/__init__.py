"""Request-scoped tracing (:mod:`.tracing`): the request half of
``accelerate_tpu/diagnostics``."""
