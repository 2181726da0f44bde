"""Fault tolerance: preemption-safe checkpointing (port of
``accelerate_tpu/resilience``).

* :mod:`.manifest` — the checkpoint manifest (per-file sizes and CRC32s,
  piece tables, process count) and validation: a checkpoint either
  validates completely or is skipped by auto-resume. The format is the JAX
  package's.
* :mod:`.distributed` — per-process piece tables of sharded saves.
* :mod:`.preemption` — SIGTERM/SIGINT handlers (and an optional
  maintenance-event poller); the training loop checks the flag at step
  boundaries, agrees across the process group, emergency-saves once and
  exits with a sentinel file; ``serve`` drains on it.
* :mod:`.retry` — bounded exponential-backoff retries around checkpoint IO.

The atomic commit lives in :mod:`accelerate_tpu_torch.checkpointing`:
every save lands in ``<dir>.tmp`` and is renamed into place, so a
checkpoint directory exists completely or not at all.
"""

from .distributed import collect_pieces, restore_from_pieces
from .manifest import (
    MANIFEST_NAME,
    SENTINEL_NAME,
    build_manifest,
    find_latest_valid_checkpoint,
    read_manifest,
    validate_checkpoint,
    write_manifest,
)
from .preemption import PreemptionHandler, get_active_handler
from .retry import run_with_retries

__all__ = [
    "MANIFEST_NAME",
    "SENTINEL_NAME",
    "PreemptionHandler",
    "build_manifest",
    "collect_pieces",
    "find_latest_valid_checkpoint",
    "get_active_handler",
    "read_manifest",
    "restore_from_pieces",
    "run_with_retries",
    "validate_checkpoint",
    "write_manifest",
]
