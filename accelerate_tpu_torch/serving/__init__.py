"""Continuous-batching serving engine (Orca-style slot scheduling over a
vLLM-style block-paged KV cache) — see :mod:`.engine` for the design and
for what is not ported yet."""

from .blocks import NULL_BLOCK, BlockAllocator, blocks_needed
from .engine import UNPORTED_REQUEST_FIELDS, EngineConfig, InferenceEngine
from .scheduler import (
    PRIORITY_CLASSES,
    Request,
    RequestState,
    SlotScheduler,
    priority_rank,
)

__all__ = [
    "NULL_BLOCK",
    "BlockAllocator",
    "blocks_needed",
    "EngineConfig",
    "InferenceEngine",
    "UNPORTED_REQUEST_FIELDS",
    "PRIORITY_CLASSES",
    "Request",
    "RequestState",
    "SlotScheduler",
    "priority_rank",
]
