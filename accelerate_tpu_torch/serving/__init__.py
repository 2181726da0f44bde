"""Continuous-batching serving engine (Orca-style slot scheduling over a
vLLM-style block-paged KV cache) — see :mod:`.engine` for the design and
for what is not ported yet."""

from .blocks import NULL_BLOCK, BlockAllocator, blocks_needed
from .engine import UNPORTED_REQUEST_FIELDS, EngineConfig, InferenceEngine
from .grammar import Grammar, GrammarError, compile_grammar, validate_instance
from .radix import RadixCache, SwapPool
from .sampling import SamplingParams, resolve_sampling
from .scheduler import (
    PRIORITY_CLASSES,
    Request,
    RequestState,
    SlotScheduler,
    priority_rank,
)
from .spec import DraftSpec, parse_draft_spec
from .usage import UsageLedger, normalize_tenant

__all__ = [
    "NULL_BLOCK",
    "BlockAllocator",
    "blocks_needed",
    "EngineConfig",
    "InferenceEngine",
    "UNPORTED_REQUEST_FIELDS",
    "Grammar",
    "GrammarError",
    "compile_grammar",
    "validate_instance",
    "RadixCache",
    "SwapPool",
    "DraftSpec",
    "parse_draft_spec",
    "UsageLedger",
    "normalize_tenant",
    "SamplingParams",
    "resolve_sampling",
    "PRIORITY_CLASSES",
    "Request",
    "RequestState",
    "SlotScheduler",
    "priority_rank",
]
