"""Continuous-batching inference engine (port of
``accelerate_tpu/serving/engine.py``: the single-lane path with its
double-buffered dispatch and flight recorder).

Orca-style iteration scheduling over a vLLM-style block-paged KV cache:

* the decode step is the model's paged step at a fixed ``[num_slots, 1]``
  shape; one dispatch runs ``decode_burst`` steps back to back. The fed
  tokens stay on the device from step to step, and the burst's
  ``[burst, num_slots]`` tokens come to the host in **one** copy;
* prompts are **chunk-prefilled**: ``prefill_chunk`` tokens of each
  prefilling slot per iteration, interleaved with decode, so a long prompt
  bounds every in-flight request's inter-token latency by one chunk;
* KV memory is allocated in ``block_size``-token blocks from a freelist
  (:mod:`.blocks`); the pools live on the device and are **updated in
  place** by the paged step (the JAX engine donates them instead). They
  are never reassigned: the CUDA graphs hold their pointers;
* **one program each, captured once.** Every operand of the decode burst
  and of the prefill chunk lives in a persistent device buffer made once
  per engine (:class:`_Operands`), filled each dispatch by one
  non-blocking copy from pinned host staging. On a CUDA device the burst
  and the chunk (with its first-token pick, on the device) are each
  captured into a CUDA graph at their first dispatch and replayed on
  every dispatch after it — the port's counterpart of the JAX engine's
  single compiled ``lax.scan`` burst and prefill executable.
  ``stats()["decode_compiles"]`` and ``["prefill_compiles"]`` count the
  captures (1 each on the card, 0 on the CPU, which runs the same
  static-buffer functions eagerly). A capture or replay that fails raises:
  the engine never falls back to eager dispatch on the card;
* **double-buffered dispatch** (``async_dispatch``, the default): round
  *i* is replayed and its tokens copied into pinned memory behind a CUDA
  event; ``step()`` returns without waiting, and the round is harvested at
  iteration *i+1*'s harvest point, after that iteration's schedule and
  prefill work ran under it. Every dispatch still follows the previous
  harvest, so the tokens are identical to the synchronous loop;
* every paged-attention call on a CUDA device is the hand-written kernel
  (``csrc/paged_attention.cu``). Its Python counters run when a launch is
  recorded, not when a graph replays it, so ``stats()`` counts eager
  launches plus replays × the launches each capture recorded;
* the flight recorder (:mod:`.flight`) splits every iteration into
  schedule, prefill, dispatch, device_wait and harvest, and
  ``stats()["host_fraction"]`` says how much of the wall time the host
  held the card back;
* **per-slot sampling lanes** (``per_slot_sampling``, the default):
  temperature / top-k / top-p / repetition penalty / seed / min_tokens, a
  grammar DFA and top-N logprobs ride as fixed-shape lane operands of a
  third program, the *lane burst*, captured once into its own CUDA graph
  at the first dispatch that needs it (``stats()["lane_decode_compiles"]``).
  CUDA graphs cannot branch on data, so the JAX engine's in-trace
  ``lax.cond`` becomes a host choice each dispatch: the plain burst graph
  replays when every live request is inert for the whole burst (no
  sampling, no grammar row, no repetition penalty, no min_tokens left, no
  logprobs), the lane graph otherwise. Draws come from a counter-based
  hash of (engine seed, request seed, output position)
  (:mod:`.sampling`), so a seeded request reproduces across admission
  orders and batches; stop sequences, min/max tokens and the
  authoritative DFA state are host state (``_emit_token``);
* the **radix prefix cache** (``prefix_cache``, the default): admission
  maps a request's longest cached prompt prefix into its block table at
  refcount+1 and prefills only the tail; a partial-block hit owes one
  copy-on-write block copy, issued in place on the engine's stream before
  the first prefill chunk. The tail's chunks start where they would without
  the cache (at the chunk boundary at or below the match), so a request's
  tokens are the same bits with the cache on or off. The pools are never
  reassigned, so the captured graphs stay valid;
* **swap preemption** (``swap_gb``): under pool exhaustion the
  lowest-priority victim's unshared blocks are gathered on the device into
  one buffer, copied by one non-blocking copy into pinned memory behind an
  event, and parked in a host :class:`~.radix.SwapPool`; the victim
  re-queues at the front of its class and is restored into fresh blocks by
  one copy up and one ``index_copy_`` per pool at re-admission. Before any
  pool row is read the in-flight round is fenced (harvested). Every edit is
  in place on the static pools, outside the graphs: swap never re-captures;
* **speculative decoding** (``spec_k``, ``draft="early_exit:N"``): the
  decode program becomes ONE spec round per dispatch — ``spec_k`` greedy
  (or, through the lanes, sampled) steps of the early-exit draft over the
  first N layers of the target's own pool, one ``[num_slots, spec_k+1]``
  verify forward through every layer and the paged kernel, and the
  acceptance, all on the device — captured once into its own graph
  (``spec_decode``; ``lane_spec_decode`` for the lanes). The host advances
  each slot by ``accept + 1``; rejected drafts are rolled back by position
  alone (the next round rewrites those rows before anything reads them);
* the **usage ledger** (``usage_accounting``, :mod:`.usage`): decode and
  prefill device-seconds, KV block-seconds, swap bytes, spec and grammar
  counts per request, rolled up by tenant and class, conserved against the
  flight recorder's ``device_wait`` and the pool-occupancy integral;
* **deadlines** (``add_request(deadline_ms=)``): an expired request
  finishes ``deadline_exceeded`` with its partial output; an in-flight
  member's expiry waits for the harvest point, so async and sync engines
  stay token-identical;
* **request tracing and telemetry**: every request carries a ``trace_id``
  (a well-formed one supplied survives, else one is generated) and, with
  an active tracer (:mod:`..diagnostics.tracing`), lands the JAX engine's
  ``req/arrive`` … ``req/finish`` events and the ``serve/schedule``,
  ``serve/prefill`` and ``serve/decode`` spans; with an active telemetry
  recorder (:mod:`..telemetry`) one ``kind="request"`` row per finish and a
  ``kind="step"`` row every ``stats_interval`` iterations, and one
  ``type="compile"`` row per graph capture; with an active metrics
  registry, each iteration's flight entry. All of it is host work around
  the dispatches, outside any captured graph; each is one global read an
  iteration when off.

Greedy output is the parity contract with the JAX engine. Not ported yet
(later slices): the mesh and the HBM pre-flight.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from dataclasses import dataclass

import numpy as np
import torch

from ..diagnostics.tracing import ensure_trace_id, get_tracer, trace_span, valid_trace_id
from ..generation import spec_accept_tokens
from ..metrics.ingest import observe_flight
from ..metrics.registry import get_active_registry
from ..ops import paged_attention as _paged_attention
from ..telemetry import get_active_recorder
from ..utils.device import resolve_device
from .blocks import BlockAllocator, blocks_needed
from .flight import ITERATION_PHASES, FlightRecorder, set_active_flight_recorder
from .grammar import compile_grammar
from .radix import RadixCache, SwapPool
from .sampling import (
    LANE_SPECS,
    TAG_ACCEPT,
    TAG_DRAFT,
    SamplingParams,
    apply_filters,
    blank_lanes,
    dist_logprobs,
    inverse_cdf_pick,
    match_stop,
    pick_tokens,
    rejection_accept,
    resolve_sampling,
    set_slot_lane,
    slot_uniforms,
)
from .scheduler import Request, RequestState, SlotScheduler, priority_rank
from .spec import parse_draft_spec
from .usage import UsageLedger, normalize_tenant

#: the spec programs; their rounds land through ``_spec_io``
_SPEC_KINDS = frozenset({"spec_decode", "lane_spec_decode"})

#: the float lanes, bit-cast views of the lane program's int32 operands
_FLOAT_LANES = frozenset(name for name, dtype, _ in LANE_SPECS if dtype == np.float32)


@dataclass
class EngineConfig:
    """Engine geometry. ``num_blocks`` defaults to full residency
    (``num_slots`` × the per-slot maximum + the null block) — set it lower
    to exercise freelist contention."""

    num_slots: int = 8
    block_size: int = 16
    #: per-request cap on prompt + generated tokens; also sizes the block
    #: table width (``ceil(max_seq_len / block_size)`` entries per slot)
    max_seq_len: int = 512
    num_blocks: int | None = None
    prefill_chunk: int = 32
    eos_token_id: int | None = None
    do_sample: bool = False
    temperature: float = 1.0
    seed: int = 0
    #: default budget for add_request(max_new_tokens=None)
    max_new_tokens: int = 64
    #: decode steps per dispatch: amortises the per-dispatch host round
    #: trip at the cost of scheduling granularity (a request finishing
    #: mid-burst wastes at most ``decode_burst - 1`` lane-steps)
    decode_burst: int = 8
    #: KV pool storage: ``"auto"`` = the params' dtype; ``"bf16"``/``"f32"``
    #: force a float width; ``"int8"``/``"fp8"`` quantize on scatter with
    #: per-row amax scales beside the pool, dequantized inside the kernel
    kv_dtype: str = "auto"
    #: double-buffered dispatch: ``step()`` hands round *i* to the device
    #: and returns without waiting; its tokens are harvested at iteration
    #: *i+1*'s harvest point, after that iteration's schedule and prefill
    #: work ran under the round. Tokens are identical to the synchronous
    #: loop (dispatch *i+1* still follows harvest *i*). ``False`` is the
    #: synchronous loop (``serve --sync-engine`` /
    #: ``ACCELERATE_SYNC_ENGINE=1``)
    async_dispatch: bool = True
    #: per-iteration flight recorder ring size (0 disables): every
    #: iteration's wall time split into schedule / prefill / dispatch /
    #: device_wait / harvest, asserted to sum to the wall time; the
    #: disabled path is one ``is None`` check
    flight_history: int = 256
    #: finished requests kept for the ``stats()`` percentiles (a ring)
    completed_history: int = 4096
    #: radix prefix sharing (:mod:`.radix`): admission maps a request's
    #: longest cached prompt prefix into its block table at refcount+1 and
    #: chunk-prefills only the tail; finished prompts' full blocks stay
    #: cached (LRU-evicted under pool pressure). Sharing edits only block
    #: tables, refcounts and (on a partial-block hit) one in-place block
    #: copy — the captured graphs stay valid
    prefix_cache: bool = True
    #: per-request sampling + constrained decoding (:mod:`.sampling`,
    #: :mod:`.grammar`): temperature / top-k / top-p / repetition penalty /
    #: seed / stop / min_tokens and a grammar DFA ride as fixed-shape lane
    #: operands of the lane burst graph, so per-request variation never
    #: re-captures. ``False`` keeps the plain greedy burst only and refuses
    #: per-request params (and engine-wide ``do_sample``) at add_request
    per_slot_sampling: bool = True
    #: top-N per-step logprobs harvested with the tokens (0 disables — the
    #: lane graph's output shape is static, so this is engine geometry;
    #: requests opt in *up to* this cap)
    logprobs_topn: int = 0
    #: concurrent distinct grammars resident in the device mask/transition
    #: tables (+1 internal row for the unconstrained sentinel). Rows are
    #: refcounted per live request and LRU-cached when idle; admission
    #: with every row held by a live request raises
    grammar_slots: int = 4
    #: DFA state budget per grammar — sizes the device tables; a grammar
    #: compiling to more states refuses at add_request
    grammar_states: int = 64
    #: repetition-penalty window: the last this-many tokens ride the
    #: ``[num_slots, rep_window]`` ring lane
    rep_window: int = 32
    #: host swap tier in GiB (0 disables): under pool exhaustion the
    #: lowest-priority victim's unshared blocks are copied to a pinned
    #: :class:`~.radix.SwapPool` and the request re-queues at the front of
    #: its class; ``finish_reason="out_of_blocks"`` truncation becomes the
    #: last resort for when even swap capacity is gone
    swap_gb: float = 0.0
    #: speculative decoding (0 = off, the plain burst). ``spec_k > 0``
    #: replaces the burst with ONE captured spec round per dispatch: every
    #: active slot drafts ``spec_k`` tokens from the draft, one ``[num_slots,
    #: spec_k+1]`` verify forward scores them through the paged kernel, and
    #: the longest agreeing prefix + the target's correction are emitted
    #: (greedy acceptance is exact: tokens equal the non-spec engine's).
    #: Sampled slots verify by rejection sampling. ``decode_burst`` is
    #: ignored while armed
    spec_k: int = 0
    #: draft policy when ``spec_k > 0`` (:mod:`.spec`): ``"early_exit:N"``
    #: runs the target's first N layers (+ its final norm and head) over the
    #: FIRST N LAYERS of the target's own pool
    draft: str = "early_exit:2"
    #: per-request resource attribution (:mod:`.usage`), conserved against
    #: the flight recorder's ``device_wait`` and the pool-occupancy
    #: integral. ``False`` removes the ledger (one truthiness check per
    #: iteration)
    usage_accounting: bool = True
    #: emit a telemetry ``kind="step"`` row (windowed throughput, cumulative
    #: counters, the usage snapshot) every this many iterations while a
    #: telemetry recorder is active (0 disables)
    stats_interval: int = 32

    @property
    def blocks_per_slot(self) -> int:
        return blocks_needed(self.max_seq_len, self.block_size)


def _packed_views(buffer, fields: dict, floats=frozenset()) -> dict:
    """Named views of one flat int32 buffer (torch or numpy), ``fields``
    ``{name: shape}`` laid out in order; names in ``floats`` are bit-cast to
    float32 (same width, same bytes)."""
    views, lo = {}, 0
    for name, shape in fields.items():
        hi = lo + int(np.prod(shape))
        v = buffer[lo:hi].reshape(shape)
        if name in floats:
            v = v.view(torch.float32) if isinstance(v, torch.Tensor) else v.view(np.float32)
        views[name] = v
        lo = hi
    return views


def _packed_size(fields: dict) -> int:
    return sum(int(np.prod(shape)) for shape in fields.values())


class _Operands:
    """A program's operands as named views of ONE persistent int32 device
    buffer (made once, so a CUDA graph can hold its pointer), and a ring of
    host staging copies of it (pinned on a CUDA device). Float operands are
    bit-cast views of the same buffer, so a program still needs one copy.

    :meth:`stage` hands out the next host copy as numpy views, once the
    copy that last read it has run (its event); :meth:`upload` copies it
    into the device buffer with one non-blocking copy and records an event
    after it. So the host never edits staging that a pending copy still
    reads, however far the stream runs behind."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], device: torch.device,
                 depth: int, floats=frozenset()):
        total = _packed_size(shapes)
        self._buffer = torch.zeros(total, dtype=torch.int32, device=device)
        self.views = _packed_views(self._buffer, shapes, floats)
        cuda = device.type == "cuda"
        self._host = [torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
                      for _ in range(depth)]
        self._host_views = [_packed_views(h.numpy(), shapes, floats) for h in self._host]
        self._events = [torch.cuda.Event() if cuda else None for _ in range(depth)]
        self._next = 0

    def stage(self) -> dict[str, np.ndarray]:
        """The next host staging copy, zeroed, as numpy views by name."""
        i = self._next
        if self._events[i] is not None:
            self._events[i].synchronize()  # the copy that last read it has run
        self._host[i].zero_()
        return self._host_views[i]

    def upload(self) -> None:
        """Copy the staged operands into the device buffer (non-blocking)."""
        i = self._next
        self._buffer.copy_(self._host[i], non_blocking=True)
        if self._events[i] is not None:
            self._events[i].record()
        self._next = (i + 1) % len(self._host)


class _Outputs:
    """A program's outputs as named views of one int32 device buffer (float
    outputs bit-cast), landed on the host by ONE non-blocking copy into a
    pinned mirror, behind an event."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], device: torch.device,
                 floats=frozenset()):
        total = _packed_size(shapes)
        cuda = device.type == "cuda"
        self._buffer = torch.zeros(total, dtype=torch.int32, device=device)
        self._host = torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
        self.views = _packed_views(self._buffer, shapes, floats)
        self.host_views = _packed_views(self._host.numpy(), shapes, floats)
        self._done = torch.cuda.Event() if cuda else None

    def copy_to_host(self) -> None:
        self._host.copy_(self._buffer, non_blocking=True)
        if self._done is not None:
            self._done.record()

    def wait(self) -> None:
        if self._done is not None:
            self._done.synchronize()


class _Program:
    """A fixed-shape function over the engine's static buffers: replayed
    from a CUDA graph on a CUDA device (captured at its first run), called
    as it is on the CPU. Counts its captures, its replays and the
    paged-attention launches its capture recorded."""

    def __init__(self, name: str, fn, device: torch.device, pool):
        self.name = name
        self._fn = fn
        self._device = device
        self._pool = pool
        self.graph = None
        self.captures = 0
        self.replays = 0
        #: dispatches of the program, replayed or (on the CPU) eager
        self.runs = 0
        #: paged-attention launches (all, and those with one query a row)
        #: the capture recorded, which every replay launches again
        self.launches_captured = 0
        self.decode_launches_captured = 0

    def run(self, upload) -> None:
        """``upload()`` (the operands' copy to the device), then the
        program; on a CUDA device the first run captures before uploading,
        so its warm-up sees the zeroed operands of an unused buffer."""
        self.runs += 1
        if self._device.type != "cuda":
            upload()
            self._fn()
            return
        if self.graph is None:
            self._capture()
        upload()
        self.graph.replay()
        self.replays += 1

    def _capture(self) -> None:
        """Warm up on a side stream (the kernel is built and loaded, the SM
        count cached, cuBLAS has its workspace), then capture. The operands
        are still zeros at the warm-up, so its writes land in the null
        block (every table entry and write mask is 0)."""
        pa = _paged_attention
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = (pa.launches, pa.decode_launches)
        with torch.cuda.graph(graph, pool=self._pool):
            self._fn()
        self.launches_captured = pa.launches - before[0]
        self.decode_launches_captured = pa.decode_launches - before[1]
        self.graph = graph
        self.captures += 1
        tel = get_active_recorder()
        if tel:
            # one row a capture, as the JAX engine's telemetry writes one a
            # compile of its executables
            tel.record_capture(self.name, time.perf_counter() - t0,
                               launches_captured=self.launches_captured)


class InferenceEngine:
    """Slot-scheduled continuous-batching engine over a paged-KV model.

    ``add_request()`` enqueues; ``step()`` runs one scheduler iteration
    (evict → admit and place → one prefill chunk per prefilling slot →
    harvest the in-flight round → one decode dispatch over every decoding
    slot) and returns the requests that finished; ``run_until_idle()``
    drains; ``stream()`` is a per-request generator. ``device=None`` means
    the CUDA card (raising when there is none); pass ``device="cpu"`` for
    the plain PyTorch paths."""

    def __init__(self, model, config: EngineConfig | None = None, device=None):
        self.config = cfg = config or EngineConfig()
        self.device = resolve_device(device)
        if not getattr(model, "supports_paged_kv", False):
            raise ValueError(
                f"model {type(model).__name__!r} does not declare "
                "supports_paged_kv: the engine needs the block-table KV step"
            )
        if model.device.type != self.device.type:
            raise ValueError(
                f"the model lies on {model.device} but the engine runs on "
                f"{self.device}: build the model on the engine's device"
            )
        self.model = model
        mcfg = model.config
        if cfg.max_seq_len > mcfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {cfg.max_seq_len} exceeds the model's "
                f"max_position_embeddings {mcfg.max_position_embeddings}"
            )
        if min(cfg.prefill_chunk, cfg.block_size, cfg.num_slots, cfg.decode_burst) < 1:
            raise ValueError(
                "prefill_chunk, block_size, num_slots, decode_burst must be >= 1"
            )

        # speculative decoding: parse the draft policy and bind the
        # early-exit draft BEFORE anything allocates (JAX's refusals, word
        # for word)
        self._spec = None
        self._draft_step = None
        if cfg.spec_k:
            if cfg.spec_k < 1:
                raise ValueError("spec_k must be >= 1 (0 disables speculation)")
            if cfg.do_sample and not cfg.per_slot_sampling:
                raise ValueError(
                    "spec_k with do_sample=True needs per_slot_sampling=True "
                    "(the rejection-sampling verify path); the legacy "
                    "per_slot_sampling=False executables are greedy-only"
                )
            if cfg.logprobs_topn:
                raise ValueError(
                    "logprobs_topn with spec_k > 0 is not supported: the "
                    "verify round emits a variable accepted prefix, so there "
                    "is no per-step harvest to ride — set spec_k=0 for "
                    "logprobs"
                )
            self._spec = parse_draft_spec(cfg.draft, mcfg.num_hidden_layers)
            factory = getattr(model, "early_exit_apply", None)
            if factory is None:
                raise ValueError(
                    f"model {type(model).__name__!r} "
                    "declares no early_exit_apply factory: the spec_k engine "
                    "needs the early-exit draft path (models/llama.py "
                    "llama_early_exit_apply)"
                )
            self._draft_step = factory(self._spec.layers)
        #: cache positions one decode dispatch may write past context_len —
        #: the block-growth lookahead (a spec round writes k+1 positions; a
        #: plain dispatch writes decode_burst)
        self._decode_lookahead = (cfg.spec_k + 1) if self._spec else cfg.decode_burst

        # per-slot sampling + grammar state. The engine-wide
        # do_sample/temperature survive as the DEFAULT SamplingParams a
        # request inherits when it supplies none
        self._psampling = bool(cfg.per_slot_sampling)
        if min(cfg.logprobs_topn, cfg.grammar_slots, cfg.rep_window - 1,
               cfg.grammar_states - 1) < 0:
            raise ValueError(
                "logprobs_topn/grammar_slots must be >= 0; "
                "rep_window/grammar_states must be >= 1"
            )
        if cfg.do_sample and not self._psampling:
            raise ValueError(
                "EngineConfig(do_sample=True) needs per_slot_sampling=True: sampled "
                "draws ride the lane burst (the engine has no threaded generator)"
            )
        self._default_sampling = SamplingParams(
            do_sample=cfg.do_sample, temperature=cfg.temperature, seed=cfg.seed,
        ).validate()
        self._vocab_size = int(mcfg.vocab_size)
        self._sampled_greedy = 0
        self._sampled_sample = 0
        self._grammar_masked_steps = 0
        self._first_token_picks = 0
        self._rej_drafted = 0
        self._rej_accepted = 0
        # grammar row table: row 0 is the permanently-pinned unconstrained
        # sentinel (mask all-True, transitions all-0); rows 1..G are
        # refcounted per live request, cached under their grammar hash
        # when idle, LRU-evicted when a new grammar needs a row
        self._grammar_rows: dict[str, int] = {}
        self._row_refs = [0] * (cfg.grammar_slots + 1)
        self._row_grammar: dict[int, object] = {}
        self._row_lru: OrderedDict[str, int] = OrderedDict()

        self._mb = mb = cfg.blocks_per_slot  # block-table width
        num_blocks = (
            cfg.num_blocks if cfg.num_blocks is not None
            else cfg.num_slots * self._mb + 1
        )
        n_kv = mcfg.num_key_value_heads
        if cfg.kv_dtype in (None, "auto"):
            store_dtype, quantized = model.dtype, False
        else:
            from ..ops.fp8 import kv_storage_dtype

            store_dtype, quantized = kv_storage_dtype(cfg.kv_dtype)
        self._quantized = quantized
        self.kv_dtype = str(store_dtype).removeprefix("torch.")
        itemsize = torch.empty((), dtype=store_dtype).element_size()
        #: bytes one cached token costs across all layers (K + V payload
        #: plus the f32 scales when quantized)
        self.kv_bytes_per_token = (
            2 * mcfg.num_hidden_layers * n_kv
            * (mcfg.head_dim * itemsize + (4 if quantized else 0))
        )

        #: max-length requests the pool holds at once
        self.kv_slot_capacity = (num_blocks - 1) // cfg.blocks_per_slot
        self.allocator = BlockAllocator(num_blocks)
        self.radix = RadixCache(self.allocator, cfg.block_size) if cfg.prefix_cache else None
        dev = self.device
        self._swap = (
            SwapPool(
                num_layers=mcfg.num_hidden_layers, block_size=cfg.block_size,
                num_kv_heads=n_kv, head_dim=mcfg.head_dim, dtype=store_dtype,
                capacity_gb=cfg.swap_gb, quantized=quantized,
                pin_memory=dev.type == "cuda",
            )
            if cfg.swap_gb and cfg.swap_gb > 0
            else None
        )
        #: per-request usage ledger (None = disabled: every hook site pays
        #: one truthiness check)
        self.usage = UsageLedger() if cfg.usage_accounting else None
        self.scheduler = SlotScheduler(
            cfg.num_slots, self.allocator, cfg.block_size, cfg.max_seq_len, radix=self.radix,
            usage=self.usage,
        )
        self._cow_copies = 0
        shape = (mcfg.num_hidden_layers, num_blocks, cfg.block_size, n_kv, mcfg.head_dim)
        # never reassigned: the graphs hold these pointers
        self._pages = {
            "k": torch.zeros(shape, dtype=store_dtype, device=dev),
            "v": torch.zeros(shape, dtype=store_dtype, device=dev),
        }
        if quantized:
            # all-ones init: a never-written row dequantizes to exactly 0
            self._pages["k_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
            self._pages["v_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)

        # host mirrors the dispatches stage from
        self._block_tables = np.zeros((cfg.num_slots, mb), np.int32)
        self._pending_tok = np.zeros((cfg.num_slots,), np.int32)

        # the programs' static operands and outputs. Masks are int32 (the
        # paged step takes any nonzero as True) so each program's operands
        # are one buffer and one copy. Prefill staging has a copy for each
        # chunk an iteration can dispatch (one per slot) and one more, so a
        # chunk staged under the in-flight round never waits for it.
        n, c, burst = cfg.num_slots, cfg.prefill_chunk, cfg.decode_burst
        decode_fields = {"tables": (n, mb), "pos0": (n,), "toks": (n, 1), "active": (n, 1)}
        self._decode_ops = _Operands(decode_fields, dev, depth=2)
        self._prefill_ops = _Operands(
            {"chunk": (1, c), "table": (1, mb), "start": (1,), "valid": (1, c), "last": (1,)},
            dev, depth=n + 1)
        # each program's outputs land by one copy behind an event; one round
        # is in flight at a time, and its harvest precedes the next dispatch
        self._prefill_io = _Outputs({"tok": (1,)}, dev)
        self._prefill_out = self._prefill_io.views["tok"]
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None  # shared
        self._programs = {"prefill": _Program("prefill", self._prefill_chunk, dev, pool)}
        # the decode programs: the plain burst and the lane burst, or with
        # spec_k the spec round and its lane twin (one round's [num_slots,
        # k+1] tokens and [num_slots] accepted lengths land by one copy)
        if self._spec is None:
            self._decode_name, self._lane_name = "decode", "lane_decode"
            self._decode_io = _Outputs({"tok": (burst, n)}, dev)
            self._decode_out = self._decode_io.views["tok"]
            self._programs["decode"] = _Program("decode", self._decode_burst, dev, pool)
        else:
            self._decode_name, self._lane_name = "spec_decode", "lane_spec_decode"
            self._spec_io = _Outputs({"tok": (n, cfg.spec_k + 1), "accept": (n,)}, dev)
            self._programs["spec_decode"] = _Program("spec_decode", self._spec_decode, dev, pool)
        if self._psampling:
            topn = max(int(cfg.logprobs_topn), 1)
            lane_fields = {name: (n,) for name, _, _ in LANE_SPECS}
            lane_fields["rep_ring"] = (n, cfg.rep_window)
            self._lane_ops = _Operands({**decode_fields, **lane_fields}, dev, depth=2,
                                       floats=_FLOAT_LANES)
            if self._spec is None:
                self._lane_out = _Outputs(
                    {"tok": (burst, n), "logp": (burst, n), "top_vals": (burst, n, topn),
                     "top_ids": (burst, n, topn)}, dev, floats=frozenset({"logp", "top_vals"}))
            g = cfg.grammar_slots + 1
            # written in place, row by row: the lane graph holds their pointers
            self._gmask = torch.ones((g, cfg.grammar_states, self._vocab_size),
                                     dtype=torch.bool, device=dev)
            self._gtrans = torch.zeros((g, cfg.grammar_states, self._vocab_size),
                                       dtype=torch.int32, device=dev)
            # the prompt-final logits, for the first-token pick of a request
            # that is not inert
            self._prefill_logits = torch.zeros((1, self._vocab_size), dtype=torch.float32,
                                               device=dev)
            # captured at the first dispatch that needs it
            lane_fn = self._lane_decode_burst if self._spec is None else self._lane_spec_decode
            self._programs[self._lane_name] = _Program(self._lane_name, lane_fn, dev, pool)

        self._launches_at_start = _paged_attention.launches
        self._decode_launches_at_start = _paged_attention.decode_launches
        self._iterations = 0
        self._tokens_emitted = 0
        self._out_of_blocks_total = 0
        self._preemptions = 0
        self._swapped_out_blocks = 0
        self._swapped_in_blocks = 0
        self._deadline_expired = 0
        # speculative accounting (accept rate = accepted / drafted): drafted
        # counts spec_k per live lane per round, accepted the verify-agreed
        # prefix length (the correction token is free and counted in neither)
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._start_time: float | None = None
        # the telemetry step row's throughput window
        self._last_stats_t: float | None = None
        self._last_stats_tokens = 0
        #: the active tracer, read once a step() (None when tracing is off)
        self._tr = None
        self._completed: deque[Request] = deque(maxlen=max(1, int(cfg.completed_history)))
        self._completed_total = 0
        #: the live requests of the round dispatched and not yet harvested
        #: (None = nothing in flight), and which program ran it ("decode" or
        #: "lane_decode", or a spec program). Slots cannot be reassigned
        #: while a round is in flight (eviction only touches FINISHED
        #: requests, and members only finish at harvest), so ``req.slot``
        #: still indexes the round's tokens when the harvest lands
        self._inflight: list[Request] | None = None
        self._inflight_kind = self._decode_name
        #: finishes a mid-schedule fence (swap-out) harvested; drained into
        #: the same step's finished list at its harvest point, so a fenced
        #: finish is returned exactly once
        self._harvest_backlog: list[Request] = []
        # per-iteration flight recorder (None = disabled: step() pays one
        # `is None` check), registered process-globally
        self._flight = FlightRecorder(cfg.flight_history) if cfg.flight_history else None
        if self._flight is not None:
            set_active_flight_recorder(self._flight)
        self._fl_phases: dict | None = None

    # -- device programs (fixed shapes, static buffers only) -----------------

    def _decode_burst(self) -> None:
        """``decode_burst`` paged steps over every slot, reading the decode
        operands and writing ``[burst, num_slots]`` int32 tokens into
        ``_decode_out``; tokens stay on the device between steps. Greedy:
        the first maximal index, as ``jnp.argmax``."""
        ops = self._decode_ops.views
        toks, pos = ops["toks"], ops["pos0"]
        for t in range(self.config.decode_burst):
            step = self.model.paged_step(
                toks, self._pages, ops["tables"], pos,
                paged_write_mask=ops["active"],  # PREFILL/free lanes must not scribble
            )
            tok = torch.argmax(step.logits[:, -1, :], dim=-1).to(torch.int32)
            self._decode_out[t].copy_(tok)
            toks, pos = tok[:, None], pos + 1

    def _lane_decode_burst(self) -> None:
        """The lane twin of :meth:`_decode_burst` (JAX
        ``_build_lane_decode_fn``): each step runs :func:`pick_tokens` over
        the lanes and advances the per-slot DFA state on the device (the
        host re-derives the authoritative state per emitted token, so a
        discarded burst tail never corrupts it); tokens, their logprobs and
        the top-N land in ``_lane_out``."""
        cfg = self.config
        ops = self._lane_ops.views
        out = self._lane_out.views
        lanes = {name: ops[name] for name, _, _ in LANE_SPECS}
        lanes["rep_ring"] = ops["rep_ring"]
        toks, pos, dfa = ops["toks"], ops["pos0"], ops["dfa_state"]
        rows = ops["grammar_row"].long()
        for t in range(cfg.decode_burst):
            step = self.model.paged_step(
                toks, self._pages, ops["tables"], pos, paged_write_mask=ops["active"],
            )
            tok, logp, top_vals, top_ids = pick_tokens(
                step.logits[:, -1, :], lanes, dfa, t, self._gmask, cfg.seed,
                eos_id=cfg.eos_token_id, logprobs_topn=cfg.logprobs_topn,
            )
            dfa = self._gtrans[rows, dfa.long(), tok.long()]
            out["tok"][t].copy_(tok)
            out["logp"][t].copy_(logp)
            out["top_vals"][t].copy_(top_vals)
            out["top_ids"][t].copy_(top_ids)
            toks, pos = tok[:, None], pos + 1

    def _draft_and_verify(self, ops, draft_pick):
        """The body both spec programs share (JAX ``_build_spec_decode_fn``):
        ``spec_k`` steps of the early-exit draft at ``[num_slots, 1]``, each
        writing its K/V in place into the first N layers of the target's
        pool at positions ``pos0 .. pos0+k-1`` (the verify below rewrites
        every one of them, in every layer, before anything reads it), then
        ONE verify forward of ``[pending, d_1 .. d_k]`` at ``[num_slots,
        k+1]`` through all layers and the paged kernel. ``draft_pick(t,
        logits)`` picks step ``t``'s draft token from its ``[num_slots,
        vocab]`` logits. Returns the drafts ``[num_slots, k]`` and the verify
        logits ``[num_slots, k+1, vocab]``."""
        k = self.config.spec_k
        toks, pos0, active = ops["toks"], ops["pos0"], ops["active"]
        tok, pos, drafts = toks, pos0, []
        for t in range(k):
            step = self._draft_step(
                tok, self._pages, ops["tables"], pos,
                paged_write_mask=active,  # PREFILL/free lanes must not scribble
            )
            nxt = draft_pick(t, step.logits[:, -1, :])
            drafts.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        d = torch.stack(drafts, dim=1)
        chunk = torch.cat([toks, d], dim=1)  # [num_slots, k+1]
        step = self.model.paged_step(
            chunk, self._pages, ops["tables"], pos0,
            paged_write_mask=active.expand(-1, k + 1),
        )
        return d, step.logits

    def _spec_decode(self) -> None:
        """The greedy spec round (JAX ``_build_spec_decode_fn``): draft,
        verify, then :func:`~..generation.spec_accept_tokens` on the device;
        ``[num_slots, k+1]`` tokens and ``[num_slots]`` accepted lengths into
        ``_spec_io``."""
        ops = self._decode_ops.views

        def greedy(_t, logits):
            return torch.argmax(logits, dim=-1).to(torch.int32)

        d, logits = self._draft_and_verify(ops, greedy)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)  # [num_slots, k+1]
        accept, tok_seq = spec_accept_tokens(d, preds)
        out = self._spec_io.views
        out["tok"].copy_(tok_seq)
        out["accept"].copy_(accept)

    def _lane_spec_decode(self) -> None:
        """The per-slot spec round (JAX ``_build_lane_spec_decode_fn``): the
        draft proposes through the lane transform (grammar mask, filters,
        sampled slots by an inverse-CDF pick under ``TAG_DRAFT``), the
        verify filters each position with the DFA state its prefix reached,
        greedy slots keep the exact longest-agreeing prefix of the filtered
        argmax, and sampled slots run :func:`~.sampling.rejection_accept`
        (accept uniforms under ``TAG_ACCEPT``). The repetition ring is held
        constant across the round, as in JAX (consistent between ``p`` and
        ``q``, so the acceptance identity is unaffected)."""
        cfg = self.config
        k, seed, eos = cfg.spec_k, cfg.seed, cfg.eos_token_id
        ops = self._lane_ops.views
        lanes = {name: ops[name] for name, _, _ in LANE_SPECS}
        lanes["rep_ring"] = ops["rep_ring"]
        rows = lanes["grammar_row"].long()
        sample = lanes["sample"] != 0
        state = {"dfa": lanes["dfa_state"]}
        q = []

        def lane_pick(t, logits):
            filt = apply_filters(logits.float(), lanes, state["dfa"], lanes["pos"] + t,
                                 self._gmask, eos)
            greedy = torch.argmax(filt, dim=-1).to(torch.int32)
            logq = dist_logprobs(filt, lanes)
            u = slot_uniforms(seed, TAG_DRAFT, lanes["seed"], lanes["pos"] + t)
            nxt = torch.where(sample, inverse_cdf_pick(logq, u), greedy)
            q.append(torch.exp(logq))
            state["dfa"] = self._gtrans[rows, state["dfa"].long(), nxt.long()]
            return nxt

        d, logits = self._draft_and_verify(ops, lane_pick)
        tlogits = logits.float()  # [num_slots, k+1, vocab]
        # DFA states along the draft path: the verify filters each position
        # with the state its PREFIX put the automaton in (the mask re-check)
        states = [lanes["dfa_state"]]
        for j in range(k):
            states.append(self._gtrans[rows, states[j].long(), d[:, j].long()])
        filts = [apply_filters(tlogits[:, j, :], lanes, states[j], lanes["pos"] + j,
                               self._gmask, eos) for j in range(k + 1)]
        preds = torch.stack([torch.argmax(f, dim=-1) for f in filts], dim=1).to(torch.int32)
        accept_g, seq_g = spec_accept_tokens(d, preds)
        p = torch.stack([torch.exp(dist_logprobs(f, lanes)) for f in filts], dim=0)
        u = torch.stack([slot_uniforms(seed, TAG_ACCEPT, lanes["seed"], lanes["pos"] + j)
                         for j in range(k)], dim=1)  # [num_slots, k]
        accept_s, seq_s = rejection_accept(d, p, torch.stack(q, dim=0), u, seed,
                                           lanes["seed"], lanes["pos"])
        out = self._spec_io.views
        out["tok"].copy_(torch.where(sample[:, None], seq_s, seq_g))
        out["accept"].copy_(torch.where(sample, accept_s, accept_g))

    def _prefill_chunk(self) -> None:
        """One ``[1, prefill_chunk]`` chunk through the paged step (the
        padded tail dropped by ``valid``), then the greedy pick at the
        static ``last`` index: one token into ``_prefill_out`` (and, with
        the lanes on, that row's logits into ``_prefill_logits``), never
        the ``[1, c, vocab]`` logits. Only a chunk that ends its prompt
        reads them."""
        ops = self._prefill_ops.views
        step = self.model.paged_step(
            ops["chunk"], self._pages, ops["table"], ops["start"],
            paged_write_mask=ops["valid"],
        )
        row = step.logits[0].index_select(0, ops["last"])
        self._prefill_out.copy_(torch.argmax(row, dim=-1).to(torch.int32))
        if self._psampling:
            self._prefill_logits.copy_(row)

    # -- public API ----------------------------------------------------------

    def add_request(
        self,
        prompt,
        max_new_tokens: int | None = None,
        arrival_time: float | None = None,
        priority: str = "interactive",
        deadline_ms: float | None = None,
        sampling=None,
        grammar: dict | None = None,
        tenant: str | None = None,
        logprobs: int | None = None,
        trace_id: str | None = None,
        upstream_hop: bool = False,
    ) -> Request:
        """Enqueue one request (``prompt`` = token ids).

        ``deadline_ms`` is a *relative* budget from now: once it elapses the
        scheduler finishes the request with
        ``finish_reason="deadline_exceeded"`` (partial output kept, blocks
        freed the same iteration); a malformed value raises ValueError.
        ``tenant`` is the usage ledger's accounting dimension: any non-empty
        string is taken (stripped, bounded), everything else is
        ``"default"`` — never an admission gate.

        ``trace_id`` is the request's distributed-trace identity: a
        well-formed supplied id survives verbatim, anything else is replaced
        by a generated one (tracing never rejects a request).
        ``upstream_hop=True`` declares that a routing tier dispatched the
        request and drew the flow arrow's tail: the engine lands its head at
        arrival. A standalone engine leaves it False.

        ``sampling`` is a :class:`~.sampling.SamplingParams` (or a dict of
        its fields) scoped to THIS request; ``None`` inherits the engine-wide
        defaults. ``logprobs`` (top-N, at most ``logprobs_topn``) sets the
        params' ``logprobs``. ``grammar`` is a constrained-decoding spec
        (``{"type": "regex", ...}`` or ``{"type": "json_schema", ...}``)
        compiled here — admission fails loudly on an unsupported grammar or
        when every grammar row is held by a live request, never mid-decode."""
        if not self._psampling and (
            sampling is not None or grammar is not None or logprobs is not None
        ):
            raise ValueError(
                "per-request sampling/grammar/logprobs need per_slot_sampling=True "
                "(this engine was built with the lanes disabled)"
            )
        upstream = upstream_hop and valid_trace_id(trace_id)
        req = Request(
            prompt=[int(t) for t in np.asarray(prompt).reshape(-1)],
            max_new_tokens=int(
                self.config.max_new_tokens if max_new_tokens is None else max_new_tokens
            ),
            priority=priority,
            tenant=normalize_tenant(tenant),
            trace_id=ensure_trace_id(trace_id),
        )
        if arrival_time is not None:
            req.arrival_time = arrival_time
        if deadline_ms is not None:
            try:
                budget_ms = float(deadline_ms)
            except (TypeError, ValueError):
                budget_ms = float("nan")
            if not budget_ms > 0:  # also rejects NaN
                raise ValueError(
                    f"malformed deadline_ms {deadline_ms!r}: want a positive "
                    "number of milliseconds"
                )
            req.deadline = time.perf_counter() + budget_ms / 1000.0
        if self._psampling:
            params = resolve_sampling(sampling, self._default_sampling)
            if logprobs is not None:
                params = dataclasses.replace(params, logprobs=int(logprobs)).validate()
            if params.logprobs > self.config.logprobs_topn:
                raise ValueError(
                    f"request wants logprobs={params.logprobs} but the engine "
                    f"captures logprobs_topn={self.config.logprobs_topn}; raise "
                    "EngineConfig.logprobs_topn (the lane graph's output shape, so "
                    "it is per-engine, not per-request)"
                )
            req.sampling = params
            if grammar is not None:
                g = compile_grammar(
                    grammar, self._vocab_size,
                    eos_id=self.config.eos_token_id,
                    max_states=self.config.grammar_states,
                )
                req.grammar_row = self._acquire_grammar_row(g)
                req.dfa_state = g.start
        try:
            self.scheduler.submit(req)
        except BaseException:
            self._release_grammar_row(req)
            raise
        if self.usage is not None:
            self.usage.begin(req)
        tr = get_tracer()
        if tr:
            # the request's async span opens at arrival, stamped with its own
            # arrival_time so span math gives the engine's TTFT exactly
            tr.request_begin(
                req.trace_id, "req/arrive", ts=req.arrival_time,
                request_id=req.request_id, prompt_tokens=req.prompt_len,
                max_new_tokens=req.max_new_tokens, priority=req.priority,
            )
            if upstream:
                tr.flow(req.trace_id, "f")
        return req

    def step(self) -> list[Request]:
        """One engine iteration: evict finished → admit queued (and run
        their copy-on-write block copies) → one prefill chunk per
        prefilling slot → harvest the in-flight round → one decode dispatch
        over every decoding slot. Returns the requests that finished this
        iteration.

        With ``async_dispatch`` the round dispatched here is harvested at
        the next iteration's harvest point, so that iteration's schedule and
        prefill work runs while the device computes; tokens surface one
        ``step()`` later and ``run_until_idle()``/``stream()`` step on until
        the drain flush lands them. A prefill chunk that ends its prompt
        reads its first token, and that read waits for the in-flight round
        (both run on one stream), as it does in the JAX engine."""
        if self._start_time is None:
            self._start_time = self._last_stats_t = time.perf_counter()
        # ONE global read an iteration when tracing is off: every request
        # event site below keys off this cached (falsy) handle
        self._tr = get_tracer() or None
        sched = self.scheduler
        finished: list[Request] = []
        fl = self._flight
        self._fl_begin()
        deferred_deadline: list[Request] = []
        with trace_span("serve/schedule"):
            if sched.deadline_live:  # guarded: deadline-free serving = one int check
                now = time.perf_counter()
                inflight_slots = None
                if self._inflight is not None:
                    # an expired member of the in-flight round still has a
                    # token landing at this step's harvest (the token the
                    # synchronous engine emitted last step): its expiry waits
                    # for the harvest point, so the two loops stay
                    # token-identical
                    inflight_slots = {r.slot for r in self._inflight}
                for req in sched.expire_deadlines(now, skip_slots=inflight_slots):
                    if req.slot is None:
                        self._release_expired_queued(req)
                    self._deadline_expired += 1
                    finished.append(req)
                if inflight_slots:
                    deferred_deadline = [r for r in self._inflight
                                         if r.deadline is not None and now > r.deadline]
            sched.evict_finished()
            self._admit_and_place()

        self._fl_switch("prefill")
        with trace_span("serve/prefill"):
            for req in sched.active(RequestState.PREFILL):
                t0_pf = time.perf_counter()
                self._prefill_one_chunk(req, finished)
                if self.usage is not None:
                    self.usage.accrue_prefill(req, time.perf_counter() - t0_pf)
        # harvest point: the previous iteration's round lands here. Backlog
        # entries were harvested by a mid-schedule fence (swap-out) and
        # drain into THIS step's finished list
        if self._harvest_backlog:
            finished.extend(self._harvest_backlog)
            self._harvest_backlog.clear()
        self._harvest_inflight(finished)
        for req in deferred_deadline:
            # the member's in-flight token has now been emitted: expire it
            # before the next dispatch; blocks free at the next evict
            if req.state is RequestState.DECODE:
                req.finish_reason = "deadline_exceeded"
                req.finish_time = time.perf_counter()
                req.state = RequestState.FINISHED
                self._deadline_expired += 1
                finished.append(req)

        self._fl_switch("dispatch")
        decoding = sched.active(RequestState.DECODE)
        if decoding:
            with trace_span("serve/decode", slots=len(decoding)):
                self._dispatch_decode(decoding, finished)
        if not self.config.async_dispatch:
            self._harvest_inflight(finished)  # the synchronous loop

        self._fl_switch("harvest")
        self._iterations += 1
        for req in finished:
            self._release_grammar_row(req)
        self._completed.extend(finished)
        self._completed_total += len(finished)
        if self._tr is not None:
            for req in finished:
                # exactly one end event a request, whatever path finished it
                self._tr.request_end(
                    req.trace_id, "req/finish", ts=req.finish_time,
                    finish_reason=req.finish_reason,
                    new_tokens=len(req.output_tokens),
                    ttft_s=req.ttft_s, tpot_s=req.tpot_s,
                )
        if self.usage is not None:
            # close each finished request's account now (held blocks drop to
            # 0 on both sides of the block-second integral)
            for req in finished:
                summary = self.usage.finish(req)
                if summary is not None:  # exactly-once across re-lists
                    req.usage = summary
        self._emit_telemetry(finished)
        rec = self._fl_finish()
        if rec is not None:
            t0, wall, phases, overlap = rec
            entry = fl.record(self._iterations, t0, wall, overlap_hidden_s=overlap, **phases)
            fl.current_phase = "idle"
            reg = get_active_registry()
            if reg:
                observe_flight(reg, entry)
            if self._tr is not None:
                # the host share as a counter track, and one instant an
                # iteration carrying its phase breakdown
                self._tr.counter("serve/iteration", fl.host_fraction())
                self._tr.instant("serve/flight",
                                 **{k: v for k, v in entry.items() if k != "t_start"})
        return finished

    def has_work(self) -> bool:
        """Requests queued or in slots, or a round not yet harvested."""
        return self.scheduler.has_work() or self._inflight is not None

    def run_until_idle(self, max_iterations: int | None = None) -> list[Request]:
        """Drain queue + slots + the in-flight round; returns every request
        finished meanwhile (``max_iterations`` bounds the loop as a
        scheduling-bug guard; the drain flush counts as an iteration)."""
        done: list[Request] = []
        it = 0
        while self.has_work():
            if max_iterations is not None and it >= max_iterations:
                raise RuntimeError(f"engine not idle after {it} iterations")
            done.extend(self.step())
            it += 1
        return done

    def stream(self, prompt, max_new_tokens: int | None = None, **request):
        """Generator yielding this request's tokens as the engine emits
        them (other in-flight requests keep decoding underneath). With stop
        sequences, tokens lag by ``max(len(stop)) - 1`` so a matched stop
        sequence, which the engine trims, is never yielded."""
        req = self.add_request(prompt, max_new_tokens, **request)
        stops = req.sampling.stop if req.sampling is not None else ()
        hold = max((len(s) for s in stops), default=1) - 1
        served = 0
        while req.state is not RequestState.FINISHED:
            self.step()
            while served < len(req.output_tokens) - hold:
                yield req.output_tokens[served]
                served += 1
        while served < len(req.output_tokens):
            yield req.output_tokens[served]
            served += 1

    def reset_stats(self) -> None:
        """Zero the measurement state (iterations, tokens, completions, the
        wall clock, the sampling, prefix-cache, swap, deadline and spec
        counters, the flight ring, the usage ledger's accruals) and keep the
        graphs, the pools, the radix trie and the capture and launch
        counters, so a run can warm up, reset and measure."""
        self._iterations = 0
        self._tokens_emitted = 0
        self._out_of_blocks_total = 0
        self._preemptions = 0
        self._swapped_out_blocks = 0
        self._swapped_in_blocks = 0
        self._deadline_expired = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._rej_drafted = 0
        self._rej_accepted = 0
        self._start_time = None
        self._last_stats_t = None
        self._last_stats_tokens = 0
        self._completed.clear()
        self._completed_total = 0
        self._sampled_greedy = 0
        self._sampled_sample = 0
        self._grammar_masked_steps = 0
        self._first_token_picks = 0
        self._cow_copies = 0
        self.scheduler.prompt_tokens_admitted = 0
        self.scheduler.prefix_hit_tokens = 0
        if self.radix is not None:
            self.radix.evicted_blocks = 0
            self.radix.inserted_blocks = 0
        if self._flight is not None:
            self._flight.reset()
        if self.usage is not None:
            self.usage.reset()

    def _launch_counts(self) -> dict:
        """Paged-attention launches this engine caused: eager launches (the
        counters' increments outside any capture) plus, for each captured
        program, its replays × the launches its capture recorded; ``decode``
        counts the launches with one query a row."""
        progs = self._programs.values()
        recorded = sum(p.launches_captured for p in progs)
        recorded_decode = sum(p.decode_launches_captured for p in progs)
        eager = _paged_attention.launches - self._launches_at_start - recorded
        eager_decode = (_paged_attention.decode_launches - self._decode_launches_at_start
                        - recorded_decode)
        return {
            "eager": eager,
            "eager_decode": eager_decode,
            "total": eager + sum(p.replays * p.launches_captured for p in progs),
            "decode": eager_decode + sum(p.replays * p.decode_launches_captured for p in progs),
        }

    def _spec_stats(self) -> dict:
        """Speculative health (JAX ``_spec_stats``; the accept rate is the
        TPOT lever: each round costs one dispatch and emits accept+1
        tokens); empty when speculation is off."""
        if self._spec is None:
            return {}
        return {
            "spec_k": self.config.spec_k,
            "spec_draft": str(self._spec),
            "spec_drafted_tokens": self._spec_drafted,
            "spec_accepted_tokens": self._spec_accepted,
            "spec_accept_rate": (
                self._spec_accepted / self._spec_drafted if self._spec_drafted else 0.0
            ),
        }

    def _sampling_stats(self) -> dict:
        """Per-slot sampling/grammar health (JAX ``_sampling_stats``); empty
        when the lanes are disabled. The rejection counters only appear with
        speculation armed."""
        if not self._psampling:
            return {}
        out = {
            "sampled_tokens_greedy": self._sampled_greedy,
            "sampled_tokens_sample": self._sampled_sample,
            "grammar_masked_steps": self._grammar_masked_steps,
            "grammar_rows_live": sum(1 for r in self._row_refs if r > 0),
            "first_token_picks": self._first_token_picks,
        }
        if self._spec is not None:
            out["rejection_drafted_tokens"] = self._rej_drafted
            out["rejection_accepted_tokens"] = self._rej_accepted
            out["rejection_accept_rate"] = (
                self._rej_accepted / self._rej_drafted if self._rej_drafted else 0.0
            )
        return out

    def stats(self) -> dict:
        """Serving health: tokens, slots and blocks, TTFT/TPOT percentiles over
        the completion window, the captures (``decode_compiles`` for the
        plain burst, or the spec round with ``spec_k``;
        ``lane_decode_compiles`` for the lane burst or the lane spec round;
        ``prefill_compiles``; the JAX engine's key names) and replays of the
        programs, the paged-attention kernel launches this engine caused
        (0 on the CPU, where the plain version runs), the sampling,
        prefix-cache, swap, deadline and spec counters, the usage ledger's
        snapshot, and the flight recorder's ``host_fraction`` and per-phase
        percentiles."""
        sched = self.scheduler
        launches = self._launch_counts()
        cached = self.radix.cached_block_count if self.radix is not None else 0
        cached_exclusive = self.radix.exclusive_block_count() if self.radix is not None else 0
        lane = self._programs.get(self._lane_name)
        out = {
            "iterations": self._iterations,
            "completed": self._completed_total,
            "queue_depth": sched.queue_depth,
            "active_slots": len(sched.active()),
            "num_slots": self.config.num_slots,
            "tokens_emitted": self._tokens_emitted,
            "decode_compiles": self._programs[self._decode_name].captures,
            "lane_decode_compiles": lane.captures if lane is not None else 0,
            "prefill_compiles": self._programs["prefill"].captures,
            "paged_attention_launches": launches["total"],
            "paged_attention_decode_launches": launches["decode"],
            "paged_attention_eager_launches": launches["eager"],
            "cuda_graphs": {
                name: {"runs": p.runs, "replays": p.replays,
                       "launches_captured": p.launches_captured,
                       "decode_launches_captured": p.decode_launches_captured}
                for name, p in self._programs.items()
            },
            "async_dispatch": self.config.async_dispatch,
            "device": str(self.device),
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "kv_slot_capacity": self.kv_slot_capacity,
            "free_blocks": self.allocator.free_count,
            # blocks live requests hold (shared prefix blocks included);
            # blocks held ONLY by the radix cache are reported apart — at
            # idle, allocated_blocks is 0 and free + cached == usable
            "allocated_blocks": self.allocator.allocated_count - cached_exclusive,
            "cached_blocks": cached,
            "cached_exclusive_blocks": cached_exclusive,
            "prefix_hit_tokens": sched.prefix_hit_tokens,
            "prefix_hit_ratio": (
                sched.prefix_hit_tokens / sched.prompt_tokens_admitted
                if sched.prompt_tokens_admitted else 0.0
            ),
            "cow_copies": self._cow_copies,
            "preemptions": self._preemptions,
            "swapped_out_blocks": self._swapped_out_blocks,
            "swapped_in_blocks": self._swapped_in_blocks,
            "out_of_blocks_total": self._out_of_blocks_total,
            "deadline_expired_total": self._deadline_expired,
        }
        out.update(self._spec_stats())
        out.update(self._sampling_stats())
        if self.usage is not None:
            # totals, capped by_tenant, heavy hitters and the conservation
            # partner totals (device_wait_seconds / pool_block_seconds)
            out["usage"] = self.usage.snapshot()
        if self.radix is not None:
            out["radix_inserted_blocks"] = self.radix.inserted_blocks
            out["radix_evicted_blocks"] = self.radix.evicted_blocks
        if self._swap is not None:
            out["swap_used_blocks"] = self._swap.used_blocks
            out["swap_capacity_blocks"] = self._swap.capacity_blocks
            out["swap_pool_host_bytes"] = self._swap.capacity_blocks * self._swap.bytes_per_block
        if self._flight is not None:
            out.update(self._flight.summary())
        if self._start_time is not None:
            elapsed = time.perf_counter() - self._start_time
            out["elapsed_s"] = elapsed
            out["tokens_per_sec"] = self._tokens_emitted / elapsed if elapsed > 0 else 0.0
        window = list(self._completed)
        for key in ("ttft_s", "tpot_s"):
            values = [getattr(r, key) for r in window if getattr(r, key) is not None]
            if values:
                out[key] = {
                    "p50": float(np.percentile(values, 50)),
                    "p99": float(np.percentile(values, 99)),
                }
        return out

    # -- flight accounting (port of the JAX engine's _fl_* helpers) ---------

    def _fl_begin(self) -> None:
        """Open the iteration's flight accounting in the "schedule" phase
        (no-op when the recorder is disabled)."""
        if self._flight is None:
            return
        t = time.perf_counter()
        self._fl_t0 = self._fl_last = t
        self._fl_phases = dict.fromkeys(ITERATION_PHASES, 0.0)
        self._fl_overlap = 0.0
        self._fl_cur = "schedule"
        # an interval counts as hidden iff a round was in flight when it
        # opened (and it is not device_wait)
        self._fl_hidden = self._inflight is not None
        self._flight.current_phase = "schedule"

    def _fl_switch(self, phase: str) -> float | None:
        """Close the open interval into its phase bucket and open
        ``phase``. Phases may be re-entered ("harvest" at the harvest point
        and for bookkeeping); the buckets accumulate, and their sum
        telescopes to the iteration wall, which ``FlightRecorder.record``
        asserts. Returns the closed interval's duration (None when the
        recorder is off): the usage ledger accrues the exact
        ``device_wait`` float the flight recorder does."""
        if self._fl_phases is None:
            return None
        t = time.perf_counter()
        dt = t - self._fl_last
        self._fl_phases[self._fl_cur] += dt
        if self._fl_hidden:
            self._fl_overlap += dt
        self._fl_last = t
        self._fl_cur = phase
        # device_wait is the residual the host could NOT hide
        self._fl_hidden = self._inflight is not None and phase != "device_wait"
        self._flight.current_phase = phase
        return dt

    def _fl_finish(self):
        """Close the last interval; ``(t0, wall_s, phases, overlap_hidden_s)``
        for ``FlightRecorder.record``, or None when the recorder is off."""
        if self._fl_phases is None:
            return None
        t = time.perf_counter()
        dt = t - self._fl_last
        self._fl_phases[self._fl_cur] += dt
        if self._fl_hidden:
            self._fl_overlap += dt
        phases, self._fl_phases = self._fl_phases, None
        self._fl_cur = "idle"
        return self._fl_t0, t - self._fl_t0, phases, self._fl_overlap

    # -- iteration internals -------------------------------------------------

    def _admit_and_place(self) -> None:
        """Admission and its device obligations (copy-on-write copies,
        swap-in restores), looped with priority preemption: when the head of
        the waiting queue outranks a running request and cannot be admitted,
        the lowest-priority victim is swapped to host memory and admission
        retries (JAX ``_admit_and_place``). Strictly higher rank only: equal
        classes never thrash each other at admission.

        A fresh hit's prefill starts at the chunk boundary at or below the
        matched length (the chunks sit where they would without the cache)
        and writes only the positions past the match. The paged kernel cuts
        each chunk's keys into splits by the chunk's start, so the same
        starts give the same sums: with the cache or without it, a request's
        K/V and tokens are the same bits. A restored request resumes where
        it stood."""
        sched = self.scheduler
        chunk = self.config.prefill_chunk
        while True:
            for req in sched.admit():
                if not req.preempted:
                    req.prefill_pos -= req.prefill_pos % chunk
                if self._tr is not None:
                    now = time.perf_counter()
                    self._tr.request_instant(
                        req.trace_id, "req/admit", ts=now, slot=req.slot,
                        queued_s=now - req.arrival_time,
                        radix_hit_tokens=req.matched_tokens,
                        restored=req.preempted,
                    )
                self._place_admitted(req)
            head = sched.peek_head()
            if head is None or self._swap is None:
                return
            victim = sched.pick_victim()
            if victim is None or priority_rank(victim.priority) <= priority_rank(head.priority):
                return
            if not self._swap_out(victim):
                return  # swap full: the head waits its turn

    def _place_admitted(self, req: Request) -> None:
        """The device half of admission (JAX ``_place_admitted``): restore a
        preempted request's swapped rows into its freshly allocated blocks
        (one copy up from pinned memory, one ``index_copy_`` per pool), or
        run the pending copy-on-write block copy of a partial-prefix hit, in
        place on every pool, on the engine's stream. That orders either
        after the in-flight round; both write blocks no in-flight lane
        reads."""
        if req.swap_plan:
            swap_t0 = time.perf_counter()
            n = len(req.swap_plan)
            ids = torch.tensor([req.blocks[idx] for idx, _ in req.swap_plan],
                               dtype=torch.long, device=self.device)
            handles = [h for _, h in req.swap_plan]
            rows = self._swap.load_rows(handles).to(self.device, non_blocking=True)
            parts = self._swap.split_rows(rows, raw=True)
            for name, pool in self._pages.items():  # byte views: every pool dtype
                pool.view(torch.uint8).index_copy_(1, ids, parts[name].transpose(0, 1))
            for h in handles:
                self._swap.release(h)
            self._swapped_in_blocks += n
            req.swap_plan = []
            req.preempted = False
            if self.usage is not None:
                # restored blocks re-enter the held count (admit() stamped
                # the pre-restore count with swap_plan still pending)
                self.usage.accrue_swap(req, bytes_in=n * self._swap.bytes_per_block)
                self.usage.update_blocks(req)
            if self._tr is not None:
                # swap-in stalls are the tail-latency share this event names
                self._tr.request_instant(
                    req.trace_id, "req/swap_in", blocks=n,
                    seconds=time.perf_counter() - swap_t0,
                )
            if req.state is RequestState.DECODE:
                # resume feeding the last emitted token at context_len
                self._pending_tok[req.slot] = req.output_tokens[-1]
        elif req.cow is not None:
            src, dst = req.cow
            for pool in self._pages.values():
                pool[:, dst].copy_(pool[:, src])
            self.allocator.decref([src])  # drop the eviction pin
            self._cow_copies += 1
            req.cow = None

    def _fence_inflight(self) -> bool:
        """Harvest the in-flight round before host code reads pool rows it
        may still be writing (JAX ``_fence_inflight``, before swap-out's
        gather). Its tokens land on their requests now (an in-flight member
        already owns that token in the synchronous engine's timeline); its
        finishes park in the backlog until the step's harvest point; the
        evict sweep runs so the caller's capacity math sees freed slots.
        Returns True when a round was fenced."""
        if self._inflight is None:
            return False
        prev = self._fl_cur if self._fl_phases is not None else None
        self._harvest_inflight(self._harvest_backlog)
        self.scheduler.evict_finished()
        if prev is not None:
            self._fl_switch(prev)  # resume the interrupted phase
        return True

    def _swap_out(self, victim: Request) -> bool:
        """Preempt ``victim`` (JAX ``_swap_out``): copy its unshared blocks
        to the host swap pool, release them, free the slot, and re-queue the
        request at the front of its class. "Unshared" means no other live
        request reads the block: a block shared only with the radix cache
        goes too (the cache's copy stays resident at refcount 1,
        evictable); a block another live request maps stays resident under
        the victim's reference. The blocks are gathered on the device into
        one ``[n, bytes_per_block]`` byte buffer and land in pinned memory by
        one non-blocking copy behind an event. Returns False when the swap
        pool cannot hold the victim."""
        swap_t0 = time.perf_counter()
        # fence FIRST: the in-flight round may still write the victim's rows
        # and holds a token the synchronous engine already emitted. The
        # fence may finish the victim or free its slot: then there is
        # nothing to swap, and the caller retries
        if self._fence_inflight() and (
            victim.state is RequestState.FINISHED or victim.slot is None
        ):
            return True
        swappable = []
        for i, b in enumerate(victim.blocks):
            rc = self.allocator.refcount(b)
            if rc == 1 or (rc == 2 and self.radix is not None and self.radix.is_cached(b)):
                swappable.append(i)
        if self._swap is None or not self._swap.can_hold(len(swappable)):
            return False
        plan: list[tuple[int, int]] = []
        released = [victim.blocks[i] for i in swappable]
        if released:
            ids = torch.tensor(released, dtype=torch.long, device=self.device)
            # K, V (, K scales, V scales): the swap rows' field order
            rows = SwapPool.pack_rows([pool.view(torch.uint8).index_select(1, ids).transpose(0, 1)
                                       for pool in self._pages.values()])
            host = torch.empty(rows.shape, dtype=torch.uint8,
                               pin_memory=self.device.type == "cuda")
            host.copy_(rows, non_blocking=True)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            plan = list(zip(swappable, self._swap.store_rows(host)))
        # refcount-1 blocks return to the freelist; cache-shared ones stay
        # allocated under the cache's own (now sole, evictable) reference
        self.allocator.decref(released)
        victim.swap_plan = plan
        self.scheduler.requeue_preempted(victim)
        self._preemptions += 1
        self._swapped_out_blocks += len(plan)
        if self.usage is not None:
            # swapped blocks leave the victim's held count; retained shared
            # blocks keep accruing
            self.usage.accrue_swap(victim, bytes_out=len(plan) * self._swap.bytes_per_block)
            self.usage.update_blocks(victim)
        if self._tr is not None:
            self._tr.request_instant(
                victim.trace_id, "req/preempt", blocks=len(plan),
                swap_out_s=time.perf_counter() - swap_t0,
            )
        return True

    def _release_expired_queued(self, req: Request) -> None:
        """A request that expired while queued holds no slot, but a preempted
        one still owns swap handles and references on blocks it shares with
        live requests: release both (JAX ``_release_expired_queued``)."""
        if req.swap_plan:
            for _, handle in req.swap_plan:
                self._swap.release(handle)
            swapped = {idx for idx, _ in req.swap_plan}
            retained = [b for i, b in enumerate(req.blocks) if i not in swapped]
            if retained:
                self.allocator.decref(retained)
            req.swap_plan = []
        req.blocks = []
        if self.usage is not None:
            self.usage.update_blocks(req)

    def _force_finish_out_of_blocks(self, req: Request, finished: list[Request]) -> None:
        req.finish_reason = "out_of_blocks"
        req.finish_time = time.perf_counter()
        req.state = RequestState.FINISHED
        self._out_of_blocks_total += 1
        finished.append(req)
        # free the blocks now so the requests this truncation makes room
        # for can grow this iteration
        self.scheduler.evict_finished()

    def _sync_block_table(self, req: Request) -> None:
        row = self._block_tables[req.slot]
        row[:] = 0
        row[: len(req.blocks)] = req.blocks

    def _params(self, req: Request) -> SamplingParams:
        return req.sampling or self._default_sampling

    def _plain_ok(self, req: Request) -> bool:
        """True when the plain greedy argmax gives this request's tokens for
        a whole burst (or its first token): nothing sampled, no grammar row,
        no repetition penalty, no eos still to suppress, no logprobs."""
        p = self._params(req)
        return (
            not p.do_sample
            and p.repetition_penalty == 1.0
            and p.logprobs == 0
            and not req.grammar_row
            and (self.config.eos_token_id is None or len(req.output_tokens) >= p.min_tokens)
        )

    def _prefill_one_chunk(self, req: Request, finished: list[Request]) -> None:
        cfg = self.config
        start = req.prefill_pos
        end = min(start + cfg.prefill_chunk, req.prompt_len)
        self._sync_block_table(req)
        ops = self._prefill_ops.stage()
        ops["chunk"][0, : end - start] = req.prompt[start:end]
        # drops the padded tail, and the cached positions of a prefix hit:
        # recomputed (as queries) but never rewritten
        ops["valid"][0, max(0, req.matched_tokens - start): end - start] = 1
        ops["table"][0] = self._block_tables[req.slot]
        ops["start"][0] = start
        is_final = end == req.prompt_len
        # the first-token pick reads the prompt's last real position
        ops["last"][0] = (req.prompt_len - 1) - start if is_final else 0
        self._programs["prefill"].run(self._prefill_ops.upload)
        req.prefill_pos = end
        if self._tr is not None:
            # one event a chunk, never a token
            self._tr.request_instant(
                req.trace_id, "req/prefill_chunk", start=start, end=end, final=is_final,
            )
        if not is_final:
            return
        if self.radix is not None:
            # the prompt's full blocks now hold valid K/V: adopt them into
            # the prefix trie (refcount+1 = the cache's reference) so later
            # admissions with the same leading tokens map them
            self.radix.insert(req.prompt, req.blocks)
        lp_entry = None
        if self._psampling and not self._plain_ok(req):
            tok, lp_entry = self._first_token_pick(req)
        else:
            self._prefill_io.copy_to_host()
            self._prefill_io.wait()  # waits for the in-flight round too
            tok = int(self._prefill_io.host_views["tok"][0])
        self._emit_token(req, tok, finished, lp_entry)
        if req.state is not RequestState.FINISHED:
            req.state = RequestState.DECODE

    def _first_token_pick(self, req: Request):
        """The first token of a request that is not inert (JAX
        ``_first_token_pick``): one ``[1, vocab]`` run of the shared
        :func:`~.sampling.pick_tokens` over the prompt-final logits the
        prefill program kept, at output position 0, eagerly (its small
        lane tensors are copied up per call). Zero extra model forwards."""
        cfg = self.config
        params = self._params(req)
        host = blank_lanes(1, cfg.rep_window)
        set_slot_lane(
            host, 0, params, pos=0, grammar_row=req.grammar_row, dfa_state=req.dfa_state,
            recent=req.prompt if params.repetition_penalty != 1.0 else (),
        )
        lanes = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in host.items()}
        tok, logp, top_vals, top_ids = pick_tokens(
            self._prefill_logits, lanes, lanes["dfa_state"], 0, self._gmask, cfg.seed,
            eos_id=cfg.eos_token_id, logprobs_topn=cfg.logprobs_topn,
        )
        self._first_token_picks += 1
        tok, logp, top_vals, top_ids = (t.cpu() for t in (tok, logp, top_vals, top_ids))
        entry = None
        if params.logprobs:
            entry = self._logprob_entry(params, float(logp[0]), top_vals[0].numpy(),
                                        top_ids[0].numpy())
        return int(tok[0]), entry

    @staticmethod
    def _logprob_entry(params, logp: float, top_vals, top_ids) -> dict:
        n = int(params.logprobs)
        return {
            "logprob": logp,
            "top": [[int(i), float(v)] for i, v in zip(top_ids[:n], top_vals[:n])],
        }

    def _ensure_decode_capacity(self, req: Request, finished: list[Request]) -> None:
        """Block growth for one decode lane, with swap preemption under pool
        exhaustion (JAX ``_ensure_decode_capacity``). Refcount-1 cached
        blocks are evicted inside ``grow_for_decode``; when even that fails,
        the lowest-priority victim (possibly ``req`` itself; a request never
        preempts a higher-priority one) is swapped out and growth retries.
        Truncation (``out_of_blocks``) is the last resort: swap disabled or
        full, or ``req`` alone in the pool with nothing left to reclaim.
        Without swap the request that failed to grow is the one truncated,
        never an innocent neighbour that fit its reservation."""
        sched = self.scheduler
        while not sched.grow_for_decode(req, tokens_ahead=self._decode_lookahead):
            if self._swap is None:
                self._force_finish_out_of_blocks(req, finished)
                return
            victim = sched.pick_victim() or req
            if priority_rank(victim.priority) < priority_rank(req.priority):
                victim = req  # never evict someone more important than req
            if victim is req and len(sched.active()) <= 1:
                # req is the sole tenant: swapping itself out only helps if a
                # strictly higher-priority head admits first; otherwise it
                # would ping-pong through the swap pool forever
                head = sched.peek_head()
                if head is None or priority_rank(head.priority) >= priority_rank(req.priority):
                    self._force_finish_out_of_blocks(req, finished)
                    return
            if not self._swap_out(victim):
                # swap full: truncation only rolls downhill — a strictly
                # lower-priority victim pays; equal priority keeps the
                # requester-pays rule
                if priority_rank(victim.priority) > priority_rank(req.priority):
                    self._force_finish_out_of_blocks(victim, finished)
                    continue
                self._force_finish_out_of_blocks(req, finished)
                return
            if victim is req:
                return  # req is queued for re-admission; its lane goes idle

    def _dispatch_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        """Grow every lane, stage the round's operands, replay a burst (or,
        with ``spec_k``, a spec round) and start the copy of its outputs to
        the host — non-blocking: ``_harvest_inflight`` lands them (at the
        next iteration's harvest point under async dispatch, right after
        this returns otherwise). The plain program replays when every live
        request is inert for the whole round; the lane program otherwise,
        its lanes rebuilt from the live requests on every dispatch."""
        # pass 1, capacity: a later lane's preemption may take an earlier
        # lane out of its slot, so lane state is staged in pass 2, over the
        # survivors
        for req in decoding:
            if req.slot is None or req.state is not RequestState.DECODE:
                continue  # preempted or force-finished by an earlier lane
            self._ensure_decode_capacity(req, finished)
        live = [req for req in decoding
                if req.slot is not None and req.state is RequestState.DECODE]
        if not live:
            return
        use_lanes = self._psampling and not all(self._plain_ok(req) for req in live)
        operands = self._lane_ops if use_lanes else self._decode_ops
        ops = operands.stage()
        if use_lanes:
            blank = blank_lanes(self.config.num_slots, self.config.rep_window)
            for name, values in blank.items():
                ops[name][:] = values
        for req in live:
            # a round writes up to _decode_lookahead positions ahead (capped
            # at the request's own budget); lane-steps past the budget write
            # into the null block and are dropped host-side
            self._sync_block_table(req)
            ops["pos0"][req.slot] = req.context_len
            ops["toks"][req.slot, 0] = self._pending_tok[req.slot]
            ops["active"][req.slot, 0] = 1
            if use_lanes:
                params = self._params(req)
                set_slot_lane(
                    ops, req.slot, params, pos=len(req.output_tokens),
                    grammar_row=req.grammar_row, dfa_state=req.dfa_state,
                    recent=(req.prompt + req.output_tokens
                            if params.repetition_penalty != 1.0 else ()),
                )
        ops["tables"][:] = self._block_tables
        self._inflight_kind = self._lane_name if use_lanes else self._decode_name
        self._programs[self._inflight_kind].run(operands.upload)
        self._round_io().copy_to_host()  # the round's one copy
        self._inflight = live

    def _round_io(self) -> _Outputs:
        """The outputs of the round in flight (or just dispatched)."""
        if self._inflight_kind in _SPEC_KINDS:
            return self._spec_io
        return self._lane_out if self._inflight_kind == "lane_decode" else self._decode_io

    def _harvest_inflight(self, finished: list[Request]) -> None:
        """Land the in-flight round: wait on its copy's event (the flight
        recorder's ``device_wait``), then emit each live lane's tokens
        (and logprobs, when the request asked) through ``_emit_token``: a
        burst's ``decode_burst`` tokens, or a spec round's accepted prefix
        and correction (``accept + 1`` tokens). A member that finished
        mid-round emits nothing more: the rest of its round is waste. The
        usage ledger apportions the round's ``device_wait`` across its
        batch by the tokens each request emitted."""
        live = self._inflight
        if live is None:
            return
        kind = self._inflight_kind
        use_lanes = kind == "lane_decode"
        u = self.usage
        pre = None if u is None else [len(r.output_tokens) for r in live]
        self._fl_switch("device_wait")
        # flight disabled: the ledger stamps its own device_wait interval
        t_dw = time.perf_counter() if u is not None and self._fl_phases is None else 0.0
        self._round_io().wait()
        self._inflight = None
        dw = self._fl_switch("harvest")
        if u is not None and dw is None:
            dw = time.perf_counter() - t_dw
        out = self._round_io().host_views
        if kind in _SPEC_KINDS:
            k = self.config.spec_k
            tok_seq, accept = out["tok"], out["accept"]
            for req in live:
                a = int(accept[req.slot])
                self._spec_drafted += k
                self._spec_accepted += a
                if u is not None:
                    u.accrue_spec(req, k, a)
                if req.sampling is not None and req.sampling.do_sample:
                    # rejection-sampling health, over sampled slots only
                    self._rej_drafted += k
                    self._rej_accepted += a
                for t in range(a + 1):
                    if req.state is RequestState.FINISHED:
                        break  # mid-round eos/length/stop: the run's tail is waste
                    self._emit_token(req, int(tok_seq[req.slot, t]), finished)
        else:
            next_toks = out["tok"]
            for req in live:
                params = self._params(req) if use_lanes else None
                for t in range(self.config.decode_burst):
                    if req.state is RequestState.FINISHED:
                        break  # mid-burst eos/length/stop: tail lane-steps are waste
                    entry = None
                    if params is not None and params.logprobs:
                        entry = self._logprob_entry(params, float(out["logp"][t, req.slot]),
                                                    out["top_vals"][t, req.slot],
                                                    out["top_ids"][t, req.slot])
                    self._emit_token(req, int(next_toks[t, req.slot]), finished, entry)
        if u is not None:
            # weighted by the tokens each request emitted from this harvest
            # (stop-trim can shrink output_tokens: clamp at 0); an
            # all-discarded round splits equally so no interval is lost
            emitted = [max(0, len(r.output_tokens) - p) for r, p in zip(live, pre)]
            shares = ([(r.request_id, e) for r, e in zip(live, emitted) if e]
                      if any(emitted) else [(r.request_id, 1) for r in live])
            u.accrue_decode(dw, shares)

    # -- grammar row lifecycle ------------------------------------------------

    def _acquire_grammar_row(self, g) -> int:
        """Pin one row of the device-resident grammar tables for a live
        request (JAX ``_acquire_grammar_row``). Rows are refcounted by
        grammar hash — concurrent requests with the same schema share one
        row. A fully-idle row keeps its tables cached LRU-style, so many
        requests over few schemas write each grammar once; eviction only
        happens when a NEW grammar needs a row and every free row is
        someone's cache entry. Runs at admission, so exhaustion (every row
        pinned by a live request) fails the add_request loudly. A row is
        written in place on the engine's stream, so the write lands after
        any round in flight."""
        row = self._grammar_rows.get(g.hash)
        if row is not None:
            self._row_lru.pop(g.hash, None)
            self._row_refs[row] += 1
            return row
        row = next(
            (r for r in range(1, self.config.grammar_slots + 1)
             if self._row_refs[r] == 0 and r not in self._row_grammar),
            None,
        )
        if row is None:
            if not self._row_lru:
                raise ValueError(
                    f"all {self.config.grammar_slots} grammar rows are held by "
                    "live requests; raise EngineConfig.grammar_slots or retry "
                    "after a constrained request finishes"
                )
            old_hash, row = self._row_lru.popitem(last=False)
            del self._grammar_rows[old_hash]
        allow, trans = g.padded_tables(self.config.grammar_states)
        self._gmask[row].copy_(torch.from_numpy(np.ascontiguousarray(allow)))
        self._gtrans[row].copy_(torch.from_numpy(np.ascontiguousarray(trans, np.int32)))
        self._grammar_rows[g.hash] = row
        self._row_grammar[row] = g
        self._row_refs[row] += 1
        return row

    def _release_grammar_row(self, req: Request) -> None:
        row = req.grammar_row
        if not row:
            return
        req.grammar_row = 0
        self._row_refs[row] -= 1
        if self._row_refs[row] == 0:
            # idle: keep the written tables as an LRU cache entry so the
            # next request with this schema skips the write
            self._row_lru[self._row_grammar[row].hash] = row

    def _emit_token(self, req: Request, tok: int, finished: list[Request],
                    lp_entry=None) -> None:
        """Append one token and apply the host-side finish rules (JAX
        ``_emit_token``): eos, length, a grammar-final state (the host
        advances the authoritative DFA), and a matched stop sequence, which
        is trimmed from the answer (``finish_reason="stop"``). Min-token eos
        suppression happened in the pick."""
        now = time.perf_counter()
        req.output_tokens.append(tok)
        self._pending_tok[req.slot] = tok
        self._tokens_emitted += 1
        params = req.sampling
        if self._psampling:
            if params is not None and params.do_sample:
                self._sampled_sample += 1
            else:
                self._sampled_greedy += 1
        if lp_entry is not None:
            lp_entry["token"] = tok
            if req.logprobs is None:
                req.logprobs = []
            req.logprobs.append(lp_entry)
        if req.first_token_time is None:
            req.first_token_time = now
            if self._tr is not None:
                self._tr.request_instant(
                    req.trace_id, "req/first_token", ts=now,
                    ttft_s=now - req.arrival_time,
                )
        eos = self.config.eos_token_id
        if eos is not None and tok == eos:
            req.finish_reason = "eos"
        elif len(req.output_tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
        if req.grammar_row:
            # entering a state with no live continuation means the match is
            # complete
            self._grammar_masked_steps += 1
            if self.usage is not None:
                self.usage.accrue_grammar(req)
            g = self._row_grammar[req.grammar_row]
            req.dfa_state = g.advance(req.dfa_state, tok)
            if req.finish_reason is None and g.final[req.dfa_state]:
                req.finish_reason = "stop"
        if req.finish_reason is None and params is not None and params.stop:
            n = match_stop(req.output_tokens, params.stop)
            if n:
                # the matched stop sequence is not part of the answer
                del req.output_tokens[-n:]
                req.finish_reason = "stop"
        if req.finish_reason is not None:
            req.finish_time = now
            req.state = RequestState.FINISHED
            finished.append(req)

    # -- observability --------------------------------------------------------

    def _emit_telemetry(self, finished: list[Request]) -> None:
        """Telemetry rows (JAX ``_emit_telemetry``): one ``kind="request"``
        row per finished request, and every ``stats_interval`` iterations a
        ``kind="step"`` row of windowed throughput and cumulative counters.
        One global read when no recorder is active."""
        tel = get_active_recorder()
        if not tel:
            return
        for req in finished:
            tel.record_serving(
                kind="request",
                request_id=req.request_id,
                trace_id=req.trace_id,
                priority=req.priority,
                tenant=req.tenant,
                prompt_tokens=req.prompt_len,
                new_tokens=len(req.output_tokens),
                ttft_s=req.ttft_s,
                tpot_s=req.tpot_s,
                finish_reason=req.finish_reason,
                # the closed per-request account (absent without the ledger)
                **(req.usage or {}),
            )
        interval = self.config.stats_interval
        if interval and self._iterations % interval == 0:
            now = time.perf_counter()
            window_s = now - (self._last_stats_t or now)
            window_tokens = self._tokens_emitted - self._last_stats_tokens
            self._last_stats_t, self._last_stats_tokens = now, self._tokens_emitted
            sched = self.scheduler
            tel.record_serving(
                kind="step",
                iteration=self._iterations,
                tokens_per_sec=(window_tokens / window_s) if window_s > 0 else None,
                queue_depth=sched.queue_depth,
                active_slots=len(sched.active()),
                slot_occupancy=sched.occupancy,
                free_blocks=self.allocator.free_count,
                kv_dtype=self.kv_dtype,
                kv_bytes_per_token=self.kv_bytes_per_token,
                kv_slot_capacity=self.kv_slot_capacity,
                decode_compiles=self._programs[self._decode_name].captures,
                # cumulative totals: a reader of a bounded JSONL tail must
                # not have to re-count them
                completed_total=self._completed_total,
                tokens_total=self._tokens_emitted,
                prefix_hit_tokens=sched.prefix_hit_tokens,
                prefix_hit_ratio=(
                    sched.prefix_hit_tokens / sched.prompt_tokens_admitted
                    if sched.prompt_tokens_admitted else 0.0
                ),
                preemptions=self._preemptions,
                swapped_out_blocks=self._swapped_out_blocks,
                swapped_in_blocks=self._swapped_in_blocks,
                out_of_blocks_total=self._out_of_blocks_total,
                deadline_expired_total=self._deadline_expired,
                **self._spec_stats(),
                **self._sampling_stats(),
                **(self._flight.telemetry_fields() if self._flight is not None else {}),
                **({"usage": self.usage.snapshot()} if self.usage is not None else {}),
            )
