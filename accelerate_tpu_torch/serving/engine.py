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
  held the card back.

Greedy output is the parity contract with the JAX engine. Not ported yet
(later slices): per-slot sampling lanes and grammars, the radix prefix
cache and copy-on-write, swap preemption (and the fence it needs),
speculative decoding, the usage ledger, deadlines and tenants.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..generation import pick_next_token
from ..ops import paged_attention as _paged_attention
from ..utils.device import resolve_device
from .blocks import BlockAllocator, blocks_needed
from .flight import ITERATION_PHASES, FlightRecorder, set_active_flight_recorder
from .scheduler import Request, RequestState, SlotScheduler

#: ``add_request`` options of the JAX engine this port does not carry yet:
#: a request that uses one is refused, never silently served without it
UNPORTED_REQUEST_FIELDS = ("sampling", "grammar", "deadline_ms", "tenant", "logprobs")


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

    @property
    def blocks_per_slot(self) -> int:
        return blocks_needed(self.max_seq_len, self.block_size)


class _Operands:
    """A program's operands as named views of ONE persistent int32 device
    buffer (made once, so a CUDA graph can hold its pointer), and a ring of
    host staging copies of it (pinned on a CUDA device).

    :meth:`stage` hands out the next host copy as numpy views, once the
    copy that last read it has run (its event); :meth:`upload` copies it
    into the device buffer with one non-blocking copy and records an event
    after it. So the host never edits staging that a pending copy still
    reads, however far the stream runs behind."""

    def __init__(self, shapes: dict[str, tuple[int, ...]], device: torch.device,
                 depth: int):
        slices, total = {}, 0
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            slices[name] = (total, total + n, shape)
            total += n
        self._buffer = torch.zeros(total, dtype=torch.int32, device=device)
        self.views = {name: self._buffer[lo:hi].view(shape)
                      for name, (lo, hi, shape) in slices.items()}
        cuda = device.type == "cuda"
        self._host = [torch.zeros(total, dtype=torch.int32, pin_memory=cuda)
                      for _ in range(depth)]
        self._host_views = [{name: h.numpy()[lo:hi].reshape(shape)
                             for name, (lo, hi, shape) in slices.items()}
                            for h in self._host]
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


class _Program:
    """A fixed-shape function over the engine's static buffers: replayed
    from a CUDA graph on a CUDA device (captured at its first run), called
    as it is on the CPU. Counts its captures, its replays and the
    paged-attention launches its capture recorded."""

    def __init__(self, fn, device: torch.device, generator: torch.Generator | None, pool):
        self._fn = fn
        self._device = device
        self._generator = generator
        self._pool = pool
        self.graph = None
        self.captures = 0
        self.replays = 0
        #: paged-attention launches (all, and those with one query a row)
        #: the capture recorded, which every replay launches again
        self.launches_captured = 0
        self.decode_launches_captured = 0

    def run(self, upload) -> None:
        """``upload()`` (the operands' copy to the device), then the
        program; on a CUDA device the first run captures before uploading,
        so its warm-up sees the zeroed operands of an unused buffer."""
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
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self._generator is not None:
            # each replay advances the generator's Philox offset: two
            # replays never draw the same numbers
            graph.register_generator_state(self._generator)
        before = (pa.launches, pa.decode_launches)
        with torch.cuda.graph(graph, pool=self._pool):
            self._fn()
        self.launches_captured = pa.launches - before[0]
        self.decode_launches_captured = pa.decode_launches - before[1]
        self.graph = graph
        self.captures += 1


class InferenceEngine:
    """Slot-scheduled continuous-batching engine over a paged-KV model.

    ``add_request()`` enqueues; ``step()`` runs one scheduler iteration
    (evict → admit → one prefill chunk per prefilling slot → harvest the
    in-flight round → one decode dispatch over every decoding slot) and
    returns the requests that finished; ``run_until_idle()`` drains;
    ``stream()`` is a per-request generator. ``device=None`` means the CUDA
    card (raising when there is none); pass ``device="cpu"`` for the plain
    PyTorch paths."""

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

        self.allocator = BlockAllocator(num_blocks)
        self.scheduler = SlotScheduler(
            cfg.num_slots, self.allocator, cfg.block_size, cfg.max_seq_len
        )
        shape = (mcfg.num_hidden_layers, num_blocks, cfg.block_size, n_kv, mcfg.head_dim)
        dev = self.device
        # never reassigned: the graphs hold these pointers
        self._pages = {
            "k": torch.zeros(shape, dtype=store_dtype, device=dev),
            "v": torch.zeros(shape, dtype=store_dtype, device=dev),
        }
        if quantized:
            # all-ones init: a never-written row dequantizes to exactly 0
            self._pages["k_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
            self._pages["v_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(cfg.seed)

        # host mirrors the dispatches stage from
        self._block_tables = np.zeros((cfg.num_slots, mb), np.int32)
        self._pending_tok = np.zeros((cfg.num_slots,), np.int32)

        # the programs' static operands and outputs. Masks are int32 (the
        # paged step takes any nonzero as True) so each program's operands
        # are one buffer and one copy. Prefill staging has a copy for each
        # chunk an iteration can dispatch (one per slot) and one more, so a
        # chunk staged under the in-flight round never waits for it.
        n, c = cfg.num_slots, cfg.prefill_chunk
        self._decode_ops = _Operands(
            {"tables": (n, mb), "pos0": (n,), "toks": (n, 1), "active": (n, 1)}, dev, depth=2)
        self._prefill_ops = _Operands(
            {"chunk": (1, c), "table": (1, mb), "start": (1,), "valid": (1, c), "last": (1,)},
            dev, depth=n + 1)
        self._decode_out = torch.zeros((cfg.decode_burst, n), dtype=torch.int32, device=dev)
        self._prefill_out = torch.zeros((1,), dtype=torch.int32, device=dev)
        pin = dev.type == "cuda"
        self._decode_host = torch.zeros((cfg.decode_burst, n), dtype=torch.int32, pin_memory=pin)
        self._prefill_host = torch.zeros((1,), dtype=torch.int32, pin_memory=pin)
        # recorded after each copy to the host; one round is in flight at a
        # time, and its harvest precedes the next dispatch
        self._decode_done = torch.cuda.Event() if pin else None
        self._prefill_done = torch.cuda.Event() if pin else None
        pool = torch.cuda.graph_pool_handle() if pin else None  # the two graphs share it
        generator = self._generator if cfg.do_sample else None
        self._programs = {
            "decode": _Program(self._decode_burst, dev, generator, pool),
            "prefill": _Program(self._prefill_chunk, dev, generator, pool),
        }

        self._launches_at_start = _paged_attention.launches
        self._decode_launches_at_start = _paged_attention.decode_launches
        self._iterations = 0
        self._tokens_emitted = 0
        self._out_of_blocks_total = 0
        self._start_time: float | None = None
        self._completed: deque[Request] = deque(maxlen=max(1, int(cfg.completed_history)))
        self._completed_total = 0
        #: the live requests of the round dispatched and not yet harvested
        #: (None = nothing in flight). Slots cannot be reassigned while a
        #: round is in flight (eviction only touches FINISHED requests, and
        #: members only finish at harvest), so ``req.slot`` still indexes
        #: the round's tokens when the harvest lands
        self._inflight: list[Request] | None = None
        # per-iteration flight recorder (None = disabled: step() pays one
        # `is None` check), registered process-globally
        self._flight = FlightRecorder(cfg.flight_history) if cfg.flight_history else None
        if self._flight is not None:
            set_active_flight_recorder(self._flight)
        self._fl_phases: dict | None = None

    # -- device programs (fixed shapes, static buffers only) -----------------

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        finished = torch.zeros(logits.shape[:-1], dtype=torch.bool, device=logits.device)
        tok, _ = pick_next_token(
            logits, self._generator, finished, 0, cfg.temperature, cfg.do_sample,
            has_eos=False,  # eos is host-side state
        )
        return tok

    def _decode_burst(self) -> None:
        """``decode_burst`` paged steps over every slot, reading the decode
        operands and writing ``[burst, num_slots]`` int32 tokens into
        ``_decode_out``; tokens stay on the device between steps."""
        ops = self._decode_ops.views
        toks, pos = ops["toks"], ops["pos0"]
        for t in range(self.config.decode_burst):
            step = self.model.paged_step(
                toks, self._pages, ops["tables"], pos,
                paged_write_mask=ops["active"],  # PREFILL/free lanes must not scribble
            )
            tok = self._pick(step.logits[:, -1, :])
            self._decode_out[t].copy_(tok)
            toks, pos = tok[:, None], pos + 1

    def _prefill_chunk(self) -> None:
        """One ``[1, prefill_chunk]`` chunk through the paged step (the
        padded tail dropped by ``valid``), then the pick at the static
        ``last`` index: one token into ``_prefill_out``, never the ``[1, c,
        vocab]`` logits. Only a chunk that ends its prompt reads it."""
        ops = self._prefill_ops.views
        step = self.model.paged_step(
            ops["chunk"], self._pages, ops["table"], ops["start"],
            paged_write_mask=ops["valid"],
        )
        self._prefill_out.copy_(self._pick(step.logits[0].index_select(0, ops["last"])))

    # -- public API ----------------------------------------------------------

    def add_request(
        self,
        prompt,
        max_new_tokens: int | None = None,
        arrival_time: float | None = None,
        priority: str = "interactive",
        **unported,
    ) -> Request:
        """Enqueue one request (``prompt`` = token ids). Options of the JAX
        engine that are not ported yet (:data:`UNPORTED_REQUEST_FIELDS`)
        raise ``ValueError`` when set, so the serve loop answers them with
        an error row instead of serving the request without them."""
        for name, value in unported.items():
            if name not in UNPORTED_REQUEST_FIELDS:
                raise TypeError(f"add_request() got an unexpected keyword argument {name!r}")
            if value is not None:
                raise ValueError(
                    f"{name!r} is not yet ported to accelerate_tpu_torch "
                    "(the JAX engine supports it)"
                )
        req = Request(
            prompt=[int(t) for t in np.asarray(prompt).reshape(-1)],
            max_new_tokens=int(
                self.config.max_new_tokens if max_new_tokens is None else max_new_tokens
            ),
            priority=priority,
        )
        if arrival_time is not None:
            req.arrival_time = arrival_time
        self.scheduler.submit(req)
        return req

    def step(self) -> list[Request]:
        """One engine iteration: evict finished → admit queued → one prefill
        chunk per prefilling slot → harvest the in-flight round → one decode
        dispatch over every decoding slot. Returns the requests that
        finished this iteration.

        With ``async_dispatch`` the round dispatched here is harvested at
        the next iteration's harvest point, so that iteration's schedule and
        prefill work runs while the device computes; tokens surface one
        ``step()`` later and ``run_until_idle()``/``stream()`` step on until
        the drain flush lands them. A prefill chunk that ends its prompt
        reads its first token, and that read waits for the in-flight round
        (both run on one stream), as it does in the JAX engine."""
        if self._start_time is None:
            self._start_time = time.perf_counter()
        sched = self.scheduler
        finished: list[Request] = []
        fl = self._flight
        self._fl_begin()
        sched.evict_finished()
        self._admit_and_place()

        self._fl_switch("prefill")
        for req in sched.active(RequestState.PREFILL):
            self._prefill_one_chunk(req, finished)
        # harvest point: the previous iteration's round lands here
        self._harvest_inflight(finished)

        self._fl_switch("dispatch")
        decoding = sched.active(RequestState.DECODE)
        if decoding:
            self._dispatch_decode(decoding, finished)
        if not self.config.async_dispatch:
            self._harvest_inflight(finished)  # the synchronous loop

        self._fl_switch("harvest")
        self._iterations += 1
        self._completed.extend(finished)
        self._completed_total += len(finished)
        rec = self._fl_finish()
        if rec is not None:
            t0, wall, phases, overlap = rec
            fl.record(self._iterations, t0, wall, overlap_hidden_s=overlap, **phases)
            fl.current_phase = "idle"
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

    def stream(self, prompt, max_new_tokens: int | None = None):
        """Generator yielding this request's tokens as the engine emits
        them (other in-flight requests keep decoding underneath)."""
        req = self.add_request(prompt, max_new_tokens)
        served = 0
        while req.state is not RequestState.FINISHED:
            self.step()
            while served < len(req.output_tokens):
                yield req.output_tokens[served]
                served += 1
        while served < len(req.output_tokens):
            yield req.output_tokens[served]
            served += 1

    def reset_stats(self) -> None:
        """Zero the measurement state (iterations, tokens, completions, the
        wall clock, the flight ring) and keep the graphs, the pools and the
        capture and launch counters, so a run can warm up, reset and
        measure."""
        self._iterations = 0
        self._tokens_emitted = 0
        self._out_of_blocks_total = 0
        self._start_time = None
        self._completed.clear()
        self._completed_total = 0
        if self._flight is not None:
            self._flight.reset()

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

    def stats(self) -> dict:
        """Serving health: tokens, slots and blocks, TTFT/TPOT percentiles over
        the completion window, the captures (``decode_compiles``,
        ``prefill_compiles``; the JAX engine's key names) and replays of the
        two programs, the paged-attention kernel launches this engine caused
        (0 on the CPU, where the plain version runs), and the flight
        recorder's ``host_fraction`` and per-phase percentiles."""
        sched = self.scheduler
        launches = self._launch_counts()
        out = {
            "iterations": self._iterations,
            "completed": self._completed_total,
            "queue_depth": sched.queue_depth,
            "active_slots": len(sched.active()),
            "num_slots": self.config.num_slots,
            "tokens_emitted": self._tokens_emitted,
            "decode_compiles": self._programs["decode"].captures,
            "prefill_compiles": self._programs["prefill"].captures,
            "paged_attention_launches": launches["total"],
            "paged_attention_decode_launches": launches["decode"],
            "paged_attention_eager_launches": launches["eager"],
            "cuda_graphs": {
                name: {"replays": p.replays, "launches_captured": p.launches_captured,
                       "decode_launches_captured": p.decode_launches_captured}
                for name, p in self._programs.items()
            },
            "async_dispatch": self.config.async_dispatch,
            "device": str(self.device),
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "free_blocks": self.allocator.free_count,
            "allocated_blocks": self.allocator.allocated_count,
            "out_of_blocks_total": self._out_of_blocks_total,
        }
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

    def _fl_switch(self, phase: str) -> None:
        """Close the open interval into its phase bucket and open
        ``phase``. Phases may be re-entered ("harvest" at the harvest point
        and for bookkeeping); the buckets accumulate, and their sum
        telescopes to the iteration wall, which ``FlightRecorder.record``
        asserts."""
        if self._fl_phases is None:
            return
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
        """Admission. Without the prefix cache and swap there is no device
        work to place (no copy-on-write copy, no swap-in restore): admitted
        requests start prefilling this iteration."""
        self.scheduler.admit()

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

    def _prefill_one_chunk(self, req: Request, finished: list[Request]) -> None:
        cfg = self.config
        start = req.prefill_pos
        end = min(start + cfg.prefill_chunk, req.prompt_len)
        self._sync_block_table(req)
        ops = self._prefill_ops.stage()
        ops["chunk"][0, : end - start] = req.prompt[start:end]
        ops["valid"][0, : end - start] = 1  # drops the padded tail
        ops["table"][0] = self._block_tables[req.slot]
        ops["start"][0] = start
        is_final = end == req.prompt_len
        # the first-token pick reads the prompt's last real position
        ops["last"][0] = (req.prompt_len - 1) - start if is_final else 0
        self._programs["prefill"].run(self._prefill_ops.upload)
        req.prefill_pos = end
        if is_final:
            self._prefill_host.copy_(self._prefill_out, non_blocking=True)
            if self._prefill_done is not None:
                self._prefill_done.record()
                self._prefill_done.synchronize()  # waits for the in-flight round too
            self._emit_token(req, int(self._prefill_host[0]), finished)
            if req.state is not RequestState.FINISHED:
                req.state = RequestState.DECODE

    def _ensure_decode_capacity(self, req: Request, finished: list[Request]) -> None:
        """Block growth for one decode lane. Without swap, pool exhaustion
        truncates the request that failed to grow (``out_of_blocks``) —
        never an innocent neighbour that fit its reservation."""
        if not self.scheduler.grow_for_decode(req, tokens_ahead=self.config.decode_burst):
            self._force_finish_out_of_blocks(req, finished)

    def _dispatch_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        """Grow every lane, stage the round's operands, replay the burst and
        start the copy of its ``[burst, num_slots]`` tokens to the host —
        non-blocking: ``_harvest_inflight`` lands them (at the next
        iteration's harvest point under async dispatch, right after this
        returns otherwise)."""
        for req in decoding:
            if req.state is RequestState.DECODE:
                self._ensure_decode_capacity(req, finished)
        live = [req for req in decoding
                if req.slot is not None and req.state is RequestState.DECODE]
        if not live:
            return
        ops = self._decode_ops.stage()
        for req in live:
            # a burst writes up to decode_burst positions ahead (capped at the
            # request's own budget); lane-steps past the budget write into the
            # null block and are dropped host-side
            self._sync_block_table(req)
            ops["pos0"][req.slot] = req.context_len
            ops["toks"][req.slot, 0] = self._pending_tok[req.slot]
            ops["active"][req.slot, 0] = 1
        ops["tables"][:] = self._block_tables
        self._programs["decode"].run(self._decode_ops.upload)
        self._decode_host.copy_(self._decode_out, non_blocking=True)  # the round's one copy
        if self._decode_done is not None:
            self._decode_done.record()
        self._inflight = live

    def _harvest_inflight(self, finished: list[Request]) -> None:
        """Land the in-flight round: wait on its copy's event (the flight
        recorder's ``device_wait``), then emit each live lane's tokens
        through ``_emit_token``. A member that finished mid-burst emits
        nothing more: its tail lane-steps are waste."""
        live = self._inflight
        if live is None:
            return
        self._fl_switch("device_wait")
        if self._decode_done is not None:
            self._decode_done.synchronize()
        self._inflight = None
        self._fl_switch("harvest")
        next_toks = self._decode_host.numpy()
        for req in live:
            for t in range(self.config.decode_burst):
                if req.state is RequestState.FINISHED:
                    break  # mid-burst eos/length: tail lane-steps are waste
                self._emit_token(req, int(next_toks[t, req.slot]), finished)

    def _emit_token(self, req: Request, tok: int, finished: list[Request]) -> None:
        now = time.perf_counter()
        req.output_tokens.append(tok)
        self._pending_tok[req.slot] = tok
        self._tokens_emitted += 1
        if req.first_token_time is None:
            req.first_token_time = now
        eos = self.config.eos_token_id
        if eos is not None and tok == eos:
            req.finish_reason = "eos"
        elif len(req.output_tokens) >= req.max_new_tokens:
            req.finish_reason = "length"
        if req.finish_reason is not None:
            req.finish_time = now
            req.state = RequestState.FINISHED
            finished.append(req)
