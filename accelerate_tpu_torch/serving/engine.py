"""Continuous-batching inference engine (port of
``accelerate_tpu/serving/engine.py``, the synchronous path).

Orca-style iteration scheduling over a vLLM-style block-paged KV cache:

* the decode step is the model's paged step at a fixed ``[num_slots, 1]``
  shape; one dispatch runs ``decode_burst`` steps back to back. The fed
  tokens stay on the device from step to step, and the burst's
  ``[burst, num_slots]`` tokens come to the host in **one** copy — the
  port's counterpart of the JAX engine's ``lax.scan`` burst;
* prompts are **chunk-prefilled**: ``prefill_chunk`` tokens of each
  prefilling slot per iteration, interleaved with decode, so a long prompt
  bounds every in-flight request's inter-token latency by one chunk;
* KV memory is allocated in ``block_size``-token blocks from a freelist
  (:mod:`.blocks`); the pools live on the device and are **updated in
  place** by the paged step (the JAX engine donates them instead);
* every paged-attention call on a CUDA device is the hand-written kernel
  (``csrc/paged_attention.cu``); ``stats()["paged_attention_launches"]``
  counts its launches, ``"paged_attention_decode_launches"`` those of them
  with one query a row.

Greedy output is the parity contract with the JAX engine. Not ported yet
(later slices): per-slot sampling lanes and grammars, the radix prefix
cache and copy-on-write, swap preemption, speculative decoding, async
double-buffered dispatch and a CUDA-graph decode, the usage ledger, the
flight recorder, deadlines and tenants.
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
    #: finished requests kept for the ``stats()`` percentiles (a ring)
    completed_history: int = 4096

    @property
    def blocks_per_slot(self) -> int:
        return blocks_needed(self.max_seq_len, self.block_size)


class InferenceEngine:
    """Slot-scheduled continuous-batching engine over a paged-KV model.

    ``add_request()`` enqueues; ``step()`` runs one scheduler iteration
    (evict → admit → one prefill chunk per prefilling slot → one decode
    dispatch over every decoding slot) and returns the requests that
    finished; ``run_until_idle()`` drains; ``stream()`` is a per-request
    generator. ``device=None`` means the CUDA card (raising when there is
    none); pass ``device="cpu"`` for the plain PyTorch paths."""

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

        self._mb = cfg.blocks_per_slot  # block-table width
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
        self._pages = {
            "k": torch.zeros(shape, dtype=store_dtype, device=dev),
            "v": torch.zeros(shape, dtype=store_dtype, device=dev),
        }
        if quantized:
            # all-ones init: a never-written row dequantizes to exactly 0
            self._pages["k_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
            self._pages["v_scale"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(cfg.seed)

        # host mirrors the paged step reads every dispatch
        self._block_tables = np.zeros((cfg.num_slots, self._mb), np.int32)
        self._pending_tok = np.zeros((cfg.num_slots,), np.int32)

        self._launches_at_start = _paged_attention.launches
        self._decode_launches_at_start = _paged_attention.decode_launches
        self._iterations = 0
        self._tokens_emitted = 0
        self._out_of_blocks_total = 0
        self._start_time: float | None = None
        self._completed: deque[Request] = deque(maxlen=max(1, int(cfg.completed_history)))
        self._completed_total = 0

    # -- device programs -----------------------------------------------------

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        finished = torch.zeros(logits.shape[:-1], dtype=torch.bool, device=logits.device)
        tok, _ = pick_next_token(
            logits, self._generator, finished, 0, cfg.temperature, cfg.do_sample,
            has_eos=False,  # eos is host-side state
        )
        return tok

    def _decode_burst(self, block_tables, pos0, toks, active) -> torch.Tensor:
        """``decode_burst`` paged steps over every slot; tokens stay on the
        device between steps. Returns ``[burst, num_slots]`` int32 (device)."""
        out = torch.empty(
            (self.config.decode_burst, self.config.num_slots), dtype=torch.int32,
            device=self.device,
        )
        pos = pos0
        for t in range(self.config.decode_burst):
            step = self.model.paged_step(
                toks, self._pages, block_tables, pos,
                paged_write_mask=active,  # PREFILL/free lanes must not scribble
            )
            tok = self._pick(step.logits[:, -1, :])
            out[t] = tok
            toks = tok[:, None]
            pos = pos + 1
        return out

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
        chunk per prefilling slot → one decode dispatch (a burst) over every
        decoding slot, harvested before returning. Returns the requests that
        finished this iteration."""
        if self._start_time is None:
            self._start_time = time.perf_counter()
        sched = self.scheduler
        finished: list[Request] = []
        sched.evict_finished()
        self._admit_and_place()
        for req in sched.active(RequestState.PREFILL):
            self._prefill_one_chunk(req, finished)
        decoding = sched.active(RequestState.DECODE)
        if decoding:
            self._dispatch_decode(decoding, finished)
        self._iterations += 1
        self._completed.extend(finished)
        self._completed_total += len(finished)
        return finished

    def run_until_idle(self, max_iterations: int | None = None) -> list[Request]:
        """Drain queue + slots; returns every request finished meanwhile
        (``max_iterations`` bounds the loop as a scheduling-bug guard)."""
        done: list[Request] = []
        it = 0
        while self.scheduler.has_work():
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

    def stats(self) -> dict:
        """Serving health: tokens, slots and blocks, TTFT/TPOT percentiles over
        the completion window, and the paged-attention kernel launches this
        engine caused (0 on the CPU, where the plain version runs)."""
        sched = self.scheduler
        out = {
            "iterations": self._iterations,
            "completed": self._completed_total,
            "queue_depth": sched.queue_depth,
            "active_slots": len(sched.active()),
            "num_slots": self.config.num_slots,
            "tokens_emitted": self._tokens_emitted,
            "paged_attention_launches": _paged_attention.launches - self._launches_at_start,
            "paged_attention_decode_launches": (_paged_attention.decode_launches
                                                - self._decode_launches_at_start),
            "device": str(self.device),
            "kv_dtype": self.kv_dtype,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "free_blocks": self.allocator.free_count,
            "allocated_blocks": self.allocator.allocated_count,
            "out_of_blocks_total": self._out_of_blocks_total,
        }
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

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device, non_blocking=True)

    def _prefill_one_chunk(self, req: Request, finished: list[Request]) -> None:
        cfg = self.config
        c = cfg.prefill_chunk
        start = req.prefill_pos
        end = min(start + c, req.prompt_len)
        chunk = np.zeros((1, c), np.int32)
        chunk[0, : end - start] = req.prompt[start:end]
        valid = np.zeros((1, c), bool)
        valid[0, : end - start] = True
        self._sync_block_table(req)
        step = self.model.paged_step(
            self._to_device(chunk), self._pages,
            self._to_device(self._block_tables[req.slot : req.slot + 1].copy()),
            self._to_device(np.asarray([start], np.int32)),
            paged_write_mask=self._to_device(valid),  # drops the padded tail
        )
        req.prefill_pos = end
        if end == req.prompt_len:
            # first-token pick from the prompt's last real position
            last = (req.prompt_len - 1) - start
            tok = self._pick(step.logits[0, last][None])
            self._emit_token(req, int(tok[0]), finished)
            if req.state is not RequestState.FINISHED:
                req.state = RequestState.DECODE

    def _ensure_decode_capacity(self, req: Request, finished: list[Request]) -> None:
        """Block growth for one decode lane. Without swap, pool exhaustion
        truncates the request that failed to grow (``out_of_blocks``) —
        never an innocent neighbour that fit its reservation."""
        if not self.scheduler.grow_for_decode(req, tokens_ahead=self.config.decode_burst):
            self._force_finish_out_of_blocks(req, finished)

    def _dispatch_decode(self, decoding: list[Request], finished: list[Request]) -> None:
        """Grow every lane, build the round's operands, run one burst and
        harvest its ``[burst, num_slots]`` tokens in one device→host copy."""
        cfg = self.config
        for req in decoding:
            if req.state is RequestState.DECODE:
                self._ensure_decode_capacity(req, finished)
        pos0 = np.zeros((cfg.num_slots,), np.int32)
        active = np.zeros((cfg.num_slots, 1), bool)
        toks = np.zeros((cfg.num_slots, 1), np.int32)
        live: list[Request] = []
        for req in decoding:
            # a burst writes up to decode_burst positions ahead (capped at the
            # request's own budget); lane-steps past the budget write into the
            # null block and are dropped host-side
            if req.slot is None or req.state is not RequestState.DECODE:
                continue
            self._sync_block_table(req)
            pos0[req.slot] = req.context_len
            toks[req.slot, 0] = self._pending_tok[req.slot]
            active[req.slot, 0] = True
            live.append(req)
        if not live:
            return
        next_toks = self._decode_burst(
            self._to_device(self._block_tables.copy()), self._to_device(pos0),
            self._to_device(toks), self._to_device(active),
        ).cpu().numpy()  # the burst's one device→host copy
        for req in live:
            for t in range(cfg.decode_burst):
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
