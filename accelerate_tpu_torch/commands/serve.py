"""``accelerate-tpu-torch serve`` — drive the continuous-batching engine from
JSONL on stdin (port of the stdin branch of
``accelerate_tpu/commands/serve.py``).

Request protocol, one JSON object per line:
``{"id": <any>, "prompt": [token ids], "max_new_tokens": <int?>,
"priority": "interactive"|"batch"?}``; each completion is written back as
``{"id", "tokens", "prompt_tokens", "ttft_s", "tpot_s", "finish_reason"}``.
A malformed request, or one carrying a field this port does not serve yet
(``sampling``, ``grammar``, ``deadline_ms``, ``tenant``, ``logprobs``), is
answered with an ``{"id", "error"}`` row and never stops the loop. Prompts
are raw token ids; the weights are random, made from ``--seed``.

The engine runs on the CUDA card unless ``--device cpu`` is given; there
it replays its decode burst and prefill chunk from CUDA graphs, with
double-buffered dispatch unless ``--sync-engine`` (or
``ACCELERATE_SYNC_ENGINE=1``) asks for the synchronous loop, which gives
the same tokens. On exit the stderr summary names the paged-attention
kernel launches (all of them, then decode and other apart), the captures
(``decode_compiles``, ``prefill_compiles``) and the flight recorder's
``host_fraction``, and a second line ``serve stats: {...}`` carries the
engine's ``stats()`` as JSON. HTTP, OpenAI routes, routing, chaos and
workload replay are later slices.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time


def _build_model(args):
    import torch

    from ..models import LlamaConfig, LlamaForCausalLM

    presets = {
        "tiny": lambda: LlamaConfig.tiny(
            vocab_size=256, hidden_size=64, layers=2, heads=4, seq=max(args.max_seq_len, 128)
        ),
        "flagship": lambda: LlamaConfig.flagship_700m(
            max_position_embeddings=max(args.max_seq_len, 1024)
        ),
    }
    config = presets[args.preset]()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    return LlamaForCausalLM.from_config(config, seed=args.seed, dtype=dtype, device=args.device)


def _make_engine(args):
    from ..serving import EngineConfig, InferenceEngine

    model = _build_model(args)
    return InferenceEngine(
        model,
        EngineConfig(
            num_slots=args.num_slots,
            block_size=args.block_size,
            max_seq_len=args.max_seq_len,
            num_blocks=args.num_blocks,
            prefill_chunk=args.prefill_chunk,
            decode_burst=args.decode_burst,
            eos_token_id=args.eos_token_id,
            do_sample=args.temperature is not None,
            temperature=args.temperature if args.temperature is not None else 1.0,
            seed=args.seed,
            max_new_tokens=args.max_new_tokens,
            kv_dtype=args.kv_dtype,
            async_dispatch=not args.sync_engine,
        ),
        device=args.device,
    )


def _result_dict(req, req_id) -> dict:
    return {
        "id": req_id,
        "tokens": req.output_tokens,
        "prompt_tokens": req.prompt_len,
        "ttft_s": req.ttft_s,
        "tpot_s": req.tpot_s,
        "finish_reason": req.finish_reason,
    }


def _engine_loop(engine, inbox, emit, stop):
    """Drain inbox → step → emit completion rows; idle-sleep when empty so a
    quiet server does not spin a core. A malformed, over-budget or
    not-yet-ported request is answered with an ``{"error": ...}`` row — it
    never kills the loop under the other in-flight requests. Returns once
    ``stop`` is set (stdin EOF) and nothing is left in flight."""
    from ..serving import UNPORTED_REQUEST_FIELDS

    pending = {}  # engine request_id -> user id
    while True:
        try:
            while True:
                payload = inbox.get_nowait()
                req_id = payload.get("id") if isinstance(payload, dict) else None
                try:
                    req = engine.add_request(
                        payload["prompt"], payload.get("max_new_tokens"),
                        priority=payload.get("priority", "interactive"),
                        **{name: payload.get(name) for name in UNPORTED_REQUEST_FIELDS},
                    )
                except Exception as e:  # noqa: BLE001 — reported, not fatal
                    emit({"id": req_id, "error": str(e)})
                    continue
                pending[req.request_id] = req_id
        except queue.Empty:
            pass
        if engine.has_work():
            for req in engine.step():
                emit(_result_dict(req, pending.pop(req.request_id, None)))
            continue
        if stop.is_set() and inbox.empty():
            return
        time.sleep(0.005)


def serve_command(args) -> int:
    out_lock = threading.Lock()

    def emit(result):
        with out_lock:
            print(json.dumps(result), flush=True)

    try:
        engine = _make_engine(args)
    except (ValueError, RuntimeError) as e:
        emit({"error": str(e)})
        print(f"serve: refusing to start: {e}", file=sys.stderr)
        return 2

    inbox: queue.Queue = queue.Queue()
    stop = threading.Event()

    def read_stdin():
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                payload = json.loads(line)
            except json.JSONDecodeError as e:
                emit({"error": f"bad JSON: {e}"})
                continue
            inbox.put(payload)
        stop.set()

    threading.Thread(target=read_stdin, daemon=True).start()
    try:
        _engine_loop(engine, inbox, emit, stop)
    except KeyboardInterrupt:
        pass
    stats = engine.stats()
    print(
        f"served {stats['completed']} requests, "
        f"{stats['tokens_emitted']} tokens "
        f"({stats.get('tokens_per_sec', 0.0):.1f} tok/s) on {stats['device']}, "
        f"paged_attention launches {stats['paged_attention_launches']} "
        f"(decode {stats['paged_attention_decode_launches']}, "
        f"other {stats['paged_attention_launches'] - stats['paged_attention_decode_launches']}), "
        f"decode_compiles {stats['decode_compiles']}, "
        f"prefill_compiles {stats['prefill_compiles']}, "
        f"host_fraction {stats.get('host_fraction', 0.0):.4f}",
        file=sys.stderr,
    )
    print(f"serve stats: {json.dumps(stats)}", file=sys.stderr)
    return 0


def add_parser(subparsers):
    p = subparsers.add_parser(
        "serve", help="Continuous-batching inference engine over stdin JSONL",
    )
    p.add_argument("--preset", choices=("tiny", "flagship"), default="tiny",
                   help="model shape (random weights; prompts are token ids)")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the engine runs (default: the CUDA card)")
    p.add_argument("--num-slots", type=int, default=8, help="decode batch slots")
    p.add_argument("--block-size", type=int, default=16, help="KV block tokens")
    p.add_argument("--max-seq-len", type=int, default=512,
                   help="per-request prompt+output cap")
    p.add_argument("--prefill-chunk", type=int, default=32,
                   help="prompt tokens prefilled per engine iteration")
    p.add_argument("--decode-burst", type=int, default=8,
                   help="decode steps per dispatch (scheduling granularity)")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="paged KV pool blocks (default: full residency — "
                   "num_slots x blocks-per-slot + 1)")
    p.add_argument("--max-new-tokens", type=int, default=64,
                   help="default output budget when a request omits it")
    p.add_argument("--kv-dtype", choices=("auto", "bf16", "f32", "int8", "fp8"),
                   default="auto",
                   help="KV pool storage (default auto = the params' dtype): "
                   "int8/fp8 quantize on scatter with per-row amax scales")
    p.add_argument(
        "--sync-engine", action="store_true",
        default=os.environ.get("ACCELERATE_SYNC_ENGINE", "") not in ("", "0"),
        help="disable double-buffered dispatch and run the synchronous step "
        "loop (env ACCELERATE_SYNC_ENGINE=1): the baseline to time the "
        "default against; the tokens are identical either way")
    p.add_argument("--eos-token-id", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None,
                   help="sampling temperature (default: greedy)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=serve_command)
