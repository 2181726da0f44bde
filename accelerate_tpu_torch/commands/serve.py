"""``accelerate-tpu-torch serve`` — drive the continuous-batching engine from
JSONL on stdin (port of the stdin branch of
``accelerate_tpu/commands/serve.py``).

Request protocol, one JSON object per line:
``{"id": <any>, "prompt": [token ids], "max_new_tokens": <int?>,
"priority": "interactive"|"batch"?, "deadline_ms": <number?>, "tenant":
<str?>, "sampling": {...}?, "grammar": {...}?, "logprobs": <int?>}``. ``sampling`` holds per-request
:class:`~accelerate_tpu_torch.serving.sampling.SamplingParams` fields
(``do_sample``, ``temperature``, ``top_k``, ``top_p``,
``repetition_penalty``, ``seed``, ``min_tokens``, ``stop`` as token-id
sequences, ``logprobs``); ``grammar`` is ``{"type": "regex", "pattern":
...}`` or ``{"type": "json_schema", "schema": {...}}`` over the byte
vocabulary; ``logprobs`` asks for the top-N per token, up to
``--logprobs-topn``. ``deadline_ms`` is a relative budget: an expired
request finishes ``deadline_exceeded`` with its partial output; ``tenant``
is the usage ledger's accounting key. Each completion is written back as
``{"id", "tenant", "tokens", "prompt_tokens", "ttft_s", "tpot_s",
"finish_reason"}``, plus ``"logprobs"`` (``[{"token", "logprob", "top":
[[id, logprob], ...]}]``) when the request asked and, with the usage
ledger on, the request's costs ``device_time_s``, ``kv_block_seconds`` and
``swap_bytes``. A malformed request, or one carrying a field this port does
not serve yet (``trace_id``, ``upstream_hop``), is answered with an
``{"id", "error"}`` row and never stops the loop. Prompts are raw token
ids; the weights are random, made from ``--seed``. The radix prefix cache
is on unless ``--no-prefix-cache``; ``--swap-gb`` (env
``ACCELERATE_SERVE_SWAP_GB``) adds the host swap tier; ``--spec-k`` and
``--draft`` (env ``ACCELERATE_SERVE_SPEC_K``, ``ACCELERATE_SERVE_DRAFT``)
arm speculative decoding, and a bad combination is a startup refusal (an
error row, exit 2); ``--no-usage-accounting`` (env
``ACCELERATE_SERVE_USAGE=0``) removes the usage ledger.

The engine runs on the CUDA card unless ``--device cpu`` is given; there
it replays its decode burst and prefill chunk from CUDA graphs, with
double-buffered dispatch unless ``--sync-engine`` (or
``ACCELERATE_SYNC_ENGINE=1``) asks for the synchronous loop, which gives
the same tokens. On exit the stderr summary names the paged-attention
kernel launches (all of them, then decode and other apart), the captures
(``decode_compiles``, ``lane_decode_compiles``, ``prefill_compiles``) and the flight recorder's
``host_fraction``, and a second line ``serve stats: {...}`` carries the
engine's ``stats()`` as JSON. HTTP, OpenAI routes, routing, chaos and
workload replay are later slices.
"""

from __future__ import annotations

import argparse
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
            prefix_cache=args.prefix_cache,
            logprobs_topn=args.logprobs_topn,
            swap_gb=args.swap_gb,
            spec_k=args.spec_k,
            draft=args.draft,
            usage_accounting=args.usage_accounting,
        ),
        device=args.device,
    )


def _result_dict(req, req_id) -> dict:
    out = {
        "id": req_id,
        "tenant": req.tenant,
        "tokens": req.output_tokens,
        "prompt_tokens": req.prompt_len,
        "ttft_s": req.ttft_s,
        "tpot_s": req.tpot_s,
        "finish_reason": req.finish_reason,
    }
    if req.logprobs is not None:
        out["logprobs"] = req.logprobs
    if req.usage is not None:
        # the usage ledger's answer-row costs: what THIS request spent
        # (device_time_s / kv_block_seconds / swap_bytes, measured)
        out.update(req.usage)
    return out


def _engine_loop(engine, inbox, emit, stop):
    """Drain inbox → step → emit completion rows; idle-sleep when empty so a
    quiet server does not spin a core. A malformed, over-budget or
    not-yet-ported request is answered with an ``{"error": ...}`` row — it
    never kills the loop under the other in-flight requests. Returns once
    ``stop`` is set (stdin EOF) and nothing is left in flight.

    A payload may carry a ``_stream`` callable (an in-process caller): it
    is called with each NEW token chunk as decode emits them. When the
    request has stop sequences, streaming lags by ``max(len(stop)) - 1``
    tokens so a chunk never carries tokens a matched stop sequence later
    trims — the final row is authoritative and completes what was
    streamed."""
    from ..serving import UNPORTED_REQUEST_FIELDS

    pending = {}  # engine request_id -> user id
    streams = {}  # engine request_id -> [stream_cb, req, served, holdback]
    while True:
        try:
            while True:
                payload = inbox.get_nowait()
                req_id = payload.get("id") if isinstance(payload, dict) else None
                try:
                    req = engine.add_request(
                        payload["prompt"], payload.get("max_new_tokens"),
                        priority=payload.get("priority", "interactive"),
                        deadline_ms=payload.get("deadline_ms"),
                        sampling=payload.get("sampling"),
                        grammar=payload.get("grammar"),
                        tenant=payload.get("tenant"),
                        logprobs=payload.get("logprobs"),
                        **{name: payload.get(name) for name in UNPORTED_REQUEST_FIELDS},
                    )
                except Exception as e:  # noqa: BLE001 — reported, not fatal
                    emit({"id": req_id, "error": str(e)})
                    continue
                pending[req.request_id] = req_id
                stream_cb = payload.get("_stream")
                if stream_cb is not None:
                    hold = 0
                    if req.sampling is not None and req.sampling.stop:
                        hold = max(len(s) for s in req.sampling.stop) - 1
                    streams[req.request_id] = [stream_cb, req, 0, hold]
        except queue.Empty:
            pass
        if engine.has_work():
            for req in engine.step():
                streams.pop(req.request_id, None)
                emit(_result_dict(req, pending.pop(req.request_id, None)))
            for entry in streams.values():
                stream_cb, req, served, hold = entry
                avail = len(req.output_tokens) - hold
                if avail > served:
                    stream_cb(req.output_tokens[served:avail])
                    entry[2] = avail
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
        f"lane_decode_compiles {stats['lane_decode_compiles']}, "
        f"prefill_compiles {stats['prefill_compiles']}, "
        f"host_fraction {stats.get('host_fraction', 0.0):.4f}",
        file=sys.stderr,
    )
    print(f"serve stats: {json.dumps(stats)}", file=sys.stderr)
    return 0


def _env_number(name: str, kind, default):
    """An env default for a numeric flag; a malformed value warns and falls
    back (the parser is built for every subcommand, so it must not die)."""
    try:
        return kind(os.environ.get(name, "") or default)
    except ValueError:
        print(f"accelerate-tpu-torch: ignoring malformed {name}={os.environ[name]!r}",
              file=sys.stderr)
        return default


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
    p.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction, default=True,
                   help="radix prefix sharing: admission maps a request's longest "
                   "cached prompt prefix and prefills only the tail "
                   "(--no-prefix-cache disables)")
    p.add_argument("--swap-gb", type=float,
                   default=_env_number("ACCELERATE_SERVE_SWAP_GB", float, 0.0),
                   help="host (pinned) KV swap tier in GiB (default 0 = off; env "
                   "ACCELERATE_SERVE_SWAP_GB): under pool exhaustion the "
                   "lowest-priority request is swapped out instead of being "
                   "truncated with finish_reason=out_of_blocks")
    p.add_argument("--spec-k", type=int,
                   default=_env_number("ACCELERATE_SERVE_SPEC_K", int, 0),
                   help="speculative decoding: draft this many tokens per slot per "
                   "round and verify them in ONE [num_slots, k+1] captured forward "
                   "(default 0 = off; env ACCELERATE_SERVE_SPEC_K). Greedy requests "
                   "stay token-identical to the non-speculative engine; sampled "
                   "requests verify by rejection sampling. A bad spec/draft "
                   "combination is a startup refusal (error row, exit 2)")
    p.add_argument("--draft", default=os.environ.get("ACCELERATE_SERVE_DRAFT", "early_exit:2"),
                   help="draft policy when --spec-k > 0 (env ACCELERATE_SERVE_DRAFT): "
                   "'early_exit:N' runs the target's own first N layers as the draft, "
                   "sharing the target's paged pool")
    usage_env = os.environ.get("ACCELERATE_SERVE_USAGE", "1")
    p.add_argument("--usage-accounting", action=argparse.BooleanOptionalAction,
                   default=usage_env.strip().lower() not in ("0", "false", "no", "off", ""),
                   help="conservation-checked per-request usage ledger: device-seconds, "
                   "KV block-seconds, swap bytes by tenant and class (default on; "
                   "env ACCELERATE_SERVE_USAGE=0 or --no-usage-accounting disables)")
    p.add_argument("--logprobs-topn", type=int, default=0,
                   help="top-N per-token logprobs a request may ask for (0 = off)")
    p.add_argument("--eos-token-id", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None,
                   help="the default sampling temperature of a request that sends no "
                   "sampling params (default: greedy)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(func=serve_command)
