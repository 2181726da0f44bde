"""``accelerate-tpu-torch serve`` — drive the continuous-batching engine from
JSONL on stdin or a local HTTP endpoint (port of
``accelerate_tpu/commands/serve.py``).

Request protocol, one JSON object per line or per ``POST /generate`` body:
``{"id": <any>, "prompt": [token ids], "max_new_tokens": <int?>,
"priority": "interactive"|"batch"?, "deadline_ms": <number?>, "tenant":
<str?>, "trace_id": <str?>, "sampling": {...}?, "grammar": {...}?,
"logprobs": <int?>}``. ``sampling`` holds per-request
:class:`~accelerate_tpu_torch.serving.sampling.SamplingParams` fields
(``do_sample``, ``temperature``, ``top_k``, ``top_p``,
``repetition_penalty``, ``seed``, ``min_tokens``, ``stop`` as token-id
sequences, ``logprobs``); ``grammar`` is ``{"type": "regex", "pattern":
...}`` or ``{"type": "json_schema", "schema": {...}}`` over the byte
vocabulary; ``logprobs`` asks for the top-N per token, up to
``--logprobs-topn``. ``deadline_ms`` is a relative budget: an expired
request finishes ``deadline_exceeded`` with its partial output; ``tenant``
is the usage ledger's accounting key; ``trace_id`` (kept when well formed,
else generated) names the request in the trace and telemetry. Each
completion is written back as ``{"id", "trace_id", "tenant", "tokens",
"prompt_tokens", "ttft_s", "tpot_s", "finish_reason"}``, plus
``"logprobs"`` (``[{"token", "logprob", "top": [[id, logprob], ...]}]``)
when the request asked and, with the usage ledger on, the request's costs
``device_time_s``, ``kv_block_seconds`` and ``swap_bytes``. A malformed
request is answered with an ``{"id", "error"}`` row and never stops the
loop. Prompts are raw token ids; the weights are random, made from
``--seed``. The radix prefix cache is on unless ``--no-prefix-cache``;
``--swap-gb`` (env ``ACCELERATE_SERVE_SWAP_GB``) adds the host swap tier;
``--spec-k`` and ``--draft`` (env ``ACCELERATE_SERVE_SPEC_K``,
``ACCELERATE_SERVE_DRAFT``) arm speculative decoding, and a bad
combination is a startup refusal (an error row, exit 2);
``--no-usage-accounting`` (env ``ACCELERATE_SERVE_USAGE=0``) removes the
usage ledger. ``--max-queue`` sheds (an error row) any request arriving
while that many wait for a slot. ``--trace SPEC`` replaces stdin with a
seeded replayable workload (:mod:`~accelerate_tpu_torch.serving.workload`;
a malformed spec is a startup refusal, exit 2).

``--http PORT`` serves ``127.0.0.1:PORT`` instead (port 0 picks a free one;
the bound port is printed on stderr): ``POST /generate`` (blocks until the
answer row), the OpenAI door ``POST /v1/completions`` and
``/v1/chat/completions`` (SSE over chunked HTTP/1.1 with ``stream``;
:mod:`~accelerate_tpu_torch.serving.openai_api`), ``GET /healthz`` (the
``starting`` → ``ready`` → ``draining`` state machine and the router's
gauges), ``GET /stats`` and ``/health`` (``engine.stats()``), ``GET
/metrics`` (OpenMetrics text) and ``GET /profile?seconds=N`` (a
``torch.profiler`` window and the flight iterations inside it, under
``--logging-dir``). The server binds first and answers ``starting`` while
the engine builds and captures. ``--logging-dir`` turns on the telemetry
JSONL and the request trace (the JAX package's file formats).

The engine loop owns the main thread; stdin and HTTP submissions land in a
thread-safe inbox it drains between iterations. The handler threads make
no CUDA call and never read the engine's structures: ``/stats`` and
``/metrics`` are answered from a ``stats()`` snapshot the engine thread
takes between iterations, ``/healthz`` from gauges it publishes every
iteration, and a ``/profile`` window is opened and closed on the engine
thread (a CUDA call from another thread during a lazy CUDA-graph capture
would invalidate the capture). SIGTERM raises the
:class:`~accelerate_tpu_torch.resilience.PreemptionHandler` flag: the loop
stops admission (late requests get an error answer), answers everything
already admitted, writes ``FLIGHT_DRAIN_<pid>.json`` under
``--logging-dir`` and exits 0.

The engine runs on the CUDA card unless ``--device cpu`` is given; there
it replays its decode burst and prefill chunk from CUDA graphs, with
double-buffered dispatch unless ``--sync-engine`` (or
``ACCELERATE_SYNC_ENGINE=1``) asks for the synchronous loop, which gives
the same tokens. On exit the stderr summary names the paged-attention
kernel launches (all of them, then decode and other apart), the captures
(``decode_compiles``, ``lane_decode_compiles``, ``prefill_compiles``) and
the flight recorder's ``host_fraction``, and a second line ``serve stats:
{...}`` carries the engine's ``stats()`` as JSON. Routing, chaos
injection, the HBM pre-flight and ``--mesh`` are later slices.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time
from collections import deque

#: seconds the drain loop waits for pipe-buffered stragglers after going
#: idle — lines written before the signal but not yet through the reader
#: thread still deserve answers
_DRAIN_IDLE_GRACE_S = 0.75
#: seconds an HTTP handler waits for the engine thread's stats snapshot
_STATS_TIMEOUT_S = 60.0


class ServeHealth:
    """The front end's lifecycle state machine: ``starting`` → ``ready`` →
    ``draining``. Transitions are one-way; readers (the /healthz handler,
    the stdin reader, the engine loop) only ever look at ``state``. The
    engine thread publishes the router's gauges every iteration
    (:meth:`publish`), so /healthz never reads the engine itself."""

    def __init__(self, replica_id: int | None = None):
        from ..analysis.lockwatch import maybe_watch

        self.replica_id = replica_id
        self._state = "starting"
        self._lock = maybe_watch(threading.Lock(), "ServeHealth._lock")
        self._gauges = dict.fromkeys(("queue_depth", "active_slots", "num_slots"))

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def ready(self) -> bool:
        return self.state == "ready"

    @property
    def draining(self) -> bool:
        return self.state == "draining"

    def mark_ready(self) -> None:
        with self._lock:
            if self._state == "starting":
                self._state = "ready"

    def mark_draining(self) -> None:
        with self._lock:
            self._state = "draining"

    def publish(self, engine) -> None:
        """The router's dispatch gauges, read on the engine thread; one
        reference swap, so a reader sees one iteration's values."""
        self._gauges = {
            "queue_depth": int(engine.scheduler.queue_depth),
            "active_slots": len(engine.scheduler.active()),
            "num_slots": int(engine.config.num_slots),
            # cumulative engine-side deadline evictions (the partial answer
            # is still delivered): the fleet's error-rate objective reads it
            "deadline_expired": int(engine._deadline_expired),
        }

    def payload(self) -> dict:
        """The /healthz answer: state + the router's dispatch gauges."""
        return {"state": self.state, "pid": os.getpid(), "replica_id": self.replica_id,
                **self._gauges}


class _EngineMailbox:
    """What the HTTP handler threads ask of the engine thread: a ``stats()``
    snapshot and ``/profile`` windows. The engine thread serves them between
    iterations (:meth:`service`), so no handler makes a CUDA call or reads
    the engine's structures while the engine thread mutates them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats_waiters: list = []
        self._windows: deque = deque()
        self._window = None  # the open profile window
        #: True when something waits for the engine thread: the loop's
        #: per-iteration check is this one attribute read
        self.pending = False

    def stats(self, timeout: float = _STATS_TIMEOUT_S) -> dict | None:
        """The engine's ``stats()``, taken by the engine thread at its next
        iteration boundary; None if it did not come within ``timeout``."""
        done, box = threading.Event(), {}
        with self._lock:
            self._stats_waiters.append((done, box))
            self.pending = True
        return box["stats"] if done.wait(timeout) else None

    def open_profile(self, window) -> None:
        """Queue a :class:`~..serving.flight.ProfileWindow`; the engine thread
        opens it at its next iteration boundary and closes it there once its
        seconds have passed (``window.closed``)."""
        with self._lock:
            self._windows.append(window)
            self.pending = True

    def service(self, engine) -> None:
        """On the engine thread, between iterations."""
        with self._lock:
            waiters, self._stats_waiters = self._stats_waiters, []
            if self._window is None and self._windows:
                self._window = self._windows.popleft()
                opening = self._window
            else:
                opening = None
            self.pending = bool(self._windows) or self._window is not None
        if waiters:
            snapshot = engine.stats()
            for done, box in waiters:
                box["stats"] = snapshot
                done.set()
        if opening is not None:
            try:
                opening.open(engine._flight, cuda=engine.device.type == "cuda")
            except Exception as e:  # noqa: BLE001 — reported to the caller
                opening.error = f"{type(e).__name__}: {e}"
                opening.closed.set()
                self._window = None
        elif self._window is not None and self._window.expired():
            self._window.close()
            self._window = None

    def close(self, engine) -> None:
        """The loop is ending: answer what waits and close an open window."""
        self.service(engine)
        if self._window is not None:
            self._window.close()
            self._window = None
        for window in self._windows:
            window.error = "the engine loop ended"
            window.closed.set()
        self._windows.clear()




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
            flight_history=args.flight_history,
            stats_interval=args.stats_interval,
        ),
        device=args.device,
    )


class _StartupRefusal(Exception):
    """Building the engine refused (bad geometry, a bad spec combination,
    no card): an error row and exit 2, distinct from an error escaping the
    live serving loop, which keeps its traceback."""


def _write_flight_drain(logging_dir, engine, k: int = 32) -> None:
    """On a SIGTERM drain, persist the flight recorder's last ``k``
    iterations beside the run's other artifacts (``FLIGHT_DRAIN_<pid>.json``):
    the post-mortem of an engine that exited cleanly but slowly."""
    if not logging_dir or engine is None:
        return
    fl = engine._flight
    if fl is None:
        return
    path = os.path.join(logging_dir, f"FLIGHT_DRAIN_{os.getpid()}.json")
    try:
        with open(path, "w") as f:
            json.dump(
                {
                    "type": "flight_drain",
                    "pid": os.getpid(),
                    "ts": time.time(),
                    "current_phase": fl.current_phase,
                    "iterations": fl.iterations,
                    "host_fraction": fl.host_fraction(),
                    "entries": fl.tail(k),
                },
                f, indent=2,
            )
    except OSError:
        pass


def _result_dict(req, req_id) -> dict:
    out = {
        "id": req_id,
        "trace_id": req.trace_id,
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


def _engine_loop(engine, inbox, emit, stop, health=None, handler=None, max_queue=None,
                 mailbox=None):
    """Drain inbox → step → deliver answer rows; idle-sleep when empty so a
    quiet server does not spin a core. Inbox items are ``(payload, cb)``:
    each answer goes to ``emit`` and, when set, to ``cb``. A malformed,
    over-budget or shed request is answered with an ``{"error": ...}`` row —
    it never kills the loop under the other in-flight requests.

    Exit conditions: ``stop`` (stdin EOF / server teardown) with nothing
    left in flight, or a drain (SIGTERM → ``health.draining``) once the
    engine has been idle for a short grace window — stragglers already in
    the pipe still get answered.

    A payload may carry a ``_stream`` callable (the OpenAI SSE path): it is
    called with each NEW token chunk as the engine harvests them — with
    double-buffered dispatch a round's tokens land one iteration late, and
    a spec round lands 1 to k+1 at once. When the request has stop
    sequences, streaming lags by ``max(len(stop)) - 1`` tokens so a chunk
    never carries tokens a matched stop sequence later trims: the final
    answer row is authoritative and exactly completes what was streamed.

    Between iterations the loop serves ``mailbox`` (stats snapshots and
    profile windows for the HTTP handlers) and publishes ``health``'s
    gauges, on this thread."""
    pending = {}  # engine request_id -> (user id, per-request callback)
    streams = {}  # engine request_id -> [stream_cb, req, served, holdback]

    def deliver(result, cb):
        emit(result)
        if cb is not None:
            cb(result)

    idle_since = None
    try:
        while True:
            if (handler is not None and handler.preemption_requested
                    and health is not None and not health.draining):
                health.mark_draining()
            try:
                while True:
                    payload, cb = inbox.get_nowait()
                    req_id = payload.get("id") if isinstance(payload, dict) else None
                    if max_queue is not None and engine.scheduler.queue_depth >= max_queue:
                        # bounded admission: an explicit over-capacity answer
                        # beats a waiting queue that grows without limit
                        deliver({
                            "id": req_id,
                            "error": f"over capacity: engine queue depth "
                            f"{engine.scheduler.queue_depth} at --max-queue "
                            f"{max_queue} — request shed",
                        }, cb)
                        continue
                    try:
                        req = engine.add_request(
                            payload["prompt"], payload.get("max_new_tokens"),
                            priority=payload.get("priority", "interactive"),
                            deadline_ms=payload.get("deadline_ms"),
                            sampling=payload.get("sampling"),
                            grammar=payload.get("grammar"),
                            tenant=payload.get("tenant"),
                            logprobs=payload.get("logprobs"),
                            trace_id=payload.get("trace_id"),
                            # only a routed replica closes the router's flow
                            # arrow: a standalone serve drawing flow heads
                            # would count every request as an orphaned flow
                            upstream_hop=(
                                health is not None and health.replica_id is not None
                                and payload.get("trace_id") is not None
                            ),
                        )
                    except Exception as e:  # noqa: BLE001 — reported, not fatal
                        deliver({"id": req_id, "error": str(e)}, cb)
                        continue
                    pending[req.request_id] = (req_id, cb)
                    stream_cb = payload.get("_stream")
                    if stream_cb is not None:
                        hold = 0
                        if req.sampling is not None and req.sampling.stop:
                            hold = max(len(s) for s in req.sampling.stop) - 1
                        streams[req.request_id] = [stream_cb, req, 0, hold]
            except queue.Empty:
                pass
            if mailbox is not None and mailbox.pending:
                mailbox.service(engine)
            if engine.has_work():
                idle_since = None
                for req in engine.step():
                    req_id, cb = pending.pop(req.request_id, (None, None))
                    streams.pop(req.request_id, None)
                    deliver(_result_dict(req, req_id), cb)
                for entry in streams.values():
                    stream_cb, req, served, hold = entry
                    avail = len(req.output_tokens) - hold
                    if avail > served:
                        stream_cb(req.output_tokens[served:avail])
                        entry[2] = avail
                if health is not None:
                    health.publish(engine)
                continue
            if health is not None:
                health.publish(engine)
            if stop.is_set() and inbox.empty():
                return  # EOF/teardown: nothing more can arrive
            if health is not None and health.draining:
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > _DRAIN_IDLE_GRACE_S:
                    return
                time.sleep(0.01)
            else:
                time.sleep(0.005)
    finally:
        if mailbox is not None:
            mailbox.close(engine)


def _print_summary(engine, drained: bool) -> None:
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
        f"host_fraction {stats.get('host_fraction', 0.0):.4f}"
        + (" (drained on SIGTERM)" if drained else ""),
        file=sys.stderr,
    )
    print(f"serve stats: {json.dumps(stats)}", file=sys.stderr)


def serve_command(args) -> int:
    # the live metrics registry: the telemetry rows (with --logging-dir)
    # and the /metrics scrape both publish through it
    from ..metrics.registry import MetricsRegistry, set_active_registry
    from ..resilience.preemption import PreemptionHandler
    from ..serving.workload import (
        TraceSpecError,
        generate_schedule,
        parse_trace_spec,
        run_schedule,
        write_workload_manifest,
    )

    set_active_registry(MetricsRegistry())
    closers = []
    if args.logging_dir:
        from ..diagnostics.tracing import Tracer, set_active_tracer
        from ..telemetry import TelemetryRecorder, set_active_recorder

        recorder = TelemetryRecorder(logging_dir=args.logging_dir)
        set_active_recorder(recorder)
        # request tracing rides the same switch: every request's lifecycle
        # (arrive → admit → prefill → first token → finish) lands in this
        # process's trace file, which the JAX package's `trace merge` reads
        tracer = Tracer(
            logging_dir=args.logging_dir,
            process_name=(f"replica_{args.replica_id}" if args.replica_id is not None
                          else "serve"),
        )
        set_active_tracer(tracer)
        closers = [tracer.close, recorder.close]

    health = ServeHealth(replica_id=args.replica_id)
    # SIGTERM = drain request: flag only, observed by the engine loop between
    # iterations. Ctrl-C keeps its KeyboardInterrupt fast path.
    handler = PreemptionHandler(handle_sigint=False)
    handler.install()

    inbox: queue.Queue = queue.Queue()
    stop = threading.Event()
    out_lock = threading.Lock()

    def emit(result):
        with out_lock:
            print(json.dumps(result), flush=True)

    def refuse(e) -> int:
        emit({"error": str(e)})
        print(f"serve: refusing to start: {e}", file=sys.stderr)
        return 2

    try:
        # a seeded replayable workload: a malformed spec is a startup refusal
        trace_spec = trace_schedule = None
        if args.trace:
            try:
                trace_spec = parse_trace_spec(args.trace)
                trace_schedule = generate_schedule(trace_spec)
            except TraceSpecError as e:
                return refuse(e)
            if args.http:
                print("serve: --trace drives the stdin/JSONL loop — HTTP mode ignores "
                      "the spec", file=sys.stderr)
                trace_spec = trace_schedule = None

        if args.http is not None:
            # factory form: the server binds FIRST (so /healthz answers
            # `starting` while the engine builds and captures), then the
            # state flips to `ready`
            def build_engine():
                try:
                    return _make_engine(args)
                except (ValueError, RuntimeError) as e:
                    raise _StartupRefusal(str(e)) from e

            try:
                return _serve_http(build_engine, inbox, stop, args.http, health=health,
                                   handler=handler, max_queue=args.max_queue,
                                   logging_dir=args.logging_dir)
            except _StartupRefusal as e:
                return refuse(e)

        try:
            engine = _make_engine(args)
        except (ValueError, RuntimeError) as e:
            return refuse(e)
        health.mark_ready()

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
                if health.draining:
                    req_id = payload.get("id") if isinstance(payload, dict) else None
                    emit({"id": req_id, "error": "draining: admission stopped"})
                    continue
                inbox.put((payload, None))
            stop.set()

        if trace_schedule is not None:
            if args.logging_dir:
                write_workload_manifest(args.logging_dir, trace_spec, trace_schedule)
            print(f"serve: replaying workload {trace_spec.as_text()} "
                  f"({len(trace_schedule)} requests)", file=sys.stderr)

            def feed_trace():
                run_schedule(trace_schedule, lambda payload: inbox.put((payload, None)),
                             should_stop=lambda: health.draining or stop.is_set())
                stop.set()

            threading.Thread(target=feed_trace, daemon=True).start()
        else:
            threading.Thread(target=read_stdin, daemon=True).start()
        try:
            _engine_loop(engine, inbox, emit, stop, health=health, handler=handler,
                         max_queue=args.max_queue)
        except KeyboardInterrupt:
            pass
        if health.draining:
            _write_flight_drain(args.logging_dir, engine)
        _print_summary(engine, health.draining)
        return 0
    finally:
        handler.uninstall()
        for close in closers:
            close()


def _serve_http(engine, inbox, stop, port, health=None, handler=None, max_queue=None,
                logging_dir=None, on_bind=None) -> int:
    """The local HTTP front end on ``127.0.0.1:port`` (0 picks a free port,
    handed to ``on_bind`` and printed). ``POST /generate`` blocks until the
    request's answer row (400 on a rejected one, 503 while starting or
    draining); the OpenAI routes answer OpenAI-shaped bodies and SSE; ``GET
    /healthz`` answers the lifecycle state and the router's gauges; ``GET
    /stats`` the engine's ``stats()``; ``GET /metrics`` OpenMetrics text from
    the active registry, refreshed from a ``stats()`` snapshot on each
    scrape; ``GET /profile?seconds=N`` a profiler window and flight dump
    into ``logging_dir/profiles/`` while the engine keeps serving (409 when
    a window is already open, 400 without a logging dir).

    ``engine`` may be a ready instance or a zero-arg factory: with a
    factory the server binds and answers ``/healthz`` as ``starting``
    while the engine builds. The engine loop runs on the calling thread,
    the server on a daemon thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs

    from ..metrics.ingest import observe_engine_stats
    from ..metrics.openmetrics import CONTENT_TYPE, render_openmetrics
    from ..metrics.registry import get_active_registry
    from ..serving.flight import ProfileWindow
    from ..serving.openai_api import OPENAI_PATHS, OpenAIFrontend

    health = health or ServeHealth()
    box = {"engine": None if callable(engine) else engine}
    mailbox = _EngineMailbox()
    frontend = OpenAIFrontend(lambda payload, cb: inbox.put((payload, cb)), streaming="delta")

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so SSE streams ride chunked transfer encoding (every
        # non-stream answer sends Content-Length)
        protocol_version = "HTTP/1.1"
        #: one profile window at a time: a second request gets a 409
        profile_lock = threading.Lock()

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _snapshot(self) -> dict | None:
            """The engine's stats() as of its next iteration boundary."""
            if box["engine"] is None:
                return None
            return mailbox.stats()

        def _send_metrics(self):
            registry = get_active_registry()
            snapshot = self._snapshot() if registry else None
            if snapshot is not None:
                observe_engine_stats(registry, snapshot)
            body = render_openmetrics(registry).encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # split off the query string (scrape params, /profile?seconds=N)
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path == "/metrics":
                self._send_metrics()
            elif path == "/profile":
                self._handle_profile(query)
            elif path == "/healthz":
                self._send(200, health.payload())
            elif path in ("", "/stats", "/health"):
                snapshot = self._snapshot()
                if snapshot is None and box["engine"] is not None:
                    self._send(503, {"error": "the engine did not answer in time"})
                else:
                    self._send(200, snapshot if snapshot is not None
                               else {"state": health.state})
            else:
                self._send(404, {"error": "unknown path"})

        def _handle_profile(self, query: str):
            """On-demand window: the engine thread opens and closes the
            profiler between iterations while it keeps serving; this
            thread waits, then exports the trace and the manifest."""
            if box["engine"] is None or not health.ready:
                self._send(503, {"error": f"engine not ready: {health.state}"})
                return
            if not logging_dir:
                self._send(400, {"error": "profiling needs --logging-dir"})
                return
            try:
                seconds = float((parse_qs(query).get("seconds") or ["2.0"])[0])
            except (TypeError, ValueError):
                self._send(400, {"error": "seconds must be a number"})
                return
            seconds = min(max(seconds, 0.05), 120.0)
            if not Handler.profile_lock.acquire(blocking=False):
                self._send(409, {"error": "a profile capture is already running"})
                return
            try:
                window = ProfileWindow(logging_dir, seconds)
                mailbox.open_profile(window)
                window.closed.wait()
                if window.error is not None:
                    raise RuntimeError(window.error)
                manifest = window.finish()
            except Exception as e:  # noqa: BLE001 — reported, never fatal
                self._send(500, {"error": f"profile capture failed: {e}"})
                return
            finally:
                Handler.profile_lock.release()
            self._send(200, manifest)

        def _send_sse(self, events):
            """Stream SSE events as HTTP/1.1 chunked transfer frames; a
            client hangup mid-stream is normal teardown, not an error."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for event in events:
                    data = event.encode()
                    self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

        def _handle_openai(self, path: str, raw: bytes):
            """The OpenAI door: the same lifecycle gate as /generate,
            OpenAI-shaped error objects on every refusal."""
            def err(status, message, type_="invalid_request_error"):
                self._send(status, {"error": {
                    "message": message, "type": type_, "param": None, "code": None,
                }})

            if not health.ready:
                err(503, f"not accepting requests: {health.state}", "server_error")
                return
            try:
                body = json.loads(raw)
            except json.JSONDecodeError as e:
                err(400, f"bad JSON: {e}")
                return
            kind, *rest = frontend.handle(path, body)
            if kind == "sse":
                self._send_sse(rest[0])
            else:
                self._send(rest[0], rest[1])

        def do_POST(self):
            path = self.path.rstrip("/")
            # read the body up front: on a keep-alive connection an early
            # refusal that skips the body would desync the next request
            try:
                n = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                n = 0
            raw = self.rfile.read(n) if n else b""
            if path in OPENAI_PATHS:
                self._handle_openai(path, raw)
                return
            if path != "/generate":
                self._send(404, {"error": "unknown path"})
                return
            if not health.ready:
                # starting or draining: an explicit answer, so a client fails
                # fast instead of queueing into a front end that will not serve
                self._send(503, {"error": f"not accepting requests: {health.state}"})
                return
            try:
                payload = json.loads(raw)
                if not isinstance(payload, dict):
                    raise ValueError("body must be a JSON object")
                if not payload.get("prompt"):
                    raise ValueError("missing prompt")
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            done = threading.Event()
            answer: dict = {}

            def cb(result):
                answer["result"] = result
                done.set()

            inbox.put((payload, cb))
            done.wait()
            result = answer["result"]
            self._send(400 if "error" in result else 200, result)

    class Server(ThreadingHTTPServer):
        # the default request_queue_size of 5 would refuse connections under
        # a burst of concurrent clients
        request_queue_size = 128
        daemon_threads = True

    server = Server(("127.0.0.1", port), Handler)
    bound = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"serving on http://127.0.0.1:{bound} (POST /generate + /v1/completions + "
          f"/v1/chat/completions, GET /healthz, /stats, /metrics, /profile)",
          file=sys.stderr, flush=True)
    if on_bind is not None:
        on_bind(bound)
    try:
        if box["engine"] is None:
            box["engine"] = engine()  # /healthz says `starting` during this build
        health.publish(box["engine"])
        health.mark_ready()
        _engine_loop(box["engine"], inbox, lambda *a: None, stop, health=health,
                     handler=handler, max_queue=max_queue, mailbox=mailbox)
    except KeyboardInterrupt:
        pass
    finally:
        # a build failure must also unbind the port: a leaked server thread
        # would answer /healthz `starting` forever
        server.shutdown()
        server.server_close()
    if box["engine"] is not None:
        if health.draining:
            _write_flight_drain(logging_dir, box["engine"])
        _print_summary(box["engine"], health.draining)
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
        "serve",
        help="Continuous-batching inference engine over stdin/JSONL or local HTTP",
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
    p.add_argument("--max-queue", type=int, default=None,
                   help="bounded admission: shed (error row) any request arriving while "
                   "this many are already waiting for a slot (default: unbounded)")
    p.add_argument("--trace", default=None, metavar="SPEC",
                   help="drive the engine from a seeded replayable workload instead of "
                   "stdin: 'name:seed:duration:rps' with name in bursty-diurnal|"
                   "longctx-flood|agentic|overbudget-storm, or 'replay:<path>' for a "
                   "recorded schedule (same seed = byte-identical schedule; malformed "
                   "spec = exit 2)")
    p.add_argument("--flight-history", type=int,
                   default=_env_number("ACCELERATE_SERVE_FLIGHT_HISTORY", int, 256),
                   help="per-iteration flight recorder ring size (default 256; 0 disables; "
                   "env ACCELERATE_SERVE_FLIGHT_HISTORY): host-vs-device phase "
                   "attribution behind stats()['host_fraction'] and GET /profile")
    p.add_argument("--stats-interval", type=int,
                   default=_env_number("ACCELERATE_SERVE_STATS_INTERVAL", int, 32),
                   help="emit a telemetry kind=\"step\" row (windowed throughput, "
                   "cumulative counters, the usage-ledger snapshot) every N engine "
                   "iterations (default 32; 0 disables; env "
                   "ACCELERATE_SERVE_STATS_INTERVAL)")
    p.add_argument("--replica-id", type=int, default=None,
                   help="identity stamped on /healthz when running behind a router")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve a local HTTP endpoint instead of stdin JSONL (0 picks a "
                   "free port, printed on stderr)")
    p.add_argument("--logging-dir", default=None,
                   help="write the telemetry JSONL, the request trace, /profile windows "
                   "and the SIGTERM flight drain here")
    p.set_defaults(func=serve_command)
