"""``accelerate-tpu-torch route`` — N engine replicas behind a
health-checked load balancer (port of ``accelerate_tpu/commands/route.py``).

Spawns ``--replicas N`` ``python -m accelerate_tpu_torch serve --http``
processes (or ``--attach``\\ es to running ones), waits for every
``/healthz`` to report ``ready``, then reads the same JSONL request protocol
as ``serve`` from stdin —
plus an optional ``"session_id"`` field for sticky placement — and writes
one JSON result line per request. Requests on a replica that dies
mid-stream are requeued to a surviving replica; the caller still gets
exactly one answer per request. ``--http PORT`` additionally mounts the
OpenAI-compatible door (``/v1/completions`` + ``/v1/chat/completions``,
:mod:`accelerate_tpu_torch.serving.openai_api`) on the router itself, so an
unmodified OpenAI client drives the whole fleet.

The replicas run on the card unless ``--device cpu`` is given (forwarded to
each). ``route`` itself makes no CUDA call; with ``--device cuda`` it builds
the kernels once (:func:`~accelerate_tpu_torch._build.build_all`) before it
spawns, so the replicas load the built libraries instead of each running
``nvcc`` on a fresh checkout. Several replicas share one card: each holds
its own context, weights, pools and graph memory, and the card time-slices
them. ``--mesh`` (one engine sharded over a mesh of cards) is ROADMAP item
18, and SLO-driven scaling (an armed ``ACCELERATE_SLO_*`` objective with
``--logging-dir`` under supervision) item 20: both refuse to start.

SIGTERM drains: admission stops (late submissions are *answered* with an
error row, never dropped), in-flight requests finish, every spawned
replica is SIGTERM'd in turn (the serve front end's own drain path), and
the router exits 0. This is the resilience preemption contract
(``resilience/preemption.py``) applied to serving.
"""

from __future__ import annotations

import json
import os
import queue
import sys
import threading
import time


#: serve flags forwarded verbatim to every replica (the fleet must be
#: shape-identical for dispatch to treat replicas as interchangeable);
#: ``--auto-blocks`` is not among them: it sizes one replica's pool against
#: the whole card
_ENGINE_FLAGS = (
    ("--device", "device"),
    ("--preset", "preset"), ("--dtype", "dtype"), ("--num-slots", "num_slots"),
    ("--block-size", "block_size"), ("--max-seq-len", "max_seq_len"),
    ("--prefill-chunk", "prefill_chunk"), ("--decode-burst", "decode_burst"),
    ("--max-new-tokens", "max_new_tokens"), ("--eos-token-id", "eos_token_id"),
    ("--temperature", "temperature"), ("--seed", "seed"),
    ("--kv-dtype", "kv_dtype"), ("--chaos-spec", "chaos_spec"),
    ("--spec-k", "spec_k"), ("--draft", "draft"),
    ("--logprobs-topn", "logprobs_topn"),
)


#: the SLO objectives' threshold variables (``accelerate_tpu/metrics/slo.py``):
#: one that is set arms the supervisor's SLO policy there
SLO_ENVS = (
    "ACCELERATE_SLO_MIN_GOODPUT_PCT", "ACCELERATE_SLO_MAX_TTFT_P99_S",
    "ACCELERATE_SLO_MAX_TPOT_P99_S", "ACCELERATE_SLO_MAX_ERROR_RATE",
    "ACCELERATE_SLO_MAX_RECOMPILES_PER_HOUR",
)


def armed_slo_objectives() -> list[str]:
    """The SLO threshold variables set in the environment."""
    return [env for env in SLO_ENVS if os.environ.get(env)]


def _serve_args(args) -> list[str]:
    tail: list[str] = []
    for flag, attr in _ENGINE_FLAGS:
        value = getattr(args, attr)
        if value is not None:
            tail += [flag, str(value)]
    if getattr(args, "sync_engine", False):
        tail.append("--sync-engine")
    return tail


def _route_http_server(router, port: int):
    """The router's OpenAI-compatible door: ``POST /v1/completions`` +
    ``/v1/chat/completions`` translated onto ``router.submit`` (so an
    unmodified OpenAI client speaks to the whole fleet), plus a
    ``GET /healthz`` fleet summary. Replicas answer whole completions, so
    SSE streams replay ``at_completion`` — same framing, one
    ``data: [DONE]``, exactly-once."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from ..serving.openai_api import OPENAI_PATHS, OpenAIFrontend

    frontend = OpenAIFrontend(
        lambda payload, cb: router.submit(payload, callback=cb),
        streaming="at_completion",
    )

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") == "/healthz":
                stats = router.stats()
                self._send(200, {
                    "state": "ready",
                    "replicas": stats.get("replicas"),
                    "queue_depth": stats.get("queue_depth"),
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            path = self.path.rstrip("/")
            try:
                n = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                n = 0
            raw = self.rfile.read(n) if n else b""
            if path not in OPENAI_PATHS:
                self._send(404, {"error": {
                    "message": "unknown path", "type": "invalid_request_error",
                    "param": None, "code": None,
                }})
                return
            try:
                body = json.loads(raw)
            except json.JSONDecodeError as e:
                self._send(400, {"error": {
                    "message": f"bad JSON: {e}",
                    "type": "invalid_request_error",
                    "param": None, "code": None,
                }})
                return
            kind, *rest = frontend.handle(path, body)
            if kind == "sse":
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for event in rest[0]:
                        data = event.encode()
                        self.wfile.write(
                            f"{len(data):X}\r\n".encode() + data + b"\r\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
            else:
                self._send(rest[0], rest[1])

    class Server(ThreadingHTTPServer):
        request_queue_size = 128

    server = Server(("127.0.0.1", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(
        f"route: OpenAI endpoint on http://127.0.0.1:{port}/v1 "
        "(POST /v1/completions, /v1/chat/completions)",
        file=sys.stderr,
    )
    return server


def _refusal(args) -> str | None:
    """Why this fleet cannot start yet, or None: what the port does not
    have, named with its ROADMAP item, before anything spawns."""
    if args.mesh:
        return ("--mesh is not yet ported (ROADMAP item 18): one engine sharded "
                "over a mesh of cards is tensor parallelism across cards")
    supervised = args.respawn or args.min_replicas is not None or args.max_replicas is not None
    armed = armed_slo_objectives()
    if supervised and not args.attach and args.logging_dir and armed:
        return ("SLO-driven scaling is not yet ported (ROADMAP item 20: metrics/slo.py, "
                f"goodput.py, diagnostics/monitor.py); armed: {', '.join(armed)} — unset "
                "them, or run without --logging-dir for queue-depth scaling")
    return None


def route_command(args) -> int:
    from ..resilience.preemption import PreemptionHandler
    from ..serving.replica import ReplicaHandle, spawn_replica, wait_until_ready
    from ..serving.router import Router
    from ..serving.workload import (
        TraceSpecError,
        WorkloadRecorder,
        generate_schedule,
        parse_trace_spec,
        run_schedule,
        write_workload_manifest,
    )

    refusal = _refusal(args)
    if refusal is not None:
        print(json.dumps({"error": refusal}))
        print(f"route: refusing to start: {refusal}", file=sys.stderr)
        return 2
    # a malformed chaos spec is a bring-up refusal here too, before any
    # replica spawns (each replica would refuse it on its own, exit 2)
    if args.chaos_spec:
        from ..serving.chaos import ChaosSpecError, parse_chaos_spec

        try:
            parse_chaos_spec(args.chaos_spec)
        except ChaosSpecError as e:
            print(json.dumps({"error": str(e)}))
            print(f"route: refusing to start: {e}", file=sys.stderr)
            return 2

    # seeded replayable workload: parsed before anything spawns — a
    # malformed spec is a bring-up refusal (exit 2), the --chaos-spec
    # contract, not a fleet brought up to replay nothing
    trace_spec = trace_schedule = None
    if args.trace:
        try:
            trace_spec = parse_trace_spec(args.trace)
            trace_schedule = generate_schedule(trace_spec)
        except TraceSpecError as e:
            print(json.dumps({"error": str(e)}))
            print(f"route: refusing to start: {e}", file=sys.stderr)
            return 2

    if args.device == "cuda" and not args.attach:
        # one build before the spawns: the replicas then load the built
        # libraries (keyed by the sources' hash) instead of each running
        # nvcc; no CUDA call here
        from .. import _build

        try:
            _build.build_all()
        except RuntimeError as e:
            print(json.dumps({"error": str(e)}))
            print(f"route: refusing to start: {e}", file=sys.stderr)
            return 2

    if args.logging_dir:
        os.makedirs(args.logging_dir, exist_ok=True)
        from ..diagnostics.tracing import Tracer, set_active_tracer

        # the router's half of every request flow (submit → dispatch →
        # finish) lands in <logging_dir>/traces/; each replica writes its
        # own half under replica_<i>/ — `trace merge` stitches them by
        # trace_id into one timeline, `trace tail` attributes the slowest
        set_active_tracer(Tracer(logging_dir=args.logging_dir, process_name="router"))

    def spawn_fn(replica_id: int):
        """One replica's spawn recipe — shared by bring-up and the
        supervisor's respawn/scale-up paths, so a respawned replica is
        byte-identical in configuration to the one it replaces."""
        serve_tail = _serve_args(args)
        env = None
        if args.logging_dir:
            # one telemetry trail per replica — two processes appending
            # the same telemetry.jsonl would interleave torn rows
            serve_tail += ["--logging-dir",
                           os.path.join(args.logging_dir, f"replica_{replica_id}")]
        return spawn_replica(replica_id, serve_tail, env=env, stderr=sys.stderr)

    replicas = []
    if args.attach:
        for i, url in enumerate(x for x in args.attach.split(",") if x):
            replicas.append(ReplicaHandle(i, url))
    else:
        try:
            for i in range(args.replicas):
                replicas.append(spawn_fn(i))
        except Exception:
            # a failed spawn mid-loop must not strand the earlier spawns:
            # kill + reap everything before the exception surfaces
            for r in replicas:
                r.kill()
            for r in replicas:
                r.wait(timeout=10.0)
            raise

    supervisor = None
    wants_supervision = (
        args.respawn
        or args.max_replicas is not None
        or args.min_replicas is not None
    )
    if wants_supervision:
        if args.attach:
            print(
                "route: --respawn/--min-replicas/--max-replicas need spawned "
                "replicas (they respawn via the serve spawn recipe) — "
                "ignoring for an --attach fleet", file=sys.stderr,
            )
        else:
            from ..serving.supervisor import ReplicaSupervisor, SupervisorConfig

            # queue-depth scaling only: the SLO verdict that would feed
            # slo_fn is ROADMAP item 20 (an armed objective refused above)

            # explicit is-None tests: --min-replicas 0 (scale-to-zero floor)
            # must not be rewritten to --replicas
            min_replicas = (
                args.replicas if args.min_replicas is None else args.min_replicas
            )
            max_replicas = (
                args.replicas if args.max_replicas is None else args.max_replicas
            )
            supervisor = ReplicaSupervisor(
                spawn_fn,
                SupervisorConfig(
                    min_replicas=min_replicas,
                    max_replicas=max(max_replicas, min_replicas, 1),
                    respawn=bool(args.respawn),
                    ready_timeout=args.ready_timeout,
                    seed=args.seed,
                ),
            )
    print(
        f"route: waiting for {len(replicas)} replica(s) to report ready...",
        file=sys.stderr,
    )
    router = Router(
        replicas,
        logging_dir=args.logging_dir,
        health_interval=args.health_interval,
        request_timeout=args.request_timeout,
        supervisor=supervisor,
        max_queue_depth=args.max_queue_depth,
    )
    try:
        wait_until_ready(replicas, timeout=args.ready_timeout)
    except Exception as e:
        # no orphans on failed bring-up: close() kills AND reaps every
        # spawned replica (and stops the supervisor first, so a respawn
        # never races the teardown)
        print(f"route: bring-up failed: {e}", file=sys.stderr)
        router.close()
        return 1
    print(
        "route: fleet ready — "
        + "  ".join(f"replica {r.replica_id} @ {r.base_url} (pid {r.pid})"
                    for r in replicas),
        file=sys.stderr,
    )
    http_server = _route_http_server(router, args.http) if args.http else None

    # SIGTERM → drain (stop admission, answer in-flight, clean exit 0);
    # the handler only raises a flag — the loop below observes it between
    # submissions, exactly like the training loop observes it between steps
    handler = PreemptionHandler(handle_sigint=True)
    handler.install()

    out_lock = threading.Lock()

    def emit(result):
        with out_lock:
            print(json.dumps(result), flush=True)

    inbox: queue.Queue = queue.Queue()
    eof = threading.Event()

    # --trace-record: capture live arrivals into the replayable schedule
    # format (workload/recorded.jsonl) — replay later with
    # --trace replay:<path>
    recorder = None
    if getattr(args, "trace_record", False):
        if args.logging_dir:
            recorder = WorkloadRecorder(args.logging_dir)
            print(f"route: recording workload to {recorder.path}", file=sys.stderr)
        else:
            print(
                "route: --trace-record needs --logging-dir — ignoring",
                file=sys.stderr,
            )

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
            if recorder is not None:
                recorder.observe(payload)
            inbox.put(payload)
        eof.set()

    if trace_schedule is not None:
        if args.logging_dir:
            write_workload_manifest(args.logging_dir, trace_spec, trace_schedule)
        print(
            f"route: replaying workload {trace_spec.as_text()} "
            f"({len(trace_schedule)} requests)", file=sys.stderr,
        )

        def feed_trace():
            run_schedule(
                trace_schedule,
                inbox.put,
                should_stop=lambda: handler.preemption_requested,
            )
            eof.set()

        threading.Thread(target=feed_trace, daemon=True).start()
    else:
        threading.Thread(target=read_stdin, daemon=True).start()

    drain_reason = "eof"
    try:
        while True:
            if handler.preemption_requested:
                drain_reason = handler.reason or "signal"
                # grace sweep: lines that were in the pipe before the signal
                # are in-flight work, not late arrivals — give the reader a
                # beat to surface them, then stop admission (anything later
                # still gets answered via submit()'s draining error row)
                grace_end = time.monotonic() + 1.0
                while time.monotonic() < grace_end:
                    try:
                        router.submit(inbox.get(timeout=0.1), callback=emit)
                    except queue.Empty:
                        continue
                router.stop_admission()
                while not inbox.empty():
                    router.submit(inbox.get_nowait(), callback=emit)
                break
            try:
                payload = inbox.get(timeout=0.1)
            except queue.Empty:
                if eof.is_set() and inbox.empty():
                    break
                continue
            router.submit(payload, callback=emit)
    finally:
        handler.uninstall()

    print(f"route: draining ({drain_reason})...", file=sys.stderr)
    clean = router.drain(timeout=args.drain_timeout)
    if http_server is not None:
        # after drain: in-flight OpenAI requests got their callbacks; a
        # late POST would have been answered with an admission-stopped row
        http_server.shutdown()
    # lines that arrived while drain() ran still get an answer (an
    # admission-stopped error row), never silence; a short quiet window
    # catches a producer mid-write before the process exits
    grace_end = time.monotonic() + 1.0
    while time.monotonic() < grace_end and not eof.is_set():
        try:
            router.submit(inbox.get(timeout=0.1), callback=emit)
        except queue.Empty:
            continue
    while not inbox.empty():
        router.submit(inbox.get_nowait(), callback=emit)
    if recorder is not None:
        recorder.close()
        print(
            f"route: recorded {recorder.recorded} request(s) to {recorder.path}",
            file=sys.stderr,
        )
    stats = router.stats()
    sup = stats.get("supervisor") or {}
    sup_text = (
        f", {sup['respawns']} respawn(s), {sup['scale_ups']} scale-up(s), "
        f"{sup['scale_downs']} scale-down(s)" if sup else ""
    )
    print(
        f"route: delivered {stats['delivered']} "
        f"({stats['tokens']} tokens, {stats['requeues']} requeues, "
        f"{stats['rejected']} rejected, {stats['shed']} shed, "
        f"{stats['deadline_expired']} deadline-expired, "
        f"{stats['dead']} dead replica(s){sup_text})",
        file=sys.stderr,
    )
    return 0 if clean else 1


def add_parser(subparsers):
    p = subparsers.add_parser(
        "route",
        help="Load-balance JSONL requests over N health-checked engine replicas",
    )
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where every replica's engine runs (forwarded to each "
                   "serve; default the card, cpu for the plain PyTorch paths)")
    p.add_argument("--replicas", type=int, default=2,
                   help="engine replica processes to spawn")
    p.add_argument("--attach", default=None, metavar="URL[,URL...]",
                   help="route to already-running serve endpoints instead of spawning")
    p.add_argument("--logging-dir", default=None,
                   help="fleet health JSONL (router/replicas.jsonl) + per-replica "
                   "telemetry land here (the JAX package's `accelerate-tpu monitor` "
                   "reads the fleet trail)")
    p.add_argument("--health-interval", type=float, default=0.5,
                   help="seconds between /healthz sweeps")
    p.add_argument("--ready-timeout", type=float, default=300.0,
                   help="seconds to wait for the fleet to report ready")
    p.add_argument("--drain-timeout", type=float, default=300.0,
                   help="seconds to wait for in-flight requests + replica exits")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="per-dispatch HTTP timeout (default: wait forever); "
                   "expiry on a slow-but-alive replica requeues the request "
                   "without marking the replica dead")
    # self-healing fleet (serving/supervisor.py)
    p.add_argument("--respawn", action="store_true",
                   help="supervise the fleet: respawn dead replicas with "
                   "exponential crash-loop backoff, quarantine flapping ones "
                   "(half-open probation rejoin), and restore --min-replicas "
                   "(default off: a dead replica stays dead, a fixed fleet)")
    p.add_argument("--min-replicas", type=int, default=None,
                   help="fleet floor the supervisor restores after deaths / "
                   "scale-down (default: --replicas; implies supervision — "
                   "pair with --respawn for death recovery)")
    p.add_argument("--max-replicas", type=int, default=None,
                   help="autoscale ceiling: sustained router queue depth "
                   "spawns up to this many replicas; an idle fleet drains "
                   "back to --min-replicas (default: --replicas, i.e. no "
                   "scaling; implies supervision)")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="bounded-queue admission: over this many queued "
                   "requests the router sheds batch-class before interactive "
                   "with explicit over-capacity error rows (default: "
                   "unbounded)")
    # engine shape passthrough (matches `serve`)
    p.add_argument("--preset", choices=("tiny", "flagship"), default="tiny")
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--decode-burst", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--eos-token-id", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-dtype", choices=("auto", "bf16", "f32", "int8", "fp8"),
                   default=None,
                   help="forwarded to every replica's serve --kv-dtype "
                   "(replicas must store KV identically for dispatch to "
                   "treat them as interchangeable)")
    p.add_argument("--spec-k", type=int, default=None,
                   help="forwarded to every replica's serve --spec-k "
                   "(speculative decoding; the fleet must decode "
                   "identically for dispatch to treat replicas as "
                   "interchangeable)")
    p.add_argument("--draft", default=None,
                   help="forwarded to every replica's serve --draft "
                   "(e.g. early_exit:2)")
    p.add_argument("--logprobs-topn", type=int, default=None,
                   help="forwarded to every replica's serve --logprobs-topn "
                   "(the OpenAI 'logprobs' field needs it; the fleet must "
                   "harvest identically)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="mount the OpenAI-compatible endpoint "
                   "(/v1/completions, /v1/chat/completions; SSE + "
                   "non-streaming) on this port, translated onto the "
                   "routed fleet — an unmodified OpenAI client talks to "
                   "the whole fleet")
    p.add_argument("--mesh", action="store_true",
                   help="each replica shards its engine over a mesh of cards: "
                   "not yet ported (ROADMAP item 18), refuses to start")
    p.add_argument(
        "--sync-engine", action="store_true",
        default=os.environ.get("ACCELERATE_SYNC_ENGINE", "") not in ("", "0"),
        help="every replica runs the synchronous step loop (forwards "
        "serve's --sync-engine; env ACCELERATE_SYNC_ENGINE=1)")
    p.add_argument("--chaos-spec", default=None,
                   help="forwarded to every replica's serve --chaos-spec "
                   "(entries scoped rN: fire only on replica N; a malformed "
                   "spec refuses to start, exit 2)")
    # replayable workload suite (serving/workload.py)
    p.add_argument("--trace", default=None, metavar="SPEC",
                   help="drive the fleet from a seeded replayable workload "
                   "instead of stdin: 'name:seed:duration:rps' with name in "
                   "bursty-diurnal|longctx-flood|agentic|overbudget-storm, "
                   "or 'replay:<path>' for a recorded schedule (same seed = "
                   "byte-identical schedule, manifest in WORKLOAD.json; "
                   "malformed spec = exit 2)")
    p.add_argument("--trace-record", action="store_true",
                   help="capture live stdin arrivals into the replayable "
                   "schedule format under <logging-dir>/workload/ — replay "
                   "with --trace replay:<path>")
    p.set_defaults(func=route_command)
    return p
