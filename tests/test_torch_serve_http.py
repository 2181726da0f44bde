"""``serve --http`` of the port (``accelerate_tpu_torch/commands/serve.py``)
over a port engine whose weights come from a tiny JAX llama
(``params_from_jax``), on the CPU.

An in-process ``_serve_http`` (factory form, bound to ``127.0.0.1`` port 0)
is driven as a client would:

* ``/healthz`` reads ``starting`` while the engine builds, then ``ready``;
* greedy ``/v1/completions``, ``/v1/chat/completions`` and ``/generate``
  give the JAX engine's tokens on the same weights;
* SSE deltas are an in-order split of the non-stream answer's tokens, with
  one finish chunk and one ``[DONE]``; a stop sequence is never over-sent;
* a ``json_schema`` answer validates against its schema;
* ``/metrics`` parses with the port's strict OpenMetrics parser and its
  counters equal ``/stats``; ``/stats`` and ``/metrics`` hammered from
  threads while requests run raise nothing;
* ``--max-queue`` sheds;
* a ``serve --device cpu --http`` subprocess drains on SIGTERM: every
  admitted request answered, exit 0, the flight drain written.

Every network call and wait has its own timeout.
"""

import dataclasses
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu_torch.commands import serve as tserve  # noqa: E402
from accelerate_tpu_torch.metrics import openmetrics as tom  # noqa: E402
from accelerate_tpu_torch.metrics import registry as treg  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.serving.grammar import validate_instance  # noqa: E402
from accelerate_tpu_torch.serving.openai_api import (  # noqa: E402
    chat_prompt,
    decode_tokens,
    encode_text,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120
VOCAB = 128  # a byte vocabulary: ASCII text round-trips, deltas decode alone
GEOMETRY = dict(num_slots=4, block_size=8, max_seq_len=96, prefill_chunk=8, decode_burst=4)
JAX_EXTRAS = dict(async_dispatch=False, flight_history=0, usage_accounting=False)
SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=128),
        num_key_value_heads=2,
    )
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg))
    return jmodel, tmodel


class _Server:
    """An in-process ``_serve_http`` on its own thread, engine built by a
    factory that waits for :meth:`release` (so ``starting`` is observable)."""

    def __init__(self, tmodel, logging_dir=None, max_queue=None, **engine_kw):
        self.inbox, self.stop = queue.Queue(), threading.Event()
        self.health = tserve.ServeHealth()
        self._release = threading.Event()
        self._bound = queue.Queue()
        self.engine = None

        def factory():
            assert self._release.wait(TIMEOUT_S)
            self.engine = tserving.InferenceEngine(
                tmodel, tserving.EngineConfig(**{**GEOMETRY, **engine_kw}), device="cpu")
            return self.engine

        self.thread = threading.Thread(target=tserve._serve_http, daemon=True, kwargs=dict(
            engine=factory, inbox=self.inbox, stop=self.stop, port=0, health=self.health,
            max_queue=max_queue, logging_dir=logging_dir, on_bind=self._bound.put))
        self.thread.start()
        self.base = f"http://127.0.0.1:{self._bound.get(timeout=TIMEOUT_S)}"

    def release(self):
        self._release.set()
        deadline = time.monotonic() + TIMEOUT_S
        while get(self.base + "/healthz")["state"] != "ready":
            assert time.monotonic() < deadline
            time.sleep(0.01)

    def close(self):
        self._release.set()
        self.stop.set()
        self.thread.join(TIMEOUT_S)
        assert not self.thread.is_alive()


def get(url, raw=False):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as resp:
        body = resp.read().decode()
    return body if raw else json.loads(body)


def post(url, body, raw=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            status, text = resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    return status, (text if raw else json.loads(text))


def sse_chunks(text):
    frames = [f for f in text.split("\n\n") if f]
    assert all(f.startswith("data: ") for f in frames) and frames[-1] == "data: [DONE]"
    assert sum(f == "data: [DONE]" for f in frames) == 1
    return [json.loads(f[6:]) for f in frames[:-1]]


def split_of(deltas, tokens):
    """True when the delta texts are the decodes of consecutive, in-order,
    non-empty runs of ``tokens`` that cover all of them."""
    reach = {0}  # token positions some split of the deltas so far can end at
    for text in deltas:
        reach = {j for i in reach for j in range(i + 1, len(tokens) + 1)
                 if decode_tokens(tokens[i:j]) == text}
    return len(tokens) in reach


@pytest.fixture(scope="module")
def server(weights):
    treg.set_active_registry(treg.MetricsRegistry())
    srv = _Server(weights[1], usage_accounting=True)
    try:
        assert get(srv.base + "/healthz")["state"] == "starting"
        status, body = post(srv.base + "/generate", {"prompt": [1, 2]})
        assert status == 503 and "starting" in body["error"]
        assert get(srv.base + "/stats") == {"state": "starting"}
        srv.release()
        yield srv
    finally:
        srv.close()
        treg.set_active_registry(None)


def _jax_greedy(jmodel, prompts, budget):
    engine = jserving.InferenceEngine(jmodel, jserving.EngineConfig(**GEOMETRY, **JAX_EXTRAS))
    reqs = [engine.add_request(p, budget) for p in prompts]
    engine.run_until_idle(max_iterations=2000)
    return [list(r.output_tokens) for r in reqs]


def test_healthz_reports_ready_with_gauges(server):
    health = get(server.base + "/healthz")
    assert health["state"] == "ready" and health["num_slots"] == GEOMETRY["num_slots"]
    assert health["pid"] == os.getpid() and health["queue_depth"] == 0
    status, body = post(server.base + "/nowhere", {})
    assert status == 404


def test_greedy_answers_equal_the_jax_engine(server, weights):
    prompt_text, chat = "The cat sat", [{"role": "user", "content": "hi there"}]
    ids = [5, 17, 99, 3, 64, 2]
    budget = 9
    jax_tokens = _jax_greedy(weights[0], [encode_text(prompt_text), ids,
                                          encode_text(chat_prompt(chat))],
                             budget)
    status, body = post(server.base + "/v1/completions",
                        {"prompt": prompt_text, "max_tokens": budget, "temperature": 0})
    assert status == 200 and body["object"] == "text_completion"
    assert body["choices"][0]["text"] == decode_tokens(jax_tokens[0])
    assert body["usage"]["completion_tokens"] == budget
    status, row = post(server.base + "/generate",
                       {"id": "g", "prompt": ids, "max_new_tokens": budget,
                        "trace_id": "0af7651916cd43dd"})
    assert status == 200 and row["tokens"] == jax_tokens[1] and row["id"] == "g"
    assert row["trace_id"] == "0af7651916cd43dd" and row["device_time_s"] > 0
    status, body = post(server.base + "/v1/chat/completions",
                        {"messages": chat, "max_tokens": budget, "temperature": 0})
    assert status == 200
    assert body["choices"][0]["message"]["content"] == decode_tokens(jax_tokens[2])
    status, body = post(server.base + "/generate", {"prompt": "not ids"})
    assert status == 400 and "error" in body


def test_sse_deltas_split_the_answer_and_never_pass_a_stop(server):
    request = {"prompt": "Once upon", "max_tokens": 12, "temperature": 0}
    status, whole = post(server.base + "/v1/completions", request)
    assert status == 200
    tokens = encode_text(whole["choices"][0]["text"])
    assert len(tokens) == 12
    status, text = post(server.base + "/v1/completions", {**request, "stream": True}, raw=True)
    chunks = sse_chunks(text)
    finals = [c for c in chunks if c["choices"][0]["finish_reason"]]
    assert len(finals) == 1 and finals[-1] is chunks[-1]
    deltas = [c["choices"][0]["text"] for c in chunks if c["choices"][0]["text"]]
    assert split_of(deltas, tokens), (deltas, tokens)
    # a two-token stop sequence taken from the answer: the stream stops
    # before it, and no chunk ever carries a byte of it
    stop = decode_tokens(tokens[5:7])
    status, text = post(server.base + "/v1/completions",
                        {**request, "stream": True, "stop": [stop]}, raw=True)
    chunks = sse_chunks(text)
    streamed = "".join(c["choices"][0]["text"] for c in chunks)
    assert stop not in streamed and streamed == decode_tokens(tokens[:5])
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


def test_json_schema_answer_validates(server):
    status, body = post(server.base + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "json please"}], "max_tokens": 24,
        "temperature": 0,
        "response_format": {"type": "json_schema", "json_schema": {"schema": SCHEMA}}})
    assert status == 200
    answer = json.loads(body["choices"][0]["message"]["content"])
    validate_instance(SCHEMA, answer)


def test_metrics_parse_and_agree_with_stats(server):
    post(server.base + "/generate", {"prompt": [7, 8, 9], "max_new_tokens": 3})
    families = tom.parse_openmetrics(get(server.base + "/metrics", raw=True))
    stats = get(server.base + "/stats")
    for family, key in (("accelerate_serving_completed", "completed"),
                        ("accelerate_serving_iterations", "iterations"),
                        ("accelerate_serving_decode_compiles", "decode_compiles")):
        assert families[family]["type"] == "counter"
        assert tom.sample_value(families, family) == stats[key], family
    assert families["accelerate_serving_iteration_seconds"]["type"] == "histogram"
    assert "accelerate_span_seconds" not in families  # no tracer without a logging dir


def test_stats_and_metrics_hammered_during_a_run(server):
    errors, answers = [], []

    def hammer():
        for i in range(15):
            try:
                if i % 2:
                    tom.parse_openmetrics(get(server.base + "/metrics", raw=True))
                else:
                    assert "completed" in get(server.base + "/stats")
                get(server.base + "/healthz")
            except Exception as e:  # noqa: BLE001 — collected and asserted below
                errors.append(repr(e))

    def request(i):
        answers.append(post(server.base + "/generate",
                            {"id": i, "prompt": [1 + i, 2, 3], "max_new_tokens": 10}))

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    threads += [threading.Thread(target=request, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    assert errors == []
    assert sorted(body["id"] for status, body in answers) == list(range(6))
    assert all(status == 200 and len(body["tokens"]) == 10 for status, body in answers)


def test_max_queue_sheds(weights):
    """The loop sheds what arrives while ``max_queue`` requests wait, and
    the HTTP door answers a shed request with a 400 error row."""
    engine = tserving.InferenceEngine(weights[1], tserving.EngineConfig(**GEOMETRY),
                                      device="cpu")
    inbox, out, stop = queue.Queue(), [], threading.Event()
    for i in range(5):
        inbox.put(({"id": i, "prompt": [1, 2, 3], "max_new_tokens": 2}, None))
    stop.set()
    tserve._engine_loop(engine, inbox, out.append, stop, max_queue=2)
    shed = sorted(r["id"] for r in out if "over capacity" in r.get("error", ""))
    assert shed == [2, 3, 4] and sorted(r["id"] for r in out if "tokens" in r) == [0, 1]
    srv = _Server(weights[1], max_queue=0)
    try:
        srv.release()
        status, body = post(srv.base + "/generate", {"prompt": [1, 2], "max_new_tokens": 2})
        assert status == 400 and "over capacity" in body["error"]
    finally:
        srv.close()


def test_serve_cpu_http_drains_on_sigterm(tmp_path):
    """The subprocess twin of the JAX serve CLI's drain test: requests in
    flight when SIGTERM lands are all answered with tokens, a late one is
    refused, the flight drain is written and the process exits 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch", "serve", "--device", "cpu",
         "--preset", "tiny", "--max-seq-len", "128", "--http", "0",
         "--logging-dir", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        base = "http://127.0.0.1:" + re.search(r"127\.0\.0\.1:(\d+)", line).group(1)
        deadline = time.monotonic() + TIMEOUT_S
        while get(base + "/healthz")["state"] != "ready":
            assert time.monotonic() < deadline
            time.sleep(0.02)
        answers = []
        threads = [threading.Thread(target=lambda i=i: answers.append(post(
            base + "/generate", {"id": i, "prompt": [i + 1, 2, 3], "max_new_tokens": 40})))
            for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + TIMEOUT_S
        while get(base + "/healthz")["active_slots"] + get(base + "/healthz")["queue_depth"] < 4:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        proc.send_signal(signal.SIGTERM)
        while get(base + "/healthz")["state"] != "draining":
            assert time.monotonic() < deadline
            time.sleep(0.005)
        late = post(base + "/generate", {"id": "late", "prompt": [1, 2], "max_new_tokens": 2})
        for t in threads:
            t.join(TIMEOUT_S)
        rc = proc.wait(timeout=TIMEOUT_S)
        stderr = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert rc == 0, stderr
    assert sorted(body["id"] for status, body in answers) == [0, 1, 2, 3]
    assert all(status == 200 and len(body["tokens"]) == 40 for status, body in answers)
    assert late[0] == 503 and "draining" in late[1]["error"]
    assert "(drained on SIGTERM)" in stderr
    assert list(tmp_path.glob("FLIGHT_DRAIN_*.json"))
