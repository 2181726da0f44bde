"""The port's observability surface against the JAX package's readers.

* OpenMetrics: the same records, spans, flight entries and ``stats()``
  dicts fed to both packages' registries render the same text, and the
  JAX package's strict parser reads the port's.
* Request tracing: the port's trace file is one the JAX package's ``trace
  merge`` reads and validates; for the same requests (same weights, same
  trace ids) the port's engine emits the JAX engine's ``req/*`` event names
  in the JAX engine's order for every request, and the serve spans.
* Telemetry: the port's JSONL rows (requests, periodic steps, a capture as
  a ``type="compile"`` row) are rows the JAX package's readers accept, and
  they feed the registry; the file rotates as the JAX recorder's does.
* The ``trace_id`` contract of the JAX package's ``tests/test_reqtrace.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu import telemetry as jtel  # noqa: E402
from accelerate_tpu.diagnostics import tracing as jtr  # noqa: E402
from accelerate_tpu.metrics import ingest as jingest  # noqa: E402
from accelerate_tpu.metrics import openmetrics as jom  # noqa: E402
from accelerate_tpu.metrics import registry as jreg  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu_torch import telemetry as ttel  # noqa: E402
from accelerate_tpu_torch.diagnostics import tracing as ttr  # noqa: E402
from accelerate_tpu_torch.metrics import ingest as tingest  # noqa: E402
from accelerate_tpu_torch.metrics import openmetrics as tom  # noqa: E402
from accelerate_tpu_torch.metrics import registry as treg  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

torch.set_num_threads(1)

VOCAB = 64
GEOMETRY = dict(num_slots=2, block_size=4, max_seq_len=48, prefill_chunk=4, decode_burst=2)


@pytest.fixture(scope="module")
def weights():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=64)
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg))
    return jmodel, tmodel


#: records of every kind the serving path writes (and a training row the
#: shared mapping also takes), in one sequence
RECORDS = [
    {"type": "serving", "kind": "request", "finish_reason": "length", "new_tokens": 7,
     "ttft_s": 0.02, "tpot_s": 0.004, "priority": "interactive", "trace_id": "0af7651916cd43dd"},
    {"type": "serving", "kind": "request", "finish_reason": "stop", "new_tokens": 3,
     "ttft_s": 0.3, "tpot_s": 0.01, "priority": "batch"},
    {"type": "serving", "kind": "step", "tokens_per_sec": 812.5, "queue_depth": 3,
     "active_slots": 2, "slot_occupancy": 1.0, "free_blocks": 9, "decode_compiles": 1,
     "completed_total": 2, "prefix_hit_tokens": 16, "prefix_hit_ratio": 0.25,
     "preemptions": 1, "swapped_out_blocks": 4, "swapped_in_blocks": 4,
     "kv_bytes_per_token": 4096, "kv_slot_capacity": 8, "host_fraction": 0.2,
     "sampled_tokens_greedy": 40, "sampled_tokens_sample": 10, "grammar_masked_steps": 6,
     "usage": {"by_tenant": {"acme": {"device_seconds": 0.5, "block_seconds": 2.0,
                                      "swap_bytes": 1024}}, "requests_finished": 2}},
    {"type": "compile", "label": "decode", "total_s": 0.8, "recompiles": 1},
    {"type": "serving", "kind": "profile", "seconds": 1.0},
    {"type": "event", "kind": "serving_retrace"},
    {"type": "step", "step_time_s": 0.1, "recompiles": 2, "tokens_per_sec": 100.0},
]
STATS = {"queue_depth": 1, "active_slots": 2, "free_blocks": 5, "tokens_emitted": 120,
         "completed": 9, "decode_compiles": 1, "iterations": 77, "tokens_per_sec": 400.0,
         "prefix_hit_ratio": 0.5, "kv_bytes_per_token": 4096, "host_fraction": 0.3,
         "preemptions": 2, "spec_drafted_tokens": 8, "spec_accepted_tokens": 2,
         "spec_accept_rate": 0.25, "usage": {"by_tenant": {"default": {"device_seconds": 1.0}}}}
FLIGHT = {"wall_s": 0.004, "schedule_s": 0.0005, "prefill_s": 0.001, "dispatch_s": 0.001,
          "device_wait_s": 0.001, "harvest_s": 0.0005, "overlap_hidden_s": 0.0002}


def _fed(reg_mod, ingest, ring_start=1_000.0):
    reg = reg_mod.MetricsRegistry(gate_main_process=False)
    for record in RECORDS:
        ingest.observe_record(reg, record)
    ingest.observe_flight(reg, FLIGHT)
    ingest.observe_span(reg, "serve/decode", 0.003)
    ingest.observe_engine_stats(reg, STATS)
    return reg


def test_the_port_renders_the_jax_openmetrics_text():
    text = tom.render_openmetrics(_fed(treg, tingest))
    ref = jom.render_openmetrics(_fed(jreg, jingest))
    strip = lambda s: "\n".join(l for l in s.splitlines() if " # {" not in l)  # noqa: E731
    # exemplar lines carry the observation's wall-clock stamp: equal but for it
    assert strip(text) == strip(ref)
    families = jom.parse_openmetrics(text)  # the JAX package's strict parser
    assert jom.sample_value(families, "accelerate_serving_completed") == 9
    assert jom.sample_value(families, "accelerate_serving_sampled_tokens", mode="greedy") == 40
    assert families["accelerate_serving_ttft_seconds"]["type"] == "histogram"
    assert tom.parse_openmetrics(text) == families


def _trace_ids(n):
    return [f"req{i:02d}trace" for i in range(n)]


def _run_traced(engine, tracer, prompts, budgets):
    for tid, prompt, budget in zip(_trace_ids(len(prompts)), prompts, budgets):
        engine.add_request(prompt, budget, trace_id=tid)
    engine.run_until_idle(max_iterations=2000)
    tracer.close()


def _request_names(path):
    """``{trace_id: [event names in file order]}`` of the request events,
    through the JAX package's reader."""
    out = {}
    for e in jtr.parse_trace_file(path):
        if e.get("cat") == jtr.REQUEST_CATEGORY:
            out.setdefault(e["id"], []).append((e["ph"], e["name"]))
    return out


def test_request_events_follow_the_jax_engine_and_merge(weights, tmp_path):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=int(k)).tolist() for k in (3, 9, 14, 5, 11)]
    budgets = [6, 4, 9, 3, 7]
    jmodel, tmodel = weights

    jtracer = jtr.Tracer(logging_dir=str(tmp_path / "jax"), process_name="serve")
    jtr.set_active_tracer(jtracer)
    try:
        _run_traced(jserving.InferenceEngine(jmodel, jserving.EngineConfig(
            **GEOMETRY, async_dispatch=False, flight_history=8, usage_accounting=False)),
            jtracer, prompts, budgets)
    finally:
        jtr.set_active_tracer(None)
    ttracer = ttr.Tracer(logging_dir=str(tmp_path / "port"), process_name="serve")
    ttr.set_active_tracer(ttracer)
    try:
        _run_traced(tserving.InferenceEngine(tmodel, tserving.EngineConfig(**GEOMETRY),
                                             device="cpu"), ttracer, prompts, budgets)
    finally:
        ttr.set_active_tracer(None)

    port_file = tmp_path / "port" / "traces" / "host_0.trace.json"
    got = _request_names(str(port_file))
    ref = _request_names(str(tmp_path / "jax" / "traces" / "host_0.trace.json"))
    assert set(got) == set(_trace_ids(len(prompts)))
    assert got == ref
    for names in got.values():
        assert names[0] == ("b", "req/arrive") and names[-1] == ("e", "req/finish")
        assert ("n", "req/first_token") in names

    merged = jtr.merge_traces(trace_dir=str(port_file.parent))  # the JAX `trace merge`
    jtr.validate_chrome_trace(merged)
    assert merged["metadata"]["request_flows"] == {
        "trace_ids": len(prompts), "cross_process": 0, "orphan_flows": 0}
    names = {e["name"] for e in merged["traceEvents"]}
    assert {"serve/schedule", "serve/prefill", "serve/decode", "serve/flight",
            "serve/iteration"} <= names


def test_telemetry_rows_are_read_by_the_jax_readers(weights, tmp_path):
    reg = treg.MetricsRegistry()
    treg.set_active_registry(reg)
    recorder = ttel.TelemetryRecorder(logging_dir=str(tmp_path))
    ttel.set_active_recorder(recorder)
    try:
        engine = tserving.InferenceEngine(
            weights[1], tserving.EngineConfig(**GEOMETRY, stats_interval=2), device="cpu")
        for i in range(3):
            engine.add_request([1 + i, 2, 3], 4, tenant="acme")
        engine.run_until_idle(max_iterations=500)
        recorder.record_capture("decode", 0.25, launches_captured=32)
    finally:
        ttel.set_active_recorder(None)
        treg.set_active_registry(None)
        recorder.close()
    path = tmp_path / "telemetry" / "telemetry.jsonl"
    assert jtel.telemetry_segments(str(path)) == [str(path)]
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert all(jtel.schema_compatible(r) for r in rows)
    requests = [r for r in rows if r.get("kind") == "request"]
    steps = [r for r in rows if r.get("kind") == "step"]
    compiles = [r for r in rows if r["type"] == "compile"]
    assert len(requests) == 3 and all(r["tenant"] == "acme" and r["new_tokens"] == 4
                                      for r in requests)
    assert steps and steps[-1]["completed_total"] <= 3 and "usage" in steps[-1]
    assert compiles == [{**compiles[0], "label": "decode", "total_s": 0.25, "recompiles": 1}]
    # the rows fed the live registry through the shared mapping
    families = jom.parse_openmetrics(tom.render_openmetrics(reg))
    assert jom.sample_value(families, "accelerate_serving_requests",
                            finish_reason="length") == 3
    assert jom.sample_value(families, "accelerate_compiles") == 1
    # and the JAX package's mapping takes them the same way
    jr = jreg.MetricsRegistry(gate_main_process=False)
    for row in rows:
        jingest.observe_record(jr, row)
    assert jom.sample_value(jom.parse_openmetrics(jom.render_openmetrics(jr)),
                            "accelerate_serving_requests", finish_reason="length") == 3


def test_the_jsonl_trail_rotates(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_TELEMETRY_MAX_BYTES", "300")
    monkeypatch.setenv("ACCELERATE_TELEMETRY_KEEP_SEGMENTS", "2")
    recorder = ttel.TelemetryRecorder(logging_dir=str(tmp_path))
    for i in range(12):
        recorder.record_event("tick", i=i, pad="x" * 40)
    recorder.close()
    recorder.close()  # idempotent
    path = str(tmp_path / "telemetry" / "telemetry.jsonl")
    segments = jtel.telemetry_segments(path)
    assert segments[-1] == path and f"{path}.1" in segments and f"{path}.3" not in segments
    kept = [json.loads(line)["i"] for seg in segments for line in open(seg)]
    assert kept == sorted(kept) and kept[-1] == 11


def test_trace_id_contract():
    tid = ttr.new_trace_id()
    assert ttr.valid_trace_id(tid) and len(tid) == 16
    assert ttr.ensure_trace_id("client-supplied_1.a:b") == "client-supplied_1.a:b"
    # malformed / unsafe ids are REPLACED, never rejected
    for bad in (None, 7, "", "a b", "x" * 65, 'quo"te', "new\nline"):
        out = ttr.ensure_trace_id(bad)
        assert out != bad and ttr.valid_trace_id(out)
        assert jtr.valid_trace_id(out)
    for good in ("0af7651916cd43dd", "x" * 64, "a.b:c-d_e"):
        assert ttr.valid_trace_id(good) == jtr.valid_trace_id(good) is True
