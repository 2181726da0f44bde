"""The port's per-slot sampling lanes, grammars, logprobs and radix prefix
cache on the graph engine, held against the JAX engine on the same
``params_from_jax`` weights (f32 and int8 KV).

* One mixed batch through both engines with the lanes on: plain greedy,
  greedy through the lanes (``logprobs=1``), repetition penalty,
  ``min_tokens`` over an eos, a stop sequence (trimmed), a regex and a
  JSON-schema grammar (greedy, so deterministic) and top-3 logprobs. Tokens
  and finish reasons are identical; logprobs agree within 1e-4 with equal
  top ids.
* The prefix cache against the JAX engine with ``prefix_cache=True``:
  partial-block hits (copy-on-write) and eviction under a small
  ``num_blocks``; identical tokens, hit tokens and ``radix_*`` counters, and
  the same tokens with the cache off.
* Inside the port: sampled requests reproduce their tokens across
  admission orders and batch companions; the plain-or-lane choice made
  each dispatch never changes a greedy token; grammar rows are refcounted,
  cached and refused as the JAX engine's are; ``serve``'s loop holds back a
  stop sequence's worth of streamed tokens.
"""

import dataclasses
import inspect
import json
import queue
import re
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.serving.grammar import validate_instance  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

torch.set_num_threads(1)

VOCAB = 128  # a byte vocabulary that spells digits, letters, quotes and braces
GEOMETRY = dict(num_slots=4, block_size=8, max_seq_len=96, prefill_chunk=8, decode_burst=4)
#: the JAX engine without what the port does not carry (or what would only
#: slow the CPU run): one synchronous loop, no flight ring, no usage ledger
JAX_EXTRAS = dict(async_dispatch=False, flight_history=0, usage_accounting=False)
REGEX = {"type": "regex", "pattern": "[a-f][a-f][a-f]x"}  # no {n} counts in the grammar
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


def _prompts(n=6, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(k)).tolist()
            for k in rng.integers(3, 20, size=n)]


def _port(tmodel, **kw):
    return tserving.InferenceEngine(tmodel, tserving.EngineConfig(**{**GEOMETRY, **kw}),
                                    device="cpu")


def _jax(jmodel, **kw):
    return jserving.InferenceEngine(
        jmodel, jserving.EngineConfig(**{**GEOMETRY, **JAX_EXTRAS, **kw}))


def _greedy(tmodel, prompts, budget):
    engine = _port(tmodel)
    reqs = [engine.add_request(p, budget) for p in prompts]
    engine.run_until_idle(max_iterations=2000)
    return [list(r.output_tokens) for r in reqs]


def _mixed_batch(greedy):
    """(prompt index, budget, add_request options) of the parity batch, and
    the eos id: a token the first prompt's greedy run emits at index 3-5
    that the third prompt's first 8 tokens do not contain and the grammars
    do not spell."""
    spelt = set(b"abcdefx" + json.dumps({"ok": False}).encode() + b"true")
    eos = next(t for t in greedy[0][3:6] if t not in greedy[2][:8] and t not in spelt)
    first = greedy[0].index(eos)
    stop = greedy[2][2:4]
    batch = [
        (0, 10, {}),                                              # plain greedy: ends at eos
        (1, 9, {"logprobs": 1}),                                  # greedy through the lanes
        (1, 9, {"sampling": {"repetition_penalty": 1.5}}),
        (0, 10, {"sampling": {"min_tokens": first + 3}}),         # eos suppressed at first
        (2, 10, {"sampling": {"stop": [stop]}}),                  # trimmed at the stop
        (3, 8, {"grammar": REGEX}),
        (4, 16, {"grammar": {"type": "json_schema", "schema": SCHEMA}}),
        (5, 7, {"logprobs": 3}),
    ]
    return eos, first, batch


def _submit(engine, prompts, batch):
    reqs = []
    for i, budget, kw in batch:
        kw = dict(kw)
        if "logprobs" in kw:  # the JAX engine takes logprobs inside sampling
            kw["sampling"] = {**kw.get("sampling", {}), "logprobs": kw.pop("logprobs")}
        reqs.append(engine.add_request(prompts[i], budget, **kw))
    return reqs


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_lane_requests_token_identical_to_jax(weights, kv_dtype):
    jmodel, tmodel = weights
    prompts = _prompts()
    greedy = _greedy(tmodel, prompts[:3], 10)
    eos, first, batch = _mixed_batch(greedy)
    kw = dict(kv_dtype=kv_dtype, eos_token_id=eos, logprobs_topn=3, prefix_cache=False)
    jeng, teng = _jax(jmodel, **kw), _port(tmodel, **kw)
    jreqs, treqs = _submit(jeng, prompts, batch), _submit(teng, prompts, batch)
    jeng.run_until_idle(max_iterations=2000)
    teng.run_until_idle(max_iterations=2000)
    for (i, _, opts), j, t in zip(batch, jreqs, treqs):
        assert (t.output_tokens, t.finish_reason) == (j.output_tokens, j.finish_reason), opts
        assert (t.logprobs is None) == (j.logprobs is None)
        for te, je in zip(t.logprobs or (), j.logprobs or ()):
            assert te["token"] == je["token"]
            assert abs(te["logprob"] - je["logprob"]) <= 1e-4
            assert [i for i, _ in te["top"]] == [i for i, _ in je["top"]]
            np.testing.assert_allclose([v for _, v in te["top"]], [v for _, v in je["top"]],
                                       rtol=0, atol=1e-4)
    by = dict(zip(range(len(batch)), treqs))
    # the scenario is what it claims
    assert by[0].finish_reason == "eos" and len(by[0].output_tokens) == first + 1
    assert len(by[3].output_tokens) >= first + 3 and eos not in by[3].output_tokens[:first + 3]
    assert by[4].finish_reason == "stop" and by[4].output_tokens == greedy[2][:2]
    assert by[5].finish_reason == "stop"
    assert re.fullmatch(REGEX["pattern"], bytes(by[5].output_tokens).decode())
    assert by[6].finish_reason == "stop"
    assert validate_instance(SCHEMA, json.loads(bytes(by[6].output_tokens).decode())) is None
    assert len(by[7].logprobs) == len(by[7].output_tokens) and len(by[7].logprobs[0]["top"]) == 3
    stats = teng.stats()
    assert stats["cuda_graphs"]["lane_decode"]["runs"] > 0
    assert stats["grammar_rows_live"] == 0 and stats["grammar_masked_steps"] > 0
    assert stats["lane_decode_compiles"] == stats["decode_compiles"] == 0  # no capture on the CPU


def _shared_prefix_prompts(seed):
    """A 20-id shared stem (two full blocks and half a block) with distinct
    tails; some tails share their first ids so hits end inside a block."""
    rng = np.random.default_rng(seed)
    stem = rng.integers(0, VOCAB, size=20).tolist()
    tails = [rng.integers(0, VOCAB, size=int(n)).tolist() for n in (3, 9, 5, 12, 2, 7)]
    tails[2][:2] = tails[1][:2]
    return [stem + t for t in tails] + [rng.integers(0, VOCAB, size=14).tolist()]


def _drive_staged(engine, prompts, budgets):
    """The first request alone until it is decoding (its prompt then sits in
    the cache), the rest after, two at a time."""
    reqs = [engine.add_request(prompts[0], budgets[0])]
    while not reqs[0].output_tokens:
        engine.step()
    for k in range(1, len(prompts), 2):
        reqs += [engine.add_request(p, b) for p, b in zip(prompts[k:k + 2], budgets[k:k + 2])]
        engine.step()
    engine.run_until_idle(max_iterations=4000)
    return reqs


RADIX_KEYS = ("prefix_hit_tokens", "cached_blocks", "radix_inserted_blocks",
              "radix_evicted_blocks")


@pytest.mark.parametrize("num_blocks", [None, 10])
def test_prefix_cache_matches_jax_with_cow_and_eviction(weights, num_blocks):
    """Full residency, and a pool of 9 usable blocks that forces the cache
    to evict. Both engines synchronous, so they schedule alike and their
    counters can be compared; at full residency the port's async engine and
    its engine without the cache give the same tokens."""
    jmodel, tmodel = weights
    prompts = _shared_prefix_prompts(2)
    budgets = [6, 5, 8, 4, 7, 5, 6]
    kw = dict(num_blocks=num_blocks, prefix_cache=True)
    jeng = _jax(jmodel, **kw, per_slot_sampling=False)
    teng = _port(tmodel, **kw, async_dispatch=False)
    jreqs, treqs = _drive_staged(jeng, prompts, budgets), _drive_staged(teng, prompts, budgets)
    tokens = [(list(r.output_tokens), r.finish_reason) for r in jreqs]
    assert [(list(r.output_tokens), r.finish_reason) for r in treqs] == tokens
    js, ts = jeng.stats(), teng.stats()
    assert {k: ts[k] for k in RADIX_KEYS} == {k: js[k] for k in RADIX_KEYS}
    assert [r.matched_tokens for r in treqs] == [r.matched_tokens for r in jreqs]
    assert ts["prefix_hit_tokens"] > 0 and ts["cow_copies"] > 0
    # a hit's chunks start at the chunk boundary at or below the match
    c = GEOMETRY["prefill_chunk"]
    assert ts["cuda_graphs"]["prefill"]["runs"] == sum(
        -(-(r.prompt_len - (r.matched_tokens - r.matched_tokens % c)) // c) for r in treqs)
    if num_blocks is not None:
        assert ts["radix_evicted_blocks"] > 0
    assert ts["allocated_blocks"] == 0 and ts["free_blocks"] + ts["cached_blocks"] == (
        teng.allocator.num_blocks - 1)
    if num_blocks is not None:
        return  # under pool pressure, sharing and timing decide who is truncated
    for other in (dict(async_dispatch=True), dict(prefix_cache=False)):
        eng = _port(tmodel, **{**kw, **other})
        assert [(list(r.output_tokens), r.finish_reason)
                for r in _drive_staged(eng, prompts, budgets)] == tokens


SAMPLED = [
    {"do_sample": True, "temperature": 0.9, "top_p": 0.9, "seed": 11},
    {"do_sample": True, "temperature": 1.3, "top_k": 8, "seed": 12},
    {"do_sample": True, "temperature": 0.7, "seed": 13, "repetition_penalty": 1.2},
    {"do_sample": True, "temperature": 1.0, "seed": 14},
]


def test_sampled_seeds_reproduce_across_admission_orders(weights):
    _, tmodel = weights
    prompts = _prompts(4, seed=5)

    def run(order, **kw):
        engine = _port(tmodel, **kw)
        reqs = {i: engine.add_request(prompts[i], 12, sampling=SAMPLED[i]) for i in order}
        engine.run_until_idle(max_iterations=2000)
        return [list(reqs[i].output_tokens) for i in sorted(reqs)]

    first = run([0, 1, 2, 3])
    assert run([3, 2, 1, 0]) == first
    assert run([2, 0, 3, 1], num_slots=2, async_dispatch=False) == first  # other batches
    # each request alone
    assert [run([i], num_slots=1)[0] for i in range(4)] == first
    assert len({tuple(t) for t in first}) == 4
    # a different engine seed draws other tokens; the same seed the same
    assert run([0, 1, 2, 3], seed=1) != first
    # an engine-wide do_sample is the default a request inherits
    engine = _port(tmodel, do_sample=True, temperature=0.9, seed=3)
    a = engine.add_request(prompts[0], 10)
    engine.run_until_idle()
    engine = _port(tmodel, do_sample=True, temperature=0.9, seed=3)
    b = engine.add_request(prompts[0], 10, sampling={"do_sample": True, "temperature": 0.9,
                                                     "seed": 3})
    engine.run_until_idle()
    assert a.output_tokens == b.output_tokens and a.sampling.do_sample


def test_plain_and_lane_graph_choice_keeps_greedy_tokens(weights):
    """Greedy requests give the same tokens whether every dispatch replays
    the plain burst (an all-greedy batch) or the lane burst (a sampled and a
    logprobs companion force it), and the host picks the plain burst again
    once no live request needs the lanes."""
    _, tmodel = weights
    prompts = _prompts(6, seed=7)
    plain = _port(tmodel, logprobs_topn=2)
    greedy = [plain.add_request(p, 9) for p in prompts[:3]]
    plain.run_until_idle()
    graphs = plain.stats()["cuda_graphs"]
    assert graphs["decode"]["runs"] > 0 and graphs["lane_decode"]["runs"] == 0

    mixed = _port(tmodel, logprobs_topn=2)
    companions = [mixed.add_request(prompts[3], 3, sampling=SAMPLED[0]),
                  mixed.add_request(prompts[4], 3, logprobs=2)]
    same = [mixed.add_request(p, 9) for p in prompts[:3]]
    mixed.run_until_idle()
    assert [r.output_tokens for r in same] == [r.output_tokens for r in greedy]
    graphs = mixed.stats()["cuda_graphs"]
    assert graphs["lane_decode"]["runs"] > 0 and graphs["decode"]["runs"] > 0
    assert all(r.finish_reason == "length" for r in companions)
    # the first token of an inert request is the prefill program's own pick
    assert mixed.stats()["first_token_picks"] == 2


def test_grammar_rows_are_refcounted_cached_and_refused(weights):
    _, tmodel = weights
    engine = _port(tmodel, grammar_slots=2)
    regex_b = {"type": "regex", "pattern": "[0-9]{2}"}
    a1 = engine.add_request([1, 2], 6, grammar=REGEX)
    a2 = engine.add_request([3, 4], 6, grammar=REGEX)
    b = engine.add_request([5, 6], 6, grammar=regex_b)
    row = a1.grammar_row
    assert a2.grammar_row == row != b.grammar_row
    with pytest.raises(ValueError, match="grammar rows are held"):
        engine.add_request([7], 6, grammar={"type": "regex", "pattern": "z+"})
    engine.run_until_idle()
    assert engine.stats()["grammar_rows_live"] == 0
    # idle rows stay cached: the same grammar takes its old row back
    again = engine.add_request([1, 2], 6, grammar=REGEX)
    assert again.grammar_row == row
    engine.run_until_idle()
    assert bytes(again.output_tokens).decode()[-1] == "x"
    # an oversize grammar and an engine without the lanes refuse
    with pytest.raises(ValueError, match="grammar_states"):
        engine.add_request([1], 6, grammar={"type": "regex", "pattern": "abcdef" * 12})
    off = _port(tmodel, per_slot_sampling=False)
    with pytest.raises(ValueError, match="per_slot_sampling"):
        off.add_request([1], 4, grammar=REGEX)
    with pytest.raises(ValueError, match="logprobs_topn"):
        engine.add_request([1], 4, logprobs=1)
    with pytest.raises(ValueError, match="per_slot_sampling"):
        _port(tmodel, per_slot_sampling=False, do_sample=True)


def test_lane_config_defaults_match_jax():
    port, ref = tserving.EngineConfig(), jserving.EngineConfig()
    for name in ("per_slot_sampling", "prefix_cache", "logprobs_topn", "grammar_slots",
                 "grammar_states", "rep_window", "swap_gb", "spec_k", "draft",
                 "usage_accounting", "stats_interval", "flight_history"):
        assert getattr(port, name) == getattr(ref, name), name
    # request tracing landed: every add_request option of the JAX engine is ported
    jax_options = inspect.signature(jserving.InferenceEngine.add_request).parameters
    port_options = inspect.signature(tserving.InferenceEngine.add_request).parameters
    assert set(jax_options) <= set(port_options)


def test_serve_loop_streams_with_stop_holdback_and_logprobs(weights):
    """The serve loop answers sampling, grammar and logprobs rows; a
    request with stop sequences streams ``max(len(stop)) - 1`` tokens
    behind, so no streamed chunk carries a token the stop trims."""
    from accelerate_tpu_torch.commands import serve

    _, tmodel = weights
    prompt = _prompts(1, seed=9)[0]
    probe = _greedy(tmodel, [prompt], 10)[0]
    stop = probe[4:7]
    engine = _port(tmodel, logprobs_topn=2)
    inbox, out, chunks = queue.Queue(), [], []
    stop_evt = threading.Event()
    inbox.put(({"id": "s", "prompt": prompt, "max_new_tokens": 10,
                "sampling": {"stop": [stop]}, "_stream": chunks.append}, None))
    inbox.put(({"id": "g", "prompt": [1, 2], "max_new_tokens": 8, "grammar": REGEX,
                "logprobs": 2}, None))
    inbox.put(({"id": "t", "prompt": [1], "trace_id": "0af7651916cd43dd8448eb211c80319c"},
               None))
    stop_evt.set()
    serve._engine_loop(engine, inbox, out.append, stop_evt)
    rows = {r["id"]: r for r in out}
    assert rows["s"]["tokens"] == probe[:4] and rows["s"]["finish_reason"] == "stop"
    streamed = [t for c in chunks for t in c]
    assert streamed == rows["s"]["tokens"][:len(streamed)]  # never a trimmed token
    assert bytes(rows["g"]["tokens"]).decode()[-1] == "x"
    assert len(rows["g"]["logprobs"]) == len(rows["g"]["tokens"])
    assert rows["t"]["trace_id"] == "0af7651916cd43dd8448eb211c80319c"  # request tracing
    # stream() holds back the same way
    engine = _port(tmodel)
    assert list(engine.stream(prompt, 10, sampling={"stop": [stop]})) == probe[:4]
