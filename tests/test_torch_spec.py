"""The port's speculative decoding (``serving/spec.py``, ``generation.
spec_accept_tokens``, ``serving/sampling.rejection_accept``, the early-exit
draft of ``models/llama.py`` and the engine's two spec programs) held
against the JAX package on the same ``params_from_jax`` weights.

* The draft-spec parser and the engine's refusals give JAX's results and
  messages, word for word.
* ``spec_accept_tokens`` and ``rejection_accept``'s accepted lengths equal
  JAX's for the same drafts, ``p``, ``q`` and uniforms; the first token a
  sampled slot emits follows the target's distribution by a chi-square test
  (p > 1e-3) over 20,000 seeds.
* The greedy spec engine is token-identical to the JAX spec engine and to
  the port's plain engine at f32 and int8 KV and ``spec_k`` 1-4, and through
  eos, a radix hit, swap preemption and a deadline.
* A round's pool rows: the draft writes in place into the first N layers
  (JAX drafts into a copy it drops); after the verify the rows the round
  owns are byte-identical to the port replaying JAX's scheme (the draft on a
  scratch copy of the pools) and within 1e-5 of the JAX engine's pools (f32
  KV; at int8, within one quantization step of the row: the two frameworks'
  f32 K/V may round to neighbouring codes).
* ``serve``'s flags and their environment defaults; a bad spec combination
  is a startup refusal.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu import generation as jgen  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.serving import sampling as jsampling  # noqa: E402
from accelerate_tpu.serving import spec as jspec  # noqa: E402
from accelerate_tpu_torch import generation as tgen  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.serving import sampling as tsampling  # noqa: E402
from accelerate_tpu_torch.serving import spec as tspec  # noqa: E402

torch.set_num_threads(1)

VOCAB = 64
GEOMETRY = dict(num_slots=3, block_size=8, max_seq_len=64, prefill_chunk=8, decode_burst=4)
#: the JAX engine without what would only slow the CPU run: one synchronous
#: loop, no flight ring, no usage ledger
JAX_EXTRAS = dict(async_dispatch=False, flight_history=0, usage_accounting=False)
DRAFT = "early_exit:1"


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=96),
        num_key_value_heads=2,
    )
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg))
    return jmodel, tmodel


def _port(tmodel, **kw):
    return tserving.InferenceEngine(tmodel, tserving.EngineConfig(**{**GEOMETRY, **kw}),
                                    device="cpu")


def _jax(jmodel, **kw):
    return jserving.InferenceEngine(
        jmodel, jserving.EngineConfig(**{**GEOMETRY, **JAX_EXTRAS, **kw}))


def _spec(spec_k):
    return dict(spec_k=spec_k, draft=DRAFT) if spec_k else {}


def _prompts(seed=0, sizes=(5, 11, 17, 3, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).tolist() for n in sizes]


def _tokens(reqs):
    return [(list(r.output_tokens), r.finish_reason) for r in reqs]


# ---------------------------------------------------------------------------
# parser, refusals, acceptance math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft,num_layers", [
    ("early_exit:2", 16), (" early_exit:1 ", 2), ("early_exit:0", 2), ("early_exit:2", 2),
    ("early_exit:x", 2), ("", 2), ("mystery", 2), ("ckpts/draft.safetensors", 2),
])
def test_parse_draft_spec_matches_jax(draft, num_layers):
    try:
        ref = jspec.parse_draft_spec(draft, num_layers)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tspec.parse_draft_spec(draft, num_layers)
        assert str(got.value) == str(e)
        return
    got = tspec.parse_draft_spec(draft, num_layers)
    assert (got.kind, got.layers, str(got)) == (ref.kind, ref.layers, str(ref))


def test_engine_refusals_match_jax_word_for_word(weights):
    jmodel, tmodel = weights
    bad = [
        dict(spec_k=-1),
        dict(spec_k=2, draft=DRAFT, do_sample=True, per_slot_sampling=False),
        dict(spec_k=2, draft=DRAFT, logprobs_topn=2),
        dict(spec_k=2, draft="early_exit:2"),
        dict(spec_k=2, draft="mystery"),
    ]
    for kw in bad:
        with pytest.raises(ValueError) as ref:
            _jax(jmodel, **kw)
        with pytest.raises(ValueError) as got:
            _port(tmodel, **kw)
        assert str(got.value) == str(ref.value), kw

    class NoDraft(tllama.LlamaForCausalLM):
        early_exit_apply = None

    plain = NoDraft(tmodel.config, device="cpu")
    with pytest.raises(ValueError) as got:
        _port(plain, spec_k=2, draft=DRAFT)
    assert str(got.value) == (
        "model 'NoDraft' declares no early_exit_apply factory: the spec_k engine needs "
        "the early-exit draft path (models/llama.py llama_early_exit_apply)")
    with pytest.raises(ValueError, match=r"early-exit draft needs 1 <= layers < 2"):
        tmodel.early_exit_apply(2)


def test_spec_accept_tokens_matches_jax():
    rng = np.random.default_rng(3)
    for k in (1, 2, 4, 6):
        d = rng.integers(0, 5, size=(64, k)).astype(np.int32)
        preds = rng.integers(0, 5, size=(64, k + 1)).astype(np.int32)
        agree = rng.random((64, k)) < 0.7  # long agreeing prefixes too
        preds[:, :k] = np.where(agree, d, preds[:, :k])
        ja, js = jgen.spec_accept_tokens(jnp.asarray(d), jnp.asarray(preds))
        ta, ts = tgen.spec_accept_tokens(torch.from_numpy(d), torch.from_numpy(preds))
        assert ta.dtype == ts.dtype == torch.int32
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _dists(rng, k, slots, vocab):
    """Random p [k+1, S, V] and q [k, S, V] with zeros (filtered tokens)."""
    def draw(*shape):
        x = rng.random(shape) * (rng.random(shape) < 0.7)
        x[..., 0] += 1e-3  # never an all-zero row
        return (x / x.sum(-1, keepdims=True)).astype(np.float32)
    return draw(k + 1, slots, vocab), draw(k, slots, vocab)


def test_rejection_accept_counts_match_jax():
    """The same drafts, p, q and accept uniforms give the same accepted
    lengths and accepted prefixes; the resampled token differs only by the
    random stream (JAX threefry, the port's counter hash) and always lies in
    the residual's support."""
    rng = np.random.default_rng(5)
    k, slots, vocab = 3, 256, 7
    p, q = _dists(rng, k, slots, vocab)
    d = np.stack([[rng.choice(vocab, p=q[j, s] / q[j, s].sum()) for j in range(k)]
                  for s in range(slots)]).astype(np.int32)
    u = rng.random((slots, k)).astype(np.float32)
    seed = np.arange(slots, dtype=np.int32)
    pos = np.full((slots,), 5, np.int32)
    ja, js = jsampling.rejection_accept(jnp.asarray(d), jnp.asarray(p), jnp.asarray(q),
                                        jnp.asarray(u), jax.random.PRNGKey(0),
                                        jnp.asarray(seed), jnp.asarray(pos))
    ta, ts = tsampling.rejection_accept(*(torch.from_numpy(x) for x in (d, p, q, u)), 0,
                                        torch.from_numpy(seed), torch.from_numpy(pos))
    ja, js, ta, ts = np.asarray(ja), np.asarray(js), ta.numpy(), ts.numpy()
    np.testing.assert_array_equal(ta, ja)
    assert 0 < (ta == k).sum() < slots and (ta == 0).sum() > 0  # every branch taken
    for s in range(slots):
        a = ta[s]
        np.testing.assert_array_equal(ts[s, :a], d[s, :a])
        assert (ts[s, a + 1:] == 0).all()
        support = p[a, s] if a == k else np.clip(p[a, s] - q[min(a, k - 1), s], 0, None)
        if support.sum() <= 0:
            support = p[a, s]
        assert support[ts[s, a]] > 0


def test_spec_sampled_tokens_follow_the_target_distribution():
    """One position drafted from q (the port's inverse-CDF pick under
    TAG_DRAFT), accepted or resampled by ``rejection_accept``: over 20,000
    seeds the emitted token's counts match p by a chi-square test."""
    from scipy.stats import chisquare

    rng = np.random.default_rng(8)
    n, vocab = 20000, 6
    p0 = rng.random(vocab).astype(np.float32)
    p0[2] = 0.0  # a filtered token
    p0 /= p0.sum()
    q0 = rng.random(vocab).astype(np.float32)
    q0 /= q0.sum()
    seed = torch.arange(n, dtype=torch.int32)
    pos = torch.zeros(n, dtype=torch.int32)
    p = torch.from_numpy(np.stack([p0, rng.random(vocab).astype(np.float32)]))[:, None, :]
    p = (p / p.sum(-1, keepdim=True)).expand(2, n, vocab)
    q = torch.from_numpy(q0)[None, None, :].expand(1, n, vocab)
    u_draft = tsampling.slot_uniforms(0, tsampling.TAG_DRAFT, seed, pos)
    d = tsampling.inverse_cdf_pick(torch.log(q[0]), u_draft)[:, None]
    u = tsampling.slot_uniforms(0, tsampling.TAG_ACCEPT, seed, pos)[:, None]
    _, tok_seq = tsampling.rejection_accept(d, p.contiguous(), q.contiguous(), u, 0, seed, pos)
    counts = np.bincount(tok_seq[:, 0].numpy(), minlength=vocab)
    assert counts[2] == 0
    kept = p0 > 0
    expected = p0[kept].astype(np.float64)
    assert chisquare(counts[kept], expected / expected.sum() * counts.sum()).pvalue > 1e-3


# ---------------------------------------------------------------------------
# the engine: greedy parity with JAX's spec engine and the port's plain one
# ---------------------------------------------------------------------------


def _trace(engine, prompts, budgets, **kw):
    reqs = [engine.add_request(p, b, **kw) for p, b in zip(prompts, budgets)]
    engine.run_until_idle(max_iterations=5000)
    return reqs


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_greedy_spec_engine_token_identical_to_jax_and_plain(weights, kv_dtype):
    """A mixed-length trace (prompts past one prefill chunk, budgets that
    end mid-round) through the JAX spec engine, the port's spec engine at
    spec_k 1-4 (async) and the port's plain engine."""
    jmodel, tmodel = weights
    prompts = _prompts(0)
    budgets = [3 + 4 * i for i in range(5)]
    plain = _tokens(_trace(_port(tmodel, kv_dtype=kv_dtype), prompts, budgets))
    for spec_k in (1, 2, 3, 4):
        teng = _port(tmodel, kv_dtype=kv_dtype, **_spec(spec_k))
        got = _tokens(_trace(teng, prompts, budgets))
        ref = _tokens(_trace(_jax(jmodel, kv_dtype=kv_dtype, per_slot_sampling=False,
                                  **_spec(spec_k)), prompts, budgets))
        assert got == ref == plain, spec_k
        st = teng.stats()
        assert st["spec_k"] == spec_k and st["spec_draft"] == DRAFT
        assert st["spec_drafted_tokens"] > 0 and 0.0 <= st["spec_accept_rate"] <= 1.0
        assert st["cuda_graphs"]["spec_decode"]["runs"] > 0 and "decode" not in st["cuda_graphs"]
        assert st["allocated_blocks"] == 0  # rollback never leaked a block


def _run_eos(engine, eos_prompt):
    return [engine.add_request(eos_prompt, 8)]


SCENARIOS = {
    # (geometry, how to drive an engine)
    "radix_hit": dict(prefix_cache=True),
    "swap": dict(num_slots=2, prefix_cache=False, num_blocks=6, swap_gb=0.01),
    "deadline": {},
    "eos": {},
}


def _drive(name, engine, eos=None):
    if name == "radix_hit":
        base = [i % 60 for i in range(20)]
        r1 = _trace(engine, [base], [6])
        return r1 + _trace(engine, [base[:19] + [61]], [6])  # a two-block hit
    if name == "swap":
        return _trace(engine, [list(range(8)), list(range(1, 9))], [30, 30])
    if name == "deadline":
        doomed = engine.add_request([5, 6, 7], 8, deadline_ms=0.001)
        return [doomed] + _trace(engine, _prompts(3, sizes=(5, 9)), [6, 6])
    return _trace(engine, [_prompts(3, sizes=(9,))[0]], [8])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_spec_scenarios_token_identical_to_jax_and_plain(weights, name):
    jmodel, tmodel = weights
    kw = dict(SCENARIOS[name])
    if name == "eos":  # a token the run emits mid-round, and not before
        probe = _tokens(_drive(name, _port(tmodel)))[0][0]
        first = next(i for i in range(2, len(probe)) if probe[i] not in probe[:i])
        kw["eos_token_id"] = probe[first]
    plain = _tokens(_drive(name, _port(tmodel, **kw)))
    teng = _port(tmodel, **kw, **_spec(4))
    got = _tokens(_drive(name, teng))
    ref = _tokens(_drive(name, _jax(jmodel, **kw, per_slot_sampling=False, **_spec(4))))
    assert got == ref == plain
    st = teng.stats()
    if name == "radix_hit":
        assert st["prefix_hit_tokens"] > 0
    elif name == "swap":
        assert [r for _, r in got] == ["length", "length"]
        assert st["preemptions"] >= 1
        assert st["swapped_out_blocks"] == st["swapped_in_blocks"] > 0
    elif name == "deadline":
        assert got[0][1] == "deadline_exceeded" and st["deadline_expired_total"] == 1
    else:
        assert got[0][1] == "eos" and len(got[0][0]) == first + 1


def test_lane_spec_greedy_and_grammar_match_jax(weights):
    """Greedy requests through the lane spec program (a repetition penalty,
    a grammar) give the JAX lane spec engine's tokens; a plain greedy
    request in the same batch gives the plain engine's."""
    jmodel, tmodel = weights
    prompts = _prompts(6, sizes=(7, 4, 12))
    regex = {"type": "regex", "pattern": "[0-3][0-3]9"}  # ids under VOCAB
    opts = [{}, {"sampling": {"repetition_penalty": 1.5}}, {"grammar": regex}]

    def run(engine):
        reqs = [engine.add_request(p, 9, **o) for p, o in zip(prompts, opts)]
        engine.run_until_idle(max_iterations=5000)
        return reqs

    teng = _port(tmodel, **_spec(3))
    got = _tokens(run(teng))
    assert got == _tokens(run(_jax(jmodel, **_spec(3))))
    assert got[0] == _tokens(_trace(_port(tmodel), prompts[:1], [9]))[0]
    assert bytes(got[2][0]).decode()[-1] == "9" and got[2][1] == "stop"
    st = teng.stats()
    assert st["cuda_graphs"]["lane_spec_decode"]["runs"] > 0
    assert st["rejection_drafted_tokens"] == 0  # no sampled slot


def test_spec_sampled_reproduce_across_admission_orders(weights):
    """Sampled slots verify by rejection sampling; every draw hashes (seed,
    position), so a seeded request's tokens do not depend on its batch."""
    _, tmodel = weights
    prompts = _prompts(9, sizes=(6, 10, 4))
    sampling = [{"do_sample": True, "temperature": 0.9, "seed": 21 + i} for i in range(3)]

    def run(order, **kw):
        engine = _port(tmodel, **_spec(3), **kw)
        reqs = {i: engine.add_request(prompts[i], 12, sampling=sampling[i]) for i in order}
        engine.run_until_idle(max_iterations=5000)
        return [list(reqs[i].output_tokens) for i in sorted(reqs)], engine.stats()

    first, st = run([0, 1, 2])
    assert run([2, 1, 0])[0] == first
    assert run([1, 2, 0], num_slots=1, async_dispatch=False)[0] == first
    assert st["rejection_drafted_tokens"] > 0 and all(len(t) == 12 for t in first)


# ---------------------------------------------------------------------------
# pool rows of a round
# ---------------------------------------------------------------------------


def _owned_rows(pages, req, block_size, upto):
    """``{pool name: [layers, upto, n_kv, hd]}`` of the request's positions
    ``0 .. upto-1``."""
    pos = np.arange(upto)
    blocks = np.asarray(req.blocks)[pos // block_size]
    return {name: np.asarray(pool)[:, blocks, pos % block_size] for name, pool in pages.items()}


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_spec_round_pool_rows_match_jax(weights, kv_dtype):
    """Two requests, synchronous engines, stopped after the same iteration
    with a round just harvested. The rows each request owns (every position
    below its context length, all layers) after the port's in-place draft
    and verify are byte-identical to a port replay of JAX's scheme for the
    last round (draft on a scratch copy of the pools, verify into the real
    ones) and within 1e-5 of the JAX engine's pools (one quantization step
    at int8)."""
    jmodel, tmodel = weights
    prompts = _prompts(4, sizes=(9, 14))
    kw = dict(kv_dtype=kv_dtype, **_spec(3))
    teng = _port(tmodel, async_dispatch=False, **kw)
    jeng = _jax(jmodel, per_slot_sampling=False, **kw)
    treqs = [teng.add_request(p, 20) for p in prompts]
    jreqs = [jeng.add_request(p, 20) for p in prompts]
    for _ in range(3):  # both prompts prefilled and decoding
        teng.step()
        jeng.step()
    assert all(r.state is tserving.RequestState.DECODE for r in treqs)

    # the next round by hand, twice: JAX's scheme (draft on a copy) and the
    # engine's own in-place program, from the same pools
    before = {name: pool.clone() for name, pool in teng._pages.items()}
    teng.step()
    in_place = {name: pool.clone() for name, pool in teng._pages.items()}
    for name, pool in teng._pages.items():
        pool.copy_(before[name])
    real = teng._pages
    teng._pages = {name: pool.clone() for name, pool in before.items()}  # the draft's scratch
    ops = teng._decode_ops.views

    def greedy(_t, logits):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    k = teng.config.spec_k
    toks, pos0, active = ops["toks"], ops["pos0"], ops["active"]
    tok, pos, drafts = toks, pos0, []
    for _ in range(k):
        step = teng._draft_step(tok, teng._pages, ops["tables"], pos, paged_write_mask=active)
        drafts.append(greedy(None, step.logits[:, -1, :]))
        tok, pos = drafts[-1][:, None], pos + 1
    teng._pages = real
    teng.model.paged_step(torch.cat([toks, torch.stack(drafts, 1)], 1), real, ops["tables"],
                          pos0, paged_write_mask=active.expand(-1, k + 1))
    jeng.step()
    assert _tokens(treqs) == _tokens(jreqs)
    bs = GEOMETRY["block_size"]
    jpages = {"k": jeng._kp, "v": jeng._vp}
    if kv_dtype == "int8":
        jpages.update(k_scale=jeng._ks, v_scale=jeng._vs)
    for t, j in zip(treqs, jreqs):
        upto = t.context_len
        assert upto == j.context_len and upto > len(t.prompt)
        got = _owned_rows({n: p.numpy() for n, p in in_place.items()}, t, bs, upto)
        scheme = _owned_rows({n: p.numpy() for n, p in real.items()}, t, bs, upto)
        ref = _owned_rows(jpages, j, bs, upto)
        for name in got:
            assert got[name].tobytes() == scheme[name].tobytes(), name
        for name in "kv":
            if kv_dtype == "int8":
                # the two frameworks' f32 K/V may round to neighbouring
                # int8 codes: within one quantization step of the row
                scale = np.maximum(got[f"{name}_scale"], ref[f"{name}_scale"])[..., None]
                diff = np.abs(got[name].astype(np.float32) * got[f"{name}_scale"][..., None]
                              - ref[name].astype(np.float32) * ref[f"{name}_scale"][..., None])
                assert (diff <= scale * 1.01 + 1e-6).all(), name
            else:
                np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# serve: the flags, their environment defaults, the startup refusal
# ---------------------------------------------------------------------------


def test_serve_spec_swap_usage_flags_and_env_reach_the_engine(monkeypatch, capsys):
    """``--spec-k``/``--draft``/``--swap-gb``/``--usage-accounting`` and
    their environment defaults (JAX's names) reach ``EngineConfig``; a bad
    spec combination is a startup refusal: an error row and exit 2."""
    import json

    from accelerate_tpu_torch.commands import serve
    from accelerate_tpu_torch.commands.accelerate_cli import build_parser

    def parse(*argv):
        return build_parser().parse_args(["serve", "--device", "cpu", "--max-seq-len", "64",
                                          *argv])

    for name in ("ACCELERATE_SERVE_SPEC_K", "ACCELERATE_SERVE_DRAFT",
                 "ACCELERATE_SERVE_SWAP_GB", "ACCELERATE_SERVE_USAGE"):
        monkeypatch.delenv(name, raising=False)
    args = parse()
    assert (args.spec_k, args.draft, args.swap_gb, args.usage_accounting) == (
        0, "early_exit:2", 0.0, True)
    monkeypatch.setenv("ACCELERATE_SERVE_SPEC_K", "3")
    monkeypatch.setenv("ACCELERATE_SERVE_DRAFT", "early_exit:1")
    monkeypatch.setenv("ACCELERATE_SERVE_SWAP_GB", "0.25")
    monkeypatch.setenv("ACCELERATE_SERVE_USAGE", "0")
    args = parse()
    assert (args.spec_k, args.draft, args.swap_gb, args.usage_accounting) == (
        3, "early_exit:1", 0.25, False)
    engine = serve._make_engine(args)
    cfg = engine.config
    assert (cfg.spec_k, cfg.draft, cfg.swap_gb, cfg.usage_accounting) == (
        3, "early_exit:1", 0.25, False)
    assert engine.usage is None and engine._swap is not None
    assert parse("--usage-accounting").usage_accounting is True
    monkeypatch.setenv("ACCELERATE_SERVE_SPEC_K", "lots")  # malformed: warned, default
    assert parse().spec_k == 0

    capsys.readouterr()
    assert serve.serve_command(parse("--spec-k", "2", "--logprobs-topn", "1")) == 2
    out = capsys.readouterr()
    row = json.loads(out.out.splitlines()[0])
    assert "logprobs_topn with spec_k > 0 is not supported" in row["error"]
    assert "refusing to start" in out.err
