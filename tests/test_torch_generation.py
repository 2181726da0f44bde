"""The port's ``generate()`` (``accelerate_tpu_torch/generation.py``) and
the llama's dense KV cache, held against the JAX package's on the same
weights and the same numpy inputs.

A tiny llama (2 layers, hidden 64, 4 heads, 64 positions) at f32: the JAX
pytree is carried across by ``params_from_jax``. Greedy tokens must be
JAX's exactly (full-forward, cached, ragged, eos mid-way and across
chunks, zero new tokens, speculative decoding with its exact-fit budget,
a prepared model); prefill logits and caches and a decode step's logits
agree within 1e-5; the errors are JAX's. Sampling cannot reproduce JAX's
bits: the same seed must give the same tokens. On the CPU the programs run
eagerly over their static buffers and nothing is captured.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from accelerate_tpu import generation as jgen  # noqa: E402
from accelerate_tpu import telemetry as jtel  # noqa: E402
from accelerate_tpu.metrics import ingest as jingest  # noqa: E402
from accelerate_tpu.metrics import registry as jreg  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.ops import layers as jlayers  # noqa: E402
from accelerate_tpu_torch import AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch import generation as tgen  # noqa: E402
from accelerate_tpu_torch import telemetry as ttel  # noqa: E402
from accelerate_tpu_torch.metrics import registry as treg  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.ops import layers as tlayers  # noqa: E402

torch.set_num_threads(1)


def _pair(layers=2, seq=64, seed=0):
    """(JAX model, port model) on the same weights."""
    jcfg = jllama.LlamaConfig.tiny(layers=layers, seq=seq)
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=seed)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def spec_models():
    """Target (4 layers), an unrelated draft (2 layers), both packages."""
    jt, tt = _pair(layers=4, seed=1)
    jd, td = _pair(layers=2, seed=9)
    ids = np.random.default_rng(0).integers(1, 250, size=(3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 7:] = 0
    ids[1, 7:] = 0  # ragged right-padded row
    return (jt, tt), (jd, td), ids, mask


class _Callable:
    """A plain callable over the JAX model: JAX's full-forward path."""

    def __init__(self, model):
        self.model = model

    def __call__(self, **kw):
        return self.model.apply_fn(self.model.params, **kw)


def _ids(seed, shape=(2, 6), low=0):
    return np.random.default_rng(seed).integers(low, 256, size=shape).astype(np.int32)


RAGGED = np.asarray([[1] * 6, [1, 1, 1, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("case", ["full_forward", "cached", "ragged_full_forward",
                                  "ragged_cached", "zero_new"])
def test_greedy_tokens_match_jax(models, case):
    jmodel, tmodel = models
    ids = _ids(5)
    kw = dict(max_new_tokens=0 if case == "zero_new" else 5)
    if case.startswith("ragged"):
        kw["attention_mask"] = RAGGED
    cached = case != "full_forward" and case != "ragged_full_forward"
    jout = np.asarray(jgen.generate(jmodel if cached else _Callable(jmodel), ids,
                                    use_cache=cached, **kw))
    tout = tgen.generate(tmodel, ids, use_cache=cached, **kw)
    assert tout.dtype == torch.int32 and tout.device.type == "cpu"
    np.testing.assert_array_equal(tout.numpy(), jout)
    if case == "zero_new":
        np.testing.assert_array_equal(tout.numpy(), ids)


@pytest.mark.parametrize("cached", [False, True])
def test_eos_mid_way_matches_jax(models, cached):
    """The first greedy token of row 0 as eos: generation halts mid-way,
    and finished rows pad with eos to where the last row stopped."""
    jmodel, tmodel = models
    ids = _ids(9)
    eos = int(tgen.generate(tmodel, ids, max_new_tokens=1)[0, 6])
    jout = np.asarray(jgen.generate(jmodel if cached else _Callable(jmodel), ids,
                                    max_new_tokens=8, eos_token_id=eos, use_cache=cached))
    tout = tgen.generate(tmodel, ids, max_new_tokens=8, eos_token_id=eos, use_cache=cached)
    assert tout.shape == jout.shape
    np.testing.assert_array_equal(tout.numpy(), jout)


def test_eos_across_chunks_matches_jax(models, monkeypatch):
    """A chunk of 2 steps between reads of the finished flags: the decode
    loop crosses several chunks and still stops where JAX's does."""
    monkeypatch.setattr(jgen, "_EOS_CHUNK", 2)
    monkeypatch.setattr(tgen, "_EOS_CHUNK", 2)
    jmodel, tmodel = models
    ids = _ids(13)
    eos = int(tgen.generate(tmodel, ids, max_new_tokens=3)[0, 8])  # third token of row 0
    jout = np.asarray(jgen.generate(jmodel, ids, max_new_tokens=9, eos_token_id=eos,
                                    use_cache=True))
    tout = tgen.generate(tmodel, ids, max_new_tokens=9, eos_token_id=eos, use_cache=True)
    np.testing.assert_array_equal(tout.numpy(), jout)
    # eos 0 is not confused with the zero-initialised buffers
    ids = _ids(10, (2, 5), low=1)
    jout = np.asarray(jgen.generate(jmodel, ids, max_new_tokens=6, eos_token_id=0,
                                    use_cache=True))
    np.testing.assert_array_equal(
        tgen.generate(tmodel, ids, max_new_tokens=6, eos_token_id=0, use_cache=True).numpy(),
        jout)


@pytest.mark.parametrize("draft_kind,k", [("draft", 4), ("target", 4), ("draft", 1),
                                          ("target", 8)])
def test_speculative_equals_plain_greedy_and_jax(spec_models, draft_kind, k):
    """Greedy speculative output equals plain greedy for any draft: an
    unrelated one (low acceptance) and the target itself (all accepted),
    and equals JAX's speculative output."""
    (jt, tt), (jd, td), ids, mask = spec_models
    jdraft, tdraft = (jd, td) if draft_kind == "draft" else (jt, tt)
    plain = tgen.generate(tt, ids, max_new_tokens=12, use_cache=True, attention_mask=mask)
    spec = tgen.generate(tt, ids, max_new_tokens=12, draft_model=tdraft, num_draft_tokens=k,
                         attention_mask=mask)
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())
    jspec = np.asarray(jgen.generate(jt, ids, max_new_tokens=12, draft_model=jdraft,
                                     num_draft_tokens=k, attention_mask=mask))
    np.testing.assert_array_equal(spec.numpy(), jspec)


def test_speculative_eos_matches_plain_and_jax(spec_models):
    (jt, tt), (jd, td), ids, mask = spec_models
    probe = tgen.generate(tt, ids, max_new_tokens=12, use_cache=True, attention_mask=mask)
    eos = int(probe[0, -1])
    plain = tgen.generate(tt, ids, max_new_tokens=12, use_cache=True, attention_mask=mask,
                          eos_token_id=eos)
    spec = tgen.generate(tt, ids, max_new_tokens=12, draft_model=td, num_draft_tokens=3,
                         attention_mask=mask, eos_token_id=eos)
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())
    jspec = np.asarray(jgen.generate(jt, ids, max_new_tokens=12, draft_model=jd,
                                     num_draft_tokens=3, attention_mask=mask, eos_token_id=eos))
    np.testing.assert_array_equal(spec.numpy(), jspec)


@pytest.mark.parametrize("k", [3, 5])
def test_speculative_exact_fit_budget_matches_plain(k):
    """prompt + max_new == max_position_embeddings: the caches are clamped
    to the position table (no k+1 margin) and the verify chunks' writes
    past the cache end are dropped, not clamped onto the last slot."""
    jt, tt = _pair(layers=2, seq=24, seed=0)
    jd, td = _pair(layers=1, seq=24, seed=9)
    ids = _ids(0, (2, 8))
    plain = tgen.generate(tt, ids, max_new_tokens=16, use_cache=True)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jgen.generate(jt, ids, max_new_tokens=16, use_cache=True)))
    spec = tgen.generate(tt, ids, max_new_tokens=16, draft_model=td, num_draft_tokens=k)
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())


def test_prepared_model_matches_jax(models):
    """Through ``Accelerator().prepare``: f32 gives JAX's tokens; under a
    bf16 compute dtype the weights are cast once a call into one kept copy,
    which a later call refreshes in place."""
    from accelerate_tpu_torch import Accelerator

    jmodel, tmodel = models
    ids = _ids(6, (1, 5))
    jout = np.asarray(jgen.generate(_Callable(jmodel), ids, max_new_tokens=4))
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        prepared = Accelerator(cpu=True).prepare(tmodel)
        np.testing.assert_array_equal(
            tgen.generate(prepared, ids, max_new_tokens=4, use_cache=True).numpy(), jout)
        spec = tgen.generate(prepared, ids, max_new_tokens=4, draft_model=tmodel,
                             num_draft_tokens=2)
        np.testing.assert_array_equal(spec.numpy(), jout)

        prepared.compute_dtype = torch.bfloat16
        out = tgen.generate(prepared, ids, max_new_tokens=4, use_cache=True)
        assert out.shape == (1, 9)
        weights = prepared.__dict__["_generation_weights"][torch.bfloat16]
        ptrs = {n: w.data_ptr() for n, w in weights.items()}
        assert all(w.dtype == torch.bfloat16 for w in weights.values())
        with torch.no_grad():
            tmodel.norm.mul_(2.0)
        try:
            tgen.generate(prepared, ids, max_new_tokens=4, use_cache=True)
            assert {n: w.data_ptr() for n, w in weights.items()} == ptrs
            assert torch.equal(weights["norm"], tmodel.norm.detach().to(torch.bfloat16))
        finally:
            with torch.no_grad():
                tmodel.norm.div_(2.0)
        tgen.clear_generation_cache(prepared)
        assert "_generation_weights" not in prepared.__dict__
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


def test_errors_match_jax(models, spec_models):
    jmodel, tmodel = models
    long = np.zeros((1, 60), np.int32)
    for cached in (False, True):  # 70 > 64
        with pytest.raises(ValueError, match="max_position_embeddings") as jerr:
            jgen.generate(jmodel if cached else _Callable(jmodel), long, max_new_tokens=10,
                          use_cache=cached)
        with pytest.raises(ValueError, match="max_position_embeddings") as terr:
            tgen.generate(tmodel, long, max_new_tokens=10, use_cache=cached)
        if cached:
            assert str(terr.value) == str(jerr.value)
    (jt, tt), (jd, td), ids, mask = spec_models
    bad = np.ones((ids.shape[0], ids.shape[1] + 3), np.int32)
    cases = [
        (ValueError, dict(max_new_tokens=4, draft_model="d", attention_mask=bad)),
        (ValueError, dict(max_new_tokens=4, use_cache=True, attention_mask=bad)),
        (ValueError, dict(max_new_tokens=4, draft_model="d", num_draft_tokens=0)),
        (ValueError, dict(max_new_tokens=4, draft_model="d", num_draft_tokens=-3)),
        (NotImplementedError, dict(max_new_tokens=4, draft_model="d", do_sample=True)),
    ]
    for exc, kw in cases:
        jkw = dict(kw, draft_model=jd) if "draft_model" in kw else kw
        tkw = dict(kw, draft_model=td) if "draft_model" in kw else kw
        with pytest.raises(exc) as jerr:
            jgen.generate(jt, ids, **jkw)
        with pytest.raises(exc) as terr:
            tgen.generate(tt, ids, **tkw)
        assert str(terr.value) == str(jerr.value)
    jt24, tt24 = _pair(layers=2, seq=24)
    jd24, td24 = _pair(layers=1, seq=24, seed=9)
    with pytest.raises(ValueError, match="max_position_embeddings") as jerr:
        jgen.generate(jt24, np.zeros((1, 8), np.int32), max_new_tokens=17, draft_model=jd24,
                      num_draft_tokens=4)
    with pytest.raises(ValueError, match="max_position_embeddings") as terr:
        tgen.generate(tt24, np.zeros((1, 8), np.int32), max_new_tokens=17, draft_model=td24,
                      num_draft_tokens=4)
    assert str(terr.value) == str(jerr.value)


def test_prefill_and_decode_logits_match_jax(models):
    """Prefill logits and its ``[L, b, max_cache, n_kv, hd]`` caches, then
    one s = 1 decode step and one s = 4 verify chunk against the cache,
    within 1e-5 of JAX at f32 (and the chunk within 1e-5 of the full
    forward's logits at those positions)."""
    jmodel, tmodel = models
    ids = _ids(0, (2, 12))
    mask = np.ones((2, 8), np.int32)
    mask[1, 6:] = 0
    with jax.default_matmul_precision("highest"):
        jpre = jmodel.apply_fn(jmodel.params, input_ids=ids[:, :8], attention_mask=mask,
                               use_cache=True, max_cache_len=12)
        idx = np.asarray([8, 6], np.int32)
        jstep = jmodel.apply_fn(jmodel.params, input_ids=ids[:, 8:9], kv_cache=jpre["kv_cache"],
                                cache_index=idx)
        jchunk = jmodel.apply_fn(jmodel.params, input_ids=ids[:, 9:12],
                                 kv_cache=jstep["kv_cache"], cache_index=idx + 1)
        jfull = jmodel.apply_fn(jmodel.params, input_ids=ids)
    with torch.no_grad():
        tpre = tmodel(input_ids=torch.as_tensor(ids[:, :8]),
                      attention_mask=torch.as_tensor(mask), use_cache=True, max_cache_len=12)
    assert tpre.kv_cache["k"].shape == (2, 2, 12, 4, 16)
    np.testing.assert_allclose(tpre.logits.detach().numpy(), np.asarray(jpre["logits"]),
                               atol=1e-5, rtol=0)
    for n in "kv":
        np.testing.assert_allclose(tpre.kv_cache[n].detach().numpy(),
                                   np.asarray(jpre["kv_cache"][n]), atol=1e-5, rtol=0)
    kv = tpre.kv_cache
    tstep = tmodel.cached_step(torch.as_tensor(ids[:, 8:9]), kv, torch.as_tensor(idx))
    assert tstep.kv_cache is kv  # in place
    np.testing.assert_allclose(tstep.logits.numpy(), np.asarray(jstep["logits"]),
                               atol=1e-5, rtol=0)
    tchunk = tmodel(input_ids=torch.as_tensor(ids[:, 9:12]), kv_cache=kv,
                    cache_index=torch.as_tensor(idx + 1))
    np.testing.assert_allclose(tchunk.logits.numpy(), np.asarray(jchunk["logits"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tchunk.logits[0].numpy(), np.asarray(jfull["logits"])[0, 9:12],
                               atol=1e-5, rtol=0)
    for n in "kv":
        np.testing.assert_allclose(kv[n].numpy(), np.asarray(jchunk["kv_cache"][n]),
                                   atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="max_cache_len 7 must be in") as terr:
        tmodel(input_ids=torch.as_tensor(ids[:, :8]), use_cache=True, max_cache_len=7)
    with pytest.raises(ValueError) as jerr:
        jmodel.apply_fn(jmodel.params, input_ids=ids[:, :8], use_cache=True, max_cache_len=7)
    assert str(terr.value) == str(jerr.value)


def test_write_kv_cache_matches_jax_and_drops_past_the_end():
    """Rows at their own positions; a chunk that runs past the cache end
    keeps its in-range lanes and drops the rest (JAX's ``mode="drop"``),
    including a row whose whole chunk lies past the end."""
    rng = np.random.default_rng(1)
    b, max_cache, s, n_kv, hd = 3, 6, 3, 2, 4
    kc = rng.standard_normal((b, max_cache, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, max_cache, n_kv, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    idx = np.asarray([1, 4, 7], np.int32)
    jk, jv = jlayers.write_kv_cache(*(jax.numpy.asarray(a) for a in (kc, vc, k, v, idx)))
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    out = tlayers.write_kv_cache(tk, tv, torch.as_tensor(k), torch.as_tensor(v),
                                 torch.as_tensor(idx))
    assert out[0] is tk and out[1] is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[2], kc[2])  # wholly past the end: untouched


def test_write_kv_cache_spare_slot_takes_the_dropped_lanes():
    """With ``spare_slot`` (the caches ``generate()`` keeps carry one slot
    past their positions) the live slots equal JAX's drop scatter on a
    cache without it, the dropped lanes land in the spare slot alone, and a
    kept query's attention never reads it."""
    rng = np.random.default_rng(2)
    b, max_cache, s, n_kv, hd = 3, 6, 3, 2, 4
    kc = rng.standard_normal((b, max_cache + 1, n_kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, max_cache + 1, n_kv, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    idx = np.asarray([1, 4, 7], np.int32)
    jk, jv = jlayers.write_kv_cache(*(jax.numpy.asarray(a) for a in
                                      (kc[:, :max_cache], vc[:, :max_cache], k, v, idx)))
    tk, tv = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    tlayers.write_kv_cache(tk, tv, torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(idx),
                           spare_slot=True)
    np.testing.assert_array_equal(tk.numpy()[:, :max_cache], np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy()[:, :max_cache], np.asarray(jv))
    np.testing.assert_array_equal(tk.numpy()[0, max_cache], kc[0, max_cache])  # nothing dropped
    assert k[1, 2].tolist() == tk[1, max_cache].tolist()  # position 6: dropped
    q = torch.as_tensor(rng.standard_normal((b, 1, 2 * n_kv, hd)).astype(np.float32))
    at = torch.as_tensor(np.asarray([0, 3, 5], np.int32))
    np.testing.assert_array_equal(
        tlayers.cached_attention(q, tk, tv, at).numpy(),
        tlayers.cached_attention(q, tk[:, :max_cache], tv[:, :max_cache], at).numpy())
    with pytest.raises(ValueError, match="does not fit a cache of 2"):
        tlayers.write_kv_cache(tk[:, :3], tv[:, :3], torch.as_tensor(k), torch.as_tensor(v),
                               torch.as_tensor(idx), spare_slot=True)


@pytest.mark.parametrize("path", ["cached", "speculative"])
def test_program_is_captured_anew_when_the_weights_move(path):
    """A kept program reads the weights in place, so a call after they
    moved to other storage (here ``load_state_dict(assign=True)``, of the
    target and, speculative, of the draft) builds it anew and gives the new
    weights' tokens; a call with the weights where they were keeps it."""
    _, tmodel = _pair(seed=0)
    _, other = _pair(seed=5)
    _, draft = _pair(layers=1, seed=9)
    ids = _ids(3, (2, 6))
    kw = (dict(use_cache=True) if path == "cached"
          else dict(draft_model=draft, num_draft_tokens=3))

    def run(model):
        out = tgen.generate(model, ids, max_new_tokens=6, **kw)
        (prog,) = model.__dict__["_generation_programs"].values()
        return out, prog

    _, first = run(tmodel)
    assert run(tmodel)[1] is first
    want = tgen.generate(other, ids, max_new_tokens=6, use_cache=True)
    tmodel.load_state_dict({n: t.clone() for n, t in other.state_dict().items()}, assign=True)
    out, second = run(tmodel)
    assert second is not first
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    if path == "speculative":
        draft.load_state_dict({n: t.clone() for n, t in draft.state_dict().items()},
                              assign=True)
        assert run(tmodel)[1] is not second


def test_telemetry_row_matches_jax_and_feeds_the_registry(models, spec_models, tmp_path):
    jmodel, tmodel = models
    jrec = jtel.TelemetryRecorder()
    jrec.record_generation(mode="speculative", new_tokens=4, seconds=0.5, accept_rate=0.5,
                           verify_rounds=2)
    jrow = jrec.records[-1]
    registry = treg.MetricsRegistry(gate_main_process=False)
    prev_reg = treg.get_active_registry()
    treg.set_active_registry(registry)
    rec = ttel.TelemetryRecorder()
    ttel.set_active_recorder(rec)
    try:
        (jt, tt), (jd, td), ids, mask = spec_models
        tgen.generate(tmodel, _ids(1), max_new_tokens=3, use_cache=True)
        tgen.generate(tmodel, _ids(1), max_new_tokens=3)
        tgen.generate(tt, ids, max_new_tokens=4, draft_model=td, num_draft_tokens=2,
                      attention_mask=mask)
    finally:
        ttel.set_active_recorder(None)
        treg.set_active_registry(prev_reg)
    rows = [r for r in rec.records if r["type"] == "generate"]
    assert [r["mode"] for r in rows] == ["kv_cache", "full_forward", "speculative"]
    assert [r["new_tokens"] for r in rows] == [6, 6, 12]
    jkeys = set(jrow) - {"step"}
    assert jkeys <= set(rows[2]), jkeys - set(rows[2])
    assert set(rows[0]) == set(rows[2]) - {"accept_rate", "verify_rounds"}
    assert 0 < rows[2]["accept_rate"] <= 1 and rows[2]["verify_rounds"] >= 1
    # the ingest counters, and JAX's ingest of the same rows
    jregistry = jreg.MetricsRegistry(gate_main_process=False)
    for row in rows:
        jingest.observe_record(jregistry, row)
    for mode in ("kv_cache", "full_forward", "speculative"):
        assert registry.counter("generations").value(mode=mode) == 1
        assert jregistry.counter("generations").value(mode=mode) == 1
    assert registry.counter("generated_tokens").value() == 24
    assert jregistry.counter("generated_tokens").value() == 24


def test_same_seed_gives_the_same_sampled_tokens(models):
    _, tmodel = models
    ids = _ids(11, (2, 5))
    kw = dict(max_new_tokens=5, do_sample=True, temperature=0.8)
    a = tgen.generate(tmodel, ids, seed=3, use_cache=True, **kw)
    b = tgen.generate(tmodel, ids, seed=3, use_cache=True, **kw)
    c = tgen.generate(tmodel, ids, seed=4, use_cache=True, **kw)
    d = tgen.generate(tmodel, ids, seed=3, **kw)  # the full-forward loop draws alike
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(a.numpy(), d.numpy())
    assert a.shape == c.shape and not np.array_equal(a.numpy(), c.numpy())


def test_cpu_captures_nothing_and_keeps_its_static_buffers(models):
    """On the CPU the decode program runs eagerly: no capture, no replay,
    and its static buffers keep their storage across steps and calls. The
    two most recently used keys stay; a third releases the oldest."""
    _, tmodel = models
    tgen.clear_generation_cache(tmodel)
    before = (tgen.captures, tgen.replays)
    ids = _ids(2, (2, 4))
    tgen.generate(tmodel, ids, max_new_tokens=3, use_cache=True)
    store = tmodel.__dict__["_generation_programs"]
    (key, prog), = store.items()
    ptrs = [t.data_ptr() for t in (prog.kv["k"], prog.kv["v"], prog.tok, prog.pos,
                                   prog.finished, prog.toks)]
    tgen.generate(tmodel, ids, max_new_tokens=3, use_cache=True)
    assert list(store) == [key] and store[key] is prog
    assert [t.data_ptr() for t in (prog.kv["k"], prog.kv["v"], prog.tok, prog.pos,
                                   prog.finished, prog.toks)] == ptrs
    assert prog.program.runs == 4 and prog.program.captures == 0
    assert (tgen.captures, tgen.replays) == before
    tgen.generate(tmodel, ids, max_new_tokens=4, use_cache=True)
    tgen.generate(tmodel, ids, max_new_tokens=5, use_cache=True)
    assert len(store) == tgen._KEPT_PROGRAMS and key not in store
    tgen.clear_generation_cache(tmodel)
    assert "_generation_programs" not in tmodel.__dict__


def test_use_cache_falls_back_for_models_without_a_cache(models):
    """A model without ``supports_kv_cache`` takes the full-forward loop."""
    _, tmodel = models
    ids = _ids(7, (1, 4))

    def plain(**kw):
        return tmodel(**kw)

    ref = tgen.generate(tmodel, ids, max_new_tokens=3)
    # a callable has no device of its own: a CPU tensor asks for the CPU
    out = tgen.generate(plain, torch.as_tensor(ids), max_new_tokens=3, use_cache=True)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
