"""The port's per-slot sampling (``accelerate_tpu_torch/serving/sampling.py``)
held against the JAX package's ``serving/sampling.py`` on the same numpy
inputs.

* :func:`apply_filters` and :func:`dist_logprobs` against the JAX functions
  on seeded logits, every lane exercised: a repetition ring with -1 pads,
  top-k 0 and 5, top-p 0.3 and 1.0, the temperature floor, min-token eos
  suppression and a grammar mask; f32, ``atol 1e-5``.
* ``SamplingParams`` refusals and ``resolve_sampling`` coercions, mirrored
  from ``tests/test_sampling_serving.py``.
* The counter hash behind the draws: fixed bits for fixed inputs, and a
  function of (seed, position, tag) only — not of the slot or the batch.
* The sampled distribution: 20,000 seeded draws from a fixed filtered
  distribution match ``exp(logp)`` by a chi-square test (p > 1e-3; the
  seeds are fixed, so the test is deterministic).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.serving import sampling as jsampling  # noqa: E402
from accelerate_tpu_torch.serving import sampling as tsampling  # noqa: E402

torch.set_num_threads(1)

S, V, W = 6, 40, 8  # slots, vocab, repetition window
EOS = 3


def _lanes():
    """The same lane values for both packages: every slot exercises a
    different mix of the filters."""
    rng = np.random.default_rng(0)
    params = [
        tsampling.SamplingParams(),                                     # inert
        tsampling.SamplingParams(do_sample=True, temperature=0.7, top_k=5),
        tsampling.SamplingParams(do_sample=True, top_p=0.3, repetition_penalty=1.4),
        tsampling.SamplingParams(temperature=0.0, repetition_penalty=0.8, min_tokens=9),
        tsampling.SamplingParams(do_sample=True, temperature=1.3, top_k=0, top_p=1.0,
                                 min_tokens=2),
        tsampling.SamplingParams(do_sample=True, temperature=0.5, top_k=5, top_p=0.3),
    ]
    recent = [(), (), rng.integers(0, V, 5).tolist(), rng.integers(0, V, 12).tolist(),
              (), [1, 1, 2]]
    rows = [0, 0, 1, 0, 1, 1]
    host = {}
    for pkg in ("jax", "torch"):
        lanes = (jsampling if pkg == "jax" else tsampling).blank_lanes(S, W)
        for slot, (p, r, g) in enumerate(zip(params, recent, rows)):
            jp = jsampling.SamplingParams(**{k: getattr(p, k) for k in (
                "do_sample", "temperature", "top_k", "top_p", "repetition_penalty", "seed",
                "min_tokens")}) if pkg == "jax" else p
            (jsampling if pkg == "jax" else tsampling).set_slot_lane(
                lanes, slot, jp, pos=4, grammar_row=g, dfa_state=slot % 3, recent=r)
        host[pkg] = lanes
    return host


def _gmask():
    rng = np.random.default_rng(1)
    mask = np.ones((2, 3, V), bool)
    mask[1] = rng.random((3, V)) < 0.6
    mask[1, :, 0] = True  # every state allows something
    return mask


def _logits():
    return (np.random.default_rng(2).normal(size=(S, V)) * 3).astype(np.float32)


def _pos(lanes):
    return lanes["pos"] + np.array([0, 3, 1, 2, 5, 0], np.int32)


def test_apply_filters_and_dist_logprobs_match_jax():
    host, gmask, logits = _lanes(), _gmask(), _logits()
    jl = {k: jnp.asarray(v) for k, v in host["jax"].items()}
    tl = {k: torch.as_tensor(v) for k, v in host["torch"].items()}
    dfa = np.arange(S, dtype=np.int32) % 3
    pos = _pos(host["torch"])
    jf = jsampling.apply_filters(jnp.asarray(logits), jl, jnp.asarray(dfa), jnp.asarray(pos),
                                 jnp.asarray(gmask), EOS)
    tf = tsampling.apply_filters(torch.as_tensor(logits), tl, torch.as_tensor(dfa),
                                 torch.as_tensor(pos), torch.as_tensor(gmask), EOS)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    # each filter acted: a penalised token, a masked token, a suppressed eos
    assert (np.asarray(jf) <= tsampling.NEG / 2).any()
    assert np.asarray(jf)[3, EOS] <= tsampling.NEG / 2  # pos 6 < min_tokens 9
    assert not np.allclose(np.asarray(jf)[2], logits[2])  # repetition penalty

    jd = np.asarray(jsampling.dist_logprobs(jf, jl))
    td = tsampling.dist_logprobs(tf, tl).numpy()
    assert ((jd > tsampling.NEG / 2) == (td > tsampling.NEG / 2)).all()  # same kept set
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    kept = (td > tsampling.NEG / 2).sum(axis=1)
    assert kept[1] == 5 and kept[5] <= 5 and kept[0] == V  # top-k 5, top-k 0


def test_pick_tokens_greedy_slots_and_logprobs_match_jax():
    """The greedy slots' tokens and every slot's reported logprobs (the
    filtered distribution at temperature 1) equal JAX's; sampled slots use
    the port's own draws."""
    host, gmask, logits = _lanes(), _gmask(), _logits()
    jl = {k: jnp.asarray(v) for k, v in host["jax"].items()}
    tl = {k: torch.as_tensor(v) for k, v in host["torch"].items()}
    dfa = np.arange(S, dtype=np.int32) % 3
    jt, jlp, jv, ji = jsampling.pick_tokens(
        jnp.asarray(logits), jl, jnp.asarray(dfa), 2, jnp.asarray(gmask),
        jax.random.PRNGKey(0), eos_id=EOS, logprobs_topn=3)
    tt, tlp, tv, ti = tsampling.pick_tokens(
        torch.as_tensor(logits), tl, torch.as_tensor(dfa), 2, torch.as_tensor(gmask), 0,
        eos_id=EOS, logprobs_topn=3)
    greedy = ~host["torch"]["sample"].astype(bool)
    np.testing.assert_array_equal(tt.numpy()[greedy], np.asarray(jt)[greedy])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tlp.numpy()[greedy], np.asarray(jlp)[greedy], rtol=0, atol=1e-5)
    # a sampled slot never picks a token its filters cut
    dist = tsampling.dist_logprobs(tsampling.apply_filters(
        torch.as_tensor(logits), tl, torch.as_tensor(dfa), tl["pos"] + 2,
        torch.as_tensor(gmask), EOS), tl).numpy()
    for slot in np.flatnonzero(~greedy):
        assert dist[slot, tt[slot]] > tsampling.NEG / 2


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(temperature=-0.1), "temperature"),
        (dict(top_p=0.0), "top_p"),
        (dict(top_p=1.5), "top_p"),
        (dict(top_k=-1), "top_k"),
        (dict(repetition_penalty=0.0), "repetition_penalty"),
        (dict(min_tokens=-1), "min_tokens"),
        (dict(logprobs=-1), "logprobs"),
        (dict(stop=((),)), "stop"),
    ],
)
def test_sampling_params_refusals_match_jax(kw, match):
    for pkg in (jsampling, tsampling):
        with pytest.raises(ValueError, match=match):
            pkg.SamplingParams(**kw).validate()


def test_resolve_sampling_coercions_match_jax():
    for pkg in (jsampling, tsampling):
        default = pkg.SamplingParams(do_sample=True, temperature=0.7)
        assert pkg.resolve_sampling(None, default) is default
        assert pkg.resolve_sampling(None) == pkg.SamplingParams()
        p = pkg.resolve_sampling({"do_sample": True, "seed": 7, "stop": [3, 4]})
        assert p.seed == 7 and p.stop == ((3, 4),)
        assert pkg.resolve_sampling({"stop": [[3], [4, 5]]}).stop == ((3,), (4, 5))
        with pytest.raises(ValueError, match="unknown sampling params"):
            pkg.resolve_sampling({"temprature": 1.0})
        with pytest.raises(ValueError, match="dict or SamplingParams"):
            pkg.resolve_sampling("greedy")
        assert pkg.SamplingParams().inert
        assert not pkg.SamplingParams(do_sample=True).inert
        assert not pkg.SamplingParams(repetition_penalty=1.2).inert
        assert not pkg.SamplingParams(logprobs=2).inert
        assert not pkg.SamplingParams(min_tokens=1).inert
    for tokens, stops, n in [([1, 2, 3], ((2, 3),), 2), ([1, 2, 3], ((9,), (3,)), 1),
                             ([1, 2, 3], ((1, 2),), 0), ([1], ((1, 1),), 0)]:
        assert tsampling.match_stop(tokens, stops) == jsampling.match_stop(tokens, stops) == n


def test_slot_uniforms_are_fixed_bits_of_seed_position_and_tag():
    seeds = torch.tensor([0, 1, 7, -5, 2**31 - 1], dtype=torch.int32)
    pos = torch.tensor([0, 0, 3, 9, 100], dtype=torch.int32)
    u = tsampling.slot_uniforms(0, tsampling.TAG_SAMPLE, seeds, pos)
    assert u.dtype == torch.float32 and ((u >= 0) & (u < 1)).all()
    # pinned: the hash is integer arithmetic, the same bits on every device,
    # and equal to the same rounds in plain Python integers
    bits = (u * (1 << 24)).to(torch.int64).tolist()
    assert bits == PINNED_BITS
    assert bits == [_python_hash(0, 0, s, p) >> 8 for s, p in zip(seeds.tolist(), pos.tolist())]
    # a slot's uniform depends on its own (seed, pos) only: any slot order,
    # any batch around it
    perm = torch.tensor([3, 0, 4, 1, 2])
    assert torch.equal(tsampling.slot_uniforms(0, 0, seeds[perm], pos[perm]), u[perm])
    for i in range(len(seeds)):
        alone = tsampling.slot_uniforms(0, 0, seeds[i:i + 1], pos[i:i + 1])
        assert torch.equal(alone, u[i:i + 1])
    # the tag, the engine seed, the request seed and the position all move it
    assert not torch.equal(tsampling.slot_uniforms(0, tsampling.TAG_DRAFT, seeds, pos), u)
    assert not torch.equal(tsampling.slot_uniforms(1, 0, seeds, pos), u)
    assert not torch.equal(tsampling.slot_uniforms(0, 0, seeds + 1, pos), u)
    assert not torch.equal(tsampling.slot_uniforms(0, 0, seeds, pos + 1), u)


#: ``slot_uniforms(0, TAG_SAMPLE, ...)`` of the test above, × 2^24
PINNED_BITS = [12307143, 7162105, 13066821, 15406362, 15544716]


def _python_hash(engine_seed, tag, seed, pos):
    """The rounds of ``slot_uniforms`` in Python's unbounded integers."""
    m = 0xFFFFFFFF

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & m
        x ^= x >> 15
        x = (x * 0x846CA68B) & m
        return x ^ (x >> 16)

    h = 0
    for v in (engine_seed, tag, seed, pos):
        h = mix((h + (v & m) + 0x9E3779B9) & m)
    return h


def test_sampled_draws_follow_the_filtered_distribution():
    """20,000 draws (request seeds 0..19,999 at position 0) from one
    filtered distribution: top-k 6 and temperature 0.8 over 16 logits. The
    counts match ``exp(logp)`` by a chi-square test."""
    from scipy.stats import chisquare

    n, vocab = 20000, 16
    logits = torch.as_tensor(np.random.default_rng(3).normal(size=vocab).astype(np.float32))
    lanes = {k: torch.as_tensor(v) for k, v in tsampling.blank_lanes(1, 4).items()}
    lanes["temp"][:] = 0.8
    lanes["top_k"][:] = 6
    logp = tsampling.dist_logprobs(logits[None], lanes)[0]
    u = tsampling.slot_uniforms(5, tsampling.TAG_SAMPLE,
                                torch.arange(n, dtype=torch.int32),
                                torch.zeros(n, dtype=torch.int32))
    toks = tsampling.inverse_cdf_pick(logp.expand(n, vocab), u)
    counts = np.bincount(toks.numpy(), minlength=vocab)
    p = torch.exp(logp).double().numpy()
    kept = p > 0
    assert counts[~kept].sum() == 0  # nothing outside the top-k
    expected = p[kept] / p[kept].sum() * n
    result = chisquare(counts[kept], expected)
    assert result.pvalue > 1e-3, (counts, expected, result)
