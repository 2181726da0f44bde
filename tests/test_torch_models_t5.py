"""T5 in the port against the JAX package's on the same weights
(``params_from_jax``) and the same numpy inputs, at ``T5Config.tiny()``
and its v1.1 variant (gated-GELU, untied head).

Tolerances: logits and single-forward losses 1e-5 (f32); gradients 1e-4 of
each leaf's scale; three steps of the 5-line loop 1e-4 (f32) and 2e-2
(bf16) relative; the relative-position buckets, ``shift_right``, greedy
seq2seq ``generate()`` tokens and the HF converter exact.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_zoo_common as common  # noqa: E402

from accelerate_tpu import generation as jgen  # noqa: E402
from accelerate_tpu.models import t5 as jt5  # noqa: E402
from accelerate_tpu_torch import generation as tgen  # noqa: E402
from accelerate_tpu_torch.models import t5 as tt5  # noqa: E402

torch.set_num_threads(1)

CONFIGS = {
    "v1_0": jt5.T5Config.tiny(),
    "v1_1": dataclasses.replace(jt5.T5Config.tiny(), feed_forward_proj="gated-gelu",
                                tie_word_embeddings=False),
}


@pytest.fixture(autouse=True)
def _reset():
    common.reset_states()
    yield
    common.reset_states()


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, jcfg in CONFIGS.items():
        jmodel = jt5.T5ForConditionalGeneration.from_config(jcfg, seed=0)
        tcfg = common.port_config(tt5.T5Config, jcfg)
        out[name] = (jmodel, tcfg, common.port_model(tt5, tt5.T5ForConditionalGeneration, tcfg,
                                                     common.np_tree(jmodel.params)))
    return out


def _batch(rng, b=4):
    ids = rng.integers(0, 256, size=(b, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    labels = rng.integers(0, 256, size=(b, 8)).astype(np.int32)
    labels[2, 6:] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_and_loss_match_jax(pairs, name):
    jmodel, _, tmodel = pairs[name]
    batch = _batch(np.random.default_rng(2))
    ref = jmodel.apply_fn(jmodel.params, **{k: jnp.asarray(v) for k, v in batch.items()})
    out = tmodel(**{k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref["logits"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.encoder_last_hidden_state.detach().numpy(),
                               np.asarray(ref["encoder_last_hidden_state"]), rtol=1e-5, atol=1e-5)
    assert common.rel(float(out.loss), float(ref["loss"])) < 1e-5


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_and_shift_right_match_jax(bidirectional):
    rel = np.arange(-300, 301, dtype=np.int32)
    ref = jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, 32, 128)
    got = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    labels = np.array([[5, 6, -100, 7], [-100, 1, 2, 3]], np.int32)
    np.testing.assert_array_equal(tt5.shift_right(torch.from_numpy(labels), 0).numpy(),
                                  np.asarray(jt5.shift_right(jnp.asarray(labels), 0)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_gradients_match_jax(pairs, name):
    jmodel, tcfg, tmodel = pairs[name]
    batch = _batch(np.random.default_rng(3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jmodel.apply_fn(p, **jb)["loss"])(jmodel.params)
    tmodel.zero_grad()
    out = tmodel(**{k: torch.from_numpy(v) for k, v in batch.items()})
    out.loss.backward()
    assert common.rel(float(out.loss), float(loss)) < 1e-5
    common.assert_grads_close(tmodel, grads, tt5, tcfg, rtol=1e-4)
    tmodel.zero_grad()


@pytest.mark.parametrize("mixed_precision", [None, "bf16"], ids=["f32", "bf16"])
def test_five_line_loop_matches_the_jax_loop(mixed_precision):
    jcfg = CONFIGS["v1_0"]
    batches = [_batch(np.random.default_rng(4), b=8)] * 3
    init, jlosses = common.jax_loop(jt5.T5ForConditionalGeneration.from_config(jcfg, seed=1),
                                    batches, mixed_precision)
    tcfg = common.port_config(tt5.T5Config, jcfg)
    losses = common.port_loop(common.port_model(tt5, tt5.T5ForConditionalGeneration, tcfg, init),
                              batches, mixed_precision)
    tol = 1e-4 if mixed_precision is None else 2e-2
    for got, ref in zip(losses, jlosses):
        assert common.rel(got, ref) < tol, (losses, jlosses)
    assert len(losses) == 3 and losses[-1] < losses[0]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_seq2seq_generate_tokens_equal_jax(pairs, name):
    """The encoder runs once, then one decoder forward a token; with and
    without a padded encoder mask, and with an eos that ends a row early."""
    jmodel, _, tmodel = pairs[name]
    ids = np.random.default_rng(5).integers(0, 256, size=(3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 6:] = 0
    for kw in ({}, {"attention_mask": mask}):
        ref = np.asarray(jgen.generate(jmodel, ids, max_new_tokens=7, **kw))
        got = tgen.generate(tmodel, ids, max_new_tokens=7, **kw).numpy()
        assert got.shape == (3, 8)
        np.testing.assert_array_equal(got, ref)
    eos = int(ref[0, 3])  # a token row 0 emits: the rows finish at different steps
    ref = np.asarray(jgen.generate(jmodel, ids, max_new_tokens=7, eos_token_id=eos))
    got = tgen.generate(tmodel, ids, max_new_tokens=7, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, ref)


def _hf_t5(c):
    h, inner, ff = c.hidden_size, c.num_heads * c.d_kv, c.d_ff
    sd = {"shared.weight": (c.vocab_size, h)}
    if not c.tie_word_embeddings:
        sd["lm_head.weight"] = (c.vocab_size, h)
    ffn = ("wi_0", "wi_1") if c.feed_forward_proj == "gated-gelu" else ("wi",)
    for side, count in (("encoder", c.num_layers), ("decoder", c.num_decoder_layers)):
        sd[f"{side}.final_layer_norm.weight"] = (h,)
        sd[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            c.relative_attention_num_buckets, c.num_heads)
        attns = [("0", "SelfAttention")] + ([("1", "EncDecAttention")] if side == "decoder" else [])
        ff_at = "1" if side == "encoder" else "2"
        for i in range(count):
            p = f"{side}.block.{i}.layer."
            for at, kind in attns:
                sd[f"{p}{at}.layer_norm.weight"] = (h,)
                for n in "qkv":
                    sd[f"{p}{at}.{kind}.{n}.weight"] = (inner, h)
                sd[f"{p}{at}.{kind}.o.weight"] = (h, inner)
            for n in ffn:
                sd[f"{p}{ff_at}.DenseReluDense.{n}.weight"] = (ff, h)
            sd[f"{p}{ff_at}.DenseReluDense.wo.weight"] = (h, ff)
            sd[f"{p}{ff_at}.layer_norm.weight"] = (h,)
    return sd


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hf_converter_matches_jax(pairs, name):
    _, tcfg, tmodel = pairs[name]
    jcfg = CONFIGS[name]
    rng = np.random.default_rng(7)
    hf = {k: rng.normal(size=shape).astype(np.float32) for k, shape in _hf_t5(jcfg).items()}
    ref = tt5.params_from_jax(jt5.convert_hf_t5_state_dict(hf, jcfg), tcfg)
    got = tmodel.convert_state_dict(hf)
    assert set(got) == set(ref) == set(tmodel.state_dict())
    for key, t in got.items():
        np.testing.assert_array_equal(t.numpy(), ref[key].numpy(), err_msg=key)
