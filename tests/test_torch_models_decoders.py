"""The zoo's decoder families in the port (gpt2, opt, gpt_neox and its
GPT-J variant, mixtral) held against the JAX package's on the same weights
(carried across by each family's ``params_from_jax``) and the same numpy
inputs, each at its ``tiny`` config (mixtral with GQA: 4 query
and 2 kv heads).

Tolerances: logits and single-forward losses 1e-5 (f32); gradients 1e-4 of
each leaf's scale; three steps of the 5-line loop against the JAX
Accelerator loop 1e-4 (f32) and 2e-2 (bf16) relative; greedy ``generate()``
tokens exact, cached and full-forward; the HF converters exact on a
synthetic HF-named state dict made with numpy (no weights downloaded).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_zoo_common as common  # noqa: E402

from accelerate_tpu import generation as jgen  # noqa: E402
from accelerate_tpu.models import gpt2 as jgpt2  # noqa: E402
from accelerate_tpu.models import gpt_neox as jneox  # noqa: E402
from accelerate_tpu.models import mixtral as jmix  # noqa: E402
from accelerate_tpu.models import opt as jopt  # noqa: E402
from accelerate_tpu_torch import generation as tgen  # noqa: E402
from accelerate_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from accelerate_tpu_torch.models import gpt_neox as tneox  # noqa: E402
from accelerate_tpu_torch.models import mixtral as tmix  # noqa: E402
from accelerate_tpu_torch.models import opt as topt  # noqa: E402

torch.set_num_threads(1)

#: name -> (JAX module, JAX model class, JAX config, port module, port class)
FAMILIES = {
    "gpt2": (jgpt2, jgpt2.GPT2LMHeadModel, jgpt2.GPT2Config.tiny(seq=64), tgpt2,
             tgpt2.GPT2LMHeadModel),
    "opt": (jopt, jopt.OPTForCausalLM, jopt.OPTConfig.tiny(seq=64), topt, topt.OPTForCausalLM),
    "gpt_neox": (jneox, jneox.GPTNeoXForCausalLM, jneox.GPTNeoXConfig.tiny(seq=64), tneox,
                 tneox.GPTNeoXForCausalLM),
    "gptj": (jneox, jneox.GPTNeoXForCausalLM,
             jneox.GPTNeoXConfig.tiny(seq=64, shared_layernorm=True, attention_bias=False),
             tneox, tneox.GPTNeoXForCausalLM),
    "mixtral": (jmix, jmix.MixtralForCausalLM,
                dataclasses.replace(jmix.MixtralConfig.tiny(seq=64), num_key_value_heads=2),
                tmix, tmix.MixtralForCausalLM),
}


@pytest.fixture(autouse=True)
def _reset():
    common.reset_states()
    yield
    common.reset_states()


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX config, JAX model, port config, port model), built once."""
    out = {}
    for name, (_, jcls, jcfg, tmod, tcls) in FAMILIES.items():
        jmodel = jcls.from_config(jcfg, seed=0)
        tcfg = common.port_config(getattr(tmod, type(jcfg).__name__), jcfg)
        out[name] = (jcfg, jmodel, tcfg,
                     common.port_model(tmod, tcls, tcfg, common.np_tree(jmodel.params)))
    return out


def _batch(rng, b=2, s=16, vocab=256):
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    return {"input_ids": ids, "labels": ids.copy(), "attention_mask": np.ones((b, s), np.int32)}


@pytest.mark.parametrize("padded", [False, True], ids=["full", "left_padded"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_logits_and_loss_match_jax(pairs, name, padded):
    jcfg, jmodel, _, tmodel = pairs[name]
    batch = _batch(np.random.default_rng(2))
    if padded:
        batch["attention_mask"][0, :5] = 0
    ref = jmodel.apply_fn(jmodel.params, **{k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = tmodel(**tb, return_logits=True)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref["logits"]),
                               rtol=1e-5, atol=1e-5)
    for key in ("loss", "lm_loss", "aux_loss"):
        if key in ref:
            assert common.rel(float(out[key]), float(ref[key])) < 1e-5, key
    # with labels the whole-sequence head product is skipped
    assert "logits" not in tmodel(**tb)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_gradients_match_jax(pairs, name):
    jcfg, jmodel, tcfg, tmodel = pairs[name]
    batch = _batch(np.random.default_rng(3))
    batch["attention_mask"][1, -4:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jmodel.apply_fn(p, **jb)["loss"])(jmodel.params)
    tmodel.zero_grad()
    out = tmodel(**{k: torch.from_numpy(v) for k, v in batch.items()})
    out.loss.backward()
    assert common.rel(float(out.loss), float(loss)) < 1e-5
    common.assert_grads_close(tmodel, grads, FAMILIES[name][3], tcfg, rtol=1e-4)
    tmodel.zero_grad()


@pytest.mark.parametrize("mixed_precision", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_five_line_loop_matches_the_jax_loop(name, mixed_precision):
    jmod, jcls, jcfg, tmod, tcls = FAMILIES[name]
    batches = [_batch(np.random.default_rng(4), b=4, s=32)] * 3
    init, jlosses = common.jax_loop(jcls.from_config(jcfg, seed=1), batches, mixed_precision)
    tcfg = common.port_config(getattr(tmod, type(jcfg).__name__), jcfg)
    losses = common.port_loop(common.port_model(tmod, tcls, tcfg, init), batches,
                              mixed_precision)
    tol = 1e-4 if mixed_precision is None else 2e-2
    assert len(losses) == 3
    for got, ref in zip(losses, jlosses):
        assert common.rel(got, ref) < tol, (losses, jlosses)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_greedy_generate_tokens_equal_jax(pairs, name):
    """Cached (prefill + the decode step) and full-forward, on a ragged
    right-padded batch."""
    _, jmodel, _, tmodel = pairs[name]
    ids = np.random.default_rng(5).integers(0, 256, size=(2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    def jax_call(**kw):  # JAX's full-forward loop calls the model
        return jmodel.apply_fn(jmodel.params, **kw)

    for use_cache in (True, False):
        ref = np.asarray(jgen.generate(jmodel if use_cache else jax_call, ids, max_new_tokens=6,
                                       attention_mask=mask, use_cache=use_cache))
        got = tgen.generate(tmodel, ids, max_new_tokens=6, attention_mask=mask,
                            use_cache=use_cache).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"use_cache={use_cache}")


def test_ids_and_positions_past_their_tables_read_the_rows_jax_reads(pairs):
    """Learned positions and token ids past their tables: JAX's gather
    clamps (a negative id counts from the end once) where ``nn.Embedding``
    would raise."""
    for name in ("gpt2", "opt"):
        jcfg, jmodel, _, tmodel = pairs[name]
        ids = np.random.default_rng(6).integers(0, 256, size=(2, 8)).astype(np.int32)
        ids[0, :4] = (300, 256, -1, -300)
        positions = np.tile(np.arange(60, 68, dtype=np.int32), (2, 1))  # past 64
        ref = jmodel.apply_fn(jmodel.params, input_ids=jnp.asarray(ids),
                              positions=jnp.asarray(positions))
        got = tmodel(input_ids=torch.from_numpy(ids), positions=torch.from_numpy(positions))
        np.testing.assert_allclose(got.logits.detach().numpy(), np.asarray(ref["logits"]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# the HF converters, on synthetic HF-named state dicts
# ---------------------------------------------------------------------------


def _hf_gpt2(c, rng):
    h, ff = c.hidden_size, 4 * c.hidden_size
    sd = {"transformer.wte.weight": (c.vocab_size, h),
          "transformer.wpe.weight": (c.max_position_embeddings, h),
          "transformer.ln_f.weight": (h,), "transformer.ln_f.bias": (h,)}
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
                   p + "attn.c_attn.weight": (h, 3 * h), p + "attn.c_attn.bias": (3 * h,),
                   p + "attn.c_proj.weight": (h, h), p + "attn.c_proj.bias": (h,),
                   p + "ln_2.weight": (h,), p + "ln_2.bias": (h,),
                   p + "mlp.c_fc.weight": (h, ff), p + "mlp.c_fc.bias": (ff,),
                   p + "mlp.c_proj.weight": (ff, h), p + "mlp.c_proj.bias": (h,)})
    return sd


def _hf_opt(c, rng):
    h, ff = c.hidden_size, c.intermediate_size
    p0 = "model.decoder."
    sd = {p0 + "embed_tokens.weight": (c.vocab_size, h),
          p0 + "embed_positions.weight": (c.max_position_embeddings + 2, h),
          p0 + "final_layer_norm.weight": (h,), p0 + "final_layer_norm.bias": (h,)}
    for i in range(c.num_hidden_layers):
        p = f"{p0}layers.{i}."
        for n in ("q", "k", "v", "out"):
            sd[p + f"self_attn.{n}_proj.weight"] = (h, h)
            sd[p + f"self_attn.{n}_proj.bias"] = (h,)
        for n in ("self_attn_layer_norm", "final_layer_norm"):
            sd[p + f"{n}.weight"] = (h,)
            sd[p + f"{n}.bias"] = (h,)
        sd.update({p + "fc1.weight": (ff, h), p + "fc1.bias": (ff,),
                   p + "fc2.weight": (h, ff), p + "fc2.bias": (h,)})
    return sd


def _hf_neox(c, rng):
    h, ff = c.hidden_size, c.intermediate_size
    sd = {"gpt_neox.embed_in.weight": (c.vocab_size, h), "embed_out.weight": (c.vocab_size, h),
          "gpt_neox.final_layer_norm.weight": (h,), "gpt_neox.final_layer_norm.bias": (h,)}
    for i in range(c.num_hidden_layers):
        p = f"gpt_neox.layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm"):
            sd[p + f"{n}.weight"] = (h,)
            sd[p + f"{n}.bias"] = (h,)
        sd.update({p + "attention.query_key_value.weight": (3 * h, h),
                   p + "attention.query_key_value.bias": (3 * h,),
                   p + "attention.dense.weight": (h, h), p + "attention.dense.bias": (h,),
                   p + "mlp.dense_h_to_4h.weight": (ff, h), p + "mlp.dense_h_to_4h.bias": (ff,),
                   p + "mlp.dense_4h_to_h.weight": (h, ff), p + "mlp.dense_4h_to_h.bias": (h,)})
    return sd


def _hf_gptj(c, rng):
    h, ff = c.hidden_size, c.intermediate_size
    sd = {"transformer.wte.weight": (c.vocab_size, h), "lm_head.weight": (c.vocab_size, h),
          "lm_head.bias": (c.vocab_size,), "transformer.ln_f.weight": (h,),
          "transformer.ln_f.bias": (h,)}
    for i in range(c.num_hidden_layers):
        p = f"transformer.h.{i}."
        for n in ("q", "k", "v", "out"):
            sd[p + f"attn.{n}_proj.weight"] = (h, h)
        sd.update({p + "ln_1.weight": (h,), p + "ln_1.bias": (h,),
                   p + "mlp.fc_in.weight": (ff, h), p + "mlp.fc_in.bias": (ff,),
                   p + "mlp.fc_out.weight": (h, ff), p + "mlp.fc_out.bias": (h,)})
    return sd


CONVERTERS = {
    "gpt2": (_hf_gpt2, jgpt2.convert_hf_gpt2_state_dict),
    "opt": (_hf_opt, jopt.convert_hf_opt_state_dict),
    "gpt_neox": (_hf_neox, jneox.convert_hf_gpt_neox_state_dict),
    "gptj": (_hf_gptj, jneox.convert_hf_gptj_state_dict),
}


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_hf_converter_matches_jax(pairs, name):
    """The port's converter equals JAX's carried across by
    ``params_from_jax`` (GPT-J's rotary permutation of the q/k rows
    included), and the converted model gives JAX's logits."""
    make, jconvert = CONVERTERS[name]
    jcfg, _, tcfg, tmodel = pairs[name]
    rng = np.random.default_rng(7)
    hf = {k: rng.normal(size=shape).astype(np.float32) for k, shape in make(jcfg, rng).items()}
    tmod = FAMILIES[name][3]
    ref = tmod.params_from_jax(jconvert(hf, jcfg), tcfg)
    got = tmodel.convert_state_dict(hf)
    assert set(got) == set(ref) == set(tmodel.state_dict())
    for key, t in got.items():
        np.testing.assert_array_equal(t.numpy(), ref[key].numpy(), err_msg=key)
