"""The port's llama (``accelerate_tpu_torch/models/llama.py``) held against
the JAX model on the same weights.

The JAX pytree from ``init_llama_params`` is carried across as numpy
arrays by ``params_from_jax``; then one prefill chunk (padded tail masked)
per row and four batched decode steps (one lane inactive) run through both
packages' block-paged step. f32 logits agree within 1e-4: the same
arithmetic in another order, through the plain paged attention on this
CPU-only box.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

torch.set_num_threads(1)

BS, MB = 4, 6
NB = 2 * MB + 1


def _configs(kind):
    jcfg = jllama.LlamaConfig.tiny(vocab_size=96, hidden_size=32, layers=2, heads=4, seq=64)
    if kind == "gqa":
        jcfg = dataclasses.replace(jcfg, num_key_value_heads=2)
    if kind == "tied":
        jcfg = dataclasses.replace(jcfg, tie_word_embeddings=True)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    return jcfg, tcfg


def _jax_params(jcfg, seed=0):
    params = jllama.init_llama_params(jax.random.PRNGKey(seed), jcfg)
    return params, jax.tree_util.tree_map(np.asarray, params)


def _port_model(tcfg, np_params):
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params, tcfg))
    return model


def test_configs_and_presets_match_jax():
    for name in ("tiny", "flagship_700m", "llama2_7b"):
        j, t = getattr(jllama.LlamaConfig, name)(), getattr(tllama.LlamaConfig, name)()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.head_dim == j.head_dim
    flagship = tllama.LlamaConfig.flagship_700m()
    assert (flagship.hidden_size, flagship.num_attention_heads, flagship.head_dim,
            flagship.intermediate_size, flagship.num_hidden_layers, flagship.vocab_size) == (
        1536, 12, 128, 6144, 16, 32000)


@pytest.mark.parametrize("kind", ["mha", "tied"])
def test_params_from_jax_unstacks_and_transposes(kind):
    jcfg, tcfg = _configs(kind)
    _, np_params = _jax_params(jcfg)
    sd = tllama.params_from_jax(np_params, tcfg)
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape, name
    np.testing.assert_array_equal(sd["layers.1.wq.weight"].numpy(),
                                  np_params["layers"]["wq"][1].T)
    np.testing.assert_array_equal(sd["layers.0.w_down.weight"].numpy(),
                                  np_params["layers"]["w_down"][0].T)
    np.testing.assert_array_equal(sd["layers.1.attn_norm"].numpy(),
                                  np_params["layers"]["attn_norm"][1])
    if kind == "tied":
        assert "lm_head.weight" not in sd and model.lm_head is None
    else:
        np.testing.assert_array_equal(sd["lm_head.weight"].numpy(), np_params["lm_head"].T)


def _paged_run(step, pages, chunk_ids, chunk_valid, tables, decode_feed):
    """Prefill each row's chunk alone ([1, c], padded tail masked), then
    decode_feed.shape[0] batched steps over [3, 1] with lane 2 inactive.
    Returns the list of logits arrays (numpy f32) of the live lanes: the
    inactive lane reads the null block, whose garbage differs by design."""
    out = []
    lens = chunk_valid.sum(axis=1)
    for r in range(2):
        logits, pages = step(pages, chunk_ids[r:r + 1], tables[r:r + 1],
                             np.asarray([0], np.int32), chunk_valid[r:r + 1])
        out.append(logits)
    active = np.asarray([[True], [True], [False]])
    for t in range(decode_feed.shape[0]):
        pos = np.asarray([lens[0] + t, lens[1] + t, 0], np.int32)
        logits, pages = step(pages, decode_feed[t], tables, pos, active)
        out.append(logits[:2])
    return out


def _inputs(rng, tcfg):
    c = 8
    chunk_ids = rng.integers(0, tcfg.vocab_size, size=(2, c)).astype(np.int32)
    chunk_valid = np.zeros((2, c), bool)
    chunk_valid[0, :6] = True   # padded tail
    chunk_valid[1, :8] = True   # full chunk
    tables = np.zeros((3, MB), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :4] = [7, 5, 9, 11]  # not in pool order
    decode_feed = rng.integers(0, tcfg.vocab_size, size=(4, 3, 1)).astype(np.int32)
    return chunk_ids, chunk_valid, tables, decode_feed


def _steppers(kind):
    """Both packages' paged step on the same weights, as
    ``step(pages, ids, bt, pos, mask) -> (logits numpy, pages)``."""
    jcfg, tcfg = _configs(kind)
    params, np_params = _jax_params(jcfg)
    model = _port_model(tcfg, np_params)

    def jax_step(pages, ids, bt, pos, mask):
        out = jllama.llama_apply(jcfg, params, jnp.asarray(ids), paged_kv=pages,
                                 block_tables=jnp.asarray(bt), cache_positions=jnp.asarray(pos),
                                 paged_write_mask=jnp.asarray(mask))
        return np.asarray(out["logits"]), out["paged_kv"]

    def port_step(pages, ids, bt, pos, mask):
        out = model.paged_step(torch.from_numpy(ids), pages, torch.from_numpy(bt),
                               torch.from_numpy(pos), torch.from_numpy(mask))
        return out.logits.numpy(), out.paged_kv

    shape = (tcfg.num_hidden_layers, NB, BS, tcfg.num_key_value_heads, tcfg.head_dim)
    return jax_step, port_step, tcfg, shape


@pytest.mark.parametrize("kind", ["mha", "gqa", "tied"])
def test_paged_step_logits_match_jax(kind):
    jax_step, port_step, tcfg, shape = _steppers(kind)
    inputs = _inputs(np.random.default_rng(1), tcfg)
    ref = _paged_run(jax_step, {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}, *inputs)
    got = _paged_run(port_step, {"k": torch.zeros(shape), "v": torch.zeros(shape)}, *inputs)
    assert [g.shape for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)


def test_paged_step_quantized_pools_match_jax():
    """int8 pools: both packages quantize their own K/V on scatter. Those
    K/V agree to ~1e-7, so a value sitting on a rounding tie may land one
    quantum (amax/127) apart; the logits gate is 2e-3 for that reason."""
    jax_step, port_step, tcfg, shape = _steppers("mha")
    inputs = _inputs(np.random.default_rng(2), tcfg)
    jpages = {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
              "k_scale": jnp.ones(shape[:-1]), "v_scale": jnp.ones(shape[:-1])}
    tpages = {"k": torch.zeros(shape, dtype=torch.int8), "v": torch.zeros(shape, dtype=torch.int8),
              "k_scale": torch.ones(shape[:-1]), "v_scale": torch.ones(shape[:-1])}
    ref = _paged_run(jax_step, jpages, *inputs)
    got = _paged_run(port_step, tpages, *inputs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)


def test_init_llama_params_on_the_device_from_a_generator():
    _, tcfg = _configs("gqa")
    sd = tllama.init_llama_params(torch.Generator().manual_seed(3), tcfg, device="cpu")
    model = tllama.LlamaForCausalLM.from_config(tcfg, seed=3, device="cpu")
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(sd[name], t), name  # same generator, same draws
    assert float(sd["layers.0.attn_norm"].mean()) == 1.0
    w = sd["layers.0.wq.weight"]  # N(0, 1/in)
    assert abs(float(w.std()) * np.sqrt(tcfg.hidden_size) - 1.0) < 0.15
    bf16 = tllama.LlamaForCausalLM.from_config(tcfg, seed=3, dtype=torch.bfloat16, device="cpu")
    assert bf16.dtype == torch.bfloat16 and bf16.device.type == "cpu"


def test_model_without_a_device_needs_cuda():
    _, tcfg = _configs("mha")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.LlamaForCausalLM(tcfg)


def test_paged_step_refuses_a_chunk_past_the_rope_tables():
    _, tcfg = _configs("mha")
    model = tllama.LlamaForCausalLM.from_config(tcfg, device="cpu")
    shape = (tcfg.num_hidden_layers, NB, BS, tcfg.num_key_value_heads, tcfg.head_dim)
    ids = torch.zeros((1, tcfg.max_position_embeddings + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.paged_step(ids, {"k": torch.zeros(shape), "v": torch.zeros(shape)},
                         torch.zeros((1, MB), dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
