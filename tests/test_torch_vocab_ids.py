"""Out-of-vocabulary token ids read the embedding rows JAX's gather reads
(``params["embed_tokens"][input_ids]``), in the llama's training forward,
its cached prefill and decode (``generate()``), and its paged step (the
serve engine); before, the port's ``nn.Embedding`` raised on them, which
killed a serve replica that JAX's would have answered.

What JAX's gather does is measured here, not assumed: ids 300, 256, -1 and
-300 against a vocabulary of 256. Tolerances: logits 1e-5 at f32; greedy
tokens exact.
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
from accelerate_tpu_torch import generation as tgen  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

VOCAB = 256
ODD_IDS = (300, 256, -1, -300)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(layers=2, seq=64)
    assert jcfg.vocab_size == VOCAB
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg))
    return jcfg, jmodel, tmodel


def _prompt():
    ids = np.random.default_rng(0).integers(0, VOCAB, size=(2, 9)).astype(np.int32)
    ids[0, 1:5] = ODD_IDS
    ids[1, -1] = 300
    return ids


def test_the_rows_read_equal_those_jax_gathers(models):
    rows = np.asarray(jnp.arange(VOCAB)[jnp.asarray(ODD_IDS + (0, 255))])
    _, _, tmodel = models
    got = tmodel._token_ids(torch.tensor(ODD_IDS + (0, 255)))
    np.testing.assert_array_equal(got.numpy(), rows)


def test_forward_logits_for_out_of_vocabulary_ids_equal_jax(models):
    jcfg, jmodel, tmodel = models
    ids = _prompt()
    ref = jllama.llama_apply(jcfg, jmodel.params, input_ids=jnp.asarray(ids))["logits"]
    got = tmodel(input_ids=torch.from_numpy(ids)).logits
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_generate_from_an_out_of_vocabulary_prompt_equals_jax(models):
    _, jmodel, tmodel = models
    ids = _prompt()
    ref = np.asarray(jgen.generate(jmodel, ids, max_new_tokens=5, use_cache=True))
    got = tgen.generate(tmodel, ids, max_new_tokens=5, use_cache=True)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_the_engine_answers_a_prompt_holding_id_300_as_jax(models):
    _, jmodel, tmodel = models
    geometry = dict(num_slots=2, block_size=8, max_seq_len=64, prefill_chunk=8, decode_burst=4)
    jengine = jserving.InferenceEngine(jmodel, jserving.EngineConfig(
        **geometry, prefix_cache=False, per_slot_sampling=False, async_dispatch=False,
        flight_history=0, usage_accounting=False))
    tengine = tserving.InferenceEngine(tmodel, tserving.EngineConfig(**geometry), device="cpu")
    outs = []
    for engine in (jengine, tengine):
        reqs = [engine.add_request(p, 6) for p in _prompt()]
        assert len(engine.run_until_idle(max_iterations=500)) == len(reqs)
        outs.append([list(r.output_tokens) for r in reqs])
    assert outs[1] == outs[0] and all(len(t) == 6 for t in outs[1])
