"""Big-model inference in the port (``accelerate_tpu_torch/big_modeling.py``,
``utils/modeling.py``, ``utils/offload.py``) held against the JAX package's
on the CPU: the device-map math and the maps the two infer for one config
and budget (equal under each family's ``jax_param_name``), the offload
folders each writes (loaded by the other), the safetensors reader against
``safetensors.numpy``, ``init_empty_weights``, and the streamed
``DispatchedModel`` over host, disk and straddling maps for the six families
with a segment plan (llama, opt, gpt_neox, gpt2, bert, t5) on the same
weights (``params_from_jax``) and inputs as JAX's model.

Tolerances: logits and losses 1e-5 (f32); greedy ``generate()`` tokens and
device maps exact; offloaded and checkpointed tensors exact.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch_zoo_common as common  # noqa: E402

from accelerate_tpu import generation as jgen  # noqa: E402
from accelerate_tpu.models import bert as jbert  # noqa: E402
from accelerate_tpu.models import gpt2 as jgpt2  # noqa: E402
from accelerate_tpu.models import gpt_neox as jneox  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.models import mixtral as jmix  # noqa: E402
from accelerate_tpu.models import opt as jopt  # noqa: E402
from accelerate_tpu.models import t5 as jt5  # noqa: E402
from accelerate_tpu.utils import modeling as jmodeling  # noqa: E402
from accelerate_tpu.utils import offload as joffload  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch import generation as tgen  # noqa: E402
from accelerate_tpu_torch.models import bert as tbert  # noqa: E402
from accelerate_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from accelerate_tpu_torch.models import gpt_neox as tneox  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.models import mixtral as tmix  # noqa: E402
from accelerate_tpu_torch.models import opt as topt  # noqa: E402
from accelerate_tpu_torch.models import t5 as tt5  # noqa: E402
from accelerate_tpu_torch.utils import modeling as tmodeling  # noqa: E402
from accelerate_tpu_torch.utils import offload as toffload  # noqa: E402

torch.set_num_threads(1)

#: name -> (JAX class, JAX config, port module, port class, the embedding
#: table's port name)
FAMILIES = {
    "llama": (jllama.LlamaForCausalLM, jllama.LlamaConfig.tiny(layers=2), tllama,
              tllama.LlamaForCausalLM, "embed_tokens"),
    "opt": (jopt.OPTForCausalLM, jopt.OPTConfig.tiny(seq=64), topt, topt.OPTForCausalLM, "wte"),
    "gpt_neox": (jneox.GPTNeoXForCausalLM, jneox.GPTNeoXConfig.tiny(seq=64), tneox,
                 tneox.GPTNeoXForCausalLM, "wte"),
    "gpt2": (jgpt2.GPT2LMHeadModel, jgpt2.GPT2Config.tiny(seq=64), tgpt2, tgpt2.GPT2LMHeadModel,
             "wte"),
    "bert": (jbert.BertForSequenceClassification, jbert.BertConfig.tiny(), tbert,
             tbert.BertForSequenceClassification, "embed_tokens"),
    "t5": (jt5.T5ForConditionalGeneration, jt5.T5Config.tiny(), tt5,
           tt5.T5ForConditionalGeneration, "shared"),
}
MAPS = ("cpu", "disk", "straddle")


def _port_config(name):
    jcls, jcfg, tmod, tcls, _ = FAMILIES[name]
    return common.port_config(getattr(tmod, type(jcfg).__name__), jcfg)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX model, port model on the CPU with the JAX weights)."""
    out = {}
    for name, (jcls, jcfg, tmod, tcls, _) in FAMILIES.items():
        jmodel = jcls.from_config(jcfg, seed=0)
        out[name] = (jmodel, common.port_model(tmod, tcls, _port_config(name),
                                               common.np_tree(jmodel.params)))
    return out


def _batch(name, rng):
    ids = rng.integers(0, 256, size=(2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}
    if name == "t5":
        batch["decoder_input_ids"] = rng.integers(0, 256, size=(2, 7)).astype(np.int32)
    return batch


def _device_map(name, kind):
    if kind != "straddle":
        return {"": kind}
    if name == "t5":  # a layer of each stack off the card, on different tiers
        return {"": 0, "encoder.layers.1": "disk", "decoder.layers.0": "cpu", "shared": "cpu"}
    return {"": 0, "layers.1": "disk", FAMILIES[name][4]: "cpu"}


def _copy_of(model):
    """A second port model with the same weights: dispatch takes over the
    model's buffers."""
    name = next(n for n, (_, _, _, tcls, _) in FAMILIES.items() if isinstance(model, tcls))
    clone = FAMILIES[name][3](model.config, device="cpu")
    clone.load_state_dict(model.state_dict())
    return clone


# ---------------------------------------------------------------------------
# dtype, size and device-map math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tdtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
    (torch.int8, jnp.int8), (torch.bool, jnp.bool_), (torch.float8_e4m3fn, "float8_e4m3fn"),
    ("int4", "int4"), ("int2", "int2")])
def test_dtype_byte_size_matches_jax(tdtype, jdtype):
    assert tmodeling.dtype_byte_size(tdtype) == jmodeling.dtype_byte_size(jdtype)


def test_compute_module_sizes_match_jax():
    shapes = {"embed.weight": (10, 4), "layers.0.w": (4, 4), "layers.1.w": (4, 4), "s": ()}
    tsizes = tmodeling.compute_module_sizes({k: (v, torch.float32) for k, v in shapes.items()})
    jsizes = jmodeling.compute_module_sizes({k: (v, jnp.float32) for k, v in shapes.items()})
    assert tsizes == jsizes and tsizes[""] == 292
    assert (tmodeling.compute_module_sizes({k: (v, torch.float32) for k, v in shapes.items()},
                                           dtype=torch.bfloat16)
            == jmodeling.compute_module_sizes({k: (v, jnp.float32) for k, v in shapes.items()},
                                              dtype=jnp.bfloat16))


_MAP_CASES = {
    "spill": ({"a.w": (100,), "b.w": (100,), "c.w": (100,)},
              {0: 500, "cpu": 500, "disk": float("inf")}, {}),
    "no_split": ({"layer.q": (100,), "layer.k": (100,)}, {0: 500, "cpu": 10**9},
                 {"no_split_prefixes": ["layer"]}),
    "split": ({"layer.q": (100,), "layer.k": (100,)}, {0: 500, "cpu": 10**9}, {}),
    "tied": ({"embed": (50,), "mid.w": (100,), "head": (50,)}, {0: 450, "cpu": 10**9},
             {"tied_parameters": [["embed", "head"]]}),
}


@pytest.mark.parametrize("case", list(_MAP_CASES))
def test_infer_auto_device_map_matches_jax(case):
    shapes, budget, kw = _MAP_CASES[case]
    tmap = tmodeling.infer_auto_device_map({k: (v, torch.float32) for k, v in shapes.items()},
                                           max_memory=budget, **kw)
    jmap = jmodeling.infer_auto_device_map({k: (v, jnp.float32) for k, v in shapes.items()},
                                           max_memory=budget, **kw)
    assert tmap == jmap


def test_get_balanced_memory_matches_jax():
    shapes = {f"layers.{i}.w": (1000,) for i in range(8)}
    budget = {0: 10**9, 1: 10**9, "cpu": 10**9}
    tb = tmodeling.get_balanced_memory({k: (v, torch.float32) for k, v in shapes.items()}, budget)
    jb = jmodeling.get_balanced_memory({k: (v, jnp.float32) for k, v in shapes.items()}, budget)
    assert tb == jb and tb[0] == tb[1] < 10**9


@pytest.mark.parametrize("split", [(0.3, 0.3), (0.55, 0.2), (0.15, 0.6)],
                         ids=["thirds", "card_heavy", "host_heavy"])
@pytest.mark.parametrize("no_split", [False, True], ids=["leaves", "whole_layers"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_inferred_device_map_equals_jax(pairs, name, split, no_split):
    """One config and one budget give one map in both packages, once the
    port's names are read as JAX's (``jax_param_name``)."""
    jmodel, _ = pairs[name]
    _, _, tmod, tcls, _ = FAMILIES[name]
    jshapes = jmodeling.flat_param_shapes(jmodel, expand_stacked=jmodel.stacked_params_prefix)
    total = jmodeling.compute_module_sizes(jshapes)[""]
    budget = {0: int(split[0] * total), "cpu": int(split[1] * total), "disk": float("inf")}
    kw = {"no_split_module_classes": [r"((en|de)coder\.)?layers\.\d+"]} if no_split else {}
    jmap = jmodeling.infer_auto_device_map(jshapes, max_memory=budget, **kw)
    with bm.init_empty_weights():
        empty = tcls(_port_config(name))
    tshapes = tmodeling.flat_param_shapes(empty)
    assert tmodeling.compute_module_sizes(tshapes)[""] == total
    tmap = tmodeling.infer_auto_device_map(tshapes, max_memory=budget,
                                           tied_parameters=tmodeling.find_tied_parameters(empty),
                                           **kw)
    assert {tmod.jax_param_name(k): v for k, v in tmap.items()} == jmap


def test_find_tied_parameters_by_identity():
    shared = torch.nn.Parameter(torch.zeros(4, 2))
    m = torch.nn.Module()
    m.a, m.b = torch.nn.Linear(2, 4), torch.nn.Linear(2, 4)
    m.b.weight = shared
    m.a.weight = shared
    assert tmodeling.find_tied_parameters(m) == [["a.weight", "b.weight"]]
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    assert tmodeling.find_tied_parameters(model) == []


# ---------------------------------------------------------------------------
# the offload store and the checkpoint readers
# ---------------------------------------------------------------------------

_DTYPES = {"float32": (torch.float32, np.float32), "float16": (torch.float16, np.float16),
           "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16), "int8": (torch.int8, np.int8),
           "uint8": (torch.uint8, np.uint8), "int64": (torch.int64, np.int64)}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_offload_folders_cross_load(tmp_path, dtype, writer):
    """A folder written by either package loads in the other, bit for bit
    (bf16 as raw 16-bit patterns), scalars included."""
    tdtype, ndtype = _DTYPES[dtype]
    rng = np.random.default_rng(1)
    values = {"block.w": rng.normal(size=(4, 6)) * 50, "s": np.asarray(3.0)}
    arrays = {k: np.asarray(v).astype(ndtype) for k, v in values.items()}
    if writer == "port":
        toffload.offload_state_dict(str(tmp_path), {
            k: torch.from_numpy(np.asarray(v, np.float64)).to(tdtype) for k, v in values.items()})
        index = joffload.load_offload_index(str(tmp_path))
        for k, a in arrays.items():
            got = np.asarray(joffload.load_offloaded_weight(str(tmp_path / f"{k}.dat"), index[k]))
            np.testing.assert_array_equal(got.astype(np.float64), a.astype(np.float64))
    else:
        joffload.offload_state_dict(str(tmp_path), arrays)
        loader = toffload.OffloadedWeightsLoader(save_folder=str(tmp_path))
        for k, a in arrays.items():
            got = loader[k]
            assert got.dtype == tdtype and tuple(got.shape) == a.shape
            np.testing.assert_array_equal(got.double().numpy(), a.astype(np.float64))
    with open(tmp_path / "index.json") as f:
        assert json.load(f)["block.w"] == {"dtype": dtype, "shape": [4, 6]}


def test_offloaded_weights_loader_mixed(tmp_path):
    toffload.offload_state_dict(str(tmp_path), {"d1": torch.ones(2, 2), "d2": torch.zeros(3)})
    loader = toffload.OffloadedWeightsLoader(state_dict={"m1": torch.full((2,), 7.0)},
                                             save_folder=str(tmp_path))
    assert set(loader) == {"m1", "d1", "d2"} and len(loader) == 3
    assert torch.equal(loader["d1"], torch.ones(2, 2))
    view = toffload.PrefixedDataset(loader, "d")
    assert set(view) == {"d1", "d2"} and torch.equal(view["2"], torch.zeros(3))


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "uint8", "int64", "bool"])
def test_safetensors_reader_equals_safetensors(tmp_path, dtype):
    """The port's own reader and writer against the ``safetensors`` package
    (which the port does not import), both ways."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(2)
    arrays = {"a.w": (rng.normal(size=(3, 5)) * 9).astype(dtype),
              "b": (rng.normal(size=(7,)) * 9).astype(dtype), "empty": np.zeros((0, 2), dtype)}
    save_file(arrays, str(tmp_path / "ref.safetensors"), metadata={"format": "np"})
    got = tmodeling.load_safetensors(str(tmp_path / "ref.safetensors"))
    assert set(got) == set(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), a)
    tmodeling.save_safetensors({k: torch.from_numpy(a) for k, a in arrays.items()},
                               str(tmp_path / "port.safetensors"))
    back = load_file(str(tmp_path / "port.safetensors"))
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k], a)


def test_safetensors_reader_bf16_and_sharded_index(tmp_path):
    from safetensors.torch import save_file

    t = {"x": torch.randn(4, 3).to(torch.bfloat16), "y": torch.arange(5, dtype=torch.int32)}
    save_file({"x": t["x"]}, str(tmp_path / "s1.safetensors"))
    save_file({"y": t["y"]}, str(tmp_path / "s2.safetensors"))
    with open(tmp_path / tmodeling.SAFE_WEIGHTS_INDEX_NAME, "w") as f:
        json.dump({"weight_map": {"x": "s1.safetensors", "y": "s2.safetensors"}}, f)
    got = tmodeling.load_state_dict_from_files(str(tmp_path))
    assert torch.equal(got["x"], t["x"]) and torch.equal(got["y"], t["y"])
    torch.save({"z": torch.ones(2)}, tmp_path / "w.bin")
    assert torch.equal(tmodeling.load_state_dict_from_files(str(tmp_path / "w.bin"))["z"],
                       torch.ones(2))


# ---------------------------------------------------------------------------
# meta init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FAMILIES))
def test_init_empty_weights_builds_meta_params_of_jax_shapes(pairs, name):
    """No bytes and no draw: every parameter on the meta device, with the
    element count of the JAX leaf it maps to (``from_config`` too)."""
    jmodel, _ = pairs[name]
    jcls, jcfg, tmod, tcls, _ = FAMILIES[name]
    with jax.default_device(jax.devices("cpu")[0]):
        from accelerate_tpu.big_modeling import init_empty_weights as jinit

        with jinit():
            jempty = jcls.from_config(jcfg)
    jsizes = {k: int(np.prod(s)) for k, (s, _) in jmodeling.flat_param_shapes(
        jempty, expand_stacked=jmodel.stacked_params_prefix).items()}
    for build in (lambda: tcls(_port_config(name)), lambda: tcls.from_config(_port_config(name))):
        with bm.init_empty_weights():
            assert bm.is_empty_init()
            empty = build()
        assert not bm.is_empty_init()
        params = dict(empty.named_parameters())
        assert all(p.is_meta for p in params.values())
        assert {tmod.jax_param_name(k): p.numel() for k, p in params.items()} == jsizes


def test_init_on_device_and_materialize():
    with bm.init_on_device("cpu"):
        model = topt.OPTForCausalLM(topt.OPTConfig.tiny())
    assert model.device.type == "cpu"
    with bm.init_on_device("meta"):
        empty = topt.OPTForCausalLM(topt.OPTConfig.tiny())
    assert empty.device.type == "meta"
    bm.materialize_params(empty, device="cpu")
    assert all(float(p.abs().sum()) == 0 for p in empty.parameters())
    bm.materialize_params(empty, lambda g: topt.init_opt_params(g, topt.OPTConfig.tiny(),
                                                                device="cpu"), seed=3, device="cpu")
    ref = topt.OPTForCausalLM.from_config(topt.OPTConfig.tiny(), seed=3, device="cpu")
    for (n, a), (_, b) in zip(empty.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the streamed model against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", MAPS)
@pytest.mark.parametrize("name", list(FAMILIES))
def test_dispatched_logits_match_jax(pairs, tmp_path, name, kind):
    jmodel, tmodel = pairs[name]
    batch = _batch(name, np.random.default_rng(3))
    ref = jmodel.apply_fn(jmodel.params, **{k: jnp.asarray(v) for k, v in batch.items()})
    dispatched = bm.dispatch_model(_copy_of(tmodel), _device_map(name, kind), main_device="cpu",
                                   offload_dir=str(tmp_path))
    out = dispatched(**batch)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref["logits"]), rtol=1e-5,
                               atol=1e-5)
    assert dispatched.dequantize_retries == 0
    if kind != "cpu":
        assert os.path.exists(tmp_path / "index.json")
    if kind == "straddle":  # some layers resident, others streamed
        assert dispatched.tiered.resident and dispatched.tiered.host and dispatched.tiered.disk
    if name == "t5":
        np.testing.assert_allclose(out.encoder_last_hidden_state.numpy(),
                                   np.asarray(ref["encoder_last_hidden_state"]), rtol=1e-5,
                                   atol=1e-5)
    dispatched.close()


@pytest.mark.parametrize("name", ["llama", "opt", "gpt_neox", "gpt2", "t5"])
def test_generate_over_a_dispatched_model_equals_jax(pairs, tmp_path, name):
    """``generate()`` takes the full-forward loop (the seq2seq loop for t5)
    over the streamed model: JAX's greedy tokens, ragged prompts included."""
    jmodel, tmodel = pairs[name]
    ids = np.random.default_rng(4).integers(0, 256, size=(3, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 6:] = 0
    dispatched = bm.dispatch_model(_copy_of(tmodel), _device_map(name, "straddle"),
                                   main_device="cpu", offload_dir=str(tmp_path))
    calls = dispatched.calls
    from accelerate_tpu.big_modeling import cpu_offload as jcpu_offload

    jrun = jmodel if name == "t5" else jcpu_offload(jmodel)  # JAX's full-forward loop needs a call
    ref = np.asarray(jgen.generate(jrun, ids, attention_mask=mask, max_new_tokens=6))
    got = tgen.generate(dispatched, ids, attention_mask=mask, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, ref)
    # one streamed forward a token (the seq2seq loop encodes once more)
    assert dispatched.calls - calls == 6 + (name == "t5")


def test_streaming_loss_with_labels_matches_jax(pairs):
    for name in ("llama", "opt", "bert"):
        jmodel, tmodel = pairs[name]
        batch = _batch(name, np.random.default_rng(5))
        batch["labels"] = batch["input_ids"][:, 0] % 2 if name == "bert" else batch["input_ids"]
        ref = jmodel.apply_fn(jmodel.params, **{k: jnp.asarray(v) for k, v in batch.items()})
        out = bm.cpu_offload(_copy_of(tmodel), execution_device="cpu")(**batch)
        assert common.rel(float(out.loss), float(ref["loss"])) < 1e-5, name


def test_model_without_segments_is_materialised_then_applied(tmp_path):
    """JAX's Mixtral has no segment plan, so a dispatched Mixtral runs on
    its materialised weights: JAX's logits."""
    jcfg = jmix.MixtralConfig.tiny(seq=64)
    jmodel = jmix.MixtralForCausalLM.from_config(jcfg, seed=0)
    tcfg = common.port_config(tmix.MixtralConfig, jcfg)
    tmodel = common.port_model(tmix, tmix.MixtralForCausalLM, tcfg, common.np_tree(jmodel.params))
    ids = np.random.default_rng(6).integers(0, 256, size=(2, 10)).astype(np.int32)
    ref = jmodel.apply_fn(jmodel.params, input_ids=jnp.asarray(ids))
    dispatched = bm.dispatch_model(tmodel, {"": 0, "layers.1": "disk", "lm_head": "cpu"},
                                   main_device="cpu", offload_dir=str(tmp_path))
    np.testing.assert_allclose(dispatched(input_ids=ids).logits.numpy(),
                               np.asarray(ref["logits"]), rtol=1e-5, atol=1e-5)


def test_dispatch_rejects_incomplete_device_map(pairs):
    with pytest.raises(ValueError, match="does not cover"):
        bm.dispatch_model(_copy_of(pairs["llama"][1]), {"layers": "cpu"}, main_device="cpu")
    with pytest.raises(ValueError, match="no offload_dir"):
        bm.dispatch_model(_copy_of(pairs["llama"][1]), {"": "disk"}, main_device="cpu")


def _hf_llama(model):
    """An HF-named state dict of the port llama (the inverse of its
    converter)."""
    sd = {"model.embed_tokens.weight": model.embed_tokens.weight.detach().clone(),
          "model.norm.weight": model.norm.detach().clone(),
          "lm_head.weight": model.lm_head.weight.detach().clone()}
    for i, layer in enumerate(model.layers):
        for ours, theirs in tllama._HF_LAYER_NAMES.items():
            t = getattr(layer, ours)
            sd[f"model.layers.{i}.{theirs}"] = (t if ours in tllama._NORMS else t.weight).detach()
    return sd


def test_load_checkpoint_in_model_with_hf_names(pairs, tmp_path):
    """An HF-named checkpoint loads into a meta-built model through its
    converter: the source's weights, on the host under a device map."""
    from safetensors.torch import save_file

    src = pairs["llama"][1]
    save_file({k: v.contiguous() for k, v in _hf_llama(src).items()},
              str(tmp_path / "model.safetensors"))
    with bm.init_empty_weights():
        dst = tllama.LlamaForCausalLM(src.config)
    bm.load_checkpoint_in_model(dst, str(tmp_path), device_map={"": "cpu"})
    for (n, a), (_, b) in zip(dst.named_parameters(), src.named_parameters()):
        assert a.device.type == "cpu" and torch.equal(a, b), n


@pytest.mark.parametrize("name", ["llama", "opt"])
def test_load_checkpoint_and_dispatch_auto(pairs, tmp_path, name):
    """The reference's one-call path on the CPU: a meta model, a checkpoint
    in the port's own names, ``device_map="auto"`` over a budget that puts
    layers on every tier: JAX's logits, and JAX's map."""
    jmodel, tmodel = pairs[name]
    tmodeling.save_safetensors(dict(tmodel.named_parameters()),
                               str(tmp_path / "model.safetensors"))
    total = sum(p.numel() * 4 for p in tmodel.parameters())
    budget = {0: int(0.35 * total), "cpu": int(0.3 * total), "disk": float("inf")}
    with bm.init_empty_weights():
        empty = FAMILIES[name][3](tmodel.config)
    loaded = bm.load_checkpoint_and_dispatch(empty, str(tmp_path / "model.safetensors"),
                                             device_map="auto", max_memory=budget,
                                             offload_folder=str(tmp_path / "offload"),
                                             main_device="cpu")
    assert set(map(str, loaded.hf_device_map.values())) == {"0", "cpu", "disk"}
    jshapes = jmodeling.flat_param_shapes(jmodel, expand_stacked=jmodel.stacked_params_prefix)
    jmap = jmodeling.infer_auto_device_map(jshapes, max_memory=budget)
    assert {FAMILIES[name][2].jax_param_name(k): v
            for k, v in loaded.hf_device_map.items()} == jmap
    batch = _batch(name, np.random.default_rng(7))
    ref = jmodel.apply_fn(jmodel.params, **{k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loaded(**batch).logits.numpy(), np.asarray(ref["logits"]),
                               rtol=1e-5, atol=1e-5)


def test_load_checkpoint_and_dispatch_resident_and_no_map(pairs, tmp_path):
    _, tmodel = pairs["gpt2"]
    tmodeling.save_safetensors(dict(tmodel.named_parameters()), str(tmp_path / "m.safetensors"))
    with bm.init_empty_weights():
        empty = tgpt2.GPT2LMHeadModel(tmodel.config)
    loaded = bm.load_checkpoint_and_dispatch(empty, str(tmp_path / "m.safetensors"),
                                             main_device="cpu")
    assert loaded is empty  # no map: the model itself, loaded where it lives
    ids = torch.randint(0, 256, (2, 8))
    with torch.no_grad():
        assert torch.equal(loaded(ids).logits, tmodel(ids).logits)


def _timed_model(n: int, sleep: float, log: list):
    """A model with a custom segment plan whose steps sleep ``sleep`` and
    log when they ran."""

    class Segmented(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i in range(n):
                self.register_parameter(f"w{i}", torch.nn.Parameter(torch.full((8,), float(i))))

        def segments(self, x):
            def step(i):
                def fn(seg, carry):
                    t0 = time.monotonic()
                    time.sleep(sleep)
                    log.append(("compute", i, t0, time.monotonic()))
                    return carry + float(seg[f"w{i}"].sum())

                return f"s{i}", [f"w{i}"], fn

            return {"init": lambda: float(x), "steps": [step(i) for i in range(n)],
                    "finalize": lambda c: c}

    return Segmented()


def test_streaming_reads_the_next_segments_while_one_computes(monkeypatch):
    """The three stages overlap: segment i+1's read and placement run while
    segment i computes (the reads are logged with their segment, and each
    starts before the previous segment's compute ends)."""
    n, sleep = 6, 0.03
    log = []
    orig_fetch = bm.TieredParams.fetch_host_or_disk

    def slow_fetch(self, path):
        t0 = time.monotonic()
        time.sleep(sleep)
        log.append(("read", int(path[1:]), t0, time.monotonic()))
        return orig_fetch(self, path)

    monkeypatch.setattr(bm.TieredParams, "fetch_host_or_disk", slow_fetch)
    dispatched = bm.cpu_offload(_timed_model(n, sleep, log), execution_device="cpu")
    assert dispatched(0.0) == sum(float(i) * 8 for i in range(n))
    reads = {i: (t0, t1) for kind, i, t0, t1 in log if kind == "read"}
    computes = {i: (t0, t1) for kind, i, t0, t1 in log if kind == "compute"}
    for i in range(n - 1):
        assert reads[i + 1][0] < computes[i][1], f"segment {i + 1} read after {i} computed"
    assert threading.active_count() >= 3  # the two workers stay for the next call
    dispatched.close()


def test_a_failed_segment_leaves_no_prefetch_running():
    log = []
    model = _timed_model(4, 0.0, log)
    base = model.segments

    def failing(x):
        plan = base(x)
        name, paths, _ = plan["steps"][1]

        def boom(seg, carry):
            raise RuntimeError("segment failed")

        plan["steps"][1] = (name, paths, boom)
        return plan

    model.segments = failing
    dispatched = bm.cpu_offload(model, execution_device="cpu")
    with pytest.raises(RuntimeError, match="segment failed"):
        dispatched(0.0)
    model.segments = base
    assert dispatched(0.0) == sum(float(i) * 8 for i in range(4))


def test_native_decoder_equals_jax():
    """``q4_decode_codes`` (the port's build of ``native/q4decode.c``) equals
    the JAX package's on the same packed bytes and codebook, and writes into
    a given buffer."""
    from accelerate_tpu import native as jnative
    from accelerate_tpu_torch import native as tnative

    rng = np.random.default_rng(8)
    packed = rng.integers(0, 256, size=(33, 40), dtype=np.uint8)
    lut = rng.integers(-127, 128, size=16).astype(np.int8)
    got = tnative.q4_decode_codes(packed, lut)
    ref = jnative.q4_decode_codes(packed, lut)
    assert got is not None and ref is not None
    assert got.ctypes.data % 64 == 0
    np.testing.assert_array_equal(got, ref)
    expect = np.empty((33, 80), np.int8)
    expect[:, 0::2], expect[:, 1::2] = lut[packed >> 4], lut[packed & 0xF]
    np.testing.assert_array_equal(got, expect)
    out = np.zeros((33, 80), np.int8)
    calls = tnative.decode_calls
    assert tnative.q4_decode_codes(packed, lut, out=out) is out and tnative.decode_calls == calls + 1
    np.testing.assert_array_equal(out, expect)
    with pytest.raises(ValueError, match="C-contiguous int8"):
        tnative.q4_decode_codes(packed, lut, out=np.zeros((33, 79), np.int8))
    assert tnative.library_path().parent.name == "native"
