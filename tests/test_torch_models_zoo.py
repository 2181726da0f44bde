"""The port's model zoo against the JAX package's: the same names with the
same config values (the port's configs have every field but
``pipeline_microbatches``, the GPipe knob of ROADMAP item 18),
``config_from_hf_json`` on one ``config.json`` a ``model_type`` written to
``tmp_path``, and ``model_factory_for_config`` naming each family's model.
No model is built at its published size: the factories are checked by the
class they build from a tiny config on the CPU.
"""

import dataclasses
import json

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.models as jmodels  # noqa: E402
import accelerate_tpu_torch.models as tmodels  # noqa: E402

JAX_ZOO = jmodels.MODEL_ZOO
PORT_ZOO = tmodels.MODEL_ZOO


def _fields(config) -> dict:
    return {k: v for k, v in dataclasses.asdict(config).items() if k != "pipeline_microbatches"}


def test_the_zoo_has_jax_names():
    assert list(PORT_ZOO) == list(JAX_ZOO)


@pytest.mark.parametrize("name", list(JAX_ZOO))
def test_each_zoo_config_equals_jax(name):
    jcfg, _ = JAX_ZOO[name]
    tcfg, factory = PORT_ZOO[name]
    assert type(tcfg).__name__ == type(jcfg).__name__
    assert _fields(tcfg) == _fields(jcfg)
    assert {f.name for f in dataclasses.fields(jcfg)} - {
        f.name for f in dataclasses.fields(tcfg)} <= {"pipeline_microbatches"}
    assert callable(factory)


#: model_type -> an HF config.json's entries (sizes kept small but off the defaults)
HF_CONFIGS = {
    "llama": {"hidden_size": 128, "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 3, "rope_theta": 500000.0, "tie_word_embeddings": True},
    "mistral": {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 8},
    "gpt2": {"n_embd": 96, "n_layer": 3, "n_head": 3, "n_positions": 256, "vocab_size": 1000},
    "bert": {"hidden_size": 96, "intermediate_size": 200, "num_hidden_layers": 2,
             "num_attention_heads": 3, "type_vocab_size": 3, "layer_norm_eps": 1e-7},
    "vit": {"image_size": 64, "patch_size": 8, "num_channels": 1, "hidden_size": 96},
    "opt": {"hidden_size": 128, "ffn_dim": 512, "num_hidden_layers": 2,
            "num_attention_heads": 4, "max_position_embeddings": 512},
    "gpt_neox": {"hidden_size": 128, "num_attention_heads": 4, "rotary_pct": 0.5,
                 "rotary_emb_base": 20000.0, "use_parallel_residual": False},
    "gptj": {"n_embd": 256, "n_head": 4, "n_layer": 2, "rotary_dim": 16, "n_inner": None},
    "mixtral": {"hidden_size": 256, "num_attention_heads": 8, "num_key_value_heads": 2,
                "num_local_experts": 4, "num_experts_per_tok": 1},
    "t5": {"d_model": 128, "d_kv": 32, "num_layers": 2, "feed_forward_proj": "relu"},
    "mt5": {"d_model": 128, "num_layers": 3, "num_decoder_layers": 2,
            "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False},
}


@pytest.mark.parametrize("model_type", list(HF_CONFIGS))
def test_config_from_hf_json_equals_jax(tmp_path, model_type):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"model_type": model_type, **HF_CONFIGS[model_type]}))
    jcfg = jmodels.config_from_hf_json(str(path))
    tcfg = tmodels.config_from_hf_json(str(path))
    assert type(tcfg).__name__ == type(jcfg).__name__
    assert _fields(tcfg) == _fields(jcfg)


def test_config_from_hf_json_refuses_as_jax(tmp_path):
    for entries in ({"model_type": "bloom"},
                    {"model_type": "opt", "hidden_size": 1024, "word_embed_proj_dim": 512}):
        path = tmp_path / "config.json"
        path.write_text(json.dumps(entries))
        with pytest.raises(ValueError) as jerr:
            jmodels.config_from_hf_json(str(path))
        with pytest.raises(ValueError) as terr:
            tmodels.config_from_hf_json(str(path))
        assert str(terr.value) == str(jerr.value)


#: config class name -> (module, the model class JAX's factory builds)
FAMILIES = {
    "LlamaConfig": ("llama", "LlamaForCausalLM"),
    "GPT2Config": ("gpt2", "GPT2LMHeadModel"),
    "OPTConfig": ("opt", "OPTForCausalLM"),
    "GPTNeoXConfig": ("gpt_neox", "GPTNeoXForCausalLM"),
    "MixtralConfig": ("mixtral", "MixtralForCausalLM"),
    "BertConfig": ("bert", "BertForSequenceClassification"),
    "T5Config": ("t5", "T5ForConditionalGeneration"),
    "ResNetConfig": ("resnet", "ResNetForImageClassification"),
    "ViTConfig": ("vit", "ViTForImageClassification"),
}


@pytest.mark.parametrize("config_name", list(FAMILIES))
def test_model_factory_for_config_builds_the_family(config_name):
    import importlib

    module, cls = FAMILIES[config_name]
    tiny = getattr(importlib.import_module(f"accelerate_tpu_torch.models.{module}"),
                   config_name).tiny()
    factory = tmodels.model_factory_for_config(tiny)
    model = factory(tiny, device="cpu")
    assert type(model).__name__ == cls
    assert all(p.device.type == "cpu" for p in model.parameters())
    if not torch.cuda.is_available():  # the card by default, and no quiet CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory(tiny)
    with pytest.raises(ValueError, match="no factory"):
        tmodels.model_factory_for_config(object())
