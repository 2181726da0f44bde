"""The model zoo (port of ``accelerate_tpu/models/__init__.py``): nine
families, :data:`MODEL_ZOO` (name → ``(config, factory)``, built lazily:
building it imports every family), :func:`config_from_hf_json` (an HF
``config.json`` onto a zoo config by ``model_type``) and
:func:`model_factory_for_config`. A factory takes the config and builds
the model with random weights on the card (``from_config``'s defaults);
JAX's ``init_empty_weights`` shapes-only path is ROADMAP item 19.
"""

from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    init_llama_params,
    params_from_jax,
)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "init_llama_params", "params_from_jax",
           "config_from_hf_json", "model_factory_for_config"]


def _zoo():
    """name → (config, factory), the names and configs of the JAX zoo."""
    from .bert import BertConfig
    from .gpt2 import GPT2Config
    from .gpt_neox import GPTNeoXConfig
    from .mixtral import MixtralConfig
    from .opt import OPTConfig
    from .resnet import ResNetConfig
    from .t5 import T5Config
    from .vit import ViTConfig

    def llama(**kw):
        # JAX's LlamaConfig defaults to remat=True; the port's to False
        return LlamaConfig(remat=True, **kw)

    entries = {
        "llama2-7b": LlamaConfig.llama2_7b(),
        "llama2-13b": llama(hidden_size=5120, intermediate_size=13824, num_hidden_layers=40,
                            num_attention_heads=40, num_key_value_heads=40),
        "llama2-70b": llama(hidden_size=8192, intermediate_size=28672, num_hidden_layers=80,
                            num_attention_heads=64, num_key_value_heads=8),
        "tiny-llama": LlamaConfig.tiny(),
        "gpt2": GPT2Config(),
        "gpt2-xl": GPT2Config(hidden_size=1600, num_hidden_layers=48, num_attention_heads=25),
        "bert-base": BertConfig(),
        "mixtral-8x7b": MixtralConfig(),
        "t5-small": T5Config.t5_small(),
        "t5-base": T5Config.t5_base(),
        "t5-11b": T5Config.t5_11b(),
        "opt-125m": OPTConfig(),
        "opt-1.3b": OPTConfig.opt_1_3b(),
        "opt-6.7b": OPTConfig.opt_6_7b(),
        "opt-13b": OPTConfig.opt_13b(),
        "opt-30b": OPTConfig.opt_30b(),
        "pythia-1.4b": GPTNeoXConfig.pythia_1_4b(),
        "gpt-neox-20b": GPTNeoXConfig.neox_20b(),
        "gpt-j-6b": GPTNeoXConfig.gptj_6b(),
        "resnet50d": ResNetConfig.resnet50d(),
        "vit-base-patch16-224": ViTConfig.vit_b16(),
    }
    return {name: (config, model_factory_for_config(config)) for name, config in entries.items()}


def __getattr__(name):
    # built lazily: the zoo imports every family
    if name == "MODEL_ZOO":
        return _zoo()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def config_from_hf_json(path: str):
    """Map an HF transformers ``config.json`` onto a zoo config by
    ``model_type`` (every type JAX maps, with JAX's defaults)."""
    import json

    with open(path) as f:
        d = json.load(f)
    mt = d.get("model_type", "llama")
    if mt in ("llama", "mistral"):
        return LlamaConfig(
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 11008),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_key_value_heads", d.get("num_attention_heads", 32)),
            max_position_embeddings=d.get("max_position_embeddings", 4096),
            rope_theta=d.get("rope_theta", 10000.0),
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            remat=True,  # JAX LlamaConfig's default
        )
    if mt == "gpt2":
        from .gpt2 import GPT2Config

        return GPT2Config(
            vocab_size=d.get("vocab_size", 50257),
            hidden_size=d.get("n_embd", 768),
            num_hidden_layers=d.get("n_layer", 12),
            num_attention_heads=d.get("n_head", 12),
            max_position_embeddings=d.get("n_positions", 1024),
        )
    if mt == "bert":
        from .bert import BertConfig

        return BertConfig(
            vocab_size=d.get("vocab_size", 30522),
            hidden_size=d.get("hidden_size", 768),
            intermediate_size=d.get("intermediate_size", 3072),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            max_position_embeddings=d.get("max_position_embeddings", 512),
            type_vocab_size=d.get("type_vocab_size", 2),
            norm_eps=d.get("layer_norm_eps", 1e-12),
        )
    if mt == "vit":
        from .vit import ViTConfig

        return ViTConfig(
            image_size=d.get("image_size", 224),
            patch_size=d.get("patch_size", 16),
            in_channels=d.get("num_channels", 3),
            hidden_size=d.get("hidden_size", 768),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            intermediate_size=d.get("intermediate_size", 3072),
            layer_norm_eps=d.get("layer_norm_eps", 1e-6),
        )
    if mt == "opt":
        from .opt import OPTConfig

        if d.get("word_embed_proj_dim", d.get("hidden_size", 768)) != d.get("hidden_size", 768):
            raise ValueError(
                "OPT checkpoints with word_embed_proj_dim != hidden_size "
                "(opt-350m) are not supported"
            )
        return OPTConfig(
            vocab_size=d.get("vocab_size", 50272),
            hidden_size=d.get("hidden_size", 768),
            intermediate_size=d.get("ffn_dim", 3072),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
        )
    if mt == "gpt_neox":
        from .gpt_neox import GPTNeoXConfig

        return GPTNeoXConfig(
            vocab_size=d.get("vocab_size", 50432),
            hidden_size=d.get("hidden_size", 768),
            intermediate_size=d.get("intermediate_size", 3072),
            num_hidden_layers=d.get("num_hidden_layers", 12),
            num_attention_heads=d.get("num_attention_heads", 12),
            max_position_embeddings=d.get("max_position_embeddings", 2048),
            rotary_pct=d.get("rotary_pct", 0.25),
            rope_theta=d.get("rotary_emb_base", 10000.0),
            use_parallel_residual=d.get("use_parallel_residual", True),
        )
    if mt == "gptj":
        from .gpt_neox import GPTNeoXConfig

        h = d.get("n_embd", 4096)
        heads = d.get("n_head", 16)
        return GPTNeoXConfig(
            vocab_size=d.get("vocab_size", 50400),
            hidden_size=h,
            intermediate_size=d.get("n_inner") or 4 * h,
            num_hidden_layers=d.get("n_layer", 28),
            num_attention_heads=heads,
            max_position_embeddings=d.get("n_positions", 2048),
            rotary_pct=d.get("rotary_dim", 64) / (h // heads),
            shared_layernorm=True,
            attention_bias=False,
        )
    if mt == "mixtral":
        from .mixtral import MixtralConfig

        return MixtralConfig(
            vocab_size=d.get("vocab_size", 32000),
            hidden_size=d.get("hidden_size", 4096),
            intermediate_size=d.get("intermediate_size", 14336),
            num_hidden_layers=d.get("num_hidden_layers", 32),
            num_attention_heads=d.get("num_attention_heads", 32),
            num_key_value_heads=d.get("num_key_value_heads", 8),
            num_local_experts=d.get("num_local_experts", 8),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
        )
    if mt in ("t5", "mt5"):
        from .t5 import T5Config

        return T5Config(
            vocab_size=d.get("vocab_size", 32128),
            hidden_size=d.get("d_model", 512),
            d_kv=d.get("d_kv", 64),
            d_ff=d.get("d_ff", 2048),
            num_layers=d.get("num_layers", 6),
            num_decoder_layers=d.get("num_decoder_layers", d.get("num_layers", 6)),
            num_heads=d.get("num_heads", 8),
            relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
            feed_forward_proj=(
                "gated-gelu" if "gated" in d.get("feed_forward_proj", "relu") else "relu"
            ),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
        )
    raise ValueError(f"unsupported model_type {mt!r}")


#: config class name → (module, model class)
_FAMILIES = {
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


def model_factory_for_config(config):
    """``factory(config, **kw)`` → the config's family's model,
    ``from_config(config, **kw)``: random weights from seed 0 on the card
    unless ``kw`` says otherwise (``seed``, ``dtype``, ``device``)."""
    import importlib

    name = type(config).__name__
    if name not in _FAMILIES:
        raise ValueError(f"no factory for {name}")
    module, cls = _FAMILIES[name]
    model_cls = getattr(importlib.import_module(f".{module}", __name__), cls)
    return lambda c, **kw: model_cls.from_config(c, **kw)
