from .llama import (
    LlamaConfig,
    LlamaForCausalLM,
    init_llama_params,
    params_from_jax,
)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "init_llama_params", "params_from_jax"]
