"""OPT causal LM (port of ``accelerate_tpu/models/opt.py``): a pre-LN
decoder with learned positions (HF's +2 offset folded away by the
converter), separate biased q/k/v projections, a ReLU MLP and the LM head
tied to ``wte``. Sizes with ``word_embed_proj_dim != hidden_size`` (only
opt-350m) are not supported, as in JAX. The forward, prefill, decode step
and streaming segments are :class:`~.gpt2.CausalLM`'s.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..parallel.sharding import NO_TP
from ..parallel.sharding import PartitionSpec as P
from ..ops.fp8 import dense
from ..ops.layers import table_rows
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf
from .gpt2 import CausalLM, hf_getter, layer_norm


@dataclass
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    remat: bool | str = False  # False | True | a jax.checkpoint_policies name

    def __post_init__(self):
        remat_policy(self.remat)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size=256, hidden_size=64, layers=2, heads=4, seq=128):
        return cls(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=4 * hidden_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            max_position_embeddings=seq,
        )

    @classmethod
    def opt_1_3b(cls):
        return cls(hidden_size=2048, intermediate_size=8192,
                   num_hidden_layers=24, num_attention_heads=32)

    @classmethod
    def opt_6_7b(cls):
        return cls(hidden_size=4096, intermediate_size=16384,
                   num_hidden_layers=32, num_attention_heads=32)

    @classmethod
    def opt_13b(cls):
        return cls(hidden_size=5120, intermediate_size=20480,
                   num_hidden_layers=40, num_attention_heads=40)

    @classmethod
    def opt_30b(cls):
        return cls(hidden_size=7168, intermediate_size=28672,
                   num_hidden_layers=48, num_attention_heads=56)


def opt_spec(c: OPTConfig) -> dict:
    h, ff = c.hidden_size, c.intermediate_size
    layer = {"ln1_g": Leaf((h,), "ones"), "ln1_b": Leaf((h,), "zeros")}
    for n in ("q", "k", "v"):
        layer[f"w_{n}"] = Leaf((h, h), 0.02)
        layer[f"b_{n}"] = Leaf((h,), "zeros")
    layer.update({
        "w_proj": Leaf((h, h), 0.02), "b_proj": Leaf((h,), "zeros"),
        "ln2_g": Leaf((h,), "ones"), "ln2_b": Leaf((h,), "zeros"),
        "w_fc": Leaf((ff, h), 0.02), "b_fc": Leaf((ff,), "zeros"),
        "w_out": Leaf((h, ff), 0.02), "b_out": Leaf((h,), "zeros"),
    })
    return {
        "wte": Leaf((c.vocab_size, h), 0.02),
        "wpe": Leaf((c.max_position_embeddings, h), 0.02),
        "layers": [dict(layer) for _ in range(c.num_hidden_layers)],
        "ln_f_g": Leaf((h,), "ones"), "ln_f_b": Leaf((h,), "zeros"),
    }


def init_opt_params(generator: torch.Generator, config: OPTConfig, dtype=torch.float32,
                    device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`OPTForCausalLM`."""
    return _params.init_state_dict(generator, opt_spec(config), dtype, device)


_OPT_PROJ = ("w_q", "w_k", "w_v", "w_proj", "w_fc", "w_out")


def params_from_jax(np_params, config: OPTConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict."""
    return _params.state_dict_from_jax(np_params, _params.transposed(_OPT_PROJ))


jax_param_name = _params.jax_param_name


def convert_hf_opt_state_dict(flat: dict, config: OPTConfig) -> dict[str, torch.Tensor]:
    """An HF transformers OPT state dict (``model.decoder.layers.{i}...``) →
    this model's state dict (port of JAX ``convert_hf_opt_state_dict``).
    HF's ``nn.Linear`` weights are ``[out, in]`` already; HF's position
    table carries the legacy +2 row offset, which is sliced away so
    positions index it directly."""
    names = {
        "ln1_g": "self_attn_layer_norm.weight", "ln1_b": "self_attn_layer_norm.bias",
        "w_q": "self_attn.q_proj.weight", "b_q": "self_attn.q_proj.bias",
        "w_k": "self_attn.k_proj.weight", "b_k": "self_attn.k_proj.bias",
        "w_v": "self_attn.v_proj.weight", "b_v": "self_attn.v_proj.bias",
        "w_proj": "self_attn.out_proj.weight", "b_proj": "self_attn.out_proj.bias",
        "ln2_g": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
        "w_fc": "fc1.weight", "b_fc": "fc1.bias", "w_out": "fc2.weight", "b_out": "fc2.bias",
    }
    get = hf_getter(flat, ("model.decoder.", "decoder.", ""))
    wpe = get("embed_positions.weight")
    if wpe.shape[0] == config.max_position_embeddings + 2:
        wpe = wpe[2:].clone()
    sd = {"wte": get("embed_tokens.weight"), "wpe": wpe,
          "ln_f_g": get("final_layer_norm.weight"), "ln_f_b": get("final_layer_norm.bias")}
    for i in range(config.num_hidden_layers):
        for ours, theirs in names.items():
            sd[f"layers.{i}.{ours}"] = get(f"layers.{i}.{theirs}")
    return sd


#: path regex → PartitionSpec over JAX's leaf names (the JAX package's
#: ``OPT_PARTITION_RULES``): a layer-stacked leaf has a leading
#: ``[layers]`` dim, which is never sharded
OPT_PARTITION_RULES = [
    (r"wte", P("tp", "fsdp")),
    (r"wpe", P(None, "fsdp")),
    (r"layers\.w_(q|k|v)", P(None, "fsdp", "tp")),
    (r"layers\.b_(q|k|v)", P(None, "tp")),
    (r"layers\.w_proj", P(None, "tp", "fsdp")),
    (r"layers\.w_fc", P(None, "fsdp", "tp")),
    (r"layers\.b_fc", P(None, "tp")),
    (r"layers\.w_out", P(None, "tp", "fsdp")),
    (r"layers\.(ln1|ln2)_(g|b)", P()),
    (r"layers\.(b_proj|b_out)", P()),
    (r"ln_f_(g|b)", P()),
]

#: the 2-D leaves JAX holds as ``[in, out]`` and the port as ``[out, in]``
#: (:func:`~..parallel.sharding.jax_leaves`)
JAX_TRANSPOSED = _OPT_PROJ


class OPTForCausalLM(CausalLM):
    """OPT (port of the JAX ``OPTForCausalLM``); the head is ``wte``."""

    partition_rules = OPT_PARTITION_RULES

    _spec = staticmethod(opt_spec)

    def _embed(self, input_ids, positions, w=None, tp=NO_TP):
        c = self.config
        w = self._leaves(w)
        return (self._lookup(w, input_ids, tp)
                + w["wpe"][table_rows(positions, c.max_position_embeddings)])

    def _head(self, w=None):
        return self._leaves(w)["wte"], None

    def _block(self, w, x, positions, attend, tp=NO_TP):
        """One pre-LN block (port of ``opt_layer_apply``): under tensor
        parallelism q, k, v and ``w_fc`` run column shards (this rank's
        heads and hidden units), ``w_proj`` and ``w_out`` row shards."""
        c = self.config
        b, s, h = x.shape
        nh, hd = tp.heads(c.num_attention_heads, "w_q"), c.head_dim
        y = tp.enter(layer_norm(x, w["ln1_g"], w["ln1_b"], c.layer_norm_eps), "w_q")
        q, k, v = ((dense(y, w[f"w_{n}"]) + w[f"b_{n}"]).reshape(b, s, nh, hd) for n in "qkv")
        attn = attend(q, k, v)
        x = x + tp.leave(dense(attn.reshape(b, s, nh * hd), w["w_proj"]), "w_proj") + w["b_proj"]
        y = tp.enter(layer_norm(x, w["ln2_g"], w["ln2_b"], c.layer_norm_eps), "w_fc")
        mlp = dense(torch.relu(dense(y, w["w_fc"]) + w["b_fc"]), w["w_out"])
        return x + tp.leave(mlp, "w_out") + w["b_out"]

    def convert_state_dict(self, flat: dict) -> dict[str, torch.Tensor]:
        """An HF-layout state dict as this model's, for ``load_state_dict``."""
        return convert_hf_opt_state_dict(flat, self.config)
