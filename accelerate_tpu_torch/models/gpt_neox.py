"""GPT-NeoX causal LM and its GPT-J variant (port of
``accelerate_tpu/models/gpt_neox.py``): a parallel-residual block
(``x + attn(ln1(x)) + mlp(ln2(x))``), rotary embeddings on the first
``rotary_dim`` dims of each head, a GELU MLP and an untied head. GPT-J
(``shared_layernorm=True``, ``attention_bias=False``) reads one LayerNorm
in both branches, has no q/k/v/output biases, a head bias, and the tanh
GELU. The forward, prefill and decode step are
:class:`~.gpt2.CausalLM`'s; the converters take HF's ``gpt_neox`` and
``gptj`` layouts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.fp8 import dense
from ..ops.layers import apply_rope, rope_frequencies, table_rows
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf
from .gpt2 import CausalLM, hf_getter, layer_norm


@dataclass
class GPTNeoXConfig:
    vocab_size: int = 50432
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 2048
    rotary_pct: float = 0.25  # fraction of head_dim that rotates
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    use_parallel_residual: bool = True
    shared_layernorm: bool = False
    attention_bias: bool = True
    #: None: exact erf for NeoX, tanh for GPT-J (``shared_layernorm``)
    gelu_approximate: bool | None = None
    remat: bool | str = False  # False | True | a jax.checkpoint_policies name

    def __post_init__(self):
        remat_policy(self.remat)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def rotary_dim(self) -> int:
        return int(self.head_dim * self.rotary_pct)

    @classmethod
    def tiny(cls, vocab_size=256, hidden_size=64, layers=2, heads=4, seq=128, **kw):
        return cls(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=4 * hidden_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            max_position_embeddings=seq,
            **kw,
        )

    @classmethod
    def neox_20b(cls):
        return cls(
            vocab_size=50432, hidden_size=6144, intermediate_size=24576,
            num_hidden_layers=44, num_attention_heads=64, rotary_pct=0.25,
        )

    @classmethod
    def pythia_1_4b(cls):
        return cls(
            vocab_size=50304, hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=24, num_attention_heads=16, rotary_pct=0.25,
        )

    @classmethod
    def gptj_6b(cls):
        return cls(
            vocab_size=50400, hidden_size=4096, intermediate_size=16384,
            num_hidden_layers=28, num_attention_heads=16,
            rotary_pct=0.25,  # rotary_dim 64 of head_dim 256
            shared_layernorm=True, attention_bias=False,
        )


def gpt_neox_spec(c: GPTNeoXConfig) -> dict:
    h, ff = c.hidden_size, c.intermediate_size
    layer = {
        "ln1_g": Leaf((h,), "ones"), "ln1_b": Leaf((h,), "zeros"),
        "w_qkv": Leaf((3 * h, h), 0.02), "w_proj": Leaf((h, h), 0.02),
        "w_fc": Leaf((ff, h), 0.02), "b_fc": Leaf((ff,), "zeros"),
        "w_out": Leaf((h, ff), 0.02), "b_out": Leaf((h,), "zeros"),
    }
    if not c.shared_layernorm:
        layer.update(ln2_g=Leaf((h,), "ones"), ln2_b=Leaf((h,), "zeros"))
    if c.attention_bias:
        layer.update(b_qkv=Leaf((3 * h,), "zeros"), b_proj=Leaf((h,), "zeros"))
    spec = {
        "wte": Leaf((c.vocab_size, h), 0.02),
        "layers": [dict(layer) for _ in range(c.num_hidden_layers)],
        "ln_f_g": Leaf((h,), "ones"), "ln_f_b": Leaf((h,), "zeros"),
        "lm_head": Leaf((c.vocab_size, h), 0.02),  # untied (NeoX embed_out)
    }
    if not c.attention_bias:
        spec["lm_head_b"] = Leaf((c.vocab_size,), "zeros")  # GPT-J's head bias
    return spec


def init_gpt_neox_params(generator: torch.Generator, config: GPTNeoXConfig,
                         dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`GPTNeoXForCausalLM`."""
    return _params.init_state_dict(generator, gpt_neox_spec(config), dtype, device)


_NEOX_PROJ = ("w_qkv", "w_proj", "w_fc", "w_out", "lm_head")


def params_from_jax(np_params, config: GPTNeoXConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict."""
    return _params.state_dict_from_jax(np_params, _params.transposed(_NEOX_PROJ))


jax_param_name = _params.jax_param_name


def _gelu(c: GPTNeoXConfig, x):
    """Family-resolved GELU: exact erf for NeoX, tanh for GPT-J (identified
    by its shared LayerNorm) unless ``gelu_approximate`` forces one."""
    approx = c.gelu_approximate
    if approx is None:
        approx = c.shared_layernorm
    return F.gelu(x, approximate="tanh" if approx else "none")


def _partial_rope(x, cos, sin, positions, rotary_dim: int):
    """Rotate the first ``rotary_dim`` dims of each head, pass the rest."""
    return torch.cat([apply_rope(x[..., :rotary_dim], cos, sin, positions),
                      x[..., rotary_dim:]], dim=-1)


def convert_hf_gpt_neox_state_dict(flat: dict, config: GPTNeoXConfig) -> dict[str, torch.Tensor]:
    """An HF transformers GPT-NeoX state dict → this model's (port of JAX
    ``convert_hf_gpt_neox_state_dict``). HF fuses QKV as ``[3h, h]`` rows
    interleaved per head (``[head0-q, head0-k, head0-v, head1-q, ...]``);
    here Q|K|V are contiguous, so the rows are de-interleaved. HF's rotary
    is rotate-half over the first ``rotary_dim`` dims, as here."""
    c = config
    nh, hd = c.num_attention_heads, c.head_dim
    get = hf_getter(flat, ("gpt_neox.", ""))

    def qkv(t):  # [3h, ...] interleaved by head → [3h, ...] Q | K | V
        t = t.reshape(nh, 3, hd, *t.shape[1:])
        return torch.cat([t[:, j].reshape(nh * hd, *t.shape[3:]) for j in range(3)])

    names = {
        "ln1_g": "input_layernorm.weight", "ln1_b": "input_layernorm.bias",
        "w_proj": "attention.dense.weight", "b_proj": "attention.dense.bias",
        "ln2_g": "post_attention_layernorm.weight", "ln2_b": "post_attention_layernorm.bias",
        "w_fc": "mlp.dense_h_to_4h.weight", "b_fc": "mlp.dense_h_to_4h.bias",
        "w_out": "mlp.dense_4h_to_h.weight", "b_out": "mlp.dense_4h_to_h.bias",
    }
    sd = {"wte": get("embed_in.weight"), "ln_f_g": get("final_layer_norm.weight"),
          "ln_f_b": get("final_layer_norm.bias"),
          "lm_head": hf_getter(flat, ("",))("embed_out.weight")}
    for i in range(c.num_hidden_layers):
        for ours, theirs in names.items():
            sd[f"layers.{i}.{ours}"] = get(f"layers.{i}.{theirs}")
        sd[f"layers.{i}.w_qkv"] = qkv(get(f"layers.{i}.attention.query_key_value.weight"))
        sd[f"layers.{i}.b_qkv"] = qkv(get(f"layers.{i}.attention.query_key_value.bias"))
    return sd


def convert_hf_gptj_state_dict(flat: dict, config: GPTNeoXConfig) -> dict[str, torch.Tensor]:
    """An HF transformers GPT-J state dict → this model's (``shared_layernorm``,
    no attention biases; port of JAX ``convert_hf_gptj_state_dict``). GPT-J
    rotates every two dims (pairs ``(x0, x1), (x2, x3), ...``) where this
    model rotates halves, so the q and k rows are permuted within the rotary
    span of each head: even rows first, then odd. Both orders give the same
    attention scores."""
    c = config
    rd, nh, hd = c.rotary_dim, c.num_attention_heads, c.head_dim
    perm_head = np.concatenate([np.arange(0, rd, 2), np.arange(1, rd, 2), np.arange(rd, hd)])
    perm = torch.as_tensor(np.concatenate([perm_head + i * hd for i in range(nh)]))
    get = hf_getter(flat, ("transformer.", ""))
    top = hf_getter(flat, ("",))
    names = {
        "ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias", "w_proj": "attn.out_proj.weight",
        "w_fc": "mlp.fc_in.weight", "b_fc": "mlp.fc_in.bias",
        "w_out": "mlp.fc_out.weight", "b_out": "mlp.fc_out.bias",
    }
    sd = {"wte": get("wte.weight"), "ln_f_g": get("ln_f.weight"), "ln_f_b": get("ln_f.bias"),
          "lm_head": top("lm_head.weight"), "lm_head_b": top("lm_head.bias")}
    for i in range(c.num_hidden_layers):
        for ours, theirs in names.items():
            sd[f"layers.{i}.{ours}"] = get(f"h.{i}.{theirs}")
        sd[f"layers.{i}.w_qkv"] = torch.cat([
            get(f"h.{i}.attn.q_proj.weight")[perm], get(f"h.{i}.attn.k_proj.weight")[perm],
            get(f"h.{i}.attn.v_proj.weight")])
    return sd


class GPTNeoXForCausalLM(CausalLM):
    """GPT-NeoX / GPT-J (port of the JAX ``GPTNeoXForCausalLM``)."""

    _spec = staticmethod(gpt_neox_spec)

    def __init__(self, config: GPTNeoXConfig, dtype=torch.float32, device=None):
        super().__init__(config, dtype=dtype, device=device)
        cos, sin = rope_frequencies(config.rotary_dim, config.max_position_embeddings,
                                    config.rope_theta,
                                    device=_params.buffer_device(self.device))
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    _embed_leaves = ("wte",)
    _head_leaves = ("ln_f_g", "ln_f_b", "lm_head", "lm_head_b")

    def _embed(self, input_ids, positions, w=None):
        w = self._parameters if w is None else w
        return w["wte"][table_rows(input_ids, self.config.vocab_size)]

    def _head(self, w=None):
        w = self._parameters if w is None else w
        return w["lm_head"], w.get("lm_head_b")

    def _block(self, w, x, positions, attend):
        """One parallel-residual block (port of ``gpt_neox_layer_apply``):
        both branches read the block's input unless
        ``use_parallel_residual`` is off."""
        c = self.config
        b, s, h = x.shape
        nh, hd = c.num_attention_heads, c.head_dim
        y = layer_norm(x, w["ln1_g"], w["ln1_b"], c.layer_norm_eps)
        qkv = dense(y, w["w_qkv"])
        if c.attention_bias:
            qkv = qkv + w["b_qkv"]
        q, k, v = (z.reshape(b, s, nh, hd) for z in qkv.split(h, dim=-1))
        q = _partial_rope(q, self.rope_cos, self.rope_sin, positions, c.rotary_dim)
        k = _partial_rope(k, self.rope_cos, self.rope_sin, positions, c.rotary_dim)
        attn_out = dense(attend(q, k, v).reshape(b, s, h), w["w_proj"])
        if c.attention_bias:
            attn_out = attn_out + w["b_proj"]
        if not c.use_parallel_residual:
            x = x + attn_out
            attn_out = 0.0  # folded in already; the final add is the MLP's alone
        y2 = y if c.shared_layernorm else layer_norm(x, w["ln2_g"], w["ln2_b"],
                                                     c.layer_norm_eps)
        mlp_out = dense(_gelu(c, dense(y2, w["w_fc"]) + w["b_fc"]), w["w_out"]) + w["b_out"]
        return x + attn_out + mlp_out

    def convert_state_dict(self, flat: dict) -> dict[str, torch.Tensor]:
        """An HF-layout state dict (GPT-J's when ``shared_layernorm``) as
        this model's, for ``load_state_dict``."""
        convert = (convert_hf_gptj_state_dict if self.config.shared_layernorm
                   else convert_hf_gpt_neox_state_dict)
        return convert(flat, self.config)
