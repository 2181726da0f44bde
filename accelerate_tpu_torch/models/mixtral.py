"""Mixtral-style sparse-MoE causal LM (port of
``accelerate_tpu/models/mixtral.py``): the llama's attention block (RMSNorm,
RoPE, GQA through :func:`~..ops.attention.attention`) and a top-k routed
expert FFN with capacity-bounded one-hot dispatch and combine (the
GShard / Switch pattern, static shapes), plus the Switch load-balancing
loss, folded into ``loss`` with ``router_aux_loss_coef``.

The routing is plain PyTorch, as JAX computes it outside any Pallas
kernel. Expert weights keep JAX's ``[E, in, out]`` layout (the batched
products take it as it is); the other projections are ``[out, in]``. The
attention sub-block is the llama's own
(:func:`~..ops.layers.rope_attention_block`); the decode step is
:class:`~.gpt2.CausalLM`'s, attending through
:func:`~..ops.layers.cached_attend` as the llama's
``rope_cached_attention_block`` does, then the routed FFN over the step's
tokens (with the capacity those tokens give, as in JAX). The
expert-parallel all-to-all (``ep`` sharding) is ROADMAP item 18; JAX has no
HF converter for this family, so the port has none.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.layers import (
    fused_cross_entropy,
    rms_norm,
    rope_attention_block,
    rope_frequencies,
    shift_labels,
    table_rows,
)
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf
from .gpt2 import CausalLM


@dataclass
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 2.0
    router_aux_loss_coef: float = 0.02
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    remat: bool | str = True  # False | True | a jax.checkpoint_policies name

    def __post_init__(self):
        remat_policy(self.remat)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size=256, hidden_size=64, layers=2, heads=4, experts=4, top_k=2, seq=128):
        return cls(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 2,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            num_key_value_heads=heads,
            num_local_experts=experts,
            num_experts_per_tok=top_k,
            max_position_embeddings=seq,
            remat=False,
        )


def mixtral_spec(c: MixtralConfig) -> dict:
    """The parameters (port layout): ``N(0, 1/in)`` projections, ``N(0,
    0.02)`` embeddings, norms 1."""
    h, ff, E = c.hidden_size, c.intermediate_size, c.num_local_experts
    q, kv = c.num_attention_heads * c.head_dim, c.num_key_value_heads * c.head_dim
    layer = {
        "wq": Leaf((q, h), h ** -0.5), "wk": Leaf((kv, h), h ** -0.5),
        "wv": Leaf((kv, h), h ** -0.5), "wo": Leaf((h, q), q ** -0.5),
        "router": Leaf((E, h), h ** -0.5),
        "e_gate": Leaf((E, h, ff), h ** -0.5), "e_up": Leaf((E, h, ff), h ** -0.5),
        "e_down": Leaf((E, ff, h), ff ** -0.5),
        "attn_norm": Leaf((h,), "ones"), "mlp_norm": Leaf((h,), "ones"),
    }
    return {
        "embed_tokens": Leaf((c.vocab_size, h), 0.02),
        "layers": [dict(layer) for _ in range(c.num_hidden_layers)],
        "norm": Leaf((h,), "ones"),
        "lm_head": Leaf((c.vocab_size, h), h ** -0.5),
    }


def init_mixtral_params(generator: torch.Generator, config: MixtralConfig,
                        dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`MixtralForCausalLM`."""
    return _params.init_state_dict(generator, mixtral_spec(config), dtype, device)


def params_from_jax(np_params, config: MixtralConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict (the 2-D
    projections transposed; the experts' ``[E, in, out]`` kept)."""
    return _params.state_dict_from_jax(
        np_params, _params.transposed(("wq", "wk", "wv", "wo", "router", "lm_head")))


def top_k_routes(probs: torch.Tensor, k: int):
    """``jax.lax.top_k(probs, k)``: the ``k`` largest of each row, in
    descending order, a tie broken to the lower expert index. A stable
    descending sort keeps equal values in index order; ``torch.topk``
    promises no order among ties, and the order of a token's ``k`` choices
    decides which assignments overflow an expert's capacity."""
    values, index = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], index[:, :k]


def moe_ffn(config: MixtralConfig, w: dict, x: torch.Tensor):
    """Top-k routed expert FFN on one layer's weights (port of JAX
    ``moe_ffn``): ``x [b, s, h]`` → ``(y [b, s, h], aux_loss)``.

    Each token's ``k`` choices, in the flat ``(token, choice)`` order, take
    the next free slot of their expert's buffer of ``capacity`` rows; an
    assignment past it is dropped (it adds nothing to the output). The
    router runs in f32; dispatch, the experts and combine in ``x.dtype``."""
    c = config
    b, s, h = x.shape
    E, k = c.num_local_experts, c.num_experts_per_tok
    tokens = x.reshape(-1, h)  # [T, h]
    T = tokens.shape[0]
    capacity = min(int(np.ceil(c.capacity_factor * T * k / E)), T)

    logits = tokens.float() @ w["router"].float().t()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = top_k_routes(probs, k)  # [T, k]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)

    sel = F.one_hot(topk_idx, E)  # [T, k, E]
    flat_sel = sel.reshape(T * k, E)
    pos = torch.cumsum(flat_sel, dim=0) * flat_sel - 1  # [T*k, E]
    pos = pos.max(dim=-1).values.reshape(T, k)
    keep = (pos < capacity) & (pos >= 0)

    onehot_e = sel.to(x.dtype)
    onehot_c = F.one_hot(torch.where(keep, pos, capacity), capacity + 1).to(x.dtype)
    onehot_c = onehot_c[..., :capacity]  # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", onehot_e, onehot_c)  # [T, E, C]
    combine = torch.einsum("tke,tkc,tk->tec", onehot_e, onehot_c, topk_w.to(x.dtype))

    expert_in = torch.einsum("tec,th->ech", dispatch, tokens)  # [E, C, h]
    g = F.silu(torch.bmm(expert_in, w["e_gate"]))
    u = torch.bmm(expert_in, w["e_up"])
    expert_out = torch.bmm(g * u, w["e_down"])  # [E, C, h]
    y = torch.einsum("tec,ech->th", combine, expert_out).reshape(b, s, h)

    me = probs.mean(dim=0)  # [E]
    ce = sel.float().sum(dim=(0, 1)) / (T * k)
    return y, E * (me * ce).sum()


class MixtralForCausalLM(CausalLM):
    """Mixtral (port of the JAX ``MixtralForCausalLM``). ``forward`` returns
    JAX's keys: ``logits`` (unless only the loss is asked for, as in
    :meth:`~.gpt2.CausalLM.forward`), ``aux_loss`` (the per-layer mean of
    the load-balancing statistic), and with ``labels`` ``lm_loss`` and
    ``loss = lm_loss + router_aux_loss_coef · aux_loss``."""

    _spec = staticmethod(mixtral_spec)

    def __init__(self, config: MixtralConfig, dtype=torch.float32, device=None):
        super().__init__(config, dtype=dtype, device=device)
        cos, sin = rope_frequencies(config.head_dim, config.max_position_embeddings,
                                    config.rope_theta,
                                    device=_params.buffer_device(self.device))
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    #: JAX's Mixtral has no streaming plan: a DispatchedModel materialises it
    segments = None

    def _embed(self, input_ids, positions, w=None):
        w = self._parameters if w is None else w
        return w["embed_tokens"][table_rows(input_ids, self.config.vocab_size)]

    def _final(self, x, w=None):
        w = self._parameters if w is None else w
        return rms_norm(x, w["norm"], self.config.rms_norm_eps)

    def _head(self, w=None):
        return (self._parameters if w is None else w)["lm_head"], None

    def _block(self, w, x, positions, attend):
        """One block (port of ``mixtral_layer_apply``): the llama's
        attention, then the routed FFN. Returns ``(x, aux)``."""
        c = self.config
        x = rope_attention_block(w, x, self.rope_cos, self.rope_sin, positions, attend,
                                 c.num_attention_heads, c.num_key_value_heads, c.head_dim,
                                 c.rms_norm_eps)
        moe_out, aux = moe_ffn(c, w, rms_norm(x, w["mlp_norm"], c.rms_norm_eps))
        return x + moe_out, aux

    def _add_losses(self, out, x, labels, aux_total) -> None:
        c = self.config
        out["aux_loss"] = aux_total / c.num_hidden_layers
        if labels is not None:
            lm_loss = fused_cross_entropy(x, self.lm_head.t(), shift_labels(labels))
            out["lm_loss"] = lm_loss
            out["loss"] = lm_loss + c.router_aux_loss_coef * out["aux_loss"]
