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

from ..parallel.sharding import PartitionSpec as P
import torch.distributed as dist

from ..ops.attention import attention
from ..ops.layers import rms_norm, rope_attention_block, rope_frequencies
from ..parallel.context import all_reduce_sum, sequence_shard
from ..parallel.sharding import NO_TP
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


def moe_ffn(config: MixtralConfig, w: dict, x: torch.Tensor, tp=NO_TP, route=None):
    """Top-k routed expert FFN on one layer's weights (port of JAX
    ``moe_ffn``): ``x [b, s, h]`` → ``(y [b, s, h], aux_loss)``.

    Each token's ``k`` choices, in the flat ``(token, choice)`` order, take
    the next free slot of their expert's buffer of ``capacity`` rows; an
    assignment past it is dropped (it adds nothing to the output). The
    router runs in f32; dispatch, the experts and combine in ``x.dtype``.

    ``route`` (:func:`routing_group`): the tokens are this rank's block of
    a global batch spread over a process group, as JAX's global arrays are
    in one program. ``capacity`` then comes from the global token count,
    the slots from the global exclusive count of each expert's selections
    in JAX's flattened ``[b_global, s_global]`` order
    (:func:`_global_exclusive_count`), and the load-balancing statistics
    are global means, their sum over the group differentiable. Without one
    the batch is this rank's, and the same code routes it. Under tensor
    parallelism every ``tp`` rank routes alike (the router is whole) and
    the experts run their hidden units' shards (``e_gate``/``e_up``
    column, ``e_down`` row, summed over ``tp`` before the combine)."""
    c = config
    b, s, h = x.shape
    E, k = c.num_local_experts, c.num_experts_per_tok
    tokens = x.reshape(-1, h)  # [T, h]

    logits = tokens.float() @ w["router"].float().t()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = top_k_routes(probs, k)  # [T, k]
    topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)

    sel = F.one_hot(topk_idx, E)  # [T, k, E]
    capacity, pos, total = expert_slots(c, sel, topk_idx, (b, s), route)
    keep = pos < capacity

    onehot_e = sel.to(x.dtype)
    onehot_c = F.one_hot(torch.where(keep, pos, capacity), capacity + 1).to(x.dtype)
    onehot_c = onehot_c[..., :capacity]  # [T, k, C]
    dispatch = torch.einsum("tke,tkc->tec", onehot_e, onehot_c)  # [T, E, C]
    combine = torch.einsum("tke,tkc,tk->tec", onehot_e, onehot_c, topk_w.to(x.dtype))

    expert_in = tp.enter(torch.einsum("tec,th->ech", dispatch, tokens), "e_gate")  # [E, C, h]
    g = F.silu(torch.bmm(expert_in, w["e_gate"]))
    u = torch.bmm(expert_in, w["e_up"])
    expert_out = tp.leave(torch.bmm(g * u, w["e_down"]), "e_down")  # [E, C, h]
    y = torch.einsum("tec,ech->th", combine, expert_out).reshape(b, s, h)

    group = route[0] if route is not None else None
    me = all_reduce_sum(probs.sum(dim=0), group) / total  # [E]
    ce = sel.float().sum(dim=(0, 1))
    if group is not None:
        dist.all_reduce(ce, group=group)
    ce = ce / (total * k)
    return y, E * (me * ce).sum()


def expert_slots(config: MixtralConfig, sel: torch.Tensor, topk_idx: torch.Tensor,
                 shape: tuple, route=None) -> tuple:
    """``(capacity, pos [T, k], total)`` of :func:`moe_ffn`'s routing:
    ``total`` the global batch's token count, ``capacity`` an expert's
    buffer rows, ``pos`` each (token, choice)'s slot in its expert's buffer
    (the assignment is dropped at ``pos >= capacity``). A token's ``k``
    choices are distinct experts, so a choice's slot is the count of its
    expert's selections by the tokens before it: the ``cumsum`` over JAX's
    flat ``(token, choice)`` order."""
    b, s = shape
    E, k = config.num_local_experts, config.num_experts_per_tok
    before, total = _global_exclusive_count(sel.sum(dim=1).reshape(b, s, E), route)
    capacity = min(int(np.ceil(config.capacity_factor * total * k / E)), total)
    return capacity, torch.gather(before.reshape(b * s, E), 1, topk_idx), total


def routing_group():
    """The ``route`` of :func:`moe_ffn` in the training forward: ``(group,
    batch index, cp index, cp extent)`` of the ranks that hold other
    tokens of the global batch (``dp × fsdp × cp``; this rank's rows are
    block ``batch index``, its chunk of the sequence block ``cp index``),
    or None where one rank holds them all."""
    from ..ops.attention import get_attention_context

    group, index = get_attention_context().axis("data")
    if group is None:
        return None
    _, cp_index, cp_extent = sequence_shard()
    return group, index, cp_index, cp_extent


def _global_exclusive_count(counts: torch.Tensor, route) -> tuple:
    """Of this rank's ``[b, s, E]`` selection counts: for each token and
    expert, the selections of the expert by every token before it in the
    global batch's flattened ``[b_global, s_global]`` order, and the global
    batch's token count. The ranks' row counts are gathered first, so a
    rank may hold fewer rows than another (an uneven last batch)."""
    b, s, E = counts.shape
    if route is None:
        flat = counts.reshape(-1, E)
        return (torch.cumsum(flat, dim=0) - flat).reshape(b, s, E), b * s
    group, bi, ci, cn = route
    mine = torch.tensor([b, bi, ci], dtype=torch.int64, device=counts.device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(every, mine, group=group)
    rows = {int(r[1]): int(r[0]) for r in every}  # batch block -> its rows
    start, B = sum(n for i, n in rows.items() if i < bi), sum(rows.values())
    whole = torch.zeros((B, cn * s, E), dtype=torch.int64, device=counts.device)
    whole[start:start + b, ci * s:(ci + 1) * s] = counts
    dist.all_reduce(whole, group=group)
    flat = whole.reshape(-1, E)
    before = (torch.cumsum(flat, dim=0) - flat).reshape(B, cn * s, E)
    return before[start:start + b, ci * s:(ci + 1) * s], B * cn * s


#: path regex → PartitionSpec over JAX's leaf names (the JAX package's
#: ``MIXTRAL_PARTITION_RULES``): a layer-stacked leaf has a leading
#: ``[layers]`` dim, which is never sharded
MIXTRAL_PARTITION_RULES = [
    (r"embed_tokens", P("tp", "fsdp")),
    (r"layers\.(wq|wk|wv)", P(None, "fsdp", "tp")),
    (r"layers\.wo", P(None, "tp", "fsdp")),
    (r"layers\.router", P(None, "fsdp", None)),
    # expert dim over ep; per-expert matmuls shard ff over tp, h over fsdp
    (r"layers\.(e_gate|e_up)", P(None, "ep", "fsdp", "tp")),
    (r"layers\.e_down", P(None, "ep", "tp", "fsdp")),
    (r"norm", P()),
    (r"lm_head", P("fsdp", "tp")),
]

#: the 2-D leaves JAX holds as ``[in, out]`` and the port as ``[out, in]``
#: (:func:`~..parallel.sharding.jax_leaves`)
JAX_TRANSPOSED = ("wq", "wk", "wv", "wo", "router", "lm_head")


class MixtralForCausalLM(CausalLM):
    """Mixtral (port of the JAX ``MixtralForCausalLM``). ``forward`` returns
    JAX's keys: ``logits`` (unless only the loss is asked for, as in
    :meth:`~.gpt2.CausalLM.forward`), ``aux_loss`` (the per-layer mean of
    the load-balancing statistic), and with ``labels`` ``lm_loss`` and
    ``loss = lm_loss + router_aux_loss_coef · aux_loss``."""

    partition_rules = MIXTRAL_PARTITION_RULES

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

    _table = "embed_tokens"
    _head_name = "lm_head"

    def _embed(self, input_ids, positions, w=None, tp=NO_TP):
        return self._lookup(self._leaves(w), input_ids, tp)

    def _final(self, x, w=None):
        return rms_norm(x, self._leaves(w)["norm"], self.config.rms_norm_eps)

    def _head(self, w=None):
        return self._leaves(w)["lm_head"], None

    def _block(self, w, x, positions, attend, tp=NO_TP, route=None):
        """One block (port of ``mixtral_layer_apply``): the llama's
        attention (this rank's heads under tensor parallelism, as the
        llama's), then the routed FFN. Returns ``(x, aux)``."""
        c = self.config
        x = rope_attention_block(w, x, self.rope_cos, self.rope_sin, positions, attend,
                                 tp.heads(c.num_attention_heads, "wq"),
                                 tp.heads(c.num_key_value_heads, "wk"), c.head_dim,
                                 c.rms_norm_eps, enter=lambda t: tp.enter(t, "wq"),
                                 leave=lambda t: tp.leave(t, "wo"))
        moe_out, aux = moe_ffn(c, w, rms_norm(x, w["mlp_norm"], c.rms_norm_eps), tp, route)
        return x + moe_out, aux

    def _train_block(self, w, x, positions, attention_mask, tp=NO_TP):
        """The training forward's block: the routing spans the global batch
        (:func:`routing_group`)."""
        return self._block(w, x, positions, lambda q, k, v: attention(
            q, k, v, segment_mask=attention_mask, causal=True), tp=tp, route=routing_group())

    def _add_aux(self, out, aux_total) -> None:
        c = self.config
        out["aux_loss"] = aux_total / c.num_hidden_layers
        if "loss" in out:
            out["lm_loss"] = out["loss"]
            out["loss"] = out["lm_loss"] + c.router_aux_loss_coef * out["aux_loss"]
