"""Vision Transformer image classifier (port of
``accelerate_tpu/models/vit.py``, timm's ``vit_base_patch16_224``): the
patch embedding as one product over ``[B, N, P·P·C]`` patches, pre-LN
blocks with true LayerNorm, biases and a tanh-GELU MLP, non-causal
attention without a mask through :func:`~..ops.attention.attention` (s =
197 at ``vit_b16``: the flash kernels on the card), learned positions and
a ``[CLS]`` head. Each layer is a submodule holding the JAX leaves by
their names, projections ``[out, in]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..parallel.sharding import NO_TP, local
from ..parallel.sharding import PartitionSpec as P
from ..modules import ModelOutput
from ..ops.attention import attention
from ..ops.fp8 import dense
from ..ops.layers import token_loss
from ..parallel.context import first_token, sequence_chunk, sequence_shard
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf
from .gpt2 import gelu_tanh, layer_norm
from .resnet import to_nhwc


@dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    in_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_classes: int = 1000
    layer_norm_eps: float = 1e-6
    remat: bool | str = False

    def __post_init__(self):
        remat_policy(self.remat)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def vit_b16(cls, num_classes: int = 1000):
        return cls(num_classes=num_classes)

    @classmethod
    def tiny(cls, num_classes: int = 3):
        return cls(
            image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128, num_classes=num_classes,
        )


def vit_spec(c: ViTConfig) -> dict:
    d, ff = c.hidden_size, c.intermediate_size
    patch_dim = c.patch_size * c.patch_size * c.in_channels
    layer = {
        "ln1_g": Leaf((d,), "ones"), "ln1_b": Leaf((d,), "zeros"),
        "w_qkv": Leaf((3 * d, d), 0.02), "b_qkv": Leaf((3 * d,), "zeros"),
        "w_proj": Leaf((d, d), 0.02), "b_proj": Leaf((d,), "zeros"),
        "ln2_g": Leaf((d,), "ones"), "ln2_b": Leaf((d,), "zeros"),
        "w_fc1": Leaf((ff, d), 0.02), "b_fc1": Leaf((ff,), "zeros"),
        "w_fc2": Leaf((d, ff), 0.02), "b_fc2": Leaf((d,), "zeros"),
    }
    return {
        "patch_embed": {"w": Leaf((d, patch_dim), 0.02), "b": Leaf((d,), "zeros")},
        "cls_token": Leaf((1, 1, d), 0.02),
        "pos_embed": Leaf((1, c.num_patches + 1, d), 0.02),
        "layers": [dict(layer) for _ in range(c.num_hidden_layers)],
        "ln_f_g": Leaf((d,), "ones"), "ln_f_b": Leaf((d,), "zeros"),
        "head": {"w": Leaf((c.num_classes, d), 0.02), "b": Leaf((c.num_classes,), "zeros")},
    }


def init_vit_params(generator: torch.Generator, config: ViTConfig, dtype=torch.float32,
                    device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`ViTForImageClassification`."""
    return _params.init_state_dict(generator, vit_spec(config), dtype, device)


def params_from_jax(np_params, config: ViTConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict."""
    return _params.state_dict_from_jax(
        np_params, _params.transposed(("w_qkv", "w_proj", "w_fc1", "w_fc2", "w")))


def _patchify(x, patch: int):
    """``[B, H, W, C]`` → ``[B, N, P·P·C]``: row-major patches, channel-last
    inside each (a ``Conv(P, stride=P)`` and a flatten)."""
    b, h, w, ch = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * ch)


#: path regex → PartitionSpec over JAX's leaf names (the JAX package's
#: ``VIT_PARTITION_RULES``): a layer-stacked leaf has a leading
#: ``[layers]`` dim, which is never sharded
VIT_PARTITION_RULES = [
    (r"patch_embed\.w", P(None, "tp")),
    (r"pos_embed|cls_token", P()),
    (r"layers\.w_qkv", P(None, "fsdp", "tp")),
    (r"layers\.b_qkv", P(None, "tp")),
    (r"layers\.w_proj", P(None, "tp", "fsdp")),
    (r"layers\.w_fc1", P(None, "fsdp", "tp")),
    (r"layers\.b_fc1", P(None, "tp")),
    (r"layers\.w_fc2", P(None, "tp", "fsdp")),
    (r"layers\.(ln1|ln2)_(g|b)|layers\.(b_proj|b_fc2)", P()),
    (r"head\.w", P("fsdp", None)),
    (r"(ln_f_|head\.b|patch_embed\.b)", P()),
]

#: the 2-D leaves JAX holds as ``[in, out]`` and the port as ``[out, in]``
#: (:func:`~..parallel.sharding.jax_leaves`)
JAX_TRANSPOSED = ("w_qkv", "w_proj", "w_fc1", "w_fc2", "w")


class ViTForImageClassification(_params.SpecModel):
    """ViT (port of the JAX ``ViTForImageClassification``):
    ``forward(pixel_values, labels=None)`` → ``logits [b, num_classes]``
    and, with ``labels [b]``, the mean CE ``loss``."""

    partition_rules = VIT_PARTITION_RULES

    _spec = staticmethod(vit_spec)

    def _block(self, w, x, tp=NO_TP):
        """One pre-LN block (port of ``_vit_block``). Under tensor
        parallelism the fused QKV's shards are gathered and this rank's
        heads' rows taken (:meth:`TPShard.fused_heads`); the projections run
        Megatron's row and column shards."""
        c = self.config
        b, n, d = x.shape
        nh, hd = tp.heads(c.num_attention_heads, "w_qkv"), c.head_dim
        y = layer_norm(x, w["ln1_g"], w["ln1_b"], c.layer_norm_eps)
        qkv = (dense(tp.enter(y, "w_qkv"), tp.fused_heads(w["w_qkv"], "w_qkv"))
               + tp.fused_heads(w["b_qkv"], "b_qkv"))
        q, k, v = (z.reshape(b, n, nh, hd) for z in qkv.split(nh * hd, dim=-1))
        attn = attention(q, k, v, causal=False).reshape(b, n, nh * hd)
        x = x + tp.leave(dense(attn, w["w_proj"]), "w_proj") + w["b_proj"]
        y = tp.enter(layer_norm(x, w["ln2_g"], w["ln2_b"], c.layer_norm_eps), "w_fc1")
        mlp = dense(gelu_tanh(dense(y, w["w_fc1"]) + w["b_fc1"]), w["w_fc2"])
        return x + tp.leave(mlp, "w_fc2") + w["b_fc2"]

    def forward(self, pixel_values, labels=None) -> ModelOutput:
        """Under tensor parallelism the patch embedding runs its ``tp``
        columns and gathers them whole (its bias, whole, added after).
        Under context parallelism the patch sequence (cls + patches) is cut
        after the embedding, JAX's words raised where the ``cp`` extent
        does not divide its length, and the cls row reaches every ``cp``
        rank before the head (:func:`~..parallel.context.first_token`)."""
        c = self.config
        cp_group, cp_rank, cp_extent = sequence_shard()
        pe = self.patch_embed
        tp = _params.layer_tp(pe)
        patches = _patchify(to_nhwc(pixel_values, c.in_channels), c.patch_size)
        h = tp.gather(dense(tp.enter(patches, "w"), local(pe.w)), "w") + local(pe.b)
        cls = local(self.cls_token).expand(h.shape[0], 1, c.hidden_size)
        h = torch.cat([cls, h], dim=1) + local(self.pos_embed)
        h = sequence_chunk(h, cp_rank, cp_extent)
        for layer in self.layers:
            h = layer(self._block, c.remat, h)
        h = layer_norm(h, local(self.ln_f_g), local(self.ln_f_b), c.layer_norm_eps)
        logits = F.linear(first_token(h, cp_group, cp_rank), local(self.head.w),
                          local(self.head.b))
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = token_loss(logits, labels, whole_batch=True)
        return out
