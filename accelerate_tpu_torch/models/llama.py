"""Llama-family causal LM (port of ``accelerate_tpu/models/llama.py``: the
training forward and the serving step).

The JAX model keeps layer-stacked params and scans one block over them;
here each layer is its own submodule (``nn.Linear(bias=False)`` stores
``[out, in]``, the transpose of the JAX ``[in, out]``), and the layer loop
is a Python loop. Ported: :class:`LlamaConfig`, :func:`init_llama_params`,
:func:`params_from_jax`, the training/eval forward
(:meth:`LlamaForCausalLM.forward`, the port of ``llama_apply``'s default
mode and ``llama_layer_apply``) and the paged step the serving engine runs
(:meth:`LlamaForCausalLM.paged_step`, the port of ``_llama_paged_step``).
The dense KV-cache decode and the streaming segments are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..modules import ModelOutput
from ..ops.attention import attention
from ..ops.layers import (
    apply_rope,
    fused_cross_entropy,
    rms_norm,
    rope_frequencies,
    rope_paged_attention_block,
    shift_labels,
)
from ..utils.device import resolve_device


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    #: recompute each layer in the backward (``torch.utils.checkpoint``);
    #: the JAX ``jax.checkpoint_policies`` names are not ported
    remat: bool = False

    def __post_init__(self):
        if not isinstance(self.remat, bool):
            raise ValueError(
                f"remat policy {self.remat!r} is not yet ported: use True (recompute "
                "each layer) or False"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls):
        return cls(remat=True)

    @classmethod
    def flagship_700m(cls, max_position_embeddings: int = 1024, remat: bool = False):
        """The ~700M flagship (hidden 1536, 12 heads × 128, ff 4h, 16
        layers): the train step ``chip_smoke.py`` drives and the serve
        CLI's ``--preset flagship``."""
        return cls(
            vocab_size=32000,
            hidden_size=1536,
            intermediate_size=6144,
            num_hidden_layers=16,
            num_attention_heads=12,
            num_key_value_heads=12,
            max_position_embeddings=max_position_embeddings,
            remat=remat,
        )

    @classmethod
    def tiny(cls, vocab_size=256, hidden_size=64, layers=2, heads=4, seq=128):
        return cls(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 3,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            num_key_value_heads=heads,
            max_position_embeddings=seq,
        )


_LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def _linear_shapes(c: LlamaConfig) -> dict[str, tuple[int, int]]:
    """``name -> (in, out)`` of each per-layer projection."""
    h, ff, nh, nkv, hd = (
        c.hidden_size, c.intermediate_size, c.num_attention_heads,
        c.num_key_value_heads, c.head_dim,
    )
    return {
        "wq": (h, nh * hd), "wk": (h, nkv * hd), "wv": (h, nkv * hd),
        "wo": (nh * hd, h), "w_gate": (h, ff), "w_up": (h, ff), "w_down": (ff, h),
    }


def init_llama_params(generator: torch.Generator, config: LlamaConfig,
                      dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`LlamaForCausalLM`, drawn on
    ``device`` from ``generator`` (which must live there): embeddings
    ``N(0, 0.02)``, projections ``N(0, 1/in)``, norms 1 — the distributions
    of the JAX ``init_llama_params``, not its bits."""
    c = config
    device = torch.device(device) if device is not None else generator.device

    def normal(*shape, std):
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * std).to(dtype)

    sd = {"embed_tokens.weight": normal(c.vocab_size, c.hidden_size, std=0.02)}
    for i in range(c.num_hidden_layers):
        for name, (din, dout) in _linear_shapes(c).items():
            sd[f"layers.{i}.{name}.weight"] = normal(dout, din, std=1.0 / np.sqrt(din))
        for name in _NORMS:
            sd[f"layers.{i}.{name}"] = torch.ones(c.hidden_size, dtype=dtype, device=device)
    sd["norm"] = torch.ones(c.hidden_size, dtype=dtype, device=device)
    if not c.tie_word_embeddings:
        sd["lm_head.weight"] = normal(c.vocab_size, c.hidden_size, std=1.0 / np.sqrt(c.hidden_size))
    return sd


def _as_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_jax(np_params, config: LlamaConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (as numpy arrays) → this model's state dict. The JAX
    leaves are layer-stacked ``[L, in, out]`` under ``params["layers"]``
    with ``lm_head [h, V]``; here each layer's projection is un-stacked and
    transposed to ``nn.Linear``'s ``[out, in]``. Tied embeddings (no
    ``lm_head`` leaf) stay tied: the head reads ``embed_tokens``."""
    layers = np_params["layers"]
    sd = {"embed_tokens.weight": _as_tensor(np_params["embed_tokens"])}
    for i in range(config.num_hidden_layers):
        for name in _LINEARS:
            sd[f"layers.{i}.{name}.weight"] = _as_tensor(np.asarray(layers[name][i]).T)
        for name in _NORMS:
            sd[f"layers.{i}.{name}"] = _as_tensor(layers[name][i])
    sd["norm"] = _as_tensor(np_params["norm"])
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _as_tensor(np.asarray(np_params["lm_head"]).T)
    return sd


class LlamaDecoderLayer(nn.Module):
    """One block's weights, under the JAX package's leaf names."""

    def __init__(self, config: LlamaConfig, dtype, device):
        super().__init__()
        for name, (din, dout) in _linear_shapes(config).items():
            setattr(self, name, nn.Linear(din, dout, bias=False, dtype=dtype, device=device))
        for name in _NORMS:
            setattr(self, name, nn.Parameter(
                torch.ones(config.hidden_size, dtype=dtype, device=device)
            ))

    def weights(self) -> dict[str, torch.Tensor]:
        """The block's tensors as the JAX layer dict (projections ``[out,
        in]``), read at call time, so a ``functional_call`` that swapped in
        compute-dtype copies hands those over."""
        w = {name: getattr(self, name).weight for name in _LINEARS}
        w.update({name: getattr(self, name) for name in _NORMS})
        return w


def llama_layer_apply(config: LlamaConfig, w: dict, x, cos, sin, positions, attention_mask):
    """One transformer block on a layer's weight dict (port of
    ``llama_layer_apply``): RMSNorm → q/k/v → RoPE → :func:`ops.attention.attention`
    (causal, ``attention_mask [b, s]`` as the key mask) → output projection
    residual → RMSNorm → SwiGLU MLP residual."""
    c = config
    nh, nkv, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim
    b, s, _ = x.shape
    y = rms_norm(x, w["attn_norm"], c.rms_norm_eps)
    q = apply_rope(F.linear(y, w["wq"]).reshape(b, s, nh, hd), cos, sin, positions)
    k = apply_rope(F.linear(y, w["wk"]).reshape(b, s, nkv, hd), cos, sin, positions)
    v = F.linear(y, w["wv"]).reshape(b, s, nkv, hd)
    attn = attention(q, k, v, segment_mask=attention_mask, causal=True)
    x = x + F.linear(attn.reshape(b, s, nh * hd), w["wo"])
    y = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
    gated = F.silu(F.linear(y, w["w_gate"])) * F.linear(y, w["w_up"])
    return x + F.linear(gated, w["w_down"])


_LAYER_KEYS = _LINEARS + _NORMS


def _remat_layer(config, x, cos, sin, positions, attention_mask, *weights):
    """:func:`llama_layer_apply` with the weights as positional tensors, so
    ``torch.utils.checkpoint`` keeps the very tensors the forward used (the
    compute-dtype copies under mixed precision) for the recompute."""
    return llama_layer_apply(config, dict(zip(_LAYER_KEYS, weights)), x, cos, sin, positions,
                             attention_mask)


class LlamaForCausalLM(nn.Module):
    """Llama: the training forward and the serving engine's block-paged KV
    step. Build one with
    :meth:`from_config` (random weights from a seed) or construct it and
    ``load_state_dict`` (e.g. :func:`params_from_jax`): the constructor
    leaves the weights uninitialised."""

    supports_paged_kv = True

    def __init__(self, config: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        c = config
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size, dtype=dtype)
            self.layers = nn.ModuleList(
                LlamaDecoderLayer(c, dtype, "meta") for _ in range(c.num_hidden_layers)
            )
            self.norm = nn.Parameter(torch.ones(c.hidden_size, dtype=dtype))
            self.lm_head = (
                None if c.tie_word_embeddings
                else nn.Linear(c.hidden_size, c.vocab_size, bias=False, dtype=dtype)
            )
        self.to_empty(device=device)
        cos, sin = rope_frequencies(c.head_dim, c.max_position_embeddings, c.rope_theta,
                                    device=device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @classmethod
    def from_config(cls, config: LlamaConfig, seed: int = 0, dtype=torch.float32,
                    device=None) -> "LlamaForCausalLM":
        device = resolve_device(device)
        model = cls(config, dtype=dtype, device=device)
        generator = torch.Generator(device=device).manual_seed(seed)
        model.load_state_dict(init_llama_params(generator, config, dtype, device))
        return model

    @property
    def device(self) -> torch.device:
        return self.norm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.norm.dtype

    def _head(self) -> torch.Tensor:
        """The LM head ``[vocab, h]`` (the embeddings when tied)."""
        return self.embed_tokens.weight if self.lm_head is None else self.lm_head.weight

    def forward(self, input_ids, attention_mask=None, labels=None, positions=None,
                return_logits: bool = False) -> ModelOutput:
        """Training / eval forward over ``input_ids [b, s]`` with full causal
        attention; ``attention_mask [b, s]`` (1 = real token) masks keys.
        With ``labels [b, s]`` (-100 ignored) the loss is the next-token CE
        computed from the pre-head hidden states by
        :func:`ops.layers.fused_cross_entropy`, one sequence chunk of logits
        at a time.

        Deviation from the JAX model: there, XLA drops the unused ``[b, s,
        vocab]`` logits when a step forces only the loss; eager PyTorch
        would compute them. So with ``labels`` given the head product over
        the whole sequence is skipped and ``out`` holds only ``loss``,
        unless ``return_logits=True``."""
        c = self.config
        b, s = input_ids.shape
        if s > c.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{c.max_position_embeddings}: RoPE position tables would be "
                "indexed out of range"
            )
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
        x = self.embed_tokens(input_ids.long())
        rope = (self.rope_cos, self.rope_sin)
        for layer in self.layers:
            w = layer.weights()
            if c.remat:
                x = checkpoint(_remat_layer, c, x, *rope, positions, attention_mask,
                               *(w[n] for n in _LAYER_KEYS), use_reentrant=False)
            else:
                x = llama_layer_apply(c, w, x, *rope, positions, attention_mask)
        x = rms_norm(x, self.norm, c.rms_norm_eps)
        head = self._head()
        out = ModelOutput()
        if labels is None or return_logits:
            out["logits"] = F.linear(x, head)
        if labels is not None:
            out["loss"] = fused_cross_entropy(x, head.t(), shift_labels(labels))
        return out

    @torch.no_grad()
    def paged_step(self, input_ids, paged_kv, block_tables, cache_positions,
                   paged_write_mask=None, attn_impl=None) -> ModelOutput:
        """One step against the block-paged KV pool: ``s == 1`` token per
        slot (a decode step) or an ``s``-token prefill chunk. ``paged_kv``
        holds ``"k"``/``"v"`` pools ``[L, num_blocks, bs, n_kv, hd]`` (plus
        ``"k_scale"``/``"v_scale"`` ``[L, num_blocks, bs, n_kv]`` f32 for
        int8/fp8 storage), **updated in place**: each layer's K/V are
        scattered through ``block_tables [b, max_blocks]`` at positions
        ``cache_positions[b] + j`` (``paged_write_mask [b, s]`` drops padded
        or inactive lanes) and attention walks the block table. Returns
        ``ModelOutput(logits [b, s, vocab], paged_kv)``."""
        c = self.config
        b, s = input_ids.shape
        if s > c.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{c.max_position_embeddings}: RoPE position tables would be "
                "indexed out of range"
            )
        idx = cache_positions.reshape(b).to(torch.int32).contiguous()
        bt = block_tables.to(torch.int32).contiguous()
        quantized = "k_scale" in paged_kv
        x = self.embed_tokens(input_ids.long())
        for i, layer in enumerate(self.layers):
            x = rope_paged_attention_block(
                layer, x, paged_kv["k"][i], paged_kv["v"][i], self.rope_cos, self.rope_sin,
                bt, idx, c.num_attention_heads, c.num_key_value_heads, c.head_dim,
                c.rms_norm_eps, write_mask=paged_write_mask,
                k_scale_l=paged_kv["k_scale"][i] if quantized else None,
                v_scale_l=paged_kv["v_scale"][i] if quantized else None,
                attn_impl=attn_impl,
            )
            y = rms_norm(x, layer.mlp_norm, c.rms_norm_eps)
            x = x + layer.w_down(F.silu(layer.w_gate(y)) * layer.w_up(y))
        x = rms_norm(x, self.norm, c.rms_norm_eps)
        return ModelOutput(logits=F.linear(x, self._head()), paged_kv=paged_kv)
