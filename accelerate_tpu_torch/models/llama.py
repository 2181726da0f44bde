"""Llama-family causal LM (port of ``accelerate_tpu/models/llama.py``: the
training forward and the serving step).

The JAX model keeps layer-stacked params and scans one block over them;
here each layer is its own submodule (``nn.Linear(bias=False)`` stores
``[out, in]``, the transpose of the JAX ``[in, out]``), and the layer loop
is a Python loop. Ported: :class:`LlamaConfig`, :func:`init_llama_params`,
:func:`params_from_jax`, the training/eval forward
(:meth:`LlamaForCausalLM.forward`, the port of ``llama_apply``'s default
mode and ``llama_layer_apply``), its prefill mode (``use_cache=True``) and
dense KV-cache decode (:meth:`LlamaForCausalLM.cached_step`, the port of
``_llama_decode_step``), which ``generate()`` runs, and the paged step the
serving engine runs (:meth:`LlamaForCausalLM.paged_step`, the port of
``_llama_paged_step``) with its early-exit draft for speculative decoding
(:func:`llama_early_exit_apply`). Every projection JAX routes through
``dense`` goes through the port's :func:`~..ops.fp8.dense` in ``forward``
and ``cached_step`` (so an fp8 recipe reaches training and ``generate()``
alike); ``paged_step`` keeps plain products, since serving has no
precision policy. :func:`convert_hf_llama_state_dict` loads an HF-layout
checkpoint. :meth:`LlamaForCausalLM.segments` is the streaming plan a
:class:`~..big_modeling.DispatchedModel` runs; the pipelined stacks are a
later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.sharding import PartitionSpec as P
from ..modules import ModelOutput
from ..ops.attention import attention
from ..ops.fp8 import dense
from ..ops.layers import (
    cross_entropy_loss,
    fused_token_loss,
    rms_norm,
    rope_attention_block,
    rope_cached_attention_block,
    rope_frequencies,
    rope_paged_attention_block,
    table_rows,
)
from ..big_modeling import init_device
from ..parallel.context import sequence_shard, shifted_targets
from ..parallel.pipeline import remat_policy, remat_wrap
from ..parallel.sharding import (
    full_tensor,
    local,
    tensor_parallel_group,
    tp_enter,
    tp_leave,
    vocab_parallel_embedding,
)


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
    #: rematerialisation of each layer in the backward: False, True (the
    #: whole layer) or a ``jax.checkpoint_policies`` name such as
    #: ``"dots_saveable"`` (:func:`~..parallel.pipeline.remat_wrap`)
    remat: bool | str = False

    def __post_init__(self):
        remat_policy(self.remat)  # an unknown name raises JAX's message

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama2_7b(cls):
        return cls(remat=True)

    @classmethod
    def flagship_700m(cls, max_position_embeddings: int = 1024, remat: bool | str = False):
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


def jax_param_name(name: str) -> str:
    """The JAX name of a port parameter (JAX's layer-stacked leaves
    expanded to ``layers.<i>.<leaf>``, as JAX's device maps expand them):
    ``nn.Linear``'s and ``nn.Embedding``'s ``.weight`` dropped."""
    return name[: -len(".weight")] if name.endswith(".weight") else name


class LlamaDecoderLayer(nn.Module):
    """One block's weights, under the JAX package's leaf names. Its
    ``forward`` is the block (:func:`llama_layer_apply`): the training
    forward calls each layer as a module, so FSDP2's hooks gather a sharded
    layer's weights around it."""

    def __init__(self, config: LlamaConfig, dtype, device):
        super().__init__()
        self.config = config
        for name, (din, dout) in _linear_shapes(config).items():
            setattr(self, name, nn.Linear(din, dout, bias=False, dtype=dtype, device=device))
        for name in _NORMS:
            setattr(self, name, nn.Parameter(
                torch.ones(config.hidden_size, dtype=dtype, device=device)
            ))

    def weights(self) -> dict[str, torch.Tensor]:
        """The block's tensors as the JAX layer dict (projections ``[out,
        in]``), read at call time, so a ``functional_call`` that swapped in
        compute-dtype copies hands those over; of a DTensor, this rank's
        shard (:func:`~..parallel.sharding.local`)."""
        w = {name: local(getattr(self, name).weight) for name in _LINEARS}
        w.update({name: local(getattr(self, name)) for name in _NORMS})
        return w

    def forward(self, x, cos, sin, positions, attention_mask, return_kv: bool = False):
        c = self.config
        w = self.weights()
        if c.remat and not return_kv:
            return remat_wrap(_remat_layer, c.remat)(c, x, cos, sin, positions, attention_mask,
                                                     *(w[n] for n in _LAYER_KEYS))
        return llama_layer_apply(c, w, x, cos, sin, positions, attention_mask,
                                 return_kv=return_kv)


def llama_layer_apply(config: LlamaConfig, w: dict, x, cos, sin, positions, attention_mask,
                      return_kv: bool = False):
    """One transformer block on a layer's weight dict (port of
    ``llama_layer_apply``): RMSNorm → q/k/v → RoPE → :func:`ops.attention.attention`
    (causal, ``attention_mask [b, s]`` as the key mask) → output projection
    residual → RMSNorm → SwiGLU MLP residual, each projection through
    :func:`~..ops.fp8.dense`. ``return_kv`` also returns the block's roped K
    and V ``[b, s, n_kv, hd]`` (the prefill's cache)."""
    c = config
    kv = []

    def attend(q, k, v):
        kv.append((k, v))
        return attention(q, k, v, segment_mask=attention_mask, causal=True)

    group = tensor_parallel_group()[0]
    n_heads, n_kv = c.num_attention_heads, c.num_key_value_heads
    if group is not None:  # this rank's heads and hidden units
        n_heads, n_kv = w["wq"].shape[0] // c.head_dim, w["wk"].shape[0] // c.head_dim

    def enter(t):
        return tp_enter(t, group)

    def leave(t):
        return tp_leave(t, group)

    x = rope_attention_block(w, x, cos, sin, positions, attend, n_heads, n_kv, c.head_dim,
                             c.rms_norm_eps, enter=enter, leave=leave)
    y = enter(rms_norm(x, w["mlp_norm"], c.rms_norm_eps))
    gated = F.silu(dense(y, w["w_gate"])) * dense(y, w["w_up"])
    x = x + leave(dense(gated, w["w_down"]))
    return (x, kv[0]) if return_kv else x


_LAYER_KEYS = _LINEARS + _NORMS


def _remat_layer(config, x, cos, sin, positions, attention_mask, *weights):
    """:func:`llama_layer_apply` with the weights as positional tensors, so
    ``torch.utils.checkpoint`` keeps the very tensors the forward used (the
    compute-dtype copies under mixed precision) for the recompute."""
    return llama_layer_apply(config, dict(zip(_LAYER_KEYS, weights)), x, cos, sin, positions,
                             attention_mask)


#: the HF transformers names of a llama layer's tensors, by this model's
_HF_LAYER_NAMES = {
    "wq": "self_attn.q_proj.weight",
    "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight",
    "wo": "self_attn.o_proj.weight",
    "w_gate": "mlp.gate_proj.weight",
    "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
    "attn_norm": "input_layernorm.weight",
    "mlp_norm": "post_attention_layernorm.weight",
}


def convert_hf_llama_state_dict(flat: dict, config: LlamaConfig) -> dict[str, torch.Tensor]:
    """An HF transformers llama state dict (``model.layers.{i}.self_attn.q_proj.weight``,
    ..., with or without the ``model.`` prefix; tensors or numpy arrays) →
    this model's state dict (port of JAX ``convert_hf_llama_state_dict``).
    No transposes: HF's ``nn.Linear`` weights and this model's share the
    ``[out, in]`` layout (JAX transposes to its ``[in, out]`` and stacks
    the layers). Tied embeddings take no ``lm_head``."""

    def tensor(x):
        return x.detach().clone() if isinstance(x, torch.Tensor) else _as_tensor(x)

    def get(name):
        for prefix in ("model.", ""):
            if prefix + name in flat:
                return tensor(flat[prefix + name])
        raise KeyError(name)

    sd = {"embed_tokens.weight": get("embed_tokens.weight"), "norm": get("norm.weight")}
    for i in range(config.num_hidden_layers):
        for ours, theirs in _HF_LAYER_NAMES.items():
            suffix = "" if ours in _NORMS else ".weight"
            sd[f"layers.{i}.{ours}{suffix}"] = get(f"layers.{i}.{theirs}")
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = tensor(flat["lm_head.weight"])
    return sd


#: path regex → PartitionSpec over JAX's leaf names (the JAX package's
#: ``LLAMA_PARTITION_RULES``): a layer-stacked leaf has a leading
#: ``[layers]`` dim, which is never sharded
LLAMA_PARTITION_RULES = [
    (r"embed_tokens", P("tp", "fsdp")),
    (r"layers\.(wq|wk|wv)", P(None, "fsdp", "tp")),
    (r"layers\.wo", P(None, "tp", "fsdp")),
    (r"layers\.(w_gate|w_up)", P(None, "fsdp", "tp")),
    (r"layers\.w_down", P(None, "tp", "fsdp")),
    (r"norm", P()),
    (r"lm_head", P("fsdp", "tp")),
]

#: the 2-D leaves JAX holds as ``[in, out]`` and the port as ``[out, in]``
#: (:func:`~..parallel.sharding.jax_leaves`)
JAX_TRANSPOSED = _LINEARS + ("lm_head",)


class LlamaForCausalLM(nn.Module):
    """Llama: the training forward, the dense KV-cache prefill and decode
    ``generate()`` runs, and the serving engine's block-paged KV step. Build one with
    :meth:`from_config` (random weights from a seed) or construct it and
    ``load_state_dict`` (e.g. :func:`params_from_jax`): the constructor
    leaves the weights uninitialised."""

    partition_rules = LLAMA_PARTITION_RULES

    supports_kv_cache = True
    supports_paged_kv = True
    #: the training forward runs on this rank's shards of a tp mesh
    #: (heads, hidden units, vocabulary rows) with Megatron's collectives
    supports_tensor_parallel = True
    #: FSDP2 gathers each layer's weights when the layer is called, and
    #: under ``cp`` the positions, the label shift and the loss span the
    #: whole sequence
    supports_context_parallel = True
    #: the inputs a ``cp`` rank takes its chunk of (``PreparedModel``)
    sequence_inputs = ("input_ids", "attention_mask", "labels", "positions")

    def __init__(self, config: LlamaConfig, dtype=torch.float32, device=None):
        super().__init__()
        device = init_device(device)
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
        if device.type != "meta":  # init_empty_weights keeps the parameters on meta
            self.to_empty(device=device)
        cos, sin = rope_frequencies(c.head_dim, c.max_position_embeddings, c.rope_theta,
                                    device=device if device.type != "meta" else "cpu")
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @classmethod
    def from_config(cls, config: LlamaConfig, seed: int = 0, dtype=torch.float32,
                    device=None) -> "LlamaForCausalLM":
        model = cls(config, dtype=dtype, device=device)
        if model.device.type == "meta":  # init_empty_weights: no draw
            return model
        device = model.device
        generator = torch.Generator(device=device).manual_seed(seed)
        model.load_state_dict(init_llama_params(generator, config, dtype, device))
        return model

    @property
    def device(self) -> torch.device:
        return self.norm.device

    @property
    def dtype(self) -> torch.dtype:
        return self.norm.dtype

    def _token_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``embed_tokens`` that JAX's gather
        (``params["embed_tokens"][input_ids]``) reads: a negative id counts
        from the end once, then every id is clamped into ``[0, vocab)``, so
        an out-of-vocabulary prompt id answers instead of raising. No host
        sync: the decode steps that call it are replayed from CUDA graphs."""
        return table_rows(input_ids, self.config.vocab_size)

    def kv_cache_shape(self, batch: int, length: int) -> tuple:
        """``[L, b, length, n_kv, hd]``: one dense cache."""
        c = self.config
        return (c.num_hidden_layers, batch, length, c.num_key_value_heads, c.head_dim)

    def _head(self) -> torch.Tensor:
        """The LM head ``[vocab, h]`` (the embeddings when tied)."""
        return self.embed_tokens.weight if self.lm_head is None else self.lm_head.weight

    def forward(self, input_ids, attention_mask=None, labels=None, positions=None,
                return_logits: bool = False, use_cache: bool = False,
                max_cache_len: int | None = None, kv_cache=None,
                cache_index=None, spare_slot: bool = False) -> ModelOutput:
        """Training / eval forward over ``input_ids [b, s]`` with full causal
        attention; ``attention_mask [b, s]`` (1 = real token) masks keys.
        With ``labels [b, s]`` (-100 ignored) the loss is the next-token CE
        computed from the pre-head hidden states by
        :func:`ops.layers.fused_token_loss`, one sequence chunk of logits
        at a time.

        **Prefill** (``use_cache=True``): the same forward, plus each layer's
        K/V in ``out.kv_cache`` ``{"k", "v"}: [L, b, max_cache_len, n_kv,
        hd]`` (zeros past ``s``; ``max_cache_len`` defaults to
        ``max_position_embeddings``). **Decode** (``kv_cache=`` with
        ``cache_index=``, and ``spare_slot``): :meth:`cached_step`.

        Deviation from the JAX model: there, XLA drops the unused ``[b, s,
        vocab]`` logits when a step forces only the loss; eager PyTorch
        would compute them. So with ``labels`` given the head product over
        the whole sequence is skipped and ``out`` holds only ``loss``,
        unless ``return_logits=True``."""
        c = self.config
        b, s = input_ids.shape
        if kv_cache is not None:
            self._check_length(s)
            return self.cached_step(input_ids, kv_cache, cache_index, spare_slot)
        # context parallelism: this rank holds chunk cp_rank of the sequence
        cp_group, cp_rank, cp_extent = sequence_shard()
        self._check_length(s * cp_extent)
        if positions is None:
            positions = (cp_rank * s + torch.arange(s, device=input_ids.device))[None, :]
            positions = positions.expand(b, s)
        tp_group, tp_rank = tensor_parallel_group()
        x = vocab_parallel_embedding(self._token_ids(input_ids), local(self.embed_tokens.weight),
                                     c.vocab_size, tp_rank, tp_group)
        rope = (self.rope_cos, self.rope_sin)
        caches = None
        if use_cache:
            max_cache = int(max_cache_len or c.max_position_embeddings)
            if not s <= max_cache <= c.max_position_embeddings:
                raise ValueError(
                    f"max_cache_len {max_cache} must be in [{s} (prompt length), "
                    f"{c.max_position_embeddings} (max_position_embeddings)] — "
                    "above it RoPE tables would silently clamp"
                )
            shape = (c.num_hidden_layers, b, max_cache, c.num_key_value_heads, c.head_dim)
            caches = {n: torch.zeros(shape, dtype=x.dtype, device=x.device) for n in "kv"}
        for i, layer in enumerate(self.layers):
            if caches is not None:
                x, (k, v) = layer(x, *rope, positions, attention_mask, return_kv=True)
                caches["k"][i, :, :s] = k
                caches["v"][i, :, :s] = v
            else:
                x = layer(x, *rope, positions, attention_mask)
        x = rms_norm(x, local(self.norm), c.rms_norm_eps)
        out = ModelOutput()
        if labels is None or return_logits:
            # the logits whole on every tp rank (the head's gradient: this
            # rank's rows)
            out["logits"] = dense(x, full_tensor(self._head()))
        if caches is not None:
            out["kv_cache"] = caches
        if labels is not None:
            out["loss"] = self._loss(x, labels, cp_group, cp_rank, tp_group, tp_rank)
        return out

    def _loss(self, x, labels, cp_group, cp_rank, tp_group, tp_rank):
        """The next-token CE over the whole sequence and the global batch.
        Under tensor parallelism each rank multiplies by its own rows of the
        head (JAX's ``lm_head: P("fsdp", "tp")``) and the log-partition and
        gold logit are summed over ``tp`` (vocab-parallel; a vocabulary that
        ``tp`` does not divide stays whole). Under context parallelism the
        labels are shifted over the gathered sequence
        (:func:`~..parallel.context.shifted_targets`). The summed NLL and
        valid count are summed over every rank that holds other tokens
        (:func:`~..ops.layers.fused_token_loss`), so every rank returns the
        global batch's mean, as JAX does (its gradient is the rank's part of
        the sum)."""
        head = local(self._head())
        vocab_shard = None
        if tp_group is not None and head.shape[0] != self.config.vocab_size:
            vocab_shard = (tp_rank * head.shape[0], tp_group)
        return fused_token_loss(x, head.t(), shifted_targets(labels, cp_group, cp_rank),
                                vocab_shard=vocab_shard)

    def segments(self, input_ids=None, attention_mask=None, positions=None, labels=None,
                 **kw):
        """The streaming plan (port of ``llama_segments``): embed → one step
        a layer (:func:`llama_layer_apply` on the streamed weights, so its
        attention runs B1 on the card) → norm and head."""
        c = self.config
        b, s = input_ids.shape
        self._check_length(s)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
        rope = (self.rope_cos, self.rope_sin)
        table = "embed_tokens.weight"
        head = table if self.lm_head is None else "lm_head.weight"

        def name(i, leaf):
            return f"layers.{i}.{leaf}" + ("" if leaf in _NORMS else ".weight")

        def layer_step(i):
            def fn(seg, carry):
                w = {k: seg[name(i, k)] for k in _LAYER_KEYS}
                return {"x": llama_layer_apply(c, w, carry["x"], *rope, positions,
                                               attention_mask)}

            return ("layer", i), [name(i, k) for k in _LAYER_KEYS], fn

        steps = [("embed", [table],
                  lambda seg, carry: {"x": seg[table][self._token_ids(input_ids)]})]
        steps += [layer_step(i) for i in range(c.num_hidden_layers)]
        steps.append(("head", ["norm", head], lambda seg, carry: {
            "logits": dense(rms_norm(carry["x"], seg["norm"], c.rms_norm_eps), seg[head])}))

        def finalize(carry):
            out = ModelOutput(logits=carry["logits"])
            if labels is not None:
                out["loss"] = cross_entropy_loss(carry["logits"][:, :-1, :], labels[:, 1:])
            return out

        return {"init": dict, "steps": steps, "finalize": finalize}

    def convert_state_dict(self, flat: dict) -> dict[str, torch.Tensor]:
        """An HF-layout state dict as this model's
        (:func:`convert_hf_llama_state_dict`), for ``load_state_dict``."""
        return convert_hf_llama_state_dict(flat, self.config)

    def _check_length(self, s: int) -> None:
        if s > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings}: RoPE position tables would be "
                "indexed out of range"
            )

    @torch.no_grad()
    def cached_step(self, input_ids, kv_cache, cache_index,
                    spare_slot: bool = False) -> ModelOutput:
        """One dense KV-cache decode step (port of ``_llama_decode_step``):
        ``input_ids [b, s]`` (``s == 1`` a decode token, ``s > 1`` a
        speculative verify chunk) at each row's own cache position
        ``cache_index [b]``. ``kv_cache`` ``{"k", "v"}: [L, b, max_cache,
        n_kv, hd]`` is **updated in place** (positions past its end are
        dropped: :func:`ops.layers.write_kv_cache`, into the cache's last
        slot when ``spare_slot``), and attention runs
        against each row's prefix (:func:`ops.layers.cached_attention`, plain
        PyTorch, as JAX computes it outside any Pallas kernel). Returns
        ``ModelOutput(logits [b, s, vocab], kv_cache)``."""
        c = self.config
        b, s = input_ids.shape
        self._check_length(s)
        idx = cache_index.reshape(b)
        x = self.embed_tokens(self._token_ids(input_ids))
        for i, layer in enumerate(self.layers):
            w = layer.weights()
            x, _, _ = rope_cached_attention_block(
                w, x, kv_cache["k"][i], kv_cache["v"][i], self.rope_cos, self.rope_sin,
                idx, c.num_attention_heads, c.num_key_value_heads, c.head_dim, c.rms_norm_eps,
                spare_slot,
            )
            y = rms_norm(x, w["mlp_norm"], c.rms_norm_eps)
            gated = F.silu(dense(y, w["w_gate"])) * dense(y, w["w_up"])
            x = x + dense(gated, w["w_down"])
        x = rms_norm(x, self.norm, c.rms_norm_eps)
        return ModelOutput(logits=dense(x, self._head()), kv_cache=kv_cache)

    def early_exit_apply(self, draft_layers: int):
        """The early-exit draft of this model: :func:`llama_early_exit_apply`."""
        return llama_early_exit_apply(self, draft_layers)

    @torch.no_grad()
    def paged_step(self, input_ids, paged_kv, block_tables, cache_positions,
                   paged_write_mask=None, attn_impl=None, num_layers=None) -> ModelOutput:
        """One step against the block-paged KV pool: ``s == 1`` token per
        slot (a decode step) or an ``s``-token prefill chunk. ``paged_kv``
        holds ``"k"``/``"v"`` pools ``[L, num_blocks, bs, n_kv, hd]`` (plus
        ``"k_scale"``/``"v_scale"`` ``[L, num_blocks, bs, n_kv]`` f32 for
        int8/fp8 storage), **updated in place**: each layer's K/V are
        scattered through ``block_tables [b, max_blocks]`` at positions
        ``cache_positions[b] + j`` (``paged_write_mask [b, s]`` drops padded
        or inactive lanes) and attention walks the block table. Returns
        ``ModelOutput(logits [b, s, vocab], paged_kv)``. ``num_layers`` runs
        only the first that many layers (reading and writing those layers
        of the pools) before the final norm and head: the early-exit
        draft."""
        c = self.config
        b, s = input_ids.shape
        self._check_length(s)
        idx = cache_positions.reshape(b).to(torch.int32).contiguous()
        bt = block_tables.to(torch.int32).contiguous()
        quantized = "k_scale" in paged_kv
        x = self.embed_tokens(self._token_ids(input_ids))
        layers = self.layers if num_layers is None else self.layers[:num_layers]
        for i, layer in enumerate(layers):
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


def llama_early_exit_apply(model: LlamaForCausalLM, draft_layers: int):
    """Early-exit draft for speculative decoding (port of JAX
    ``llama_early_exit_apply``): a paged step running only the target's
    first ``draft_layers`` blocks, closed with the target's own final norm
    and head. It shares the target's weights (no copy) and reads and
    writes the FIRST ``draft_layers`` layers of the target's own paged pool:
    identical weights make the draft's K/V at any cached position equal the
    target's for those layers, so prefix sharing, copy-on-write and swap
    keep the draft state for free. The returned function takes
    :meth:`LlamaForCausalLM.paged_step`'s arguments."""
    config = model.config
    if not 1 <= draft_layers < config.num_hidden_layers:
        raise ValueError(
            f"early-exit draft needs 1 <= layers < {config.num_hidden_layers} "
            f"(the target's depth), got {draft_layers}"
        )

    def early_exit_apply(input_ids, paged_kv, block_tables, cache_positions,
                         paged_write_mask=None, attn_impl=None) -> ModelOutput:
        return model.paged_step(input_ids, paged_kv, block_tables, cache_positions,
                                paged_write_mask=paged_write_mask, attn_impl=attn_impl,
                                num_layers=draft_layers)

    return early_exit_apply
