"""GPT-2 causal LM (port of ``accelerate_tpu/models/gpt2.py``): the classic
pre-LN transformer with learned positions, true LayerNorm, a fused QKV
projection, a GELU MLP and the LM head tied to ``wte``.

Also the pieces the zoo's other families share, as the JAX package shares
them from this module: :func:`layer_norm` (opt, gpt_neox, vit) and
:class:`CausalLM`, the training forward, prefill and dense-cache decode
step of a decoder family (gpt2, opt, gpt_neox). The JAX model keeps
layer-stacked params and scans one block over them; here each layer is a
submodule holding the JAX leaves by their names (projections ``[out,
in]``, the transpose of JAX's), and the layer loop is a Python loop.
Ported: the config and its presets, the init, ``params_from_jax``, the
forward with its prefill mode (``use_cache=True``), the decode step
``generate()`` runs (:meth:`CausalLM.cached_step`), the streaming segments
a :class:`~..big_modeling.DispatchedModel` runs (:meth:`CausalLM.segments`)
and the HF converter. The pipelined stacks are a later slice (ROADMAP item
18).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..modules import ModelOutput
from ..ops.attention import attention
from ..ops.fp8 import dense
from ..ops.layers import (
    cached_attend,
    cross_entropy_loss,
    fused_cross_entropy,
    shift_labels,
    table_rows,
)
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf


@dataclass
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    remat: bool | str = False  # False | True | a jax.checkpoint_policies name

    def __post_init__(self):
        remat_policy(self.remat)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @classmethod
    def tiny(cls, vocab_size=256, hidden_size=64, layers=2, heads=4, seq=128):
        return cls(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            max_position_embeddings=seq,
        )


def layer_norm(x, g, b, eps):
    """True LayerNorm in f32 (GPT-2 centres the mean, unlike llama's
    RMSNorm), cast back to ``x.dtype``."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()
    return out.to(x.dtype)


def gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gpt2_spec(c: GPT2Config) -> dict:
    """The parameters (port layout): GPT-2's fixed 0.02-std init."""
    h, ff = c.hidden_size, c.intermediate_size
    layer = {
        "ln1_g": Leaf((h,), "ones"), "ln1_b": Leaf((h,), "zeros"),
        "w_qkv": Leaf((3 * h, h), 0.02), "b_qkv": Leaf((3 * h,), "zeros"),
        "w_proj": Leaf((h, h), 0.02), "b_proj": Leaf((h,), "zeros"),
        "ln2_g": Leaf((h,), "ones"), "ln2_b": Leaf((h,), "zeros"),
        "w_fc": Leaf((ff, h), 0.02), "b_fc": Leaf((ff,), "zeros"),
        "w_out": Leaf((h, ff), 0.02), "b_out": Leaf((h,), "zeros"),
    }
    return {
        "wte": Leaf((c.vocab_size, h), 0.02),
        "wpe": Leaf((c.max_position_embeddings, h), 0.02),
        "layers": [dict(layer) for _ in range(c.num_hidden_layers)],
        "ln_f_g": Leaf((h,), "ones"), "ln_f_b": Leaf((h,), "zeros"),
    }


def init_gpt2_params(generator: torch.Generator, config: GPT2Config, dtype=torch.float32,
                     device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`GPT2LMHeadModel`."""
    return _params.init_state_dict(generator, gpt2_spec(config), dtype, device)


#: the projections, ``[in, out]`` in JAX and ``[out, in]`` here
_GPT2_PROJ = ("w_qkv", "w_proj", "w_fc", "w_out")


def params_from_jax(np_params, config: GPT2Config) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict."""
    return _params.state_dict_from_jax(np_params, _params.transposed(_GPT2_PROJ))


jax_param_name = _params.jax_param_name


def convert_hf_gpt2_state_dict(flat: dict, config: GPT2Config) -> dict[str, torch.Tensor]:
    """An HF transformers GPT-2 state dict (``transformer.h.{i}.attn.c_attn.weight``,
    ..., with or without the ``transformer.`` prefix) → this model's state
    dict (port of JAX ``convert_hf_gpt2_state_dict``). HF's Conv1D weights
    are ``[in, out]``, as JAX's, so each projection is transposed here."""
    names = {
        "ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias",
        "w_qkv": "attn.c_attn.weight", "b_qkv": "attn.c_attn.bias",
        "w_proj": "attn.c_proj.weight", "b_proj": "attn.c_proj.bias",
        "ln2_g": "ln_2.weight", "ln2_b": "ln_2.bias",
        "w_fc": "mlp.c_fc.weight", "b_fc": "mlp.c_fc.bias",
        "w_out": "mlp.c_proj.weight", "b_out": "mlp.c_proj.bias",
    }
    get = hf_getter(flat, ("transformer.", ""))
    sd = {"wte": get("wte.weight"), "wpe": get("wpe.weight"),
          "ln_f_g": get("ln_f.weight"), "ln_f_b": get("ln_f.bias")}
    for i in range(config.num_hidden_layers):
        for ours, theirs in names.items():
            t = get(f"h.{i}.{theirs}")
            sd[f"layers.{i}.{ours}"] = t.t().contiguous() if ours in _GPT2_PROJ else t
    return sd


def hf_getter(flat: dict, prefixes):
    """``get(name)``: the tensor at the first ``prefix + name`` of ``flat``
    (tensors or numpy arrays), as a CPU tensor."""

    def get(name):
        for prefix in prefixes:
            if prefix + name in flat:
                x = flat[prefix + name]
                return x.detach().clone() if isinstance(x, torch.Tensor) else _params.as_tensor(x)
        raise KeyError(name)

    return get


class CausalLM(_params.SpecModel):
    """A decoder family's model over a parameter spec: the training / eval
    forward, its prefill mode and the dense KV-cache decode step that
    ``generate()`` runs. A family gives its spec, ``_embed``, ``_block``
    (one layer, attention through the ``attend(q, k, v)`` it is handed),
    ``_final`` and ``_head``. ``_embed``, ``_final``, ``_head`` and
    ``_logits`` read the model's own top-level leaves, or the dict ``w``
    that a streamed segment hands them (``_embed_leaves``, ``_head_leaves``
    name what those segments stream)."""

    supports_kv_cache = True
    _embed_leaves = ("wte", "wpe")
    _head_leaves = ("ln_f_g", "ln_f_b", "wte")

    def kv_cache_shape(self, batch: int, length: int) -> tuple:
        """``[L, b, length, kv heads, head_dim]``: one dense cache."""
        c = self.config
        return (c.num_hidden_layers, batch, length,
                getattr(c, "num_key_value_heads", c.num_attention_heads), c.head_dim)

    def _check_length(self, s: int) -> None:
        if s > self.config.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings "
                f"{self.config.max_position_embeddings}: the position lookup would "
                "silently clamp, producing wrong logits"
            )

    def _final(self, x, w=None):
        w = self._parameters if w is None else w
        return layer_norm(x, w["ln_f_g"], w["ln_f_b"], self.config.layer_norm_eps)

    def _logits(self, x, w=None):
        head, bias = self._head(w)
        logits = dense(x, head)
        return logits if bias is None else logits + bias

    def segments(self, input_ids=None, attention_mask=None, positions=None, labels=None,
                 **kw):
        """The streaming plan (port of ``gpt2_segments``, ``opt_segments``
        and ``gpt_neox_segments``): embed → one step a layer → final norm
        and head, each step a function of its streamed weights and the
        carry. The layer step is the family's ``_block``, so its attention
        runs :func:`~..ops.attention.attention` (B1 on the card)."""
        b, s = input_ids.shape
        self._check_length(s)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)

        def attend(q, k, v):
            return attention(q, k, v, segment_mask=attention_mask, causal=True)

        def layer_step(i):
            names = self.layers[i].leaf_names

            def fn(seg, carry):
                w = {n: seg[f"layers.{i}.{n}"] for n in names}
                out = self._block(w, carry["x"], positions, attend)
                return {"x": out[0] if isinstance(out, tuple) else out}

            return ("layer", i), [f"layers.{i}.{n}" for n in names], fn

        head_leaves = [n for n in self._head_leaves if n in self._parameters]
        steps = [("embed", list(self._embed_leaves),
                  lambda seg, carry: {"x": self._embed(input_ids, positions, seg)})]
        steps += [layer_step(i) for i in range(len(self.layers))]
        steps.append(("head", head_leaves,
                      lambda seg, carry: {"logits": self._logits(self._final(carry["x"], seg),
                                                                  seg)}))

        def finalize(carry):
            out = ModelOutput(logits=carry["logits"])
            if labels is not None:
                out["loss"] = cross_entropy_loss(carry["logits"][:, :-1, :], labels[:, 1:])
            return out

        return {"init": dict, "steps": steps, "finalize": finalize}

    def _run_layer(self, i: int, x, positions, attend):
        """Layer ``i``; a family with an auxiliary output (Mixtral) returns
        ``(x, aux)``."""
        return self._block(_params.weights(self.layers[i]), x, positions, attend)

    def forward(self, input_ids, attention_mask=None, labels=None, positions=None,
                return_logits: bool = False, use_cache: bool = False,
                max_cache_len: int | None = None, kv_cache=None, cache_index=None,
                spare_slot: bool = False) -> ModelOutput:
        """Training / eval forward over ``input_ids [b, s]`` with causal
        attention; ``attention_mask [b, s]`` (1 = real token) masks keys.
        With ``labels [b, s]`` (-100 ignored) the loss is the next-token CE,
        computed from the pre-head hidden states one sequence chunk at a
        time (:func:`~..ops.layers.fused_cross_entropy`), and the logits
        over the whole sequence are skipped unless ``return_logits``: XLA
        drops them in JAX when only the loss is forced. ``use_cache=True``
        also returns each layer's K/V in ``out.kv_cache`` ``{"k", "v"}: [L,
        b, max_cache_len, heads, hd]`` (zeros past ``s``); ``kv_cache=``
        with ``cache_index=`` is :meth:`cached_step`."""
        c = self.config
        b, s = input_ids.shape
        self._check_length(s)
        if kv_cache is not None:
            return self.cached_step(input_ids, kv_cache, cache_index, spare_slot)
        if positions is None:
            positions = torch.arange(s, device=input_ids.device)[None, :].expand(b, s)
        x = self._embed(input_ids, positions)
        caches = None
        if use_cache:
            max_cache = int(max_cache_len or c.max_position_embeddings)
            if not s <= max_cache <= c.max_position_embeddings:
                raise ValueError(
                    f"max_cache_len {max_cache} must be in [{s} (prompt length), "
                    f"{c.max_position_embeddings} (max_position_embeddings)]"
                )
            shape = self.kv_cache_shape(b, max_cache)
            caches = {n: torch.zeros(shape, dtype=x.dtype, device=x.device) for n in "kv"}
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            if caches is not None:
                def attend(q, k, v, i=i):
                    caches["k"][i, :, :s] = k
                    caches["v"][i, :, :s] = v
                    return attention(q, k, v, segment_mask=attention_mask, causal=True)

                out = self._run_layer(i, x, positions, attend)
            else:
                out = _params.apply_layer(self._train_block, c.remat, layer, x, positions,
                                          attention_mask)
            if isinstance(out, tuple):
                x, aux = out
                aux_total = aux_total + aux
            else:
                x = out
        x = self._final(x)
        out = ModelOutput()
        if labels is None or return_logits:
            out["logits"] = self._logits(x)
        if caches is not None:
            out["kv_cache"] = caches
        self._add_losses(out, x, labels, aux_total)
        return out

    def _train_block(self, w, x, positions, attention_mask):
        return self._block(w, x, positions, lambda q, k, v: attention(
            q, k, v, segment_mask=attention_mask, causal=True))

    def _add_losses(self, out, x, labels, aux_total) -> None:
        if labels is not None:
            head, bias = self._head()
            out["loss"] = fused_cross_entropy(x, head.t(), shift_labels(labels), bias=bias)

    @torch.no_grad()
    def cached_step(self, input_ids, kv_cache, cache_index,
                    spare_slot: bool = False) -> ModelOutput:
        """One dense KV-cache decode step: ``input_ids [b, s]`` (``s == 1``
        a decode token, ``s > 1`` a verify chunk) at each row's own cache
        position ``cache_index [b]``. ``kv_cache`` ``{"k", "v"}`` is
        **updated in place** and attention runs against each row's prefix,
        both through :func:`~..ops.layers.cached_attend` (whose
        ``spare_slot`` this is; plain PyTorch, as JAX computes it outside
        any Pallas kernel), as the llama's decode step does. Returns
        ``ModelOutput(logits [b, s, vocab], kv_cache)``."""
        b, s = input_ids.shape
        self._check_length(s)
        idx = cache_index.reshape(b)
        positions = idx[:, None].long() + torch.arange(s, device=input_ids.device)[None, :]
        x = self._embed(input_ids, positions)
        for i in range(len(self.layers)):
            attend = cached_attend(kv_cache["k"][i], kv_cache["v"][i], idx, spare_slot)
            out = self._run_layer(i, x, positions, attend)
            x = out[0] if isinstance(out, tuple) else out
        return ModelOutput(logits=self._logits(self._final(x)), kv_cache=kv_cache)


class GPT2LMHeadModel(CausalLM):
    """GPT-2 (port of the JAX ``GPT2LMHeadModel``). The head is ``wte``
    itself: one Parameter, so its gradient sums both uses, as JAX's
    does."""

    _spec = staticmethod(gpt2_spec)

    def _embed(self, input_ids, positions, w=None):
        c = self.config
        w = self._parameters if w is None else w
        return (w["wte"][table_rows(input_ids, c.vocab_size)]
                + w["wpe"][table_rows(positions, c.max_position_embeddings)])

    def _head(self, w=None):
        return (self._parameters if w is None else w)["wte"], None

    def _block(self, w, x, positions, attend):
        """One pre-LN block (port of ``gpt2_layer_apply``)."""
        c = self.config
        b, s, h = x.shape
        nh, hd = c.num_attention_heads, c.head_dim
        y = layer_norm(x, w["ln1_g"], w["ln1_b"], c.layer_norm_eps)
        qkv = dense(y, w["w_qkv"]) + w["b_qkv"]
        q, k, v = (z.reshape(b, s, nh, hd) for z in qkv.split(h, dim=-1))
        attn = attend(q, k, v)
        x = x + dense(attn.reshape(b, s, h), w["w_proj"]) + w["b_proj"]
        y = layer_norm(x, w["ln2_g"], w["ln2_b"], c.layer_norm_eps)
        return x + dense(gelu_tanh(dense(y, w["w_fc"]) + w["b_fc"]), w["w_out"]) + w["b_out"]

    def convert_state_dict(self, flat: dict) -> dict[str, torch.Tensor]:
        """An HF-layout state dict as this model's, for ``load_state_dict``."""
        return convert_hf_gpt2_state_dict(flat, self.config)
