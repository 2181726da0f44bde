"""T5 encoder-decoder (port of ``accelerate_tpu/models/t5.py``): RMSNorm
without bias, unscaled QKᵀ plus a log-bucketed relative-position bias
(computed once a stack and shared by its layers; bidirectional in the
encoder, causal in the decoder; none in cross-attention), bias-free
projections, the v1.0 ReLU or v1.1 gated-GELU FFN, and a head tied to
``shared`` with a ``d_model^-0.5`` scale (v1.0) or an untied ``lm_head``
(v1.1).

Attention is JAX's own ``_t5_attention`` in plain PyTorch (softmax in
f32): the flash kernels take no additive bias, so T5 runs no kernel, as in
JAX. ``generate()`` runs it through its seq2seq loop
(:func:`~..generation.generate`, ``is_encoder_decoder``);
:meth:`T5ForConditionalGeneration.segments` is the streaming plan a
:class:`~..big_modeling.DispatchedModel` runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..modules import ModelOutput
from ..ops.fp8 import dense
from ..ops.layers import cross_entropy_loss, rms_norm, table_rows
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf
from .gpt2 import gelu_tanh, hf_getter


@dataclass
class T5Config:
    vocab_size: int = 32128
    hidden_size: int = 512  # d_model
    d_kv: int = 64  # per-head dim (T5 decouples it from d_model / heads)
    d_ff: int = 2048
    num_layers: int = 6  # encoder depth
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # "relu" (v1.0) | "gated-gelu" (v1.1)
    tie_word_embeddings: bool = True
    decoder_start_token_id: int = 0
    remat: bool | str = False  # False | True | a jax.checkpoint_policies name

    def __post_init__(self):
        remat_policy(self.remat)

    @classmethod
    def t5_small(cls):
        return cls()

    @classmethod
    def t5_base(cls):
        return cls(hidden_size=768, d_ff=3072, num_layers=12, num_decoder_layers=12, num_heads=12)

    @classmethod
    def t5_11b(cls):
        return cls(
            hidden_size=1024, d_kv=128, d_ff=65536,
            num_layers=24, num_decoder_layers=24, num_heads=128,
        )

    @classmethod
    def tiny(cls, vocab_size=256, hidden_size=64, layers=2, heads=4):
        return cls(
            vocab_size=vocab_size, hidden_size=hidden_size, d_kv=hidden_size // heads,
            d_ff=hidden_size * 3, num_layers=layers, num_decoder_layers=layers,
            num_heads=heads,
        )


def _ffn_leaves(c: T5Config) -> dict:
    h, ff = c.hidden_size, c.d_ff
    if c.feed_forward_proj == "gated-gelu":
        ffn = {"wi_0": Leaf((ff, h), h ** -0.5), "wi_1": Leaf((ff, h), h ** -0.5)}
    else:
        ffn = {"wi": Leaf((ff, h), h ** -0.5)}
    ffn["wo_ffn"] = Leaf((h, ff), ff ** -0.5)
    return ffn


def _attn_leaves(c: T5Config, prefix: str) -> dict:
    h, inner = c.hidden_size, c.num_heads * c.d_kv
    return {f"{prefix}q": Leaf((inner, h), (h * c.d_kv) ** -0.5),
            f"{prefix}k": Leaf((inner, h), h ** -0.5),
            f"{prefix}v": Leaf((inner, h), h ** -0.5),
            f"{prefix}o": Leaf((h, inner), inner ** -0.5)}


def t5_spec(c: T5Config) -> dict:
    h = c.hidden_size
    enc = {"attn_norm": Leaf((h,), "ones"), **_attn_leaves(c, "w"),
           "ffn_norm": Leaf((h,), "ones"), **_ffn_leaves(c)}
    dec = {"attn_norm": Leaf((h,), "ones"), **_attn_leaves(c, "w"),
           "cross_norm": Leaf((h,), "ones"), **_attn_leaves(c, "c"),
           "ffn_norm": Leaf((h,), "ones"), **_ffn_leaves(c)}
    bias = Leaf((c.relative_attention_num_buckets, c.num_heads), h ** -0.5)
    spec = {
        "shared": Leaf((c.vocab_size, h), 1.0),
        "encoder": {"rel_bias": bias, "layers": [dict(enc) for _ in range(c.num_layers)],
                    "final_norm": Leaf((h,), "ones")},
        "decoder": {"rel_bias": bias,
                    "layers": [dict(dec) for _ in range(c.num_decoder_layers)],
                    "final_norm": Leaf((h,), "ones")},
    }
    if not c.tie_word_embeddings:
        spec["lm_head"] = Leaf((c.vocab_size, h), h ** -0.5)
    return spec


def init_t5_params(generator: torch.Generator, config: T5Config, dtype=torch.float32,
                   device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`T5ForConditionalGeneration`."""
    return _params.init_state_dict(generator, t5_spec(config), dtype, device)


_T5_PROJ = ("wq", "wk", "wv", "wo", "cq", "ck", "cv", "co", "wi", "wi_0", "wi_1", "wo_ffn",
            "lm_head")


def params_from_jax(np_params, config: T5Config) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict."""
    return _params.state_dict_from_jax(np_params, _params.transposed(_T5_PROJ))


jax_param_name = _params.jax_param_name


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions (HF
    ``T5Attention._relative_position_bucket``), in JAX's f32 arithmetic."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact)
    large = max_exact + (log_ratio * (num_buckets - max_exact)).to(ret.dtype)
    large = large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def compute_position_bias(rel_bias: torch.Tensor, q_len: int, k_len: int, bidirectional: bool,
                          num_buckets: int, max_distance: int) -> torch.Tensor:
    """``[1, num_heads, q_len, k_len]`` additive score bias."""
    dev = rel_bias.device
    ctx = torch.arange(q_len, dtype=torch.int32, device=dev)[:, None]
    mem = torch.arange(k_len, dtype=torch.int32, device=dev)[None, :]
    buckets = relative_position_bucket(mem - ctx, bidirectional, num_buckets, max_distance)
    return rel_bias[buckets.long()].permute(2, 0, 1)[None]


def _t5_attention(q, k, v, bias, mask):
    """Unscaled QKᵀ plus ``bias`` (broadcast to ``[b, nh, sq, sk]``, or
    None), keys past ``mask [b, sk]`` at -1e9, softmax in f32."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = torch.where(mask[:, None, None, :].bool(), scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def shift_right(labels: torch.Tensor, decoder_start_token_id: int, pad_id: int = 0):
    """Teacher-forcing decoder inputs (HF ``_shift_right``): the start
    token, then the labels without their last position, -100 as pad."""
    shifted = torch.roll(labels, 1, dims=-1)
    shifted[:, 0] = decoder_start_token_id
    return torch.where(shifted == -100, pad_id, shifted)


class T5ForConditionalGeneration(_params.SpecModel):
    """T5 (port of the JAX ``T5ForConditionalGeneration``)."""

    is_encoder_decoder = True
    _spec = staticmethod(t5_spec)

    def _attend(self, w, x, kv_in, prefix, bias, mask):
        c = self.config
        b, s, _ = x.shape
        nh, kv = c.num_heads, c.d_kv
        q = dense(x, w[f"{prefix}q"]).reshape(b, s, nh, kv)
        k = dense(kv_in, w[f"{prefix}k"]).reshape(b, kv_in.shape[1], nh, kv)
        v = dense(kv_in, w[f"{prefix}v"]).reshape(b, kv_in.shape[1], nh, kv)
        return dense(_t5_attention(q, k, v, bias, mask).reshape(b, s, nh * kv), w[f"{prefix}o"])

    def _ffn(self, w, x):
        c = self.config
        y = rms_norm(x, w["ffn_norm"], c.layer_norm_epsilon)
        if c.feed_forward_proj == "gated-gelu":
            z = gelu_tanh(dense(y, w["wi_0"])) * dense(y, w["wi_1"])
        else:
            z = F.relu(dense(y, w["wi"]))
        return x + dense(z, w["wo_ffn"])

    def _encoder_block(self, w, x, bias, mask):
        eps = self.config.layer_norm_epsilon
        y = rms_norm(x, w["attn_norm"], eps)
        return self._ffn(w, x + self._attend(w, y, y, "w", bias, mask))

    def _decoder_block(self, w, x, bias, dec_mask, enc_out, enc_mask):
        eps = self.config.layer_norm_epsilon
        y = rms_norm(x, w["attn_norm"], eps)
        x = x + self._attend(w, y, y, "w", bias, dec_mask)
        y = rms_norm(x, w["cross_norm"], eps)
        x = x + self._attend(w, y, enc_out, "c", None, enc_mask)
        return self._ffn(w, x)

    def _bias(self, rel_bias, s: int, bidirectional: bool):
        c = self.config
        bias = compute_position_bias(rel_bias, s, s, bidirectional,
                                     c.relative_attention_num_buckets,
                                     c.relative_attention_max_distance)
        if bidirectional:
            return bias
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=bias.device))[None, None]
        return torch.where(causal, bias, -1e9)

    def encode(self, input_ids, attention_mask=None):
        """The encoder stack and its final norm (port of ``t5_encode``)."""
        c = self.config
        x = self.shared[table_rows(input_ids, c.vocab_size)]
        bias = self._bias(self.encoder.rel_bias, input_ids.shape[1], True)
        for layer in self.encoder.layers:
            x = _params.apply_layer(self._encoder_block, c.remat, layer, x, bias, attention_mask)
        return rms_norm(x, self.encoder.final_norm, c.layer_norm_epsilon)

    def decode(self, decoder_input_ids, decoder_attention_mask, enc_out, enc_mask):
        """The decoder stack and its final norm (port of ``t5_decode``):
        the relative bias merged with the causal mask (-1e9 above the
        diagonal)."""
        c = self.config
        x = self.shared[table_rows(decoder_input_ids, c.vocab_size)]
        bias = self._bias(self.decoder.rel_bias, decoder_input_ids.shape[1], False)
        for layer in self.decoder.layers:
            x = _params.apply_layer(self._decoder_block, c.remat, layer, x, bias,
                                    decoder_attention_mask, enc_out, enc_mask)
        return rms_norm(x, self.decoder.final_norm, c.layer_norm_epsilon)

    def forward(self, input_ids=None, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None, labels=None, encoder_outputs=None) -> ModelOutput:
        """Seq2seq forward (port of ``t5_apply``). With ``labels`` and no
        ``decoder_input_ids`` the decoder reads the shifted-right labels
        (the HF contract) and the loss is the unshifted CE: decoder position
        t predicts label t. ``encoder_outputs [b, s_enc, h]`` skips the
        encoder (generation encodes the prompt once). Returns ``logits``,
        ``encoder_last_hidden_state`` and, with ``labels``, ``loss``."""
        c = self.config
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("T5 needs decoder_input_ids or labels")
            decoder_input_ids = shift_right(labels, c.decoder_start_token_id)
        enc_out = (encoder_outputs if encoder_outputs is not None
                   else self.encode(input_ids, attention_mask))
        x = self.decode(decoder_input_ids, decoder_attention_mask, enc_out, attention_mask)
        head = self.lm_head if "lm_head" in self._parameters else (
            self.shared * c.hidden_size ** -0.5)
        logits = dense(x, head)
        out = ModelOutput(logits=logits, encoder_last_hidden_state=enc_out)
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits, labels)  # no shift: seq2seq
        return out

    def segments(self, input_ids=None, attention_mask=None, decoder_input_ids=None,
                 decoder_attention_mask=None, labels=None, encoder_outputs=None, **kw):
        """The streaming plan (port of ``t5_segments``): encoder embed → a
        step an encoder layer → its norm → decoder embed → a step a decoder
        layer → norm and head; the carry holds the encoder's output for
        cross-attention. ``encoder_outputs`` skips the encoder's steps, as
        :meth:`forward` does. The tied head scales the hidden state rather
        than the table, as JAX's plan does, so a quantized table stays
        quantized for :func:`~..ops.fp8.dense`."""
        c = self.config
        eps = c.layer_norm_epsilon
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("T5 needs decoder_input_ids or labels")
            decoder_input_ids = shift_right(labels, c.decoder_start_token_id)

        def layer_step(side, i, block, *extra):
            names = getattr(self, side).layers[i].leaf_names

            def fn(seg, carry):
                w = {n: seg[f"{side}.layers.{i}.{n}"] for n in names}
                return {**carry, "x": block(w, carry["x"], *(e(carry) for e in extra))}

            return (f"{side}_layer", i), [f"{side}.layers.{i}.{n}" for n in names], fn

        def embed_step(side, ids, bidirectional):
            def fn(seg, carry):
                bias = self._bias(seg[f"{side}.rel_bias"], ids.shape[1], bidirectional)
                return {**carry, "x": seg["shared"][table_rows(ids, c.vocab_size)],
                        "bias": bias}

            return f"{side}_embed", ["shared", f"{side}.rel_bias"], fn

        steps = []
        if encoder_outputs is None:
            steps.append(embed_step("encoder", input_ids, True))
            steps += [layer_step("encoder", i, self._encoder_block, lambda cr: cr["bias"],
                                 lambda cr: attention_mask) for i in range(c.num_layers)]
            steps.append(("encoder_final", ["encoder.final_norm"], lambda seg, carry: {
                "enc_out": rms_norm(carry["x"], seg["encoder.final_norm"], eps)}))
        steps.append(embed_step("decoder", decoder_input_ids, False))
        steps += [layer_step("decoder", i, self._decoder_block, lambda cr: cr["bias"],
                             lambda cr: decoder_attention_mask, lambda cr: cr["enc_out"],
                             lambda cr: attention_mask) for i in range(c.num_decoder_layers)]
        tied = "lm_head" not in self._parameters

        def head(seg, carry):
            x = rms_norm(carry["x"], seg["decoder.final_norm"], eps)
            if tied:
                x = x * c.hidden_size ** -0.5
            return {**carry, "logits": dense(x, seg["shared" if tied else "lm_head"])}

        steps.append(("head", ["decoder.final_norm", "shared" if tied else "lm_head"], head))

        def finalize(carry):
            out = ModelOutput(logits=carry["logits"], encoder_last_hidden_state=carry["enc_out"])
            if labels is not None:
                out["loss"] = cross_entropy_loss(carry["logits"], labels)
            return out

        init = (lambda: {}) if encoder_outputs is None else (lambda: {"enc_out": encoder_outputs})
        return {"init": init, "steps": steps, "finalize": finalize}

    def convert_state_dict(self, flat: dict) -> dict[str, torch.Tensor]:
        """An HF-layout state dict as this model's, for ``load_state_dict``
        (:func:`convert_hf_t5_state_dict`)."""
        return convert_hf_t5_state_dict(flat, self.config)


def convert_hf_t5_state_dict(flat: dict, config: T5Config) -> dict[str, torch.Tensor]:
    """An HF transformers T5 state dict → this model's (port of JAX
    ``convert_hf_t5_state_dict``). HF's ``[out, in]`` weights are the
    port's layout already."""
    c = config
    get = hf_getter(flat, ("",))
    sd = {"shared": get("shared.weight")}
    ffn = ("wi_0", "wi_1") if c.feed_forward_proj == "gated-gelu" else ("wi",)
    for side, count in (("encoder", c.num_layers), ("decoder", c.num_decoder_layers)):
        sd[f"{side}.rel_bias"] = get(
            f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
        sd[f"{side}.final_norm"] = get(f"{side}.final_layer_norm.weight")
        ff = 1 if side == "encoder" else 2
        for i in range(count):
            blk, ours = f"{side}.block.{i}.layer", f"{side}.layers.{i}"
            sd[f"{ours}.attn_norm"] = get(f"{blk}.0.layer_norm.weight")
            for n in "qkvo":
                sd[f"{ours}.w{n}"] = get(f"{blk}.0.SelfAttention.{n}.weight")
            for n in ffn:
                sd[f"{ours}.{n}"] = get(f"{blk}.{ff}.DenseReluDense.{n}.weight")
            sd[f"{ours}.wo_ffn"] = get(f"{blk}.{ff}.DenseReluDense.wo.weight")
            sd[f"{ours}.ffn_norm"] = get(f"{blk}.{ff}.layer_norm.weight")
            if side == "decoder":
                sd[f"{ours}.cross_norm"] = get(f"{blk}.1.layer_norm.weight")
                for n in "qkvo":
                    sd[f"{ours}.c{n}"] = get(f"{blk}.1.EncDecAttention.{n}.weight")
    if not c.tie_word_embeddings and "lm_head.weight" in flat:
        sd["lm_head"] = get("lm_head.weight")
    return sd
