"""BERT-style bidirectional encoder for sequence(-pair) classification
(port of ``accelerate_tpu/models/bert.py``): learned position and
token-type embeddings, pre-norm blocks with RMSNorm (as the JAX model has
them), non-causal attention with a key mask through
:func:`~..ops.attention.attention` (the flash kernels on the card, as the
LMs), a tanh-GELU MLP, ``[CLS]`` pooling and a linear head. Each layer is a
submodule holding the JAX leaves by their names, projections ``[out,
in]``. :meth:`BertForSequenceClassification.segments` is the streaming
plan a :class:`~..big_modeling.DispatchedModel` runs; the pipelined stack
is a later slice (ROADMAP item 18).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..parallel.sharding import NO_TP, local, vocab_parallel_embedding
from ..parallel.sharding import PartitionSpec as P
from ..modules import ModelOutput
from ..ops.attention import attention
from ..ops.fp8 import dense
from ..ops.layers import rms_norm, table_rows, token_loss
from ..parallel.context import first_token, sequence_shard
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf
from .gpt2 import gelu_tanh


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    norm_eps: float = 1e-12
    remat: bool | str = False  # False | True | a jax.checkpoint_policies name

    def __post_init__(self):
        remat_policy(self.remat)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size=512, hidden_size=64, layers=2, heads=4, seq=64, num_labels=2):
        return cls(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=hidden_size * 4,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            max_position_embeddings=seq,
            num_labels=num_labels,
        )


def bert_spec(c: BertConfig) -> dict:
    h, ff = c.hidden_size, c.intermediate_size
    layer = {
        "wq": Leaf((h, h), h ** -0.5), "wk": Leaf((h, h), h ** -0.5),
        "wv": Leaf((h, h), h ** -0.5), "wo": Leaf((h, h), h ** -0.5),
        "w_in": Leaf((ff, h), h ** -0.5), "w_out": Leaf((h, ff), ff ** -0.5),
        "attn_norm": Leaf((h,), "ones"), "mlp_norm": Leaf((h,), "ones"),
    }
    return {
        "embed_tokens": Leaf((c.vocab_size, h), 0.02),
        "embed_positions": Leaf((c.max_position_embeddings, h), 0.02),
        "embed_types": Leaf((c.type_vocab_size, h), 0.02),
        "emb_norm": Leaf((h,), "ones"),
        "layers": [dict(layer) for _ in range(c.num_hidden_layers)],
        "norm": Leaf((h,), "ones"),
        "classifier": {"w": Leaf((c.num_labels, h), h ** -0.5),
                       "b": Leaf((c.num_labels,), "zeros")},
    }


def init_bert_params(generator: torch.Generator, config: BertConfig, dtype=torch.float32,
                     device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`BertForSequenceClassification`."""
    return _params.init_state_dict(generator, bert_spec(config), dtype, device)


def params_from_jax(np_params, config: BertConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict."""
    return _params.state_dict_from_jax(
        np_params, _params.transposed(("wq", "wk", "wv", "wo", "w_in", "w_out", "w")))


jax_param_name = _params.jax_param_name


#: path regex → PartitionSpec over JAX's leaf names (the JAX package's
#: ``BERT_PARTITION_RULES``): a layer-stacked leaf has a leading
#: ``[layers]`` dim, which is never sharded
BERT_PARTITION_RULES = [
    (r"embed_tokens", P("tp", "fsdp")),
    (r"embed_positions", P(None, "fsdp")),
    (r"embed_types", P(None, "fsdp")),
    (r"layers\.(wq|wk|wv)", P(None, "fsdp", "tp")),
    (r"layers\.wo", P(None, "tp", "fsdp")),
    (r"layers\.w_in", P(None, "fsdp", "tp")),
    (r"layers\.w_out", P(None, "tp", "fsdp")),
    (r"norm", P()),
    (r"classifier\.w", P("fsdp", None)),
    (r"classifier\.b", P()),
]

#: the 2-D leaves JAX holds as ``[in, out]`` and the port as ``[out, in]``
#: (:func:`~..parallel.sharding.jax_leaves`)
JAX_TRANSPOSED = ("wq", "wk", "wv", "wo", "w_in", "w_out", "w")


class BertForSequenceClassification(_params.SpecModel):
    """BERT (port of the JAX ``BertForSequenceClassification``):
    ``forward(input_ids, attention_mask=None, token_type_ids=None,
    labels=None)`` → ``logits [b, num_labels]`` and, with ``labels [b]``,
    the mean NLL ``loss``."""

    partition_rules = BERT_PARTITION_RULES

    _spec = staticmethod(bert_spec)

    #: the inputs a ``cp`` rank takes its chunk of (``PreparedModel``)
    sequence_inputs = ("input_ids", "attention_mask", "token_type_ids")

    def _block(self, w, x, attention_mask, tp=NO_TP):
        """One encoder block (port of ``bert_layer_apply``): under tensor
        parallelism q, k, v and ``w_in`` run column shards, ``wo`` and
        ``w_out`` row shards."""
        c = self.config
        b, s, h = x.shape
        nh, hd = tp.heads(c.num_attention_heads, "wq"), c.head_dim
        y = tp.enter(rms_norm(x, w["attn_norm"], c.norm_eps), "wq")
        q, k, v = (dense(y, w[n]).reshape(b, s, nh, hd) for n in ("wq", "wk", "wv"))
        attn = attention(q, k, v, segment_mask=attention_mask, causal=False)
        x = x + tp.leave(dense(attn.reshape(b, s, nh * hd), w["wo"]), "wo")
        y = tp.enter(rms_norm(x, w["mlp_norm"], c.norm_eps), "w_in")
        return x + tp.leave(dense(gelu_tanh(dense(y, w["w_in"])), w["w_out"]), "w_out")

    def _embed(self, w, input_ids, token_type_ids, offset: int = 0, tp=NO_TP):
        c = self.config
        pos = offset + torch.arange(input_ids.shape[1], device=input_ids.device)
        tokens = vocab_parallel_embedding(table_rows(input_ids, c.vocab_size),
                                          w["embed_tokens"], c.vocab_size, tp.rank,
                                          tp.group if tp.on("embed_tokens") else None)
        x = (tokens + w["embed_positions"][table_rows(pos, c.max_position_embeddings)][None]
             + w["embed_types"][table_rows(token_type_ids, c.type_vocab_size)])
        return rms_norm(x, w["emb_norm"], c.norm_eps)

    @staticmethod
    def _inputs(input_ids, attention_mask, token_type_ids):
        b, s = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int32, device=dev)
        return attention_mask, token_type_ids

    @staticmethod
    def _output(logits, labels) -> ModelOutput:
        """The logits and, with ``labels``, the mean NLL over the global
        batch (every ``cp`` rank pools the same ``[CLS]`` rows)."""
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = token_loss(logits, labels, whole_batch=True)
        return out

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                labels=None) -> ModelOutput:
        """Under context parallelism a ``cp`` rank holds its chunk of the
        sequence (positions offset by ``cp_rank × s``, the key mask with
        it), and the ``[CLS]`` row, which only rank 0 holds, reaches every
        rank through a differentiable sum
        (:func:`~..parallel.context.first_token`)."""
        c = self.config
        cp_group, cp_rank, _ = sequence_shard()
        attention_mask, token_type_ids = self._inputs(input_ids, attention_mask, token_type_ids)
        w = {n: local(p) for n, p in self._parameters.items()}
        x = self._embed(w, input_ids, token_type_ids, cp_rank * input_ids.shape[1], self._tp())
        for layer in self.layers:
            x = layer(self._block, c.remat, x, attention_mask)
        x = rms_norm(x, w["norm"], c.norm_eps)
        logits = F.linear(first_token(x, cp_group, cp_rank), local(self.classifier.w),
                          local(self.classifier.b))  # [CLS]
        return self._output(logits, labels)

    def segments(self, input_ids=None, attention_mask=None, token_type_ids=None, labels=None,
                 **kw):
        """The streaming plan (port of ``bert_segments``): embed → one step
        a layer → norm and classifier. The classifier reads its weight
        dequantized, as JAX's ``x @ w`` does."""
        from ..utils.quantization import dequantize_array

        c = self.config
        attention_mask, token_type_ids = self._inputs(input_ids, attention_mask, token_type_ids)
        embed = ["embed_tokens", "embed_positions", "embed_types", "emb_norm"]

        def layer_step(i):
            names = self.layers[i].leaf_names

            def fn(seg, carry):
                w = {n: seg[f"layers.{i}.{n}"] for n in names}
                return {"x": self._block(w, carry["x"], attention_mask)}

            return ("layer", i), [f"layers.{i}.{n}" for n in names], fn

        def head(seg, carry):
            x = rms_norm(carry["x"], seg["norm"], c.norm_eps)[:, 0, :]
            w = dequantize_array(seg["classifier.w"], x.dtype)
            return {"logits": F.linear(x, w, seg["classifier.b"])}

        steps = [("embed", embed,
                  lambda seg, carry: {"x": self._embed(seg, input_ids, token_type_ids)})]
        steps += [layer_step(i) for i in range(c.num_hidden_layers)]
        steps.append(("head", ["norm", "classifier.w", "classifier.b"], head))
        return {"init": dict, "steps": steps,
                "finalize": lambda carry: self._output(carry["logits"], labels)}
