"""ResNet-D image classifier (port of ``accelerate_tpu/models/resnet.py``,
timm's ``resnet50d``): a deep 3×3 stem, the stride on the bottleneck's 3×3
conv, and an average-pool shortcut before the 1×1 projection.

BatchNorm normalises with the current batch's statistics in training and
in eval alike (no running stats), as in JAX. The convolutions are
``F.conv2d`` over NCHW with OIHW kernels (JAX: NHWC and HWIO, converted by
:func:`params_from_jax`), each padded explicitly to XLA's ``"SAME"`` split:
a strided window over an even size pads (0, 1), where ``padding=1`` would
pad (1, 1). The shortcut's average pool counts the padded zeros, as JAX's
``reduce_window(...) / stride²`` does. The input may be NHWC (JAX's
layout), NCHW (torch's) or ``[b, h, w]`` grayscale (:func:`to_nhwc`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.sharding import NO_TP
from ..parallel.sharding import PartitionSpec as P
from ..modules import ModelOutput
from ..ops.layers import loss_group, token_loss
from ..parallel.context import all_reduce_sum
from ..parallel.pipeline import remat_policy
from . import _params
from ._params import Leaf


@dataclass
class ResNetConfig:
    depths: tuple = (3, 4, 6, 3)  # resnet50
    base_width: int = 64
    num_classes: int = 1000
    in_channels: int = 3
    bn_eps: float = 1e-5
    remat: bool | str = False

    def __post_init__(self):
        remat_policy(self.remat)

    @classmethod
    def resnet50d(cls, num_classes: int = 1000):
        return cls(num_classes=num_classes)

    @classmethod
    def tiny(cls, num_classes: int = 3):
        return cls(depths=(1, 1), base_width=8, num_classes=num_classes)


def _conv_leaf(kh, kw, cin, cout) -> Leaf:
    return Leaf((cout, cin, kh, kw), float(np.sqrt(2.0 / (kh * kw * cin))))


def _bn_leaves(name: str, ch: int) -> dict:
    return {f"{name}_gamma": Leaf((ch,), "ones"), f"{name}_beta": Leaf((ch,), "zeros")}


def resnet_spec(c: ResNetConfig) -> dict:
    w = c.base_width
    stem = {"conv1": _conv_leaf(3, 3, c.in_channels, w // 2),
            "conv2": _conv_leaf(3, 3, w // 2, w // 2), "conv3": _conv_leaf(3, 3, w // 2, w)}
    for name, ch in (("g1", w // 2), ("g2", w // 2), ("g3", w)):
        stem.update(_bn_leaves(name, ch))
    stages, cin = [], w
    for i, depth in enumerate(c.depths):
        planes = w * (2 ** i)
        cout = planes * 4
        blocks = []
        for _ in range(depth):
            block = {"conv1": _conv_leaf(1, 1, cin, planes),
                     "conv2": _conv_leaf(3, 3, planes, planes),
                     "conv3": _conv_leaf(1, 1, planes, cout)}
            for j, ch in (("1", planes), ("2", planes), ("3", cout)):
                block.update(_bn_leaves(f"g{j}", ch))
            if cin != cout:
                block["conv_proj"] = _conv_leaf(1, 1, cin, cout)
                block.update(_bn_leaves("gp", cout))
            blocks.append(block)
            cin = cout
        stages.append(blocks)
    return {"stem": stem, "stages": stages,
            "fc": {"w": Leaf((c.num_classes, cin), float(np.sqrt(1.0 / cin))),
                   "b": Leaf((c.num_classes,), "zeros")}}


def init_resnet_params(generator: torch.Generator, config: ResNetConfig, dtype=torch.float32,
                       device=None) -> dict[str, torch.Tensor]:
    """Random weights as a state dict of :class:`ResNetForImageClassification`."""
    return _params.init_state_dict(generator, resnet_spec(config), dtype, device)


def jax_layout(leaf: str, ndim: int) -> tuple | None:
    """The port's dims as JAX's (:func:`~..parallel.sharding.jax_leaves`):
    kernels OIHW from HWIO, the classifier ``[out, in]``."""
    if ndim == 4:
        return (3, 2, 0, 1)
    return (1, 0) if leaf == "w" and ndim == 2 else None


def _from_jax_layout(leaf, arr):
    if arr.ndim == 4:  # HWIO → OIHW
        return arr.transpose(3, 2, 0, 1)
    return arr.T if leaf == "w" else arr


def params_from_jax(np_params, config: ResNetConfig) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) → this model's state dict: kernels HWIO →
    OIHW, the classifier ``[in, out]`` → ``[out, in]``."""
    return _params.state_dict_from_jax(np_params, _from_jax_layout, stacked=())


def same_padding(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``ceil(n / stride)``
    outputs, the odd pad on the high side."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k: int, stride: int, value: float = 0.0):
    (t, b), (l, r) = same_padding(x.shape[2], k, stride), same_padding(x.shape[3], k, stride)
    return F.pad(x, (l, r, t, b), value=value) if t or b or l or r else x


def _conv(x, w, stride: int = 1):
    return F.conv2d(_pad_same(x, w.shape[2], stride), w, stride=stride)


def _bn(x, gamma, beta, eps, batch=None):
    """Batch statistics over (N, H, W) in f32. With ``batch`` ``(group,
    rows)`` (the ranks that hold other rows of the batch,
    :func:`~..ops.layers.loss_group`, and the rows they hold together,
    :func:`global_rows`) they are the global batch's, as JAX's are over its
    global array: the sum, then the sum of squares about the global mean,
    each all-reduced (:func:`~..parallel.context.all_reduce_sum`, whose
    gradient is an all-reduce too)."""
    x32 = x.float()
    if batch is None:
        mean = x32.mean(dim=(0, 2, 3), keepdim=True)
        var = x32.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    else:
        group, rows = batch
        n = rows * x32.shape[2] * x32.shape[3]
        mean = all_reduce_sum(x32.sum(dim=(0, 2, 3), keepdim=True), group) / n
        var = all_reduce_sum(((x32 - mean) ** 2).sum(dim=(0, 2, 3), keepdim=True), group) / n
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * gamma[:, None, None] + beta[:, None, None]).to(x.dtype)


def global_rows(x: torch.Tensor, group):
    """``(group, the rows its ranks hold together)`` for :func:`_bn`, the
    ranks' own counts of ``x``'s rows summed (a rank may hold fewer, as in
    an uneven last batch); None without a group."""
    if group is None:
        return None
    total = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    dist.all_reduce(total, group=group)
    return group, int(total)


def to_nhwc(pixel_values: torch.Tensor, in_channels: int) -> torch.Tensor:
    """Image input as NHWC: a channel dim appended to grayscale ``[b, h,
    w]``, torch's NCHW moved to channel-last (shared by the zoo's image
    models, as in JAX)."""
    x = pixel_values
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] != in_channels and x.shape[1] == in_channels:
        x = x.movedim(1, -1)
    return x


def _conv_bn(x, w: dict, conv: str, norm: str, eps: float, tp, batch, stride: int = 1):
    """A convolution then batch norm. Under tensor parallelism the kernel's
    output channels are on ``tp`` (JAX's HWIO ``P(None, None, "fsdp",
    "tp")``): each rank convolves with its shard and the channels are
    gathered whole before the norm, which takes every channel (a
    column-parallel product with a gathered output)."""
    y = tp.gather(_conv(tp.enter(x, conv), w[conv], stride), conv, dim=1)
    return _bn(y, w[f"{norm}_gamma"], w[f"{norm}_beta"], eps, batch)


def _bottleneck_d(eps: float, w: dict, x, stride: int, tp=NO_TP, batch=None):
    """The ResNet-D bottleneck (port of ``_bottleneck_d``)."""
    y = F.relu(_conv_bn(x, w, "conv1", "g1", eps, tp, batch))
    y = F.relu(_conv_bn(y, w, "conv2", "g2", eps, tp, batch, stride))
    y = _conv_bn(y, w, "conv3", "g3", eps, tp, batch)
    shortcut = x
    if stride > 1:
        shortcut = F.avg_pool2d(_pad_same(shortcut, stride, stride), stride, stride)
    if "conv_proj" in w:
        shortcut = _conv_bn(shortcut, w, "conv_proj", "gp", eps, tp, batch)
    return F.relu(y + shortcut)


def _stage(ws, x, eps: float, index: int, batch, tps):
    """One stage over its blocks' weights (a :class:`~._params.Stage`'s
    call, rematerialised whole)."""
    for b, (w, tp) in enumerate(zip(ws, tps)):
        x = _bottleneck_d(eps, w, x, 2 if (b == 0 and index > 0) else 1, tp, batch)
    return x


#: path regex → PartitionSpec over JAX's leaf names (the JAX package's
#: ``RESNET_PARTITION_RULES``): a layer-stacked leaf has a leading
#: ``[layers]`` dim, which is never sharded
RESNET_PARTITION_RULES = [
    (r"conv", P(None, None, "fsdp", "tp")),  # HWIO kernels
    (r"(gamma|beta)", P()),
    (r"fc\.w", P("fsdp", "tp")),
    (r"fc\.b", P()),
]

#: the 2-D leaves JAX holds as ``[in, out]`` and the port as ``[out, in]``
#: (:func:`~..parallel.sharding.jax_leaves`)
JAX_TRANSPOSED = ("w",)


class ResNetForImageClassification(_params.SpecModel):
    """ResNet-D (port of the JAX ``ResNetForImageClassification``):
    ``forward(pixel_values, labels=None)`` → ``logits [b, num_classes]``
    and, with ``labels [b]``, the mean CE ``loss``. ``remat`` recomputes a
    stage at a time, as JAX checkpoints each stage."""

    partition_rules = RESNET_PARTITION_RULES

    _spec = staticmethod(resnet_spec)

    def forward(self, pixel_values, labels=None) -> ModelOutput:
        """The batch statistics and the loss span the global batch
        (:func:`~..ops.layers.loss_group`: every ``cp`` rank takes the
        whole batch, as JAX computes this family); under tensor parallelism
        each convolution and the classifier run their output shards and
        gather them whole."""
        c = self.config
        eps = c.bn_eps
        x = to_nhwc(pixel_values, c.in_channels).permute(0, 3, 1, 2)  # NCHW
        batch = global_rows(x, loss_group(whole_batch=True))
        s, tp = _params.weights(self.stem), _params.layer_tp(self.stem)
        x = F.relu(_conv_bn(x, s, "conv1", "g1", eps, tp, batch, 2))
        x = F.relu(_conv_bn(x, s, "conv2", "g2", eps, tp, batch))
        x = F.relu(_conv_bn(x, s, "conv3", "g3", eps, tp, batch))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for i, stage in enumerate(self.stages):
            x = stage(_stage, c.remat, x, eps, i, batch)
        x = x.float().mean(dim=(2, 3))  # global average pool
        fc, tp = _params.weights(self.fc), _params.layer_tp(self.fc)
        if tp.on("w"):  # the classes on tp
            logits = tp.gather(F.linear(tp.enter(x, "w"), fc["w"].float()), "w") + fc["b"].float()
        else:
            logits = F.linear(x, fc["w"].float(), fc["b"].float())
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = token_loss(logits, labels, whole_batch=True)
        return out
