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
import torch.nn.functional as F

from ..modules import ModelOutput
from ..ops.layers import cross_entropy_loss
from ..parallel.pipeline import remat_policy, remat_wrap
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


def _bn(x, gamma, beta, eps):
    """Batch statistics over (N, H, W) in f32."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3), keepdim=True)
    var = x32.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * gamma[:, None, None] + beta[:, None, None]).to(x.dtype)


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


def _bottleneck_d(eps: float, w: dict, x, stride: int):
    """The ResNet-D bottleneck (port of ``_bottleneck_d``)."""
    y = F.relu(_bn(_conv(x, w["conv1"]), w["g1_gamma"], w["g1_beta"], eps))
    y = F.relu(_bn(_conv(y, w["conv2"], stride), w["g2_gamma"], w["g2_beta"], eps))
    y = _bn(_conv(y, w["conv3"]), w["g3_gamma"], w["g3_beta"], eps)
    shortcut = x
    if stride > 1:
        shortcut = F.avg_pool2d(_pad_same(shortcut, stride, stride), stride, stride)
    if "conv_proj" in w:
        shortcut = _bn(_conv(shortcut, w["conv_proj"]), w["gp_gamma"], w["gp_beta"], eps)
    return F.relu(y + shortcut)


def _stage(eps: float, index: int, names, x, *flat):
    """One stage over its blocks' weights, handed over as positional
    tensors (so a remat recompute sees the very tensors the forward used)."""
    at = 0
    for b, keys in enumerate(names):
        w = dict(zip(keys, flat[at:at + len(keys)]))
        at += len(keys)
        x = _bottleneck_d(eps, w, x, 2 if (b == 0 and index > 0) else 1)
    return x


class ResNetForImageClassification(_params.SpecModel):
    """ResNet-D (port of the JAX ``ResNetForImageClassification``):
    ``forward(pixel_values, labels=None)`` → ``logits [b, num_classes]``
    and, with ``labels [b]``, the mean CE ``loss``. ``remat`` recomputes a
    stage at a time, as JAX checkpoints each stage."""

    _spec = staticmethod(resnet_spec)

    def forward(self, pixel_values, labels=None) -> ModelOutput:
        c = self.config
        eps = c.bn_eps
        x = to_nhwc(pixel_values, c.in_channels).permute(0, 3, 1, 2)  # NCHW
        s = _params.weights(self.stem)
        x = F.relu(_bn(_conv(x, s["conv1"], 2), s["g1_gamma"], s["g1_beta"], eps))
        x = F.relu(_bn(_conv(x, s["conv2"]), s["g2_gamma"], s["g2_beta"], eps))
        x = F.relu(_bn(_conv(x, s["conv3"]), s["g3_gamma"], s["g3_beta"], eps))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        stage = remat_wrap(_stage, c.remat)
        for i, blocks in enumerate(self.stages):
            ws = [_params.weights(block) for block in blocks]
            x = stage(eps, i, tuple(tuple(w) for w in ws), x,
                      *(t for w in ws for t in w.values()))
        x = x.float().mean(dim=(2, 3))  # global average pool
        logits = F.linear(x, self.fc.w.float(), self.fc.b.float())
        out = ModelOutput(logits=logits)
        if labels is not None:
            out["loss"] = cross_entropy_loss(logits[:, None, :], labels[:, None])
        return out
