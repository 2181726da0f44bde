"""Quantized weights: the bitsandbytes-analog int8 and 4-bit paths (port of
``accelerate_tpu/utils/quantization.py``).

Weights keep the port's ``[out, in]`` layout and quantize along ``in``:

* :class:`QTensor` — int8 codes ``[out, in]`` and one f32 scale an output
  row ``[out, 1]``: JAX's codes and scales (quantized along its ``in``
  axis, -2 of ``[in, out]``) transposed, bit for bit.
* :class:`Q4Tensor` — two 4-bit codebook indices a byte ``[out, in/2]``
  (the even ``in`` index in the high nibble), absmax blocks along ``in``
  and the block scales double-quantized (int8 residuals ``[out, nb]``
  around an f32 per-row offset ``[out, 1]`` with an f32 step ``[out,
  1]``): JAX's indices and scale planes transposed. (JAX packs along
  ``out``, so the packed bytes themselves differ; the indices do not.)
* :class:`Q4DecodedTensor` — the same with the indices already decoded to
  int8 codebook values (code × 127) on the host by the native decoder
  (``native/q4decode.c``), as the streaming executor hands them to the
  card.

The products are JAX's: :func:`int8_matmul` row-quantizes the activations
and runs one int8 GEMM with int32 accumulation (bnb ``Linear8bitLt``
semantics); :func:`q4_matmul` quantizes each (row, block) slab of the
activations and runs one int8 GEMM a block of ``in``. Both reach
``torch._int_mm`` through :func:`int8_gemm` (cuBLAS on the card), which
pads to its shape rules. JAX computes these outside any Pallas kernel, so
they are library calls here, not ports of a kernel. Because the port's
tied heads are ``[vocab, hidden]`` = ``[out, in]`` already, JAX's
transposed forms (``q4_matmul_t``, the ``.T`` markers) have no use here.

The quantizers compute on the weight's own device (the card quantizes a
30B layer in milliseconds); every step is exact IEEE arithmetic, and the
4-bit scale statistics run in JAX's own numpy arithmetic on JAX's layout,
so the codes and scales equal JAX's on any device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

INT8_MAX = 127.0

#: int8 GEMMs launched on the card (``torch._int_mm`` over CUDA tensors)
#: since import
int8_gemm_launches = 0


def int8_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ bᵀ`` for int8 ``a`` and ``b [N, K]``, accumulated in
    int32 (``torch._int_mm``; ``b`` may be a column slice). cuBLAS's int8
    GEMM takes more than 16 rows and ``K``, ``N`` multiples of 8, so the
    operands are padded with zeros, which add nothing, and the result
    sliced back."""
    global int8_gemm_launches
    m, k = a.shape
    n = b.shape[0]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        b = F.pad(b, (0, pad_k, 0, pad_n))
    out = torch._int_mm(a, b.t())
    if a.is_cuda:
        int8_gemm_launches += 1
    return out[:m, :n]


def _quantize_rows(x2: torch.Tensor):
    """Per-row absmax int8 quantization of f32 ``x2 [..., k]``: ``(codes,
    step)`` with ``step = max(|row|, 1e-30) / 127``, JAX's arithmetic."""
    sx = torch.clamp_min(x2.abs().amax(dim=-1, keepdim=True), 1e-30) / INT8_MAX
    xq = torch.clamp(torch.round(x2 / sx), -INT8_MAX, INT8_MAX).to(torch.int8)
    return xq, sx


class QTensor:
    """int8 weight ``q [out, in]`` and f32 scale ``[out, 1]``; dequantizes
    to ``q * scale``."""

    PLANES = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def dtype(self):  # the storage dtype, which sizing counts
        return self.q.dtype

    @property
    def device(self):
        return self.q.device

    def planes(self) -> dict:
        return {p: getattr(self, p) for p in self.PLANES}

    def to(self, device) -> "QTensor":
        return QTensor(self.q.to(device), self.scale.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)

    def __getitem__(self, idx):
        """Row gather (an embedding lookup): int8 rows move, scaled after."""
        if self.q.ndim == 2 and _row_index(idx):
            return self.q[idx].float() * self.scale[idx]
        return self.dequantize()[idx]

    def __repr__(self):
        return f"QTensor(shape={self.shape}, scale={tuple(self.scale.shape)})"


def _row_index(idx) -> bool:
    """An int or an integer tensor: a whole-row gather."""
    if isinstance(idx, (int, np.integer)):
        return True
    return isinstance(idx, torch.Tensor) and not idx.is_floating_point() \
        and idx.dtype != torch.bool


def _as_f32(w) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.detach().float()
    return torch.from_numpy(np.asarray(w, dtype=np.float32))


def quantize_array(w, axis: int = -1) -> QTensor:
    """Symmetric absmax int8 quantization over ``axis`` (``in`` of ``[out,
    in]``): one scale an output row, on ``w``'s device."""
    w = _as_f32(w)
    absmax = w.abs().amax(dim=axis, keepdim=True)
    scale = absmax / INT8_MAX
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return QTensor(q, scale)


def dequantize_array(x, dtype=torch.float32):
    """A quantized weight as a dense tensor; anything else as it is."""
    return x.dequantize(dtype) if isinstance(x, (QTensor, Q4Tensor, Q4DecodedTensor)) else x


def int8_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x @ dequantize(qt)ᵀ`` as an int8 GEMM: the activations are
    quantized a row (absmax), the product accumulates in int32, and the
    row and output-channel scales apply to it; the full-precision weight
    is never made."""
    k = x.shape[-1]
    lead = x.shape[:-1]
    xq, sx = _quantize_rows(x.reshape(-1, k).float())
    acc = int8_gemm(xq, qt.q).float()
    out = acc * (sx * qt.scale[:, 0].float()[None, :])
    return out.to(x.dtype).reshape(*lead, qt.q.shape[0])


#: the 16 NF4 levels (QLoRA): quantiles of a standard normal in [-1, 1]
NF4_CODE = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

#: the linear symmetric int4 code that ``"fp4"`` selects: 16 evenly spaced
#: levels over [-1, 1]
INT4_CODE = np.linspace(-1.0, 1.0, 16, dtype=np.float32)


def _nibbles(packed: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """``packed [..., n]`` → ``lut`` values ``[..., 2n]``, the high nibble
    first."""
    idx = packed.long()
    return torch.stack([lut[idx >> 4], lut[idx & 0xF]], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def _int8_lut(code) -> torch.Tensor:
    """The codebook on the int8 grid: ``round(code × 127)``."""
    return torch.round(torch.as_tensor(code, dtype=torch.float32) * INT8_MAX).to(torch.int8)


class _Q4Scales:
    def scales(self) -> torch.Tensor:
        """The decoded block scales, f32 ``[out, nb]``."""
        return self.scale_q.float() * self.scale_scale.float() + self.scale_offset.float()

    @property
    def block_size(self) -> int:
        return self.shape[-1] // self.scale_q.shape[-1]

    @property
    def ndim(self):
        return len(self.shape)

    def _scaled(self, values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
        """``values [..., in]`` times each block's scale ``scales [..., nb]``."""
        nb = scales.shape[-1]
        blocks = values.reshape(*values.shape[:-1], nb, values.shape[-1] // nb)
        return (blocks * scales[..., None]).reshape(values.shape)


class Q4Tensor(_Q4Scales):
    """A 4-bit blockwise-quantized weight (see the module docstring)."""

    PLANES = ("packed", "scale_q", "scale_offset", "scale_scale", "code")

    def __init__(self, packed, scale_q, scale_offset, scale_scale, code):
        self.packed = packed              # uint8 [out, in/2]
        self.scale_q = scale_q            # int8  [out, in/block]
        self.scale_offset = scale_offset  # f32   [out, 1]
        self.scale_scale = scale_scale    # f32   [out, 1]
        self.code = code                  # f32   [16], the codebook
        if packed.shape[:-1] != scale_q.shape[:-1]:
            raise ValueError(f"Q4Tensor layout mismatch: packed {tuple(packed.shape)} and "
                             f"scale_q {tuple(scale_q.shape)} must share their rows")

    @property
    def shape(self):
        return tuple(self.packed.shape[:-1]) + (self.packed.shape[-1] * 2,)

    @property
    def dtype(self):  # the storage accounting dtype (sub-byte)
        return "int4"

    @property
    def device(self):
        return self.packed.device

    def planes(self) -> dict:
        return {p: getattr(self, p) for p in self.PLANES}

    def to(self, device) -> "Q4Tensor":
        return Q4Tensor(*(p.to(device) for p in self.planes().values()))

    def codes_int8(self) -> torch.Tensor:
        """The indices decoded to int8 codebook values ``[out, in]`` on the
        weight's device."""
        return _nibbles(self.packed, _int8_lut(self.code).to(self.packed.device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        vals = _nibbles(self.packed, self.code.float().to(self.packed.device))
        return self._scaled(vals, self.scales()).to(dtype)

    def __getitem__(self, idx):
        """Row gather: only the gathered rows are unpacked."""
        if self.packed.ndim == 2 and _row_index(idx):
            vals = _nibbles(self.packed[idx], self.code.float().to(self.packed.device))
            return self._scaled(vals, self.scales()[idx])
        return self.dequantize()[idx]

    def __repr__(self):
        return f"Q4Tensor(shape={self.shape}, block={self.block_size})"


class Q4DecodedTensor(_Q4Scales):
    """int8 codebook values ``c8 [out, in]`` (code × 127) with the 4-bit
    weight's block scales: what the streaming executor decodes on the host
    and copies to the card. Transient: never stored."""

    def __init__(self, c8, scale_q, scale_offset, scale_scale):
        self.c8 = c8
        self.scale_q = scale_q
        self.scale_offset = scale_offset
        self.scale_scale = scale_scale

    @property
    def shape(self):
        return tuple(self.c8.shape)

    @property
    def device(self):
        return self.c8.device

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self._scaled(self.c8.float(), self.scales() / INT8_MAX).to(dtype)

    def __getitem__(self, idx):
        if self.c8.ndim == 2 and _row_index(idx):
            return self._scaled(self.c8[idx].float(), self.scales()[idx] / INT8_MAX)
        return self.dequantize()[idx]

    def __repr__(self):
        return f"Q4DecodedTensor(shape={self.shape})"


def _block_for(n: int, requested: int) -> int:
    """Largest divisor of ``n`` that is <= the requested block size."""
    b = min(requested, n)
    while n % b != 0:
        b -= 1
    return b


_FP4_WARNED = [False]


def _warn_fp4_once():
    if not _FP4_WARNED[0]:
        _FP4_WARNED[0] = True
        import warnings

        warnings.warn(
            "quant_type='fp4' maps to a linear 16-level int4 code here, not "
            "bitsandbytes' 4-bit-float code: loaded weights differ "
            "numerically from the reference's Linear4bit fp4 path",
            stacklevel=3,
        )


def quantize_array_4bit(w, block_size: int = 64, quant_type: str = "nf4") -> Q4Tensor:
    """Blockwise 4-bit quantization of ``w [..., out, in]`` along ``in``:
    each block's absmax, the nearest codebook level a weight (the level
    midpoints searched, as JAX searches them), two indices a byte; the
    block scales double-quantized to int8 around each row's mean. The
    indices are computed on ``w``'s device; the scale statistics (a few
    numbers a block) in numpy on JAX's ``[nb, out]`` layout, so their
    rounding is JAX's."""
    code = NF4_CODE if quant_type == "nf4" else INT4_CODE
    if quant_type == "fp4":
        _warn_fp4_once()
    w = _as_f32(w)
    if w.ndim < 2:
        raise ValueError("4-bit quantization needs a >=2-D weight")
    k = w.shape[-1]
    if k % 2:
        raise ValueError(f"in dim {k} must be even to pack int4 pairs")
    lead = tuple(w.shape[:-1])
    block = _block_for(k, block_size)
    nb = k // block
    blocks = w.reshape(*lead, nb, block)
    absmax = blocks.abs().amax(dim=-1)  # [..., out, nb]
    absmax = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax)
    midpoints = torch.from_numpy((code[1:] + code[:-1]) / 2.0).to(w.device)
    idx = torch.searchsorted(midpoints, blocks / absmax[..., None], out_int32=True)
    idx = idx.to(torch.uint8).reshape(*lead, k)
    packed = (idx[..., 0::2] << 4) | idx[..., 1::2]
    a = np.ascontiguousarray(absmax.cpu().numpy().swapaxes(-1, -2))  # JAX's [..., nb, out]
    offset = a.mean(axis=-2, keepdims=True).astype(np.float32)
    resid = a - offset
    s2 = np.abs(resid).max(axis=-2, keepdims=True) / 127.0
    s2 = np.where(s2 == 0.0, 1.0, s2).astype(np.float32)
    scale_q = np.clip(np.round(resid / s2), -127, 127).astype(np.int8)

    def port(arr):  # JAX's [..., x, out] → the port's [..., out, x]
        return torch.from_numpy(np.ascontiguousarray(arr.swapaxes(-1, -2))).to(w.device)

    return Q4Tensor(packed, port(scale_q), port(offset), port(s2),
                    torch.from_numpy(code.copy()).to(w.device))


def _q4_product(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x [..., in]`` against int8 codes ``[out, in]`` with block scales
    ``[out, nb]``: each (row, block) slab of ``x`` is quantized to int8,
    each block's int8 GEMM accumulates in int32, and both quantizations
    are undone on its partial sum."""
    n, k = codes.shape
    nb = scales.shape[-1]
    blk = k // nb
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).float()
    xq, sx = _quantize_rows(x2.reshape(-1, nb, blk))  # [M, nb, blk], [M, nb, 1]
    xq = xq.transpose(0, 1).contiguous()
    step = scales.float() / INT8_MAX  # [out, nb]
    out = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x.device)
    for j in range(nb):
        part = int8_gemm(xq[j], codes[:, j * blk:(j + 1) * blk]).float()
        out += part * sx[:, j] * step[:, j]
    return out.to(x.dtype).reshape(*lead, n)


def q4_matmul(x: torch.Tensor, t: Q4Tensor) -> torch.Tensor:
    """``x @ dequantize(t)ᵀ`` as one int8 GEMM a block: the codebook
    rounded onto the int8 grid (±0.4% of a level, far inside nf4's own
    error), the indices decoded on the weight's device."""
    return _q4_product(x, t.codes_int8(), t.scales())


def q4_decoded_matmul(x: torch.Tensor, d: Q4DecodedTensor) -> torch.Tensor:
    """``x @ dequantize(d)ᵀ`` with the codes already int8."""
    return _q4_product(x, d.c8, d.scales())


_QUANTIZED = (QTensor, Q4Tensor, Q4DecodedTensor)


def is_quantized(x) -> bool:
    return isinstance(x, _QUANTIZED)


def dequantize_tree(params: dict, dtype=torch.float32) -> dict:
    """Every quantized weight of a flat dict dequantized to ``dtype``."""
    return {k: dequantize_array(v, dtype) for k, v in params.items()}


def quantized_planes(weights: dict) -> dict:
    """``{name: QTensor | Q4Tensor}`` as ``{<name>.<plane>: tensor}``, the
    names the device map and the offload store address."""
    return {f"{name}.{plane}": t for name, qt in weights.items()
            for plane, t in qt.planes().items()}


#: embedding and head names across the zoo, which are not quantized unless
#: ``quantize_embeddings`` (bnb never swaps ``nn.Embedding``)
DEFAULT_SKIP_MODULES = [
    "embed_tokens", "embed_positions", "embed_types", "wte", "wpe", "lm_head",
]


@dataclass
class BnbQuantizationConfig:
    """The reference's quantization config. ``fp4`` selects a LINEAR
    16-level int4 code, not bnb's 4-bit float code (a warning says so once);
    the bnb-only knobs are accepted."""

    load_in_8bit: bool | None = None
    load_in_4bit: bool = False
    llm_int8_threshold: float = 6.0  # bnb's outlier split: accepted, no counterpart
    bnb_4bit_quant_type: str = "nf4"
    bnb_4bit_use_double_quant: bool = True  # scales are always stored int8 + offset
    bnb_4bit_compute_dtype: Any = None
    bnb_4bit_block_size: int = 64
    skip_modules: list = field(default_factory=list)
    keep_in_fp32_modules: list = field(default_factory=list)
    torch_dtype: Any = None
    quantize_embeddings: bool = False

    def __post_init__(self):
        if self.load_in_8bit is not None and bool(self.load_in_8bit) == bool(self.load_in_4bit):
            raise ValueError(
                "pass exactly one of load_in_8bit / load_in_4bit (the reference raises on "
                "the same conflict); explicitly disabling both would silently int8-quantize"
            )
        if self.load_in_8bit is None:
            self.load_in_8bit = not self.load_in_4bit
        if self.bnb_4bit_quant_type not in ("nf4", "fp4"):
            raise ValueError(f"bnb_4bit_quant_type must be 'nf4' or 'fp4', got "
                             f"{self.bnb_4bit_quant_type!r}")

    @property
    def compute_dtype(self) -> torch.dtype:
        source = (self.bnb_4bit_compute_dtype
                  if self.load_in_4bit and self.bnb_4bit_compute_dtype is not None
                  else self.torch_dtype)
        if source is None:
            return torch.float32
        name = str(source).split(".")[-1]
        return {"bfloat16": torch.bfloat16, "float16": torch.float16}.get(name, torch.float32)


def _eligible(path: str, t: torch.Tensor, config: BnbQuantizationConfig) -> bool:
    """A projection ``[out, in]``: 2-D, floating, ``in`` >= 16 (JAX's
    guard on its in-axis), even ``in`` for 4-bit packing, not skipped."""
    if t.ndim != 2 or not t.is_floating_point() or t.shape[-1] < 16:
        return False
    if config.load_in_4bit and t.shape[-1] % 2:
        return False
    for pat in list(config.skip_modules) + list(config.keep_in_fp32_modules):
        if re.fullmatch(pat, path) or path == pat or path.startswith(pat + "."):
            return False
    if not config.quantize_embeddings:
        segments = path.split(".")
        if any(name in segments for name in DEFAULT_SKIP_MODULES):
            return False
    return True


def _owner(model: torch.nn.Module, name: str) -> tuple[torch.nn.Module, str]:
    """The submodule that holds parameter ``name``, and its leaf name."""
    module_name, _, leaf = name.rpartition(".")
    return (model.get_submodule(module_name) if module_name else model), leaf


def call_with_weights(model: torch.nn.Module, weights: dict, args=(), kwargs=None):
    """The model's class ``forward`` with ``weights`` (``{name: tensor}``)
    in place of those parameters for the call: ``torch.func.functional_call``
    without going through the instance's ``forward``, which a quantized
    model and a hook replace."""
    kept = []
    try:
        for name, value in weights.items():
            module, leaf = _owner(model, name)
            kept.append((module, leaf, module._parameters[leaf]))
            module._parameters[leaf] = value
        return type(model).forward(model, *args, **(kwargs or {}))
    finally:
        for module, leaf, old in kept:
            module._parameters[leaf] = old


def _set_param(model: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    module, leaf = _owner(model, name)
    module._parameters[leaf] = torch.nn.Parameter(value, requires_grad=False)


def quantize_model_params(model: torch.nn.Module, config: BnbQuantizationConfig,
                          device=None) -> torch.nn.Module:
    """Replace eligible weights by quantized ones, computed on ``device``
    (default: where each weight lies) and kept where the weight lay. The
    model keeps them in ``model.quantized_weights`` (``{name: QTensor |
    Q4Tensor}``), its parameter becoming a shape-only meta placeholder, and
    its ``forward`` runs on their dequantized values (``compute_dtype``);
    the streaming executor hands them to the layers as they are, so the
    products run on int8. Returns the same module."""
    plan = [(name, p) for name, p in model.named_parameters() if _eligible(name, p, config)]
    if not plan:  # checked before mutating: a failed call leaves the model intact
        raise ValueError("no parameters were eligible for quantization")
    if config.load_in_4bit:
        def quant(w):
            return quantize_array_4bit(w, block_size=config.bnb_4bit_block_size,
                                       quant_type=config.bnb_4bit_quant_type)
    else:
        quant = quantize_array
    store = model.__dict__.setdefault("quantized_weights", {})
    for name, p in plan:
        if p.is_meta:
            raise ValueError(f"{name} is a meta tensor: load a checkpoint before quantizing")
        home = p.device
        store[name] = quant(p.detach().to(device or home)).to(home)
        _set_param(model, name, torch.empty(p.shape, dtype=p.dtype, device="meta"))

    compute_dtype = config.compute_dtype

    def quantized_forward(*args, **kwargs):
        return call_with_weights(model, dequantize_tree(model.quantized_weights, compute_dtype),
                                 args, kwargs)

    model.forward = quantized_forward
    model.is_quantized = True
    model.quantization_config = config
    return model


def load_and_quantize_model(
    model: torch.nn.Module,
    bnb_quantization_config: BnbQuantizationConfig | None = None,
    weights_location: str | None = None,
    device_map: Any = None,
    no_split_module_classes=None,
    max_memory=None,
    offload_folder: str | None = None,
    offload_state_dict: bool = False,
    main_device=None,
):
    """Load a checkpoint (to the host), quantize it (on ``main_device``,
    the card by default) and dispatch it under ``device_map``, as
    :func:`~..big_modeling.load_checkpoint_and_dispatch` does."""
    from ..big_modeling import dispatch_model, load_checkpoint_in_model
    from .device import resolve_device
    from .modeling import get_balanced_memory, infer_auto_device_map

    config = bnb_quantization_config or BnbQuantizationConfig()
    device = resolve_device(main_device)
    if weights_location is not None:
        load_checkpoint_in_model(model, weights_location,
                                 device_map={"": "cpu"} if device_map else None,
                                 main_device=device)
    model = quantize_model_params(model, config, device=device)
    if device_map is None:
        return model
    if isinstance(device_map, str):
        from .modeling import flat_param_shapes

        shapes = flat_param_shapes(model)
        if device_map == "balanced":
            max_memory = get_balanced_memory(shapes, max_memory, no_split_module_classes)
        from .modeling import find_tied_parameters

        device_map = infer_auto_device_map(shapes, max_memory=max_memory,
                                           no_split_module_classes=no_split_module_classes,
                                           tied_parameters=find_tied_parameters(model))
    return dispatch_model(model, device_map, main_device=device, offload_dir=offload_folder)

