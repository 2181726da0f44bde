"""Device-map inference, model-memory math and checkpoint reading (port of
``accelerate_tpu/utils/modeling.py``).

A "module" is a dot-path prefix of the model's parameter names and the
devices are memory tiers: cards (``0..n-1``, HBM), ``"cpu"`` (host DRAM)
and ``"disk"``. The port's layers are submodules already (``layers.<i>.<leaf>``),
so a device map splits at layer granularity without the JAX package's
expansion of layer-stacked leaves; each family's ``jax_param_name`` maps a
port name onto the JAX name (``layers.<i>.<leaf>`` there too, after
expansion), under which an inferred map equals JAX's.

Checkpoints: ``.safetensors`` (read here by :func:`load_safetensors`, a
few-line reader of the format's header and raw little-endian bytes, and
written by :func:`save_safetensors`), sharded ``*.index.json`` layouts,
``.bin``/``.pt`` through ``torch.load(weights_only=True)`` and ``.npz``.
"""

from __future__ import annotations

import json
import os
import re
import struct
from collections import defaultdict
from typing import Any, Iterable, Mapping

import numpy as np
import torch

WEIGHTS_INDEX_NAME = "pytorch_model.bin.index.json"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"


# ---------------------------------------------------------------------------
# dtype sizes
# ---------------------------------------------------------------------------


def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch or numpy dtype or a name; the sub-byte
    names ``"int4"`` and ``"int2"`` give 0.5 and 0.25."""
    dtype_str = str(dtype)
    if dtype_str in ("int4", "CustomDtype.INT4"):
        return 0.5
    if dtype_str in ("int2", "CustomDtype.INT2"):
        return 0.25
    if "float8" in dtype_str or dtype_str in ("fp8", "CustomDtype.FP8"):
        return 1.0
    m = re.search(r"(\d+)", dtype_str.split(".")[-1])
    if m is None:
        if "bool" in dtype_str:
            return 1.0
        raise ValueError(f"cannot size dtype {dtype}")
    return int(m.group(1)) / 8


def named_module_tensors(named_shapes: Mapping[str, tuple], prefix: str = ""
                         ) -> Iterable[tuple[str, tuple, Any]]:
    for name, (shape, dtype) in named_shapes.items():
        yield name, shape, dtype


def flat_param_shapes(model, expand_stacked=None) -> dict[str, tuple]:
    """``{name: (shape, dtype)}`` of a model's parameters (meta ones
    included), its quantized weights counted by their planes (``<name>.q``,
    ``<name>.scale``; the 4-bit planes), in the JAX package's pytree order
    (:func:`jax_order`), which the greedy placement walks. The port keeps
    no layer-stacked leaves, so ``expand_stacked`` (JAX's argument) has
    nothing to expand and is accepted for its signature."""
    from .quantization import quantized_planes

    quantized = getattr(model, "quantized_weights", {})
    items = [(n, p) for n, p in model.named_parameters() if n not in quantized]
    items += list(quantized_planes(quantized).items())
    items.sort(key=lambda item: jax_order(item[0]))
    return {name: (tuple(t.shape), t.dtype) for name, t in items}


def jax_order(name: str) -> tuple:
    """Sort key of a dotted name in a JAX pytree's flattening order: the
    names at each level sorted, layer indices numerically."""
    return tuple((0, int(c), "") if c.isdigit() else (1, 0, c) for c in name.split("."))


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------


def compute_module_sizes(named_shapes: Mapping[str, tuple], dtype=None,
                         special_dtypes: Mapping[str, Any] | None = None) -> dict[str, int]:
    """Size in bytes of every module prefix. ``dtype`` overrides the
    storage dtype (fp32 weights loaded as bf16); ``special_dtypes``
    overrides it tensor by tensor."""
    sizes: dict[str, int] = defaultdict(int)
    for name, (shape, tensor_dtype) in named_shapes.items():
        if special_dtypes and name in special_dtypes:
            size = int(np.prod(shape, dtype=np.int64) * dtype_byte_size(special_dtypes[name])) \
                if shape else 1
        else:
            use = dtype if dtype is not None else tensor_dtype
            size = int(np.prod(shape, dtype=np.int64) * dtype_byte_size(use)) if shape \
                else int(dtype_byte_size(use))
        parts = name.split(".")
        for i in range(len(parts) + 1):
            sizes[".".join(parts[:i])] += size
    return dict(sizes)


def compute_module_total_buffer_size(named_shapes, dtype=None) -> int:
    return compute_module_sizes(named_shapes, dtype=dtype).get("", 0)


# ---------------------------------------------------------------------------
# memory probing
# ---------------------------------------------------------------------------


def get_max_memory(max_memory: Mapping | None = None) -> dict:
    """``{device: usable bytes}`` over the cards, ``"cpu"`` and ``"disk"``:
    90% of each card's free memory (``torch.cuda.mem_get_info``) and of the
    host's available pages (``os.sysconf``), an unbounded disk. A given
    ``max_memory`` is returned in bytes (``"10GiB"`` strings allowed)."""
    if max_memory is not None:
        return {k: _to_bytes(v) for k, v in max_memory.items()}
    out: dict = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[i] = int(torch.cuda.mem_get_info(i)[0] * 0.9)
    try:
        out["cpu"] = int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES") * 0.9)
    except (ValueError, OSError, AttributeError):
        out["cpu"] = 16 * 2**30
    out["disk"] = float("inf")
    return out


def _to_bytes(v) -> int | float:
    if isinstance(v, (int, float)):
        return v
    s = str(v).upper().replace(" ", "")
    for unit, mul in (("GIB", 2**30), ("MIB", 2**20), ("KIB", 2**10), ("GB", 10**9),
                      ("MB", 10**6), ("KB", 10**3)):
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * mul)
    return int(float(s))


# ---------------------------------------------------------------------------
# tied params
# ---------------------------------------------------------------------------


def find_tied_parameters(model) -> list[list[str]]:
    """Groups of parameter names that share one tensor (found by identity,
    as the reference finds them). The zoo reads a tied head from the
    embedding's own parameter, so its models have none, as JAX's declare
    none."""
    by_id: dict[int, list[str]] = defaultdict(list)
    for name, p in model.named_parameters(remove_duplicate=False):
        by_id[id(p)].append(name)
    return [sorted(names) for names in by_id.values() if len(names) > 1]


# ---------------------------------------------------------------------------
# device-map inference
# ---------------------------------------------------------------------------


def _module_children(named_shapes: Mapping[str, tuple], prefix: str) -> list[str]:
    """Direct child module names under a prefix."""
    seen = []
    plen = len(prefix) + 1 if prefix else 0
    for name in named_shapes:
        if prefix and not name.startswith(prefix + "."):
            continue
        child = name[plen:].split(".")[0]
        full = f"{prefix}.{child}" if prefix else child
        if full not in seen:
            seen.append(full)
    return seen


def infer_auto_device_map(
    named_shapes: Mapping[str, tuple],
    max_memory: Mapping | None = None,
    no_split_module_classes: list[str] | None = None,
    dtype=None,
    special_dtypes: Mapping[str, Any] | None = None,
    tied_parameters: list[list[str]] | None = None,
    clean_result: bool = True,
    no_split_prefixes: list[str] | None = None,
) -> dict[str, Any]:
    """Greedy first-fit placement of modules onto the tiers in order (cards
    → cpu → disk), keeping no-split units whole and tied weights on one
    tier. ``no_split_prefixes`` (regexes allowed, e.g. ``layers\\.\\d+``)
    and ``no_split_module_classes`` name the units that land whole."""
    max_memory = get_max_memory(max_memory)
    no_split = list(no_split_prefixes or []) + list(no_split_module_classes or [])
    sizes = compute_module_sizes(named_shapes, dtype=dtype, special_dtypes=special_dtypes)
    tied_groups = tied_parameters or []

    devices = [d for d in max_memory if max_memory[d] > 0]
    devices.sort(key=lambda d: (isinstance(d, str), str(d) == "disk", str(d)))

    device_map: dict[str, Any] = {}
    remaining = {d: max_memory[d] for d in devices}

    def is_no_split(name: str) -> bool:
        return any(re.fullmatch(pat, name) for pat in no_split)

    def tied_to(name: str) -> list[str]:
        out = []
        for group in tied_groups:
            if name in group:
                out.extend(g for g in group if g != name)
        return out

    queue = _module_children(named_shapes, "")
    dev_idx = 0
    while queue:
        name = queue.pop(0)
        if name in device_map:  # already placed as a tied companion
            continue
        companions = [c for c in tied_to(name) if c not in device_map]
        total = sizes.get(name, 0) + sum(sizes.get(c, 0) for c in companions)
        placed = False
        while dev_idx < len(devices):
            device = devices[dev_idx]
            if total <= remaining[device]:
                device_map[name] = device
                remaining[device] -= total
                for c in companions:
                    device_map[c] = device
                placed = True
                break
            # does not fit: split if allowed, else go on to the next tier
            children = [] if is_no_split(name) else _module_children(named_shapes, name)
            children = [c for c in children if c != name]
            if children and not (len(children) == 1 and children[0] == name):
                queue = children + queue
                placed = True
                break
            dev_idx += 1
        if not placed:
            raise ValueError(f"module {name!r} ({total} bytes) does not fit on any device tier")

    if clean_result:
        device_map = clean_device_map(device_map)
    return device_map


def clean_device_map(device_map: dict[str, Any], module_name: str = "") -> dict[str, Any]:
    """Collapse children that all share a device into their parent."""
    prefix = module_name + "." if module_name else ""
    values = [v for k, v in device_map.items() if k == module_name or k.startswith(prefix)]
    if module_name and len(values) > 0 and len(set(map(str, values))) == 1:
        for k in [k for k in device_map if k.startswith(prefix)]:
            del device_map[k]
        device_map[module_name] = values[0]
        return device_map
    children = {k.split(".")[0] if not module_name
                else module_name + "." + k[len(prefix):].split(".")[0]
                for k in device_map if k != module_name and (not module_name or k.startswith(prefix))}
    for child in sorted(children):
        clean_device_map(device_map, child)
    return device_map


def get_balanced_memory(
    named_shapes: Mapping[str, tuple],
    max_memory: Mapping | None = None,
    no_split_module_classes: list[str] | None = None,
    dtype=None,
    special_dtypes=None,
    low_zero: bool = False,
) -> dict:
    """Even out the cards' budgets so layers spread across cards instead of
    filling card 0 first; ``low_zero`` keeps card 0 light for activations
    and the generation state."""
    user_max = max_memory is not None
    max_memory = get_max_memory(max_memory)
    chips = [d for d in max_memory if not isinstance(d, str)]
    if len(chips) <= 1:
        return max_memory
    total_size = compute_module_sizes(named_shapes, dtype=dtype,
                                      special_dtypes=special_dtypes).get("", 0)
    n = len(chips) - int(low_zero)
    per_chip = total_size // n + total_size // (n * 10)  # +10% slack, as the reference
    out = dict(max_memory)
    for d in chips:
        cap = max_memory[d]
        if low_zero and d == 0:
            out[d] = min(cap, per_chip // 2) if not user_max else cap
        else:
            out[d] = min(cap, per_chip)
    return out


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

#: safetensors dtype names ↔ torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors that map its pages (nothing is
    read until a tensor is used): an 8-byte little-endian header length, a
    JSON header of ``{name: {dtype, shape, data_offsets}}``, then the raw
    little-endian bytes."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    if not header:
        return {}
    data = np.memmap(path, dtype=np.uint8, mode="c", offset=8 + n)
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        raw = torch.from_numpy(data[begin:end])
        out[name] = raw.view(_ST_DTYPES[info["dtype"]]).reshape(info["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Mapping[str, str] | None = None) -> None:
    """Write ``tensors`` (CPU or card) as one ``.safetensors`` file, which
    the ``safetensors`` package and :func:`load_safetensors` read; the
    header is padded with spaces to a multiple of 8 bytes."""
    header, offset = {}, 0
    items = sorted(tensors.items())
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = dict(metadata)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            flat = t.detach().contiguous().reshape(-1).cpu()
            if flat.numel():
                f.write(flat.view(torch.uint8).numpy())


def load_state_dict_from_files(checkpoint_path: str) -> dict[str, torch.Tensor]:
    """A checkpoint directory or file as a flat ``{name: CPU tensor}``:
    sharded ``model.safetensors.index.json`` / ``pytorch_model.bin.index.json``
    layouts and single files."""
    path = checkpoint_path
    if os.path.isdir(path):
        for index_name in (SAFE_WEIGHTS_INDEX_NAME, WEIGHTS_INDEX_NAME, "model.index.json"):
            index_file = os.path.join(path, index_name)
            if os.path.exists(index_file):
                with open(index_file) as f:
                    index = json.load(f)
                out = {}
                for shard in sorted(set(index["weight_map"].values())):
                    out.update(_load_single_file(os.path.join(path, shard)))
                return out
        for candidate in ("model.safetensors", "pytorch_model.bin", "model.npz"):
            p = os.path.join(path, candidate)
            if os.path.exists(p):
                return _load_single_file(p)
        raise FileNotFoundError(f"no checkpoint found under {path}")
    return _load_single_file(path)


def _load_single_file(path: str) -> dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    if path.endswith(".npz"):
        from ..models._params import as_tensor

        data = np.load(path)
        return {k: as_tensor(data[k]) for k in data.files}
    if path.endswith((".bin", ".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in sd.items()}
    raise ValueError(f"unrecognised checkpoint format: {path}")
