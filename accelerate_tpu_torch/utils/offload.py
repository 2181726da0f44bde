"""The disk tier's weight store (port of ``accelerate_tpu/utils/offload.py``):
one raw ``<name>.dat`` file a tensor plus ``index.json`` (``{name: {dtype,
shape}}``), byte for byte the JAX package's format, so a folder written by
either package loads in the other. bf16 is stored as its raw 16-bit
patterns under the dtype name ``"bfloat16"``. Loaded weights are CPU
tensors that map the file's pages: nothing is read until one is used.
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

#: index dtype names of the tensors numpy has no type for
_RAW_16 = {"bfloat16": torch.bfloat16}


def _as_array(weight) -> tuple[np.ndarray, str]:
    """``(numpy array of the bytes to write, index dtype name)``."""
    if isinstance(weight, torch.Tensor):
        t = weight.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    array = np.asarray(weight)
    name = str(array.dtype)
    if name == "bfloat16":  # an ml_dtypes array
        return array.view(np.uint16), name
    return array, name


def offload_weight(weight, weight_name: str, offload_folder: str,
                   index: dict | None = None) -> dict:
    """Write one tensor as ``<name>.dat`` and record it in ``index``."""
    os.makedirs(offload_folder, exist_ok=True)
    array, dtype_name = _as_array(weight)
    file_path = os.path.join(offload_folder, f"{weight_name}.dat")
    mm = np.memmap(file_path, dtype=array.dtype, mode="w+", shape=array.shape or (1,))
    mm[:] = array if array.shape else array.reshape(1)
    mm.flush()
    del mm
    if index is not None:
        index[weight_name] = {"dtype": dtype_name, "shape": list(array.shape)}
    return index if index is not None else {}


def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """The tensor of one ``.dat`` file, mapping its pages (copy on write:
    the file is never written)."""
    shape = tuple(weight_info["shape"])
    dtype_name = weight_info["dtype"]
    raw16 = _RAW_16.get(dtype_name)
    mm = np.memmap(weight_file, dtype=np.uint16 if raw16 else np.dtype(dtype_name), mode="c",
                   shape=shape or (1,))
    out = torch.from_numpy(mm)
    if raw16 is not None:
        out = out.view(torch.int16).view(raw16)
    return out.reshape(shape)


def save_offload_index(index: dict, offload_folder: str) -> None:
    with open(os.path.join(offload_folder, "index.json"), "w") as f:
        json.dump(index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    with open(os.path.join(offload_folder, "index.json")) as f:
        return json.load(f)


def offload_state_dict(save_dir: str, state_dict: Mapping[str, Any]) -> dict:
    """Offload a whole flat state dict; returns (and writes) its index."""
    index: dict = {}
    for name, value in state_dict.items():
        index = offload_weight(value, name, save_dir, index)
    save_offload_index(index, save_dir)
    return index


class PrefixedDataset(Mapping):
    """View of a Mapping with a key prefix."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter([k for k in self.dataset if k.startswith(self.prefix)])

    def __len__(self):
        return len([k for k in self.dataset if k.startswith(self.prefix)])


class OffloadedWeightsLoader(Mapping):
    """Lazy Mapping over in-memory and disk-offloaded weights; an index
    entry with a ``safetensors_file`` reads that file's tensor."""

    def __init__(self, state_dict: Mapping[str, Any] | None = None,
                 save_folder: str | None = None, index: Mapping | None = None, device=None):
        if state_dict is None and save_folder is None and index is None:
            raise ValueError("need either a state_dict or a save_folder/index")
        self.state_dict = dict(state_dict or {})
        if index is None and save_folder is not None:
            index = load_offload_index(save_folder)
        self.index = dict(index or {})
        self.save_folder = save_folder
        self.all_keys = list(self.state_dict)
        self.all_keys.extend(k for k in self.index if k not in self.all_keys)
        self.device = device

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        weight_info = self.index[key]
        if weight_info.get("safetensors_file") is not None:
            from .modeling import load_safetensors

            return load_safetensors(weight_info["safetensors_file"])[
                weight_info.get("weight_name", key)]
        return load_offloaded_weight(os.path.join(self.save_folder, f"{key}.dat"), weight_info)

    def __contains__(self, key) -> bool:  # without mapping the file
        return key in self.state_dict or key in self.index

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)


def extract_submodules_state_dict(state_dict: Mapping, submodule_names: list[str]) -> dict:
    out = {}
    for name in submodule_names:
        out.update({k: v for k, v in state_dict.items()
                    if k == name or k.startswith(name + ".")})
    return out
