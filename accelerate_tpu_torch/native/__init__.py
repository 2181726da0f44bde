"""Native helpers of the host-side data path (port of
``accelerate_tpu/native``): the 4-bit nibble decoder
(:func:`q4_decode_codes`, ``q4decode.c``) that the streaming executor runs
on a segment's packed planes before their copy to the card.

The library is built with the system C compiler at first use into the
git-ignored ``build/native/`` at the root of the checkout, named by the
host ISA (the CPU's feature flags: a ``-march=native`` build must not be
reused on an older CPU) and the source's hash, as ``_build.py`` builds the
CUDA sources. Where no compiler builds it, :func:`q4_decode_codes` returns
None and callers take the path without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "q4decode.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False

#: calls of the native decoder since import
decode_calls = 0


def _isa_tag() -> str:
    """The host ISA as ``<machine>-<hash of the CPU feature flags>``."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return f"{platform.machine()}-{hashlib.sha256(feats.encode()).hexdigest()[:12]}"
    except OSError:
        pass
    return platform.machine() or "unknown"


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libq4decode-{_isa_tag()}-{digest}.so"


def _build() -> ctypes.CDLL:
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [os.environ.get("CC", "cc"), "-O3", "-march=native", "-shared", "-fPIC",
               str(SOURCE), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)  # atomic against a concurrent build
    lib = ctypes.CDLL(str(path))
    lib.q4_decode_codes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int8),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_int8),
    ]
    lib.q4_decode_codes.restype = None
    return lib


def load():
    """The decoder library, built at the first call; None when it cannot
    be built."""
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            try:
                _lib = _build()
            except (OSError, subprocess.SubprocessError):
                _lib = None
    return _lib


def aligned_empty(shape, dtype, align: int = 64) -> np.ndarray:
    """Uninitialised array whose data pointer is ``align``-byte aligned."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.empty(n + align, dtype=np.uint8)
    offset = (-raw.ctypes.data) % align
    return raw[offset:offset + n].view(dtype).reshape(shape)


def q4_decode_codes(packed: np.ndarray, lut16: np.ndarray, out: np.ndarray | None = None):
    """packed uint8 ``[..., n]`` → int8 code values ``[..., 2n]`` (the high
    nibble first) through the 16-entry ``lut16``, written into ``out`` (a
    C-contiguous int8 array, e.g. a view of pinned memory) or a new
    64-byte-aligned array; None when the library is unavailable."""
    global decode_calls
    lib = load()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lut = np.ascontiguousarray(lut16, dtype=np.int8)
    shape = packed.shape[:-1] + (packed.shape[-1] * 2,)
    if out is None:
        out = aligned_empty(shape, np.int8)
    elif out.shape != shape or out.dtype != np.int8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous int8 {shape}, got {out.dtype} {out.shape}")
    lib.q4_decode_codes(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        packed.size,
        lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
    )
    decode_calls += 1
    return out
