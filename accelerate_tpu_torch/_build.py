"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). Libraries land in
``build/torch_kernels/`` at the root of the checkout, named by the hash of
their source, so an edited source rebuilds and an unchanged one loads the
existing library. Nothing here runs at import: the first CUDA tensor that
reaches a kernel triggers its build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: every kernel source of the package, built together by :func:`build_all`
SOURCES = ("paged_attention.cu", "flash_attention.cu")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


def library_path(source: str) -> Path:
    """Where the library for ``source`` lives: keyed by the source's hash
    and the compiler flags, so any edit selects a fresh build."""
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str):
    """Start ``nvcc`` for one source; returns ``(popen, tmp, final)`` or
    ``None`` when the library is already built."""
    final = library_path(source)
    if final.exists():
        return None
    nvcc = _nvcc()
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, final


def _finish(source: str, started) -> None:
    proc, tmp, final = started
    out, err = proc.communicate()
    log = final.with_suffix(".log")
    log.write_text(out + err)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {source} (exit {proc.returncode}):\n{err}"
        )
    os.replace(tmp, final)  # atomic: a concurrent build sees all or nothing


def build_all(sources=SOURCES) -> dict[str, Path]:
    """Build every source that is not built yet, all ``nvcc`` processes
    started together; returns ``{source: library path}``. Raises with
    nvcc's stderr when a build fails."""
    with _lock:
        started = {src: _start(src) for src in sources}
        errors = []
        for src, st in started.items():
            if st is None:
                continue
            try:
                _finish(src, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {src: library_path(src) for src in sources}


def build_log(source: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the current build of ``source``, or '' if it was built elsewhere."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, building it first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is not None:
            return lib
    path = build_all((source,))[source]
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib
