"""Checkpoint manifest: the completeness certificate of a checkpoint dir (a
copy of ``accelerate_tpu/resilience/manifest.py``: the same format, so each
package's validator accepts the other's checkpoints).

``manifest.json`` is written LAST (immediately before the atomic
``os.rename`` of ``checkpoint_N.tmp`` → ``checkpoint_N``), so its presence
plus a passing validation means every byte of the checkpoint landed:

```json
{
  "format_version": 1,
  "kind": "sharded" | "gathered",
  "step": 120, "iteration": 4,
  "host_count": 2, "timestamp": 1754200000.0,
  "files": {"shard_00000/model.safetensors": {"bytes": 4096, "crc32": 123}},
  "arrays": {            // sharded kind only: piece table per component
    "model_0": {
      "layer.w": {
        "global_shape": [64, 64], "dtype": "float32", "spec": "('fsdp',)",
        "pieces": [{"file": "shard_00000/model_0.safetensors",
                    "piece": "layer.w::p0", "offsets": [[0, 32], [0, 64]]}]
      }
    }
  }
}
```

Validation re-checks existence, size, and CRC32 of every listed file —
a truncated or bit-rotted checkpoint fails closed and auto-resume falls
back to the previous valid one. Legacy (pre-manifest) checkpoint dirs are
accepted when their ``accelerator_state.json`` is present, so old runs
stay resumable.
"""

from __future__ import annotations

import json
import logging
import os
import zlib
from typing import Any

from .retry import run_with_retries

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
#: written next to the checkpoints on a preemption-triggered emergency save
SENTINEL_NAME = "PREEMPTED.json"
FORMAT_VERSION = 1

_CRC_CHUNK = 1 << 20


def file_crc32(path: str) -> int:
    """Streaming CRC32 of a file (reads back what was written — on a flaky
    mount this doubles as write verification)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CRC_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _walk_files(root: str) -> list[str]:
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if name == MANIFEST_NAME:
                continue
            full = os.path.join(dirpath, name)
            out.append(os.path.relpath(full, root))
    return sorted(out)


def build_manifest(
    checkpoint_dir: str,
    kind: str = "gathered",
    step: int | None = None,
    iteration: int | None = None,
    host_count: int = 1,
    arrays: dict[str, Any] | None = None,
    extra: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Walk ``checkpoint_dir`` and produce the manifest dict (sizes + CRCs
    of every file currently in it)."""
    import time

    files = {}
    for rel in _walk_files(checkpoint_dir):
        full = os.path.join(checkpoint_dir, rel)
        files[rel.replace(os.sep, "/")] = {
            "bytes": os.path.getsize(full),
            "crc32": file_crc32(full),
        }
    manifest: dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "host_count": int(host_count),
        "timestamp": time.time(),
        "files": files,
    }
    if step is not None:
        manifest["step"] = int(step)
    if iteration is not None:
        manifest["iteration"] = int(iteration)
    if arrays:
        manifest["arrays"] = arrays
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(checkpoint_dir: str, manifest: dict[str, Any]) -> str:
    """Durably write ``manifest.json`` (write → flush → fsync) — the commit
    rename that follows must never promote a dir whose certificate is
    itself torn."""
    path = os.path.join(checkpoint_dir, MANIFEST_NAME)

    def _write():
        with open(path, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())

    run_with_retries(_write, what=f"write {path}")
    return path


def read_manifest(checkpoint_dir: str) -> dict[str, Any] | None:
    path = os.path.join(checkpoint_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def validate_checkpoint(
    checkpoint_dir: str, check_crc: bool = True
) -> tuple[bool, str]:
    """Is ``checkpoint_dir`` a complete, uncorrupted checkpoint?

    Returns ``(ok, reason)``. A ``.tmp`` dir (interrupted, uncommitted
    save) is always invalid. A dir with a manifest must have every listed
    file present with the recorded size (and CRC32 when ``check_crc``).
    A legacy dir without a manifest passes when its
    ``accelerator_state.json`` exists — pre-manifest saves wrote no
    certificate, and rejecting them all would strand old runs.
    """
    if not os.path.isdir(checkpoint_dir):
        return False, "not a directory"
    if checkpoint_dir.rstrip("/").endswith(".tmp"):
        return False, "uncommitted .tmp directory"
    manifest = read_manifest(checkpoint_dir)
    if manifest is None:
        if os.path.exists(os.path.join(checkpoint_dir, "accelerator_state.json")):
            return True, "legacy checkpoint (no manifest)"
        return False, "no manifest and no accelerator_state.json"
    for rel, meta in manifest.get("files", {}).items():
        full = os.path.join(checkpoint_dir, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel}"
        size = os.path.getsize(full)
        if size != meta.get("bytes"):
            return False, f"size mismatch for {rel}: {size} != {meta.get('bytes')}"
        if check_crc and meta.get("crc32") is not None:
            if file_crc32(full) != meta["crc32"]:
                return False, f"checksum mismatch for {rel}"
    return True, "ok"


def find_latest_valid_checkpoint(
    checkpoints_dir: str, check_crc: bool = True
) -> str | None:
    """Newest ``checkpoint_<i>`` under ``checkpoints_dir`` that validates;
    corrupt/partial ones are skipped with a warning (the auto-resume
    contract: never select a ``.tmp`` or torn checkpoint)."""
    from ..checkpointing import _sorted_checkpoints

    for candidate in reversed(_sorted_checkpoints(checkpoints_dir)):
        ok, reason = validate_checkpoint(candidate, check_crc=check_crc)
        if ok:
            return candidate
        logger.warning("skipping invalid checkpoint %s: %s", candidate, reason)
    return None
