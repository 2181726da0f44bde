"""Per-process piece tables for sharded checkpoints (port of
``accelerate_tpu/resilience/distributed.py``).

A sharded save has each process write only its pieces of every tensor
into its own ``shard_<process_index>/`` directory, and a piece table that
says where each piece sits in the global tensor; the manifest merges the
tables. The format is the JAX package's, so a table written here reads
like one written there.

The port has no sharded tensors yet (FSDP2 and DTensor are ROADMAP item
18): every tensor is replicated across the processes, a piece is the whole
tensor, and process 0 alone writes it, where JAX keeps the shards whose
``replica_id`` is 0. A sharded tensor's placements will fill the same
table. Load assembles each tensor from its pieces, whichever process wrote
them, so a checkpoint written by N processes restores into M.
"""

from __future__ import annotations

import logging
from typing import Any, Callable

import torch

logger = logging.getLogger(__name__)


def shard_dirname(process_index: int) -> str:
    return f"shard_{process_index:05d}"


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's spelling of a torch dtype (``float32``, ``bfloat16``), as the
    JAX package writes it into a table."""
    return str(dtype).removeprefix("torch.")


def _whole(shape) -> list[list[int]]:
    return [[0, int(d)] for d in shape]


def host_snapshot(flat: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A host copy of every tensor of ``flat`` that owns its memory, made
    now: card tensors are copied into pinned memory without blocking and
    the card is synchronised once at the end (pinned blocks come back to
    PyTorch's host cache when freed, so a later save reuses them); host
    tensors are cloned. When this returns every copy has finished, so a
    later in-place update of a tensor cannot reach its snapshot."""
    out: dict[str, torch.Tensor] = {}
    on_card = False
    for key, t in flat.items():
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            on_card = True
        else:
            host = t.clone()
        out[key] = host
    if on_card:
        torch.cuda.synchronize()
    return out


def collect_pieces(flat: dict[str, torch.Tensor], process_index: int = 0
                   ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """Snapshot THIS process's pieces of every tensor of ``flat``.

    Returns ``(pieces, table)``: ``pieces`` maps ``"<key>::p0"`` to a host
    copy of the tensor (what this process writes to its shard file), and
    ``table`` maps the key to its manifest entry (global shape, dtype,
    spec and this process's pieces; the writer fills in each piece's
    ``file``). A replicated tensor is a piece of process 0 only.

    The device→host copies run here, on the calling thread, and have
    finished when this returns (:func:`host_snapshot`): this is an async
    save's snapshot point."""
    pieces: dict[str, torch.Tensor] = {}
    table: dict[str, Any] = {}
    if process_index == 0:
        pieces = host_snapshot({f"{key}::p0": t for key, t in flat.items()})
    for key, t in flat.items():
        entry_pieces = []
        if process_index == 0:
            entry_pieces.append({"piece": f"{key}::p0", "offsets": _whole(t.shape)})
        table[key] = {
            "global_shape": list(t.shape),
            "dtype": dtype_name(t.dtype),
            "spec": None,
            "pieces": entry_pieces,
        }
    return pieces, table


def merge_piece_tables(tables: list[dict[str, Any]]) -> dict[str, Any]:
    """Union of per-process piece tables into one manifest entry per key
    (processes contribute disjoint pieces of the same global tensors)."""
    merged: dict[str, Any] = {}
    for table in tables:
        for key, entry in table.items():
            if key not in merged:
                merged[key] = {k: v for k, v in entry.items() if k != "pieces"}
                merged[key]["pieces"] = []
            merged[key]["pieces"].extend(entry["pieces"])
    return merged


def assemble_full(entry: dict[str, Any], load_piece: Callable[[dict], torch.Tensor]
                  ) -> torch.Tensor:
    """The whole tensor on the host from every piece's offsets; raises if
    the pieces do not cover it."""
    shape = tuple(entry["global_shape"])
    pieces = entry["pieces"]
    if not pieces:
        raise ValueError("manifest entry has no pieces")
    first = load_piece(pieces[0])
    if not shape:  # scalar
        return first.reshape(())
    if len(pieces) == 1 and pieces[0]["offsets"] == _whole(shape):
        return first.reshape(shape)
    out = torch.empty(shape, dtype=first.dtype)
    # coverage must be PROVEN before handing back uninitialised memory: a
    # single partial piece (a torn multi-process checkpoint) is as
    # dangerous as a gap between several
    filled = torch.zeros(shape, dtype=torch.bool)
    for piece in pieces:
        idx = tuple(slice(start, stop) for start, stop in piece["offsets"])
        out[idx] = load_piece(piece)
        filled[idx] = True
    if not bool(filled.all()):
        raise ValueError("checkpoint pieces do not cover the full array")
    return out


def restore_from_pieces(live: dict[str, torch.Tensor], arrays_meta: dict[str, Any],
                        load_piece: Callable[[dict], torch.Tensor]) -> dict[str, torch.Tensor]:
    """``{key: host tensor}`` for every key of ``live``, assembled from a
    manifest piece table; a key missing from the table, or a shape other
    than the live tensor's, raises."""
    out = {}
    for key, t in live.items():
        if key not in arrays_meta:
            raise KeyError(f"checkpoint manifest is missing tensor {key!r}")
        entry = arrays_meta[key]
        if tuple(entry["global_shape"]) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {entry['global_shape']} "
                             f"vs live {list(t.shape)}")
        out[key] = assemble_full(entry, load_piece)
    return out
