"""Checkpoint and resume (port of ``accelerate_tpu/checkpointing.py``).

The directory contract is the JAX package's: ``checkpoint_<i>/`` rotation
under ``project_dir/checkpoints`` with ``total_limit``, and the same file
names — ``model.safetensors``, ``optimizer.safetensors``,
``scheduler.bin``, ``sampler.bin``, ``custom_checkpoint_<i>.pkl``,
``scaler.bin``, ``random_states_<rank>.pkl``, ``accelerator_state.json``
and the ``manifest.json`` written last — so each package's checkpoint
discovery and validation reads the other's directories. The tensors in the
files carry the port's names (the module's ``state_dict`` keys).

Tensors are written through the port's own safetensors writer
(:func:`~.utils.modeling.save_safetensors`). The optimizer's tensors
(AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``) go into the array file
as ``state.<param index>.<name>``; its ``param_groups`` and any non-tensor
state ride in the file's ``__metadata__``. Every save lands in
``<dir>.tmp`` and is renamed into place after the manifest (sizes and
CRC32s of every file) is written, so a checkpoint exists completely or not
at all.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import pickle
import random
import re
import shutil
import struct
import time
from typing import Any

import numpy as np
import torch

from .diagnostics.tracing import traced
from .resilience.distributed import host_snapshot
from .utils.modeling import load_safetensors, save_safetensors

logger = logging.getLogger(__name__)

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
CUSTOM_STATES_NAME = "custom_checkpoint"
SCALER_NAME = "scaler"

#: the ``__metadata__`` key of an optimizer file that holds its
#: ``param_groups`` and non-tensor state, as JSON
_OPTIMIZER_META = "optimizer"


# ---------------------------------------------------------------------------
# flat-dict tensor IO
# ---------------------------------------------------------------------------


def save_array_dict(flat: dict[str, torch.Tensor], path: str, safe_serialization: bool = True,
                    metadata: dict[str, str] | None = None) -> str:
    """Write ``flat`` to ``path`` + ``.safetensors`` (``.bin``, a
    ``torch.save`` of the dict and the metadata, with
    ``safe_serialization=False``); returns the file written."""
    if safe_serialization:
        out = path if path.endswith(".safetensors") else path + ".safetensors"
        save_safetensors(flat, out, metadata=metadata)
        return out
    out = path + ".bin"
    torch.save({"tensors": dict(flat), "metadata": dict(metadata or {})}, out)
    return out


def _array_file(path: str) -> str:
    """``path`` itself when it names an array file, else its
    ``.safetensors`` or ``.bin`` sibling that exists."""
    if path.endswith((".safetensors", ".bin")) and os.path.exists(path):
        return path
    for suffix in (".safetensors", ".bin"):
        if os.path.exists(path + suffix):
            return path + suffix
    raise FileNotFoundError(path)


def read_metadata(path: str) -> dict[str, str]:
    """The ``__metadata__`` of an array file written by
    :func:`save_array_dict` (``{}`` when it has none)."""
    path = _array_file(path)
    if path.endswith(".safetensors"):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            return json.loads(f.read(n)).get("__metadata__", {})
    return torch.load(path, map_location="cpu", weights_only=True).get("metadata", {})


def load_array_dict(path: str) -> dict[str, torch.Tensor]:
    """An array file written by :func:`save_array_dict` as ``{name: CPU
    tensor}``."""
    path = _array_file(path)
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)["tensors"]


def _model_flat(model) -> dict[str, torch.Tensor]:
    module = getattr(model, "module", model)
    return dict(module.state_dict())


def _load_model_flat(model, flat: dict[str, torch.Tensor]) -> None:
    """Copy ``flat`` into the live parameters in place (an optimizer built
    on them keeps them); a missing or extra key, or another shape, raises."""
    module = getattr(model, "module", model)
    module.load_state_dict(flat, strict=True)


def _jsonable(obj):
    if isinstance(obj, torch.Tensor):
        return obj.item() if obj.numel() == 1 else obj.tolist()
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    return obj


def _optimizer_flat(opt) -> tuple[dict[str, torch.Tensor], dict[str, str]]:
    """The optimizer's tensors as ``state.<param index>.<name>`` and its
    ``param_groups`` and non-tensor state as the file's metadata."""
    sd = opt.state_dict()
    flat: dict[str, torch.Tensor] = {}
    other: dict[str, dict] = {}
    for pid, entry in sd["state"].items():
        for name, value in entry.items():
            if isinstance(value, torch.Tensor):
                flat[f"state.{pid}.{name}"] = value
            else:
                other.setdefault(str(pid), {})[name] = _jsonable(value)
    meta = {"param_groups": _jsonable(sd["param_groups"]), "state": other}
    return flat, {_OPTIMIZER_META: json.dumps(meta)}


def _restore_optimizer(opt, flat: dict[str, torch.Tensor], metadata: dict[str, str]) -> None:
    """Load an optimizer's file into the live optimizer. Each tensor lands
    on its parameter's device, in a copy of its own (never a view of the
    mapped file); ``step`` lands where the live optimizer keeps it — on
    its parameter's device for a capturable or fused group, on the host
    otherwise — since ``Optimizer.load_state_dict`` leaves it where it was
    saved."""
    meta = json.loads(metadata[_OPTIMIZER_META])
    inner = getattr(opt, "optimizer", opt)
    params = [p for group in inner.param_groups for p in group["params"]]
    groups = meta["param_groups"]
    group_of = {pid: g for g in groups for pid in g["params"]}
    state: dict[int, dict] = {}
    for key, value in flat.items():
        _, pid, name = key.split(".", 2)
        pid = int(pid)
        param = params[pid]
        group = group_of.get(pid, {})
        if name == "step":
            on_param = group.get("capturable") or group.get("fused")
            device = param.device if on_param else torch.device("cpu")
            live = inner.state.get(param, {}).get("step")
            if isinstance(live, torch.Tensor):
                device = live.device
            value = value.to(device=device, dtype=torch.float32, copy=True)
        else:
            value = value.to(device=param.device, copy=True)
        state.setdefault(pid, {})[name] = value
    for pid, entry in meta["state"].items():
        state.setdefault(int(pid), {}).update(entry)
    for g in groups:
        if isinstance(g.get("betas"), list):
            g["betas"] = tuple(g["betas"])
    inner.load_state_dict({"state": state, "param_groups": groups})


# ---------------------------------------------------------------------------
# RNG bundles
# ---------------------------------------------------------------------------


def _collect_rng_state() -> dict[str, Any]:
    from .utils.random import generator_state

    states: dict[str, Any] = {"random_state": random.getstate(),
                              "numpy_random_seed": np.random.get_state(),
                              "torch_manual_seed": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["torch_cuda_manual_seed"] = torch.cuda.get_rng_state_all()
    generator = generator_state()
    if generator is not None:
        # the framework generator: the counterpart of JAX's jax_key
        states["torch_generator"] = generator
    return states


def _restore_rng_state(states: dict[str, Any]):
    from .utils.random import set_generator_state

    random.setstate(states["random_state"])
    np.random.set_state(states["numpy_random_seed"])
    if "torch_manual_seed" in states:
        torch.set_rng_state(states["torch_manual_seed"])
    cuda = states.get("torch_cuda_manual_seed")
    if cuda is not None and torch.cuda.is_available() and len(cuda) == torch.cuda.device_count():
        torch.cuda.set_rng_state_all(cuda)
    set_generator_state(states.get("torch_generator"))


# ---------------------------------------------------------------------------
# the async writer and the commit
# ---------------------------------------------------------------------------

#: the in-flight async checkpoint write (one worker: saves are ordered).
#: ``pending_commit`` is the (tmp_dir, final_dir, meta) of a written but not
#: yet committed async save; ``pending_dirs`` protects those directories
#: from rotation until the commit lands.
_ASYNC_SAVE: dict[str, Any] = {
    "executor": None,
    "future": None,
    "pending_commit": None,
    "pending_dirs": set(),
}


def _pending_checkpoint_dirs() -> set[str]:
    """Directories with an async write or commit still in flight — rotation
    must never delete these."""
    return set(_ASYNC_SAVE["pending_dirs"])


def _commit_checkpoint_dir(tmp_dir: str, final_dir: str):
    """The commit. A fresh ``final_dir`` (automatic naming): ONE atomic
    ``os.rename``. An existing ``final_dir`` (a reused directory, or the
    non-automatic ``checkpoints/``): a per-entry merge-overwrite with the
    manifest moved last, so unrelated content there survives."""
    from .resilience.manifest import MANIFEST_NAME
    from .resilience.retry import run_with_retries

    def _commit():
        if not os.path.isdir(final_dir):
            os.rename(tmp_dir, final_dir)
            return
        # the manifest moves LAST: a crash mid-merge leaves old-manifest-
        # vs-new-files (or no manifest), which validation fails closed
        entries = sorted(os.listdir(tmp_dir), key=lambda e: e == MANIFEST_NAME)
        for entry in entries:
            src = os.path.join(tmp_dir, entry)
            dst = os.path.join(final_dir, entry)
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            os.replace(src, dst)
        shutil.rmtree(tmp_dir, ignore_errors=True)

    run_with_retries(_commit, what=f"commit {final_dir}")
    # fsync the parent so the rename itself survives a host crash
    try:
        parent_fd = os.open(os.path.dirname(os.path.abspath(final_dir)) or ".", os.O_RDONLY)
        try:
            os.fsync(parent_fd)
        finally:
            os.close(parent_fd)
    except OSError:
        pass


def _num_processes() -> int:
    from .state import PartialState

    return PartialState._shared_state.get("num_processes", 1)


def _finish_pending_commit(cross_process_safe: bool):
    """Perform a deferred async commit. A multi-process commit needs the
    barrier first (every process's writer joined): callers that barriered
    pass ``cross_process_safe=True``."""
    pending = _ASYNC_SAVE["pending_commit"]
    if pending is None:
        return
    tmp_dir, final_dir, meta = pending
    if not cross_process_safe and _num_processes() > 1:
        return  # the next barriered join point commits
    _ASYNC_SAVE["pending_commit"] = None
    try:
        if meta.get("is_main", True):
            _write_checkpoint_manifest(tmp_dir, meta)
            _commit_checkpoint_dir(tmp_dir, final_dir)
            _record_checkpoint_telemetry("save", final_dir, meta)
        logger.info("Committed checkpoint %s", final_dir)
    finally:
        _ASYNC_SAVE["pending_dirs"].discard(final_dir)
        _ASYNC_SAVE["pending_dirs"].discard(tmp_dir)


def wait_for_checkpoint():
    """Block until a pending ``async_save`` finished writing and (where this
    process can do so safely) committed its directory. A failed write is
    never committed: its ``.tmp`` stays for diagnosis and the error is
    raised once."""
    future = _ASYNC_SAVE["future"]
    if future is not None:
        try:
            future.result()
        except BaseException:
            _abort_pending_commit()
            raise
        finally:
            _ASYNC_SAVE["future"] = None
    _finish_pending_commit(cross_process_safe=False)


def _atexit_drain_async_saves():
    """A clean interpreter exit joins an in-flight async save and commits
    it (one process), or leaves it uncommitted (several: no barrier is
    available at exit), and says which."""
    future = _ASYNC_SAVE["future"]
    pending = _ASYNC_SAVE["pending_commit"]
    if future is None and pending is None:
        return
    try:
        wait_for_checkpoint()
        if _num_processes() > 1 and _ASYNC_SAVE["pending_commit"] is not None:
            logger.warning(
                "multi-process async checkpoint save left UNCOMMITTED (.tmp) at "
                "interpreter exit — no cross-process barrier is available here; "
                "resume will use the previous committed checkpoint"
            )
        else:
            _finish_pending_commit(cross_process_safe=True)
        logger.info("joined in-flight async checkpoint save at interpreter exit")
    except Exception:
        logger.error("in-flight async checkpoint save FAILED during interpreter exit "
                     "— the last checkpoint may be lost", exc_info=True)
    finally:
        executor = _ASYNC_SAVE["executor"]
        if executor is not None:
            executor.shutdown(wait=True)
            _ASYNC_SAVE["executor"] = None


def _async_executor():
    if _ASYNC_SAVE["executor"] is None:
        from concurrent.futures import ThreadPoolExecutor

        _ASYNC_SAVE["executor"] = ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix="checkpoint-writer")
        atexit.register(_atexit_drain_async_saves)
    return _ASYNC_SAVE["executor"]


def _abort_pending_commit():
    """Drop the pending-commit bookkeeping without promoting the ``.tmp``."""
    pending = _ASYNC_SAVE["pending_commit"]
    _ASYNC_SAVE["pending_commit"] = None
    if pending is not None:
        _ASYNC_SAVE["pending_dirs"].discard(pending[0])
        _ASYNC_SAVE["pending_dirs"].discard(pending[1])


def _join_writer_then_barrier(accelerator):
    """Join the local async writer, ALWAYS reach the barrier, then raise any
    local write failure (raising before the barrier would leave the other
    processes waiting in it). A deferred multi-process commit lands here:
    after the barrier the processes agree whether any writer failed; if one
    did every process aborts the commit, else the main process renames and
    a second barrier makes the rename visible before anyone reads."""
    had_async = _ASYNC_SAVE["future"] is not None or _ASYNC_SAVE["pending_commit"] is not None
    error = None
    try:
        wait_for_checkpoint()
    except Exception as e:  # noqa: BLE001 — surfaced after the barrier
        error = e
    accelerator.wait_for_everyone()
    if had_async and accelerator.num_processes > 1:
        any_failed = accelerator.state.consensus_any(error is not None)
        commit_error = None
        if any_failed:
            _abort_pending_commit()
        elif _ASYNC_SAVE["pending_commit"] is not None:
            try:
                _finish_pending_commit(cross_process_safe=True)
            except Exception as e:  # noqa: BLE001 — surfaced after the barrier
                commit_error = e
        accelerator.wait_for_everyone()
        if error is None:
            error = commit_error
    if error is not None:
        raise error


def _record_checkpoint_telemetry(kind: str, path: str, meta: dict):
    from .telemetry import get_active_recorder

    recorder = get_active_recorder()
    if not recorder:
        return
    # an async save commits at the NEXT join point: the writer stamps its
    # true duration into write_seconds when the files land
    seconds = meta.get("write_seconds")
    if seconds is None and "t0" in meta:
        seconds = time.perf_counter() - meta["t0"]
    recorder.record_checkpoint(kind=kind, seconds=seconds, bytes_written=meta.get("bytes"),
                               shard_count=meta.get("shard_count"),
                               is_async=meta.get("is_async", False), path=path)


def _write_checkpoint_manifest(tmp_dir: str, meta: dict):
    """Merge the per-process piece tables (sharded saves) and write the
    manifest — the last file before the commit rename."""
    from .resilience.manifest import build_manifest, write_manifest

    arrays = None
    shard_count = 0
    if meta.get("sharded"):
        from .resilience.distributed import merge_piece_tables

        arrays = {}
        tables_by_component: dict[str, list] = {}
        for entry in sorted(os.listdir(tmp_dir)):
            table_path = os.path.join(tmp_dir, entry, "piece_table.json")
            if not (entry.startswith("shard_") and os.path.exists(table_path)):
                continue
            shard_count += 1
            with open(table_path) as f:
                for component, table in json.load(f).items():
                    tables_by_component.setdefault(component, []).append(table)
        for component, tables in tables_by_component.items():
            arrays[component] = merge_piece_tables(tables)
    manifest = build_manifest(
        tmp_dir,
        kind="sharded" if meta.get("sharded") else "gathered",
        step=meta.get("step"),
        iteration=meta.get("iteration"),
        host_count=meta.get("host_count", 1),
        arrays=arrays,
    )
    meta["bytes"] = sum(f["bytes"] for f in manifest["files"].values())
    meta["shard_count"] = shard_count
    write_manifest(tmp_dir, manifest)


def _resolve_sharded(accelerator, sharded) -> bool:
    if sharded is not None:
        return bool(sharded)
    plugin = getattr(accelerator, "fault_tolerance_plugin", None)
    return bool(plugin is not None and getattr(plugin, "sharded_io", False))


def _rotate_checkpoints(checkpoints_dir: str, total_limit: int, incoming: int = 1):
    """Delete the oldest committed checkpoints so that ``incoming`` more fit
    under ``total_limit``; a checkpoint with a pending async write or
    commit is never deleted."""
    existing = _sorted_checkpoints(checkpoints_dir)
    pending_paths = {os.path.abspath(p) for p in _pending_checkpoint_dirs()}
    excess = len(existing) + incoming - total_limit
    for path in existing:
        if excess <= 0:
            break
        if os.path.abspath(path) in pending_paths:
            logger.warning("rotation: keeping %s (async checkpoint write in flight)", path)
            continue
        shutil.rmtree(path, ignore_errors=True)
        excess -= 1


# ---------------------------------------------------------------------------
# accelerator-level save and load
# ---------------------------------------------------------------------------


@traced("checkpoint/save")
def save_accelerator_state(accelerator, output_dir: str | None = None,
                           safe_serialization: bool = True, async_save: bool = False,
                           sharded: bool | None = None):
    """Save every prepared model, optimizer, scheduler and loader, the
    registered objects, the loss scaler, the RNG bundle and the step.

    Every save is atomic: files land in ``<output_dir>.tmp``, the manifest
    is written last, and the directory is renamed into place after a
    barrier. ``output_dir=None`` saves under ``{project_dir}/checkpoints``
    (``checkpoint_<iteration>`` with automatic naming, rotated to
    ``total_limit``).

    ``async_save=True``: the device→host snapshot of every tensor runs now
    and has finished when this returns (the next optimizer step updates the
    weights and moments in place); the file writes, the manifest and the
    commit run on a background thread and at the next join point
    (:func:`wait_for_checkpoint`, the next save or load, ``end_training``,
    or interpreter exit).

    ``sharded=True`` (the default under ``FaultTolerancePlugin(sharded_io=
    True)``): each process writes its pieces into ``shard_<rank>/`` with a
    piece table, which the manifest merges (:mod:`.resilience.distributed`).
    A write whose retries (``io_attempts``) run out raises."""
    from .resilience.retry import run_with_retries

    t0 = time.perf_counter()
    # join the previous writer, then barrier: saves are ordered, and the
    # rotation below deletes directories other processes may still write
    _join_writer_then_barrier(accelerator)
    sharded = _resolve_sharded(accelerator, sharded)
    if output_dir is None:
        if accelerator.project_dir is None:
            raise ValueError("pass output_dir or set project_dir on the Accelerator")
        checkpoints_dir = os.path.join(accelerator.project_dir, "checkpoints")
        config = accelerator.project_configuration
        if config.automatic_checkpoint_naming:
            output_dir = os.path.join(checkpoints_dir, f"checkpoint_{config.iteration}")
            if accelerator.is_main_process and config.total_limit is not None:
                _rotate_checkpoints(checkpoints_dir, config.total_limit)
        else:
            output_dir = checkpoints_dir
    output_dir = os.path.normpath(output_dir)
    tmp_dir = output_dir + ".tmp"
    if accelerator.is_main_process and os.path.isdir(tmp_dir):
        shutil.rmtree(tmp_dir)  # leftover from an interrupted save
    accelerator.wait_for_everyone()
    os.makedirs(tmp_dir, exist_ok=True)

    is_main = accelerator.is_main_process
    process_index = accelerator.process_index

    # snapshot every tensor NOW, on the calling thread; the copies have
    # finished when this block ends
    model_pieces: list = []
    opt_pieces: list = []
    model_flats: list = []
    opt_flats: list = []
    opt_states = [_optimizer_flat(o) for o in accelerator._optimizers]
    opt_metas = [meta for _, meta in opt_states]
    if sharded:
        from .resilience.distributed import collect_pieces

        model_pieces = [collect_pieces(_model_flat(m), process_index)
                        for m in accelerator._models]
        opt_pieces = [collect_pieces(flat, process_index) for flat, _ in opt_states]
    elif is_main:  # only the main process writes the array files
        model_flats = [host_snapshot(_model_flat(m)) for m in accelerator._models]
        opt_flats = [host_snapshot(flat) for flat, _ in opt_states]
    del opt_states
    # …and every host-side state (the writer must see this step's values,
    # not whatever the loop mutates next)
    sched_states = [s.state_dict() for s in accelerator._schedulers]
    # the loaders' epoch and mid-epoch position, so load_state resumes
    # without a manual skip_first_batches
    dl_states = [dl.state_dict() for dl in accelerator._dataloaders]
    custom_states = [obj.state_dict() for obj in accelerator._custom_objects]
    scaler_state = (accelerator._loss_scale.state_dict()
                    if getattr(accelerator, "_loss_scale", None) is not None else None)
    meta = {"step": accelerator.step, "iteration": accelerator.save_iteration}
    rng_state = _collect_rng_state()

    commit_meta = {
        "t0": t0,
        "is_main": is_main,
        "is_async": bool(async_save),
        "sharded": sharded,
        "step": meta["step"],
        "iteration": meta["iteration"],
        "host_count": accelerator.num_processes,
    }

    def _pickle_to(path: str, state):
        def _write():
            with open(path, "wb") as f:
                pickle.dump(state, f)

        run_with_retries(_write, what=f"write {path}")

    def _write_arrays(flat, path, what, metadata=None):
        return run_with_retries(
            lambda: save_array_dict(flat, path, safe_serialization, metadata=metadata),
            what=f"write {what}")

    def _write_files():
        from .resilience.distributed import shard_dirname

        if sharded:
            shard_dir = os.path.join(tmp_dir, shard_dirname(process_index))
            os.makedirs(shard_dir, exist_ok=True)
            piece_tables: dict[str, Any] = {}
            for name, per_obj, metas in ((MODEL_NAME, model_pieces, None),
                                         (OPTIMIZER_NAME, opt_pieces, opt_metas)):
                for i, (pieces, table) in enumerate(per_obj):
                    suffix = "" if i == 0 else f"_{i}"
                    written = _write_arrays(pieces, os.path.join(shard_dir, f"{name}{suffix}"),
                                            f"{name}{suffix} shard",
                                            metas[i] if metas and is_main else None)
                    rel = os.path.relpath(written, tmp_dir).replace(os.sep, "/")
                    for entry in table.values():
                        for piece in entry["pieces"]:
                            piece["file"] = rel
                    piece_tables[f"{name}_{i}"] = table
            with open(os.path.join(shard_dir, "piece_table.json"), "w") as f:
                json.dump(piece_tables, f)
        else:
            for i, flat in enumerate(model_flats):
                suffix = "" if i == 0 else f"_{i}"
                _write_arrays(flat, os.path.join(tmp_dir, f"{MODEL_NAME}{suffix}"),
                              f"{MODEL_NAME}{suffix}")
            for i, flat in enumerate(opt_flats):
                suffix = "" if i == 0 else f"_{i}"
                _write_arrays(flat, os.path.join(tmp_dir, f"{OPTIMIZER_NAME}{suffix}"),
                              f"{OPTIMIZER_NAME}{suffix}", opt_metas[i])
        if is_main:
            for i, state in enumerate(sched_states):
                _pickle_to(os.path.join(tmp_dir, f"{SCHEDULER_NAME}{'' if i == 0 else f'_{i}'}.bin"),
                           state)
            for i, state in enumerate(dl_states):
                _pickle_to(os.path.join(tmp_dir, f"{SAMPLER_NAME}{'' if i == 0 else f'_{i}'}.bin"),
                           state)
            for i, state in enumerate(custom_states):
                _pickle_to(os.path.join(tmp_dir, f"{CUSTOM_STATES_NAME}_{i}.pkl"), state)
            if scaler_state is not None:
                _pickle_to(os.path.join(tmp_dir, f"{SCALER_NAME}.bin"), scaler_state)
            with open(os.path.join(tmp_dir, "accelerator_state.json"), "w") as f:
                json.dump(meta, f)
        # every process writes its own RNG bundle
        _pickle_to(os.path.join(tmp_dir, f"{RNG_STATE_NAME}_{process_index}.pkl"), rng_state)
        # async: stamp the true write duration now (the commit, and the
        # telemetry row, may come much later)
        if commit_meta["is_async"]:
            commit_meta["write_seconds"] = time.perf_counter() - t0
        logger.info("Saved state to %s (pending commit to %s)", tmp_dir, output_dir)

    accelerator.project_configuration.iteration += 1
    if async_save:
        _ASYNC_SAVE["pending_dirs"].update({output_dir, tmp_dir})
        _ASYNC_SAVE["pending_commit"] = (tmp_dir, output_dir, commit_meta)
        _ASYNC_SAVE["future"] = _async_executor().submit(_write_files)
        return output_dir

    _write_files()
    accelerator.wait_for_everyone()
    if is_main:
        _write_checkpoint_manifest(tmp_dir, commit_meta)
        _commit_checkpoint_dir(tmp_dir, output_dir)
    accelerator.wait_for_everyone()
    _record_checkpoint_telemetry("save", output_dir, commit_meta)
    return output_dir


_CHECKPOINT_DIR_RE = re.compile(r"^checkpoint_(\d+)$")


def _sorted_checkpoints(checkpoints_dir: str) -> list[str]:
    """Committed ``checkpoint_<i>`` dirs, oldest→newest; a non-numeric
    suffix (a ``checkpoint_12.tmp`` left by an interrupted save) is not a
    checkpoint and is skipped."""
    if not os.path.isdir(checkpoints_dir):
        return []
    entries = []
    for d in os.listdir(checkpoints_dir):
        match = _CHECKPOINT_DIR_RE.match(d)
        if match:
            entries.append((int(match.group(1)), os.path.join(checkpoints_dir, d)))
    return [path for _, path in sorted(entries)]


def _piece_loader(input_dir: str):
    """``piece_entry → tensor`` with a per-call cache of opened shard files
    (several pieces usually share one file)."""
    cache: dict[str, dict[str, torch.Tensor]] = {}

    def load_piece(piece: dict) -> torch.Tensor:
        rel = piece["file"]
        if rel not in cache:
            cache[rel] = load_array_dict(os.path.join(input_dir, rel))
        return cache[rel][piece["piece"]]

    return load_piece


@traced("checkpoint/restore")
def load_accelerator_state(accelerator, input_dir: str | None = None, **kwargs):
    """Load what :func:`save_accelerator_state` saved into the prepared
    objects, in place. With ``input_dir=None`` the newest checkpoint under
    ``{project_dir}/checkpoints`` whose manifest validates is loaded;
    corrupt or partial ones (and ``.tmp`` directories) are skipped. A
    sharded checkpoint is assembled from its pieces, whichever process
    wrote them."""
    t0 = time.perf_counter()
    # an in-flight async save must land on EVERY process before ANY reads
    _join_writer_then_barrier(accelerator)
    from .resilience.manifest import find_latest_valid_checkpoint, read_manifest

    if input_dir is None:
        if accelerator.project_dir is None:
            raise ValueError("pass input_dir or set project_dir on the Accelerator")
        checkpoints_dir = os.path.join(accelerator.project_dir, "checkpoints")
        input_dir = find_latest_valid_checkpoint(checkpoints_dir)
        if input_dir is None:
            raise FileNotFoundError(f"no valid checkpoints under {checkpoints_dir}")

    manifest = read_manifest(input_dir)
    if manifest is not None and manifest.get("kind") == "sharded":
        from .resilience.distributed import restore_from_pieces

        load_piece = _piece_loader(input_dir)
        arrays = manifest.get("arrays", {})
        for i, model in enumerate(accelerator._models):
            _load_model_flat(model, restore_from_pieces(
                _model_flat(model), arrays[f"{MODEL_NAME}_{i}"], load_piece))
        for i, opt in enumerate(accelerator._optimizers):
            table = arrays.get(f"{OPTIMIZER_NAME}_{i}", {})
            flat = {key: restore_from_pieces({key: torch.empty(entry["global_shape"])},
                                             {key: entry}, load_piece)[key]
                    for key, entry in table.items()}
            owner = [e["pieces"][0]["file"] for e in table.values() if e["pieces"]]
            if not owner:  # an optimizer that never stepped: no tensors
                owner = [f"shard_00000/{OPTIMIZER_NAME}{'' if i == 0 else f'_{i}'}"]
            _restore_optimizer(opt, flat, read_metadata(os.path.join(input_dir, owner[0])))
    else:
        for i, model in enumerate(accelerator._models):
            suffix = "" if i == 0 else f"_{i}"
            _load_model_flat(model, load_array_dict(os.path.join(input_dir,
                                                                 f"{MODEL_NAME}{suffix}")))
        for i, opt in enumerate(accelerator._optimizers):
            path = os.path.join(input_dir, f"{OPTIMIZER_NAME}{'' if i == 0 else f'_{i}'}")
            _restore_optimizer(opt, load_array_dict(path), read_metadata(path))
    for i, sched in enumerate(accelerator._schedulers):
        path = os.path.join(input_dir, f"{SCHEDULER_NAME}{'' if i == 0 else f'_{i}'}.bin")
        with open(path, "rb") as f:
            sched.load_state_dict(pickle.load(f))
    for i, dl in enumerate(accelerator._dataloaders):
        path = os.path.join(input_dir, f"{SAMPLER_NAME}{'' if i == 0 else f'_{i}'}.bin")
        if os.path.exists(path):
            with open(path, "rb") as f:
                dl.load_state_dict(pickle.load(f))
    for i, obj in enumerate(accelerator._custom_objects):
        with open(os.path.join(input_dir, f"{CUSTOM_STATES_NAME}_{i}.pkl"), "rb") as f:
            obj.load_state_dict(pickle.load(f))
    scaler_file = os.path.join(input_dir, f"{SCALER_NAME}.bin")
    if getattr(accelerator, "_loss_scale", None) is not None and os.path.exists(scaler_file):
        with open(scaler_file, "rb") as f:
            accelerator._loss_scale.load_state_dict(pickle.load(f))
    state_file = os.path.join(input_dir, "accelerator_state.json")
    if os.path.exists(state_file):
        with open(state_file) as f:
            meta = json.load(f)
        accelerator.step = meta.get("step", 0)
        if "iteration" in meta:
            # resume the rotation counter past the loaded checkpoint
            accelerator.project_configuration.iteration = meta["iteration"] + 1
    base = os.path.basename(os.path.normpath(input_dir))
    if base.startswith("checkpoint_"):
        accelerator.project_configuration.iteration = int(base.rsplit("_", 1)[-1]) + 1

    rng_file = os.path.join(input_dir, f"{RNG_STATE_NAME}_{accelerator.process_index}.pkl")
    if not os.path.exists(rng_file):
        rng_file = os.path.join(input_dir, f"{RNG_STATE_NAME}_0.pkl")
    if os.path.exists(rng_file):
        with open(rng_file, "rb") as f:
            # the bundle holds numpy and torch states: not weights-only
            _restore_rng_state(pickle.load(f))
    logger.info("Loaded state from %s", input_dir)
    _record_checkpoint_telemetry("restore", input_dir, {
        "t0": t0,
        "bytes": sum(f["bytes"] for f in manifest["files"].values()) if manifest else None,
        "shard_count": (sum(1 for d in os.listdir(input_dir) if d.startswith("shard_"))
                        if manifest is not None and manifest.get("kind") == "sharded" else 0),
        "is_async": False,
    })
    return input_dir


# ---------------------------------------------------------------------------
# standalone model save
# ---------------------------------------------------------------------------


def save_model_weights(accelerator, model, save_directory: str, max_shard_size="10GB",
                       safe_serialization: bool = True):
    """The model's weights for :func:`~.big_modeling.load_checkpoint_and_dispatch`:
    one ``model.safetensors``, or shards of at most ``max_shard_size``
    (``model-00001-of-0000N.safetensors``) with a
    ``model.safetensors.index.json``. The main process writes."""
    os.makedirs(save_directory, exist_ok=True)
    if not isinstance(model, torch.nn.Module) and not hasattr(model, "module"):
        raise TypeError(f"cannot save {type(model)}")
    if not accelerator.is_main_process:
        accelerator.wait_for_everyone()
        return
    flat = host_snapshot(_model_flat(model))
    shards = _shard_flat_dict(flat, _parse_size(max_shard_size))
    if len(shards) == 1:
        save_array_dict(shards[0], os.path.join(save_directory, MODEL_NAME), safe_serialization)
    else:
        ext = ".safetensors" if safe_serialization else ".bin"
        index = {"metadata": {"total_size": sum(_nbytes(v) for v in flat.values())},
                 "weight_map": {}}
        for i, shard in enumerate(shards):
            name = f"model-{i + 1:05d}-of-{len(shards):05d}"
            save_array_dict(shard, os.path.join(save_directory, name), safe_serialization)
            for key in shard:
                index["weight_map"][key] = name + ext
        index_name = ("model.safetensors.index.json" if safe_serialization
                      else "pytorch_model.bin.index.json")
        with open(os.path.join(save_directory, index_name), "w") as f:
            json.dump(index, f, indent=2)
    accelerator.wait_for_everyone()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _parse_size(size) -> int:
    if isinstance(size, int):
        return size
    size = str(size).upper().strip()
    for unit, mul in (("GB", 2**30), ("MB", 2**20), ("KB", 2**10)):
        if size.endswith(unit):
            return int(float(size[: -len(unit)]) * mul)
    return int(size)


def _shard_flat_dict(flat: dict[str, torch.Tensor], max_bytes: int) -> list[dict]:
    shards, current, size = [], {}, 0
    for key, value in flat.items():
        if current and size + _nbytes(value) > max_bytes:
            shards.append(current)
            current, size = {}, 0
        current[key] = value
        size += _nbytes(value)
    if current:
        shards.append(current)
    return shards


def save_object(obj, path, safe_serialization=False):
    """Pickle ``obj`` to ``path`` (``Accelerator.save``)."""
    with open(path, "wb") as f:
        pickle.dump(obj, f)
