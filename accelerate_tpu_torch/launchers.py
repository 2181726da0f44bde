"""``notebook_launcher`` and ``debug_launcher`` (port of
``accelerate_tpu/launchers.py``).

The JAX package drives every local chip from one process, so it has no
fork. Here each process drives one device: ``debug_launcher`` spawns one
CPU process a rank under the launch environment the state reads
(``ACCELERATE_COORDINATOR_ADDR``, ``ACCELERATE_NUM_PROCESSES``,
``ACCELERATE_PROCESS_ID``), joins them within a deadline, and returns what
each rank's function returned. ``notebook_launcher`` runs one process on
one card, inline, as the JAX package's runs inline.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import tempfile
import time

from .utils.environment import patch_environment

#: how long a launcher waits for its ranks by default
LAUNCH_TIMEOUT_S = 300.0


def _run_rank(function, args, result_path: str):
    import torch.distributed as dist

    result = function(*args)
    with open(result_path, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        # every rank is done before any takes the group down
        dist.barrier()
        dist.destroy_process_group()
    # the result is on disk: skip the interpreter's teardown, where a
    # gloo rank now and then aborts in a C++ destructor ("terminate called
    # without an active exception"), which would fail a finished launch
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def debug_launcher(function, args=(), num_processes: int = 2,
                   timeout: float = LAUNCH_TIMEOUT_S) -> list:
    """Run ``function(*args)`` in ``num_processes`` CPU processes joined in a
    gloo group: the multi-process paths without a card. The ranks meet
    through a ``FileStore`` in a fresh temporary directory (no port, so
    concurrent launches cannot collide) and run with ``ACCELERATE_USE_CPU``
    and one OpenMP thread each. ``function`` must be importable by name
    (defined at a module's top level). Returns each rank's result in rank
    order. A rank still running at the deadline is killed with the others
    and raises ``TimeoutError``; a non-zero exit raises ``RuntimeError``."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="accelerate_debug_") as workdir:
        store = "file://" + os.path.join(workdir, "store")
        procs, paths = [], []
        try:
            for rank in range(num_processes):
                path = os.path.join(workdir, f"result_{rank}.pkl")
                env = dict(ACCELERATE_USE_CPU=1, OMP_NUM_THREADS=1,
                           ACCELERATE_COORDINATOR_ADDR=store,
                           ACCELERATE_NUM_PROCESSES=num_processes, ACCELERATE_PROCESS_ID=rank)
                with patch_environment(**env):  # a spawned child copies os.environ
                    p = ctx.Process(target=_run_rank, args=(function, args, path),
                                    name=f"rank_{rank}")
                    p.start()
                procs.append(p)
                paths.append(path)
            deadline = time.monotonic() + timeout
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            late = [p.name for p in procs if p.is_alive()]
            if late:
                raise TimeoutError(f"{', '.join(late)} still running after {timeout:.0f} s")
            failed = {p.name: p.exitcode for p in procs if p.exitcode != 0}
            if failed:
                raise RuntimeError(f"launched function failed: exit codes {failed}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results = []
        for path in paths:
            with open(path, "rb") as f:  # written by this launcher's own ranks
                results.append(pickle.load(f))
        return results


def notebook_launcher(function, args=(), num_processes: int | None = None,
                      mixed_precision: str = "no", use_port: str = "29500",
                      master_addr: str = "127.0.0.1", node_rank: int = 0, num_nodes: int = 1):
    """Run a training function from a notebook: one process on one card,
    inline. ``num_processes`` may not exceed the cards present; more than
    one process a card, and multi-node launches, are the ``launch`` CLI's
    (ROADMAP item 23). Must run before any ``Accelerator`` exists in this
    process."""
    import torch

    from .state import AcceleratorState, PartialState

    if AcceleratorState._shared_state or PartialState._shared_state:
        in_use = AcceleratorState if AcceleratorState._shared_state else PartialState
        raise ValueError(
            f"A {in_use.__name__} was already initialized in this process; "
            "notebook_launcher must run before any Accelerator is created "
            "(restart the kernel)."
        )
    cards = torch.cuda.device_count()
    if num_processes is not None and num_processes > cards:
        raise ValueError(f"num_processes={num_processes} but only {cards} CUDA device(s) exist")
    if num_nodes != 1 or node_rank != 0 or (num_processes or 1) > 1:
        raise ValueError("notebook_launcher runs one process; several (or several nodes) "
                         "are not yet ported (the launch CLI, ROADMAP item 23)")
    if mixed_precision not in ("no", "bf16"):
        raise ValueError(f"mixed_precision={mixed_precision!r} is not yet ported "
                         "(the port runs 'no' and 'bf16')")
    with patch_environment(ACCELERATE_MIXED_PRECISION=mixed_precision):
        return function(*args)
