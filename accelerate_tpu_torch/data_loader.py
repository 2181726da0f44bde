"""The prepared data loader: sharded sampling, device placement and the
end-of-epoch bookkeeping (port of ``accelerate_tpu/data_loader.py``).

1. **Index math.** :class:`BatchSamplerShard` and
   :class:`IterableDatasetShard` decide which samples each process sees.
   They keep the JAX package's global-schedule construction (a round of
   ``num_processes`` batches at a time, completed by cycling the first
   round's indices), so every process's index lists equal JAX's one for
   one.
2. **The loader.** :class:`DataLoaderShard` is a ``torch.utils.data.DataLoader``
   rebuilt around the sharded batch sampler, keeping the user's
   ``collate_fn``, ``num_workers`` and ``pin_memory``. It reads one batch
   ahead to flag the last one (``end_of_dataloader``, which syncs gradient
   accumulation), records ``remainder`` for ``gather_for_metrics``, and
   moves each batch to the device (without a wait from pinned memory).
   Asked for (``prefetch_batches > 0``), a prefetch thread does host work
   only (reads and collation), never a collective.

Named deviation: each process's loop sees its local batch, as in PyTorch
and the reference, not JAX's global ``jax.Array`` (``to_global_array``).
With equal batches on every process the averaged gradient is the global
batch's, so the update equals JAX's; the per-process loss is the local
mean.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Sequence

import numpy as np
import torch
from torch.utils.data import BatchSampler, DataLoader, IterableDataset, SequentialSampler

from . import operations as ops
from .diagnostics.tracing import trace_span
from .state import GradientState, PartialState
from .utils.random import synchronize_rng_states

#: the DataLoader arguments a rebuilt loader keeps from the user's
_LOADER_KWARGS = ("collate_fn", "num_workers", "pin_memory", "timeout", "worker_init_fn",
                  "multiprocessing_context", "generator", "prefetch_factor",
                  "persistent_workers", "pin_memory_device", "in_order")

# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


class SeedableRandomSampler:
    """The same permutation on every process for a given (seed, epoch),
    ``np.random.default_rng(seed + epoch)``'s, so it equals the JAX
    package's; ``set_epoch`` moves to the next."""

    def __init__(self, data_source_length: int, seed: int = 0, epoch: int = 0):
        self.length = data_source_length
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.length

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(self.length).tolist()


class BatchSamplerShard:
    """This process's share of a batch sampler's schedule.

    * ``split_batches=False``: batches go round-robin; every process yields
      the same count of full batches. With ``even_batches`` the last round
      is completed by cycling the indices of the first ``num_processes``
      batches; with ``drop_last`` an incomplete last round is dropped; with
      neither, the trailing batches go as they are to their owners.
    * ``split_batches=True``: every batch is cut into ``num_processes``
      contiguous slices and this process takes slice ``process_index``.
    """

    def __init__(self, batch_sampler, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        if split_batches and self.batch_size is not None and self.batch_size % num_processes != 0:
            raise ValueError(
                f"split_batches=True requires batch size ({self.batch_size}) divisible "
                f"by num_processes ({num_processes})."
            )
        if self.batch_size is None and even_batches:
            raise ValueError(
                "even_batches=True needs a batch sampler with a fixed batch_size; "
                "pass even_batches=False for size-less samplers."
            )
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def sampler(self):
        return getattr(self.batch_sampler, "sampler", None)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if n % self.num_processes == 0 or self.drop_last:
            return n // self.num_processes
        if self.even_batches:
            return n // self.num_processes + 1
        return n // self.num_processes + int(self.process_index < n % self.num_processes)

    def __iter__(self):
        yield from self._iter_split() if self.split_batches else self._iter_round_robin()

    def _iter_split(self):
        shard = self.batch_size // self.num_processes
        lo, hi = shard * self.process_index, shard * (self.process_index + 1)
        first = last = None
        for batch in self.batch_sampler:
            if first is None:
                first = list(batch)
            if len(batch) == self.batch_size:
                yield batch[lo:hi]
            last = batch  # only the final batch can be short
        if self.drop_last or first is None or len(last) == self.batch_size:
            return
        if not self.even_batches:
            if len(last) > lo:
                yield last[lo:hi]
            return
        filler = itertools.islice(itertools.cycle(first), self.batch_size - len(last))
        yield (list(last) + list(filler))[lo:hi]

    def _iter_round_robin(self):
        """Stream the global schedule one round (``num_processes`` batches)
        at a time; this process owns position ``process_index`` of each."""
        P, B = self.num_processes, self.batch_size
        STOP = object()
        first_rounds: list[list[int]] = []  # the first P batches: the cycle source
        round_buf: list[list[int]] = []
        it = iter(self.batch_sampler)
        pending = next(it, STOP)
        while pending is not STOP:
            batch = list(pending)
            pending = next(it, STOP)
            if len(first_rounds) < P:
                first_rounds.append(batch)
            round_buf.append(batch)
            if len(round_buf) == P and pending is not STOP:
                yield round_buf[self.process_index]
                round_buf = []
        if not round_buf:
            return
        if self.drop_last:
            if len(round_buf) == P:
                yield round_buf[self.process_index]
            return
        if not self.even_batches:
            if self.process_index < len(round_buf):
                yield round_buf[self.process_index]
            return
        source = itertools.cycle([i for b in first_rounds for i in b])
        last = round_buf[-1]
        if len(last) < B:
            round_buf[-1] = last + list(itertools.islice(source, B - len(last)))
        while len(round_buf) < P:
            round_buf.append(list(itertools.islice(source, B)))
        yield round_buf[self.process_index]


class IterableDatasetShard(IterableDataset):
    """A length-less stream sharded per process: buffer one global batch,
    yield this process's slice, and complete a short tail by cycling the
    first buffered batch unless ``drop_last``."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False):
        if split_batches and batch_size > 1 and batch_size % num_processes != 0:
            raise ValueError(
                f"split_batches=True requires batch size ({batch_size}) divisible "
                f"by num_processes ({num_processes})."
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        n = len(self.dataset)  # raises for a truly length-less stream
        real_bs = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        rounds = n // real_bs if self.drop_last else math.ceil(n / real_bs)
        return rounds * (real_bs // self.num_processes)

    def __iter__(self):
        real_bs = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        shard = real_bs // self.num_processes
        lo, hi = shard * self.process_index, shard * (self.process_index + 1)
        first = None
        buf: list = []
        for element in self.dataset:
            buf.append(element)
            if len(buf) == real_bs:
                yield from buf[lo:hi]
                if first is None:
                    first = list(buf)
                buf = []
        if buf and not self.drop_last:
            if first is None:
                first = list(buf)
            buf = buf + list(itertools.islice(itertools.cycle(first), real_bs - len(buf)))
            yield from buf[lo:hi]


class SkipBatchSampler:
    """A batch sampler without its first ``skip_batches`` batches."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def sampler(self):
        return getattr(self.batch_sampler, "sampler", None)

    def __iter__(self):
        yield from itertools.islice(iter(self.batch_sampler), self.skip_batches, None)

    @property
    def total_length(self):
        return len(self.batch_sampler)

    def __len__(self):
        return len(self.batch_sampler) - self.skip_batches


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


class DataLoaderStateMixin:
    """Pushes begin/end and the remainder into :class:`GradientState`, so
    ``gather_for_metrics`` drops the repeated tail and ``accumulate`` syncs
    on the last batch."""

    def begin(self):
        self.end_of_dataloader = False
        self.remainder = -1
        if not self._drop_last:
            try:
                self.remainder = self.total_dataset_length % self.total_batch_size
            except (TypeError, ValueError):
                pass  # a length-less stream or a size-less sampler
        self.gradient_state._add_dataloader(self)

    def end(self):
        self.gradient_state._remove_dataloader(self)


class DataLoaderShard(DataLoaderStateMixin, DataLoader):
    """A ``DataLoader`` over this process's shard that places each batch on
    ``device`` and flags the last one a batch ahead. ``state_dict`` /
    ``load_state_dict`` resume mid-epoch at the recorded position."""

    def __init__(self, dataset, batch_sampler=None, device=None, rng_types: Sequence[str] | None = None,
                 synchronized_generator=None, skip_batches: int = 0,
                 total_batch_size: int | None = None, _drop_last: bool = False,
                 _non_blocking: bool = False, prefetch_batches: int = 0, **loader_kwargs):
        self._iterable = isinstance(dataset, IterableDataset)
        if not self._iterable and batch_sampler is None:
            raise ValueError("a map-style dataset needs a batch sampler")
        super().__init__(dataset, batch_sampler=batch_sampler, **loader_kwargs)
        self.device = device
        self.rng_types = list(rng_types) if rng_types else []
        self.synchronized_generator = synchronized_generator
        self.skip_batches = skip_batches
        self._drop_last = _drop_last
        self._non_blocking = _non_blocking
        self._total_batch_size = total_batch_size
        self.prefetch_batches = prefetch_batches
        self.gradient_state = GradientState()
        self.end_of_dataloader = False
        self.remainder = -1
        self.iteration = 0
        self.batches_yielded = 0  # within the current epoch (stateful resume)
        self._resume_skip = 0     # applied once by the next __iter__

    @property
    def total_batch_size(self) -> int:
        """Samples in one global step: the batch times the process count,
        or the batch itself under ``split_batches``."""
        if self._total_batch_size is not None:
            return self._total_batch_size
        bs = getattr(self.batch_sampler, "batch_size", None)
        if bs is None:
            raise ValueError("total_batch_size unknown for size-less samplers")
        if isinstance(self.batch_sampler, BatchSamplerShard) and not self.batch_sampler.split_batches:
            return bs * self.batch_sampler.num_processes
        return bs

    @property
    def total_dataset_length(self) -> int:
        """Samples in the whole dataset (under an iterable shard, its stream's)."""
        if isinstance(self.dataset, IterableDatasetShard):
            return len(self.dataset.dataset)
        return len(self.dataset)

    def set_epoch(self, epoch: int):
        """The epoch for the sampler under the shard (and the dataset)."""
        self.iteration = epoch
        node = self.batch_sampler
        while node is not None:
            sampler = getattr(node, "sampler", None)
            if sampler is not None and hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
                break
            node = getattr(node, "batch_sampler", None)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self):
        if self._iterable:
            per_proc = len(self.dataset) // self.batch_size
            return max(per_proc - self.skip_batches, 0)
        return max(len(self.batch_sampler) - self.skip_batches, 0)

    # -- iteration -----------------------------------------------------------

    def _batches(self) -> Iterator[Any]:
        """Collated host batches of this process (the DataLoader's own
        iterator: its workers, collation and pinning)."""
        return super().__iter__()

    def _place(self, batch):
        """The batch on :attr:`device`; without a wait for the device when
        asked (``non_blocking``) or when the loader pins its batches (the
        pinned buffers come from PyTorch's caching host allocator, which
        keeps them until the copy is done)."""
        if self.device is None:
            return batch
        return ops.send_to_device(batch, self.device,
                                  non_blocking=self._non_blocking or self.pin_memory)

    @property
    def _prefetch_safe(self) -> bool:
        """A prefetch thread must not run collectives; the dispatcher's
        batches do, so it turns the thread off while a group is up."""
        return True

    def _prefetched(self, it: Iterator[Any]) -> Iterator[tuple[Any, bool]]:
        """Reads and collation on a host thread, ``prefetch_batches`` ahead;
        the device copy stays on the consumer's thread. Yields ``(batch,
        is_last)``: the producer's one-batch look-ahead decides ``is_last``."""
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch_batches))
        stop = threading.Event()
        SENTINEL = object()

        def _produce():
            try:
                current = next(it, SENTINEL)
                while current is not SENTINEL and not stop.is_set():
                    nxt = next(it, SENTINEL)
                    q.put((current, nxt is SENTINEL))
                    current = nxt
                q.put((SENTINEL, None))
            except BaseException as e:  # handed to the consumer, which raises it
                q.put((e, "error"))

        worker = threading.Thread(target=_produce, daemon=True, name="dataloader-prefetch")
        worker.start()
        try:
            while True:
                item, flag = q.get()
                if flag == "error":
                    raise item
                if item is SENTINEL:
                    return
                yield self._place(item), flag
        finally:
            stop.set()
            while worker.is_alive():  # drain so a blocked put() sees the stop flag
                try:
                    q.get_nowait()
                except queue.Empty:
                    worker.join(timeout=0.1)

    def _synchronous(self, it: Iterator[Any]) -> Iterator[tuple[Any, bool]]:
        SENTINEL = object()
        current = next(it, SENTINEL)
        while current is not SENTINEL:
            nxt = next(it, SENTINEL)
            yield self._place(current), nxt is SENTINEL
            current = nxt

    def __iter__(self):
        if self.rng_types:
            synchronize_rng_states(self.rng_types, self.synchronized_generator)
        self.begin()
        it = self._batches()
        skip = self.skip_batches + self._resume_skip
        self._resume_skip = 0
        # the position starts at the applied skip, so a state_dict taken
        # after a resume records the epoch's true position
        self.batches_yielded = skip
        if skip:
            it = itertools.islice(it, skip, None)
        use_thread = self.prefetch_batches > 0 and self._prefetch_safe
        stream = self._prefetched(it) if use_thread else self._synchronous(it)
        DONE = object()
        try:
            while True:
                # how long the training loop waits for data
                with trace_span("dataloader/fetch", prefetch=use_thread):
                    item = next(stream, DONE)
                if item is DONE:
                    break
                batch, is_last = item
                if is_last:
                    self.end_of_dataloader = True
                    if self.gradient_state.sync_with_dataloader:
                        self.gradient_state._set_sync_gradients(True)
                self.batches_yielded += 1
                yield batch
        finally:
            # the epoch advances only on full consumption, so a state_dict
            # after a break resumes this epoch at batches_yielded
            if self.end_of_dataloader:
                self.iteration += 1
                self.batches_yielded = 0
            self.end()

    # -- stateful resume -----------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.iteration

    @property
    def position(self) -> int:
        """The batch position within the epoch; between ``load_state_dict``
        and the next ``__iter__``, the position the next pass resumes from."""
        if self._resume_skip:
            return self.skip_batches + self._resume_skip
        return self.batches_yielded

    def state_dict(self) -> dict:
        return {"iteration": self.iteration, "batches_yielded": self.batches_yielded,
                "position": self.batches_yielded, "skip_batches": self.skip_batches}

    def load_state_dict(self, state: dict):
        self.iteration = state.get("iteration", 0)
        self.set_epoch(self.iteration)
        position = state.get("batches_yielded", state.get("position", 0))
        self._resume_skip = max(0, position - self.skip_batches)


@dataclass(frozen=True)
class _TensorMeta:
    shape: tuple
    dtype: torch.dtype


class DataLoaderDispatcher(DataLoaderShard):
    """Process 0 alone reads global batches and broadcasts them; every
    process then takes its slice. For streams that exist on one process
    only: the others never touch the dataset.

    The batch's structure (its nesting, each tensor's shape and dtype, any
    non-tensor leaves) travels as one object broadcast when it changes;
    the tensors as tensor broadcasts, on the card under NCCL."""

    def __init__(self, *args, even_batches: bool = True, slice_fn=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.even_batches = even_batches
        self.slice_fn = slice_fn

    @property
    def _prefetch_safe(self) -> bool:
        return PartialState().backend is None

    def _batches(self) -> Iterator[Any]:
        state = PartialState()
        if state.backend is None:
            yield from super()._batches()
            return
        comm = state.device
        END, SAME, NEW = 0, 1, 2

        def control(value: int) -> int:
            t = torch.tensor([value], dtype=torch.int64, device=comm)
            return int(ops.broadcast(t).item())

        skeleton = None
        if state.is_main_process:
            for batch in super()._batches():
                tensors: list[torch.Tensor] = []
                shape = ops.recursively_apply(
                    lambda t: tensors.append(t) or _TensorMeta(tuple(t.shape), t.dtype), batch)
                changed = shape != skeleton
                control(NEW if changed else SAME)
                if changed:
                    skeleton = shape
                    ops.broadcast_object_list([skeleton])
                sent = [ops.broadcast(t.to(comm).contiguous()) for t in tensors]
                yield ops.recursively_apply(lambda _: sent.pop(0), skeleton,
                                            test_type=lambda x: isinstance(x, _TensorMeta))
            control(END)
            return
        while True:
            code = control(END)
            if code == END:
                return
            if code == NEW:
                skeleton = ops.broadcast_object_list([None])[0]
            yield ops.recursively_apply(
                lambda m: ops.broadcast(torch.empty(m.shape, dtype=m.dtype, device=comm)),
                skeleton, test_type=lambda x: isinstance(x, _TensorMeta))

    def _place(self, batch):
        """This process's rows of the global batch: an uneven tail wraps to
        the batch's start under ``even_batches``, else splits unevenly."""
        state = PartialState()
        n, i = state.num_processes, state.process_index
        if self.slice_fn is not None and n > 1:
            return super()._place(self.slice_fn(batch, n, i))

        def rows(x):
            return isinstance(x, torch.Tensor) and x.ndim >= 1

        if n > 1 and not self.even_batches and any(
                rows(x) and x.shape[0] % n for x in ops._leaves(batch)):
            return super()._place(ops.recursively_apply(
                lambda x: torch.tensor_split(x, n)[i] if x.ndim >= 1 else x, batch))

        def pad(x):
            if rows(x) and x.shape[0] % n:
                missing = n - x.shape[0] % n
                reps = math.ceil(missing / max(x.shape[0], 1))
                return torch.cat([x] + [torch.cat([x] * reps)[:missing]])
            return x

        def take(x):
            if rows(x) and x.shape[0] % n == 0:
                share = x.shape[0] // n
                return x[i * share:(i + 1) * share]
            return x

        if self.even_batches:
            batch = ops.recursively_apply(pad, batch)
        if n > 1:
            batch = ops.recursively_apply(take, batch)
        return super()._place(batch)


# ---------------------------------------------------------------------------
# prepare / skip
# ---------------------------------------------------------------------------


def _is_stock_sampler(sampler) -> bool:
    """The samplers a rebuild may replace (sequential, whole-dataset random);
    a custom order (subset, weighted, a user's class) is kept."""
    return type(sampler).__name__ in ("SequentialSampler", "RandomSampler", "SeedableRandomSampler")


def _is_stock_batch_sampler(batch_sampler) -> bool:
    return type(batch_sampler).__name__ == "BatchSampler" and _is_stock_sampler(
        getattr(batch_sampler, "sampler", None))


def _loader_kwargs(dataloader) -> dict:
    return {k: getattr(dataloader, k) for k in _LOADER_KWARGS if hasattr(dataloader, k)}


def prepare_data_loader(dataloader: DataLoader, device=None, num_processes: int | None = None,
                        process_index: int | None = None, split_batches: bool = False,
                        put_on_device: bool = True, rng_types: Sequence[str] | None = None,
                        dispatch_batches: bool | None = None, even_batches: bool = True,
                        slice_fn_for_dispatch=None, use_seedable_sampler: bool = False,
                        data_seed: int = 0, non_blocking: bool = False,
                        prefetch_batches: int = 0) -> DataLoaderShard:
    """A ``torch.utils.data.DataLoader`` rebuilt over this process's shard
    (the JAX package's decision tree): a shuffling sampler becomes a
    :class:`SeedableRandomSampler` (the same permutation on every process),
    a custom sampler or batch sampler is kept, and the batch sampler is
    wrapped in :class:`BatchSamplerShard`. ``dispatch_batches`` reads
    global batches on process 0 alone (:class:`DataLoaderDispatcher`).
    Every prepared loader is stateful (``state_dict`` /
    ``load_state_dict``), so ``use_stateful_dataloader`` is not asked."""
    state = PartialState()
    # a sharded mesh splits the batch over dp × fsdp and hands the cp and tp
    # ranks the same rows (JAX's batch_axes=("dp", "fsdp")); the prepared
    # model cuts a family's sequences over cp (PreparedModel._sequence_chunks)
    sharded = getattr(state, "sharded", False)
    if num_processes is None:
        num_processes = state.data_parallel_size if sharded else state.num_processes
    if process_index is None:
        process_index = state.data_parallel_rank if sharded else state.process_index
    if device is None and put_on_device:
        device = state.device
    if not put_on_device:
        device = None
    dataset = dataloader.dataset
    batch_size = dataloader.batch_size
    drop_last = bool(dataloader.drop_last)
    sampler = getattr(dataloader, "sampler", None)
    batch_sampler = getattr(dataloader, "batch_sampler", None)
    kwargs = _loader_kwargs(dataloader)
    common = dict(device=device, rng_types=rng_types, _drop_last=drop_last,
                  _non_blocking=non_blocking, prefetch_batches=prefetch_batches, **kwargs)
    is_iterable = isinstance(dataset, IterableDataset)

    if dispatch_batches:
        global_bs = (batch_size or 1) * (1 if split_batches else num_processes)
        dispatch = dict(total_batch_size=global_bs, even_batches=even_batches,
                        slice_fn=slice_fn_for_dispatch, **common)
        if is_iterable:
            shard = IterableDatasetShard(dataset, batch_size=global_bs, drop_last=drop_last)
            return DataLoaderDispatcher(shard, batch_size=global_bs, drop_last=drop_last,
                                        **dispatch)
        inner = (SeedableRandomSampler(len(dataset), seed=data_seed) if use_seedable_sampler
                 else SequentialSampler(range(len(dataset))))
        return DataLoaderDispatcher(dataset, batch_sampler=BatchSampler(inner, global_bs, drop_last),
                                    **dispatch)

    if is_iterable:
        shard = IterableDatasetShard(dataset, batch_size=batch_size or 1, drop_last=drop_last,
                                     num_processes=num_processes, process_index=process_index,
                                     split_batches=split_batches)
        shard_bs = (batch_size or 1) // num_processes if split_batches else (batch_size or 1)
        return DataLoaderShard(
            shard, batch_size=shard_bs, drop_last=drop_last,
            total_batch_size=(batch_size or 1) * (1 if split_batches else num_processes), **common)

    if batch_sampler is not None and batch_size is None:  # a user's batch sampler
        batch_size = getattr(batch_sampler, "batch_size", None)
        drop_last = getattr(batch_sampler, "drop_last", drop_last)
        common["_drop_last"] = drop_last
    if batch_sampler is not None and not _is_stock_batch_sampler(batch_sampler):
        inner_batch_sampler = batch_sampler
    else:
        if sampler is not None and not _is_stock_sampler(sampler):
            inner_sampler = sampler
        elif use_seedable_sampler or type(sampler).__name__ == "RandomSampler":
            inner_sampler = SeedableRandomSampler(len(dataset), seed=data_seed)
        else:
            inner_sampler = SequentialSampler(range(len(dataset)))
        inner_batch_sampler = BatchSampler(inner_sampler, batch_size or 1, drop_last)
    shard = BatchSamplerShard(inner_batch_sampler, num_processes=num_processes,
                              process_index=process_index, split_batches=split_batches,
                              even_batches=even_batches)
    return DataLoaderShard(dataset, batch_sampler=shard, **common)


class SkipDataLoader(DataLoaderShard):
    """A prepared loader that starts ``skip_batches`` into the epoch."""


def skip_first_batches(dataloader, num_batches: int = 0):
    """A new loader over the same shard that starts ``num_batches`` in (the
    resume-mid-epoch idiom); a plain DataLoader is prepared first."""
    if not isinstance(dataloader, DataLoaderShard):
        dataloader = prepare_data_loader(dataloader)
    try:
        total_bs = dataloader.total_batch_size
    except ValueError:
        total_bs = dataloader._total_batch_size
    common = dict(device=dataloader.device, rng_types=dataloader.rng_types,
                  synchronized_generator=dataloader.synchronized_generator,
                  total_batch_size=total_bs, _drop_last=dataloader._drop_last,
                  _non_blocking=dataloader._non_blocking,
                  prefetch_batches=dataloader.prefetch_batches, **_loader_kwargs(dataloader))
    if dataloader._iterable:
        common.update(skip_batches=num_batches, batch_size=dataloader.batch_size,
                      drop_last=dataloader.drop_last)
    else:
        common["batch_sampler"] = SkipBatchSampler(dataloader.batch_sampler, num_batches)
    if isinstance(dataloader, DataLoaderDispatcher):
        return DataLoaderDispatcher(dataloader.dataset, even_batches=dataloader.even_batches,
                                    slice_fn=dataloader.slice_fn, **common)
    return SkipDataLoader(dataloader.dataset, **common)
