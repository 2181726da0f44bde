"""The port's prepared data loader held against the JAX package's, index
for index: ``BatchSamplerShard`` and ``IterableDatasetShard`` over a grid
of lengths × batch sizes × 1-4 processes × ``split_batches`` ×
``even_batches`` × ``drop_last``; ``SeedableRandomSampler``'s permutation
each epoch; and the loader built from a ``torch.utils.data.DataLoader``:
its batches for every process, ``end_of_dataloader`` and ``remainder`` at
each step, ``skip_first_batches`` and a ``state_dict`` resume mid-epoch.
Every comparison is exact. One process runs here: the loaders are built for
each process index in turn (the multi-process loop is
``tests/test_torch_distributed.py``).
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from torch.utils.data import BatchSampler, DataLoader, Dataset, IterableDataset  # noqa: E402

from accelerate_tpu import data_loader as jdata  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu.state import PartialState as JPartialState  # noqa: E402
from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch import data_loader as tdata  # noqa: E402

LENGTHS = (2, 7, 21, 24)
BATCH_SIZES = (1, 3, 4)
PROCESSES = (1, 2, 3, 4)


@pytest.fixture(autouse=True)
def _reset_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    JGradState._reset_state()


def _shards(module, batch_sampler, n, **kw):
    out = []
    for i in range(n):
        try:
            shard = module.BatchSamplerShard(batch_sampler, n, i, **kw)
            out.append((len(shard), [list(b) for b in shard]))
        except ValueError as e:
            out.append(("raises", str(e)))
    return out


@pytest.mark.parametrize("drop_last", [False, True], ids=["keep", "drop_last"])
@pytest.mark.parametrize("even", [True, False], ids=["even", "uneven"])
@pytest.mark.parametrize("split", [False, True], ids=["round_robin", "split"])
@pytest.mark.parametrize("n", PROCESSES)
@pytest.mark.parametrize("bs", BATCH_SIZES)
@pytest.mark.parametrize("length", LENGTHS)
def test_batch_sampler_shard_index_lists_equal_jax(length, bs, n, split, even, drop_last):
    kw = dict(split_batches=split, even_batches=even)
    got = _shards(tdata, BatchSampler(range(length), bs, drop_last), n, **kw)
    want = _shards(jdata, jdata.BatchSampler(range(length), bs, drop_last), n, **kw)
    assert got == want
    if split and not drop_last and even and bs % n == 0:  # every index is served
        assert set(itertools.chain(*(b for _, lists in got for b in lists))) == set(range(length))


class _Stream:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(range(self.n))


@pytest.mark.parametrize("drop_last", [False, True], ids=["keep", "drop_last"])
@pytest.mark.parametrize("split", [False, True], ids=["round_robin", "split"])
@pytest.mark.parametrize("n", PROCESSES)
@pytest.mark.parametrize("bs", BATCH_SIZES)
@pytest.mark.parametrize("length", (2, 7, 21))
def test_iterable_dataset_shard_streams_equal_jax(length, bs, n, split, drop_last):
    def shards(module):
        out = []
        for i in range(n):
            try:
                shard = module.IterableDatasetShard(_Stream(length), batch_size=bs,
                                                    drop_last=drop_last, num_processes=n,
                                                    process_index=i, split_batches=split)
                out.append((len(shard), list(shard)))
            except ValueError as e:
                out.append(("raises", str(e)))
        return out

    assert shards(tdata) == shards(jdata)


@pytest.mark.parametrize("seed", [0, 5])
def test_seedable_sampler_permutations_per_epoch_equal_jax(seed):
    port, ref = tdata.SeedableRandomSampler(23, seed=seed), jdata.SeedableRandomSampler(23, seed=seed)
    seen = []
    for epoch in range(3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert list(port) == list(ref)
        seen.append(list(port))
    assert seen[0] != seen[1] and sorted(seen[2]) == list(range(23))


class _Rows(Dataset):
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": torch.tensor([i, 10 * i])}


def _port_loader(n_rows, bs, n, i, **kw):
    shuffle = kw.pop("shuffle", False)
    return tdata.prepare_data_loader(DataLoader(_Rows(n_rows), batch_size=bs, shuffle=shuffle),
                                     num_processes=n, process_index=i, **kw)


def _jax_loader(n_rows, bs, n, i, **kw):
    shuffle = kw.pop("shuffle", False)
    JPartialState()
    return jdata.prepare_data_loader(DataLoader(_Rows(n_rows), batch_size=bs, shuffle=shuffle),
                                     num_processes=n, process_index=i, put_on_device=False,
                                     **kw)


def _walk(loader, state):
    """Each batch's rows with (end_of_dataloader, remainder) as the loop sees them."""
    out = []
    for batch in loader:
        out.append((np.asarray(batch["x"]).tolist(), state.end_of_dataloader, state.remainder))
    assert not state.in_dataloader  # the loader removed itself at the end
    return out


@pytest.mark.parametrize("shuffle", [False, True], ids=["sequential", "shuffled"])
@pytest.mark.parametrize("n,bs,rows", [(1, 4, 10), (2, 4, 37), (3, 2, 11), (4, 3, 12)])
def test_prepared_loader_batches_and_end_flags_equal_jax(n, bs, rows, shuffle):
    Accelerator(cpu=True)
    for i in range(n):
        got = _walk(_port_loader(rows, bs, n, i, shuffle=shuffle), GradientState())
        want = _walk(_jax_loader(rows, bs, n, i, shuffle=shuffle), JGradState())
        assert got == want
        assert [end for _, end, _ in got] == [False] * (len(got) - 1) + [True]
        assert got[-1][2] == rows % (bs * n)


def test_prefetch_thread_and_synchronous_loops_give_the_same_batches():
    Accelerator(cpu=True)
    threaded = _walk(_port_loader(37, 4, 2, 1, prefetch_batches=2), GradientState())
    plain = _walk(_port_loader(37, 4, 2, 1, prefetch_batches=0), GradientState())
    assert threaded == plain and len(threaded) == 5


def test_iterable_loader_equals_jax():
    class Stream(IterableDataset):
        def __len__(self):
            return 13

        def __iter__(self):
            return iter(torch.arange(13))

    Accelerator(cpu=True)
    for i in range(2):
        port = tdata.prepare_data_loader(DataLoader(Stream(), batch_size=3), num_processes=2,
                                         process_index=i)
        ref = jdata.prepare_data_loader(SimpleNamespace(
            dataset=_Stream(13), batch_size=3, drop_last=False, collate_fn=None, sampler=None,
            batch_sampler=None), num_processes=2, process_index=i, put_on_device=False)
        got = [(b.tolist(), GradientState().end_of_dataloader, GradientState().remainder)
               for b in port]
        want = [(np.asarray(b).tolist(), JGradState().end_of_dataloader, JGradState().remainder)
                for b in ref]
        assert got == want and len(port) == len(ref)


@pytest.mark.parametrize("skip", [0, 2, 5])
def test_skip_first_batches_equals_jax(skip):
    acc = Accelerator(cpu=True)
    port = acc.skip_first_batches(_port_loader(37, 4, 2, 1), skip)
    ref = jdata.skip_first_batches(_jax_loader(37, 4, 2, 1), skip)
    got = [b["x"].tolist() for b in port]
    assert got == [np.asarray(b["x"]).tolist() for b in ref]
    assert len(got) == len(port) == max(5 - skip, 0)


def test_state_dict_resumes_mid_epoch_as_jax_does():
    Accelerator(cpu=True)
    rows = {}
    for name, make in (("port", _port_loader), ("jax", _jax_loader)):
        full = [np.asarray(b["x"]).tolist() for b in make(37, 4, 2, 0, shuffle=True)]
        first = make(37, 4, 2, 0, shuffle=True)
        head = []
        for b in first:
            head.append(np.asarray(b["x"]).tolist())
            if len(head) == 2:
                break
        state = first.state_dict()
        resumed = make(37, 4, 2, 0, shuffle=True)
        resumed.load_state_dict(state)
        assert resumed.position == 2
        tail = [np.asarray(b["x"]).tolist() for b in resumed]
        assert head + tail == full
        rows[name] = (state, full)
    assert rows["port"] == rows["jax"]


def test_prepare_routes_a_dataloader_and_keeps_order():
    acc = Accelerator(cpu=True)
    model = torch.nn.Linear(2, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    dl = DataLoader(_Rows(6), batch_size=2)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    p_model, p_opt, p_dl, p_sched = acc.prepare(model, opt, dl, sched)
    assert isinstance(p_dl, tdata.DataLoaderShard) and p_dl.collate_fn is dl.collate_fn
    assert p_sched.optimizers == [p_opt] and p_model.module is model
    assert acc.prepare(p_dl) is p_dl
    # the sync at the epoch's end: 3 batches under 2-step accumulation
    acc.gradient_state.plugin_kwargs["num_steps"] = 2
    syncs = []
    for _ in p_dl:
        with acc.accumulate(p_model):
            syncs.append(acc.sync_gradients)
    assert syncs == [False, True, True]
