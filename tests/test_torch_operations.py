"""The port's eager collectives and process helpers at 2 and 4 gloo ranks,
held against what the JAX package's functions return for the same
per-rank operands.

The port runs for real: ``debug_launcher`` spawns the ranks (a
``FileStore`` under a fresh temporary directory, one OpenMP thread each,
a deadline), once a world size a test session, and every case below reads
that launch's results. The JAX functions are driven as
``tests/test_multihost_sim.py`` drives them, with
``jax.experimental.multihost_utils`` replaced by a fake: here one thread a
rank, exchanging each rank's payload at a barrier, so
``process_allgather`` and ``broadcast_one_to_all`` see every rank's value.
Results are compared exactly (f32 sums 1e-6 relative: the gloo sum and
numpy's may add in another order).
"""

import threading
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

# make jax.experimental.multihost_utils an attribute mock.patch can swap
from jax.experimental import multihost_utils as _real_multihost  # noqa: E402,F401
import torch_dist_workers as workers  # noqa: E402

from accelerate_tpu import operations as jops  # noqa: E402
from accelerate_tpu.state import PartialState as JPartialState  # noqa: E402
from accelerate_tpu_torch import AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch import operations as tops  # noqa: E402

WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


class _ThreadWorld:
    """``multihost_utils`` for ``n`` ranks run as threads of this process."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n
        self.local = threading.local()

    def _exchange(self, value):
        self.slots[self.local.rank] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def process_allgather(self, x, tiled=False):
        xs = [np.asarray(v) for v in self._exchange(np.asarray(x))]
        return np.concatenate(xs) if tiled else np.stack(xs)

    def broadcast_one_to_all(self, x, is_source=None):
        if is_source is None:
            is_source = self.local.rank == 0
        pairs = self._exchange((np.asarray(x), bool(is_source)))
        return next(v for v, source in pairs if source)


def _jax_ranks(n: int, fn) -> list:
    """``fn(rank)`` on ``n`` threaded ranks of the JAX package's collectives."""
    world = _ThreadWorld(n)
    results, errors = [None] * n, []

    def run(rank):
        world.local.rank = rank
        world.local.state = SimpleNamespace(num_processes=n, process_index=rank, debug=False)
        try:
            results[rank] = fn(rank)
        except BaseException as e:  # handed to the test thread
            errors.append(e)
            world.barrier.abort()

    with mock.patch("jax.experimental.multihost_utils", world), \
            mock.patch.object(jops, "_state", lambda: world.local.state):
        threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def _split(n, rank, inputs, pad):
    state = SimpleNamespace(num_processes=n, process_index=rank)
    with JPartialState.split_between_processes(state, inputs, apply_padding=pad) as part:
        return part


#: each case: the key of the port's result, and JAX's result for (inputs, world, rank)
CASES = {
    "gather": lambda i, n, r: jops.gather(i[r]["rows"]),
    "gather_nested": lambda i, n, r: jops.gather({"a": i[r]["rows"], "b": [i[r]["ints"]]}),
    "gather_object": lambda i, n, r: jops.gather_object(i[r]["objects"]),
    "broadcast": lambda i, n, r: jops.broadcast([i[r]["rows"], i[r]["ints"]], from_process=n - 1),
    "broadcast_object_list": lambda i, n, r: jops.broadcast_object_list(
        list(i[r]["objects"][:1]), from_process=0),
    "reduce_sum": lambda i, n, r: jops.reduce(i[r]["rows"], reduction="sum", scale=2.0),
    "reduce_mean": lambda i, n, r: jops.reduce(i[r]["rows"], reduction="mean", scale=0.5),
    "accelerator_reduce": lambda i, n, r: jops.reduce(i[r]["rows"], reduction="sum"),
    "pad": lambda i, n, r: jops.pad_across_processes(i[r]["ragged"], dim=0, pad_index=-1),
    "pad_first": lambda i, n, r: jops.pad_across_processes(i[r]["ragged"], dim=0, pad_index=-1,
                                                           pad_first=True),
    "pad_dim1": lambda i, n, r: jops.pad_across_processes(i[r]["ragged"].T, dim=1),
    "sizes": lambda i, n, r: jops.gather_sizes_across_processes(len(i[r]["ragged"])),
    "split_list_False": lambda i, n, r: _split(n, r, i[0]["items"], False),
    "split_list_True": lambda i, n, r: _split(n, r, i[0]["items"], True),
    "split_dict_False": lambda i, n, r: _split(n, r, {"x": i[0]["items"], "t": i[0]["table"]},
                                               False),
    "split_dict_True": lambda i, n, r: _split(n, r, {"x": i[0]["items"], "t": i[0]["table"]}, True),
}


def _assert_same(got, want, key):
    if isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _assert_same(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(got, np.ndarray):
        assert len(got) == len(want), key
        for a, b in zip(got, want):
            _assert_same(a, b, key)
    elif isinstance(want, (np.ndarray, np.generic)) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (key, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        assert got == want, key


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_collective_matches_jax(tmp_path_factory, world, case):
    port = workers.collectives_result(tmp_path_factory, world)
    inputs = workers.collective_inputs(world)
    ref = _jax_ranks(world, lambda r: CASES[case](inputs, world, r))
    for rank in range(world):
        _assert_same(port[rank][case], ref[rank], f"{case} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_process_helpers_under_a_gloo_group(tmp_path_factory, world):
    port = workers.collectives_result(tmp_path_factory, world)
    for rank, out in enumerate(port):
        assert out["backend"] == "gloo" and out["distributed_type"] == "MULTI_CPU"
        assert (out["rank"], out["world"]) == (rank, world)
        assert out["mesh"] == (("dp",), world)
        assert out["consensus_none"] is False and out["consensus_last"] is True
        assert out["main_ran_first"] is True
        assert out["on_main"] == (0 if rank == 0 else None)
        assert out["on_last"] == (rank if rank == world - 1 else None)
        assert out["on_process_1"] == (1 if rank == 1 else None)
        assert out["is_last_process"] == (rank == world - 1)


@pytest.mark.parametrize("world", WORLDS)
def test_synchronize_rng_states_hands_every_rank_the_main_process_state(tmp_path_factory, world):
    import random

    port = workers.collectives_result(tmp_path_factory, world)
    torch.manual_seed(100)
    np.random.seed(100)
    random.seed(100)
    gen = torch.Generator().manual_seed(200)
    want = [torch.rand(1).item(), float(np.random.rand()), random.random(),
            torch.rand(1, generator=gen).item()]
    assert [out["rng_after_sync"] for out in port] == [want] * world


class _PlainStream:
    """``workers.Stream`` as the JAX package reads a stream: iterable and
    sized, without ``__getitem__`` (a torch ``IterableDataset`` inherits
    one, which the JAX loader would take for a map-style dataset)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter(range(self.n))


def _jax_dispatched(world: int, even: bool) -> list:
    """The JAX dispatcher's batches for each rank: its process-0 read of the
    global batches, then its own per-rank slicing (``_place``) with the
    state it reads faked to ``world`` ranks."""
    from accelerate_tpu import data_loader as jdata

    loader = SimpleNamespace(dataset=_PlainStream(workers.DISPATCH_STREAM),
                             batch_size=workers.DISPATCH_BATCH, drop_last=False,
                             collate_fn=None, sampler=None, batch_sampler=None)
    out = []
    for rank in range(world):
        dl = jdata.prepare_data_loader(loader, num_processes=world, process_index=rank,
                                       dispatch_batches=True, even_batches=even,
                                       put_on_device=False)
        batches = list(dl._raw_batches())
        with mock.patch.object(jdata, "PartialState",
                               lambda: SimpleNamespace(num_processes=world, process_index=rank)):
            out.append([np.asarray(dl._place(b)).tolist() for b in batches])
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("even", [True, False], ids=["even", "uneven"])
def test_dispatch_batches_gives_each_rank_jax_rows(tmp_path_factory, world, even):
    port = workers.collectives_result(tmp_path_factory, world)
    ref = _jax_dispatched(world, even)
    for rank in range(world):
        assert port[rank][f"dispatch_even_{even}"] == ref[rank], rank


def test_debug_mode_names_the_mismatching_operand(monkeypatch):
    """Without a group the check is skipped; with one, a disagreement
    raises before the collective (here faked at the gather of the shapes)."""
    from accelerate_tpu_torch import PartialState

    state = PartialState(cpu=True)
    monkeypatch.setattr(state, "debug", True)
    t = torch.zeros(2, 3)
    assert tops.gather(t) is t
    monkeypatch.setattr(state, "backend", "gloo")
    monkeypatch.setattr(tops, "gather_object", lambda objs: objs + [((5, 3), "torch.float32")])
    with pytest.raises(tops.DistributedOperationException, match="process 1"):
        tops.gather(t)


def test_tree_helpers():
    nested = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": [torch.arange(4), "text"]}
    assert tops.find_batch_size(nested) == 2 and tops.find_batch_size(["x"]) is None
    assert tops.convert_to_fp32(nested)["a"].dtype == torch.float32
    assert tops.listify(nested)["b"] == [[0, 1, 2, 3], "text"]
    assert tops.slice_tensors(nested, slice(0, 1))["b"][0].tolist() == [0]
    cat = tops.concatenate([{"x": torch.ones(1, 2)}, {"x": torch.zeros(2, 2)}])
    assert cat["x"].shape == (3, 2)
    padded = tops.pad_input_tensors(torch.arange(3)[:, None], batch_size=3, num_processes=2)
    assert padded[:, 0].tolist() == [0, 1, 2, 2]
    moved = tops.send_to_device(nested, "cpu", skip_keys="b")
    assert moved["b"] is nested["b"]
