"""The port's ``find_executable_batch_size`` held against the JAX package's:
the same function, running out of memory above a size, tries the same
sizes and settles on the same one — the port's out-of-memory is a raised
``torch.OutOfMemoryError`` (or the CUDA allocator's and cuBLAS's messages),
JAX's a ``RESOURCE_EXHAUSTED``. The failed try's exception, and with it
the tensors its frames hold, is gone before the next size runs."""

import gc
import weakref

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from accelerate_tpu.utils import memory as jmemory  # noqa: E402
from accelerate_tpu_torch.utils import memory as tmemory  # noqa: E402


def _oom_port():
    return torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def _oom_jax():
    return RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate")


@pytest.mark.parametrize("fits", [128, 37, 16, 1])
@pytest.mark.parametrize("start", [128, 100])
def test_tries_the_same_sizes_as_jax(fits, start):
    tried = {"port": [], "jax": []}
    for name, module, oom in (("port", tmemory, _oom_port), ("jax", jmemory, _oom_jax)):
        @module.find_executable_batch_size(starting_batch_size=start)
        def train(batch_size, scale=1):
            tried[name].append(batch_size)
            if batch_size > fits:
                raise oom()
            return batch_size * scale

        tried[name + "_result"] = train(scale=2)
    assert tried["port"] == tried["jax"]
    assert tried["port_result"] == tried["jax_result"] == 2 * tried["port"][-1]
    assert tried["port"][-1] <= fits and (tried["port"][0] == start)


def test_reaching_zero_and_other_errors_raise_as_jax_does():
    for module, oom in ((tmemory, _oom_port), (jmemory, _oom_jax)):
        @module.find_executable_batch_size(starting_batch_size=4)
        def never_fits(batch_size):
            raise oom()

        with pytest.raises(RuntimeError, match="reached zero"):
            never_fits()

        @module.find_executable_batch_size(starting_batch_size=4)
        def broken(batch_size):
            raise ValueError("a bug, not memory")

        with pytest.raises(ValueError, match="a bug"):
            broken()

        @module.find_executable_batch_size(starting_batch_size=4)
        def no_batch_size(steps):
            return steps

        with pytest.raises(TypeError, match="batch_size"):
            no_batch_size()


@pytest.mark.parametrize("exc,expected", [
    (torch.OutOfMemoryError("CUDA out of memory."), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"),
     True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("cuDNN error: CUDNN_STATUS_NOT_SUPPORTED."), True),
    (RuntimeError("DefaultCPUAllocator: can't allocate memory: you tried to allocate 1 bytes"),
     True),
    (RuntimeError("shape mismatch"), False),
    (ValueError("CUDA out of memory."), False),
    (RuntimeError("CUDA out of memory.", "two args"), False),
], ids=lambda v: type(v).__name__ if isinstance(v, BaseException) else str(v))
def test_should_reduce_batch_size_recognises_the_card_s_messages(exc, expected):
    assert tmemory.should_reduce_batch_size(exc) is expected


def test_the_failed_try_s_tensors_are_freed_before_the_next_size():
    """A try that holds a large activation when it runs out of memory: the
    next try must not see it alive (a retry made inside ``except`` would
    keep the traceback, its frames, and so the activation)."""
    refs = []
    alive_at_next_try = []

    @tmemory.find_executable_batch_size(starting_batch_size=8)
    def train(batch_size):
        gc.collect()
        alive_at_next_try.append([r() is not None for r in refs])
        activation = torch.ones(batch_size, 1024)
        refs.append(weakref.ref(activation))
        if batch_size > 2:
            raise torch.OutOfMemoryError("CUDA out of memory.")
        return batch_size

    assert train() == 2
    assert alive_at_next_try == [[], [False], [False, False]]


def test_release_memory_and_memory_info_without_a_card():
    a, b = torch.ones(3), [1]
    a, b = tmemory.release_memory(a, b)
    assert a is None and b is None
    assert tmemory.release_memory() == []
    if not torch.cuda.is_available():
        assert tmemory.get_device_memory_info() == {}


def test_free_memory_drops_the_prepared_objects():
    from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True)
    module = torch.nn.Linear(2, 2)
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=0.1))
    model, opt = acc.free_memory(model, opt)
    assert model is None and opt is None
    assert acc._models == [] and acc._optimizers == [] and acc.step == 0
    assert acc.clear() == []
    acc.set_trigger()
    assert acc.check_trigger() is True and acc.check_trigger() is False
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
