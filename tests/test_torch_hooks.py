"""The port's user hooks (``accelerate_tpu_torch/hooks.py``) held to the
semantics the JAX package's ``tests/test_hooks.py`` pins, on every object
whose call goes through its ``forward``: an ``nn.Module``, a prepared model
and a dispatched (streamed) model. Where JAX has the same object (a
prepared regression model), the hooked outputs are compared with JAX's on
the same input: exact up to f32 (1e-6).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import torch_zoo_common as common  # noqa: E402

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu.hooks import ModelHook as JModelHook  # noqa: E402
from accelerate_tpu.hooks import add_hook_to_module as jadd_hook  # noqa: E402
from accelerate_tpu.test_utils import RegressionModel as JRegressionModel  # noqa: E402
from accelerate_tpu_torch import Accelerator  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch.hooks import (  # noqa: E402
    ModelHook,
    SequentialHook,
    UserCpuOffloadHook,
    add_hook_to_module,
    remove_hook_from_module,
)
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

torch.set_num_threads(1)


class Regression(torch.nn.Module):
    """``prediction = a * x + b``: the JAX test model's function."""

    def __init__(self, a=2.0, b=0.0):
        super().__init__()
        self.a = torch.nn.Parameter(torch.tensor(a))
        self.b = torch.nn.Parameter(torch.tensor(b))

    def forward(self, x):
        return {"prediction": self.a * x + self.b}


@pytest.fixture(autouse=True)
def _reset():
    common.reset_states()
    yield
    common.reset_states()


def _wrapped(kind):
    """A callable model of each kind, and how to read its prediction."""
    if kind == "module":
        return Regression()
    if kind == "prepared":
        return Accelerator(cpu=True).prepare_model(Regression())
    model = tllama.LlamaForCausalLM.from_config(tllama.LlamaConfig.tiny(layers=2), device="cpu")
    return bm.cpu_offload(model, execution_device="cpu")


def _call(kind, model, x):
    if kind == "dispatched":
        return model(input_ids=torch.as_tensor(x, dtype=torch.long)[None].repeat(1, 2)).logits
    return model(x=torch.as_tensor(x))["prediction"]


class ScaleInput(ModelHook):
    def pre_forward(self, module, *args, **kwargs):
        key = "input_ids" if "input_ids" in kwargs else "x"
        kwargs[key] = kwargs[key] * 2
        return args, kwargs


class CountOutput(ModelHook):
    def __init__(self):
        self.calls = 0

    def post_forward(self, module, output):
        self.calls += 1
        return output


KINDS = ["module", "prepared", "dispatched"]


@pytest.mark.parametrize("kind", KINDS)
def test_pre_forward_transforms_inputs(kind):
    model = _wrapped(kind)
    x = np.asarray([1.0, 2.0], np.float32)
    doubled = _call(kind, model, x * 2)
    add_hook_to_module(model, ScaleInput())
    torch.testing.assert_close(_call(kind, model, x), doubled, rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_post_forward_runs_and_remove_restores(kind):
    model = _wrapped(kind)
    hook = CountOutput()
    add_hook_to_module(model, hook)
    x = np.asarray([1.0], np.float32)
    _call(kind, model, x)
    assert hook.calls == 1 and model._hf_hook is hook
    remove_hook_from_module(model)
    assert "_hf_hook" not in vars(model) and "forward" not in vars(model)
    _call(kind, model, x)
    assert hook.calls == 1  # no longer invoked


@pytest.mark.parametrize("kind", KINDS)
def test_append_builds_sequential_hook(kind):
    model = _wrapped(kind)
    h1, h2 = CountOutput(), CountOutput()
    add_hook_to_module(model, h1)
    add_hook_to_module(model, h2, append=True)
    assert isinstance(model._hf_hook, SequentialHook)
    _call(kind, model, np.asarray([1.0], np.float32))
    assert h1.calls == 1 and h2.calls == 1
    add_hook_to_module(model, CountOutput())  # without append: replaces
    assert isinstance(model._hf_hook, CountOutput)
    _call(kind, model, np.asarray([1.0], np.float32))
    assert h1.calls == 1


def test_hooked_prepared_model_matches_jax():
    """The JAX test's own case: a prepared regression model (a=2, b=0) with
    a hook doubling its input, in both packages."""

    class JScale(JModelHook):
        def pre_forward(self, module, *args, **kwargs):
            kwargs["x"] = kwargs["x"] * 2.0
            return args, kwargs

    x = np.asarray([1.0, 2.0, -0.5], np.float32)
    jmodel = JAccelerator().prepare_model(JRegressionModel(a=2.0, b=0.0))
    jadd_hook(jmodel, JScale())
    ref = np.asarray(jmodel(x=x).prediction.force())
    model = Accelerator(cpu=True).prepare_model(Regression(2.0, 0.0))
    add_hook_to_module(model, ScaleInput())
    np.testing.assert_allclose(model(x=torch.as_tensor(x))["prediction"].detach().numpy(), ref,
                               rtol=1e-6)


def test_post_forward_may_replace_the_output_and_no_grad_holds():
    class Replace(ModelHook):
        no_grad = True

        def post_forward(self, module, output):  # the wrapped forward ran without grad
            assert not output["prediction"].requires_grad
            return {"prediction": output["prediction"] + 1}

    model = add_hook_to_module(Regression(), Replace())
    out = model(x=torch.ones(2))["prediction"]
    assert torch.equal(out, torch.full((2,), 3.0)) and not out.requires_grad


def test_init_and_detach_hooks_and_recursive_removal():
    seen = []

    class Lifecycle(ModelHook):
        def init_hook(self, module):
            seen.append("init")
            return module

        def detach_hook(self, module):
            seen.append("detach")
            return module

    outer = torch.nn.Sequential(Regression(), Regression())
    for child in outer:
        add_hook_to_module(child, Lifecycle())
    add_hook_to_module(outer, Lifecycle())
    remove_hook_from_module(outer, recurse=True)
    assert seen == ["init"] * 3 + ["detach"] * 3
    assert not any("_hf_hook" in vars(m) for m in outer.modules())


def test_user_cpu_offload_hook_handle():
    model = Regression()
    hook = CountOutput()
    add_hook_to_module(model, hook)
    handle = UserCpuOffloadHook(model, hook)
    handle.offload()  # re-runs init_hook: the identity here
    model(x=torch.ones(1))
    handle.remove()
    model(x=torch.ones(1))
    assert hook.calls == 1 and "_hf_hook" not in vars(model)


def test_hook_on_an_object_without_forward_raises():
    with pytest.raises(TypeError, match="not callable through a forward"):
        add_hook_to_module(object(), ModelHook())
