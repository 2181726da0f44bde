"""The zoo's encoder and image families in the port (bert, vit, resnet)
held against the JAX package's on the same weights (``params_from_jax``)
and the same numpy inputs, each at its ``tiny`` config.

Tolerances: logits and single-forward losses 1e-5 (f32); gradients 1e-4 of
each leaf's scale; three steps of the 5-line loop against the JAX
Accelerator loop 1e-4 (f32) and 2e-2 (bf16) relative. The traps: BERT's
key mask and ids past its tables; ResNet's "SAME" padding of a strided
window on an even and an odd input size, in JAX's NHWC and torch's NCHW.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_zoo_common as common  # noqa: E402

from accelerate_tpu.models import bert as jbert  # noqa: E402
from accelerate_tpu.models import resnet as jresnet  # noqa: E402
from accelerate_tpu.models import vit as jvit  # noqa: E402
from accelerate_tpu_torch.models import bert as tbert  # noqa: E402
from accelerate_tpu_torch.models import resnet as tresnet  # noqa: E402
from accelerate_tpu_torch.models import vit as tvit  # noqa: E402

torch.set_num_threads(1)

#: name -> (JAX model class, JAX config, port module, port class, port config class)
FAMILIES = {
    "bert": (jbert.BertForSequenceClassification, jbert.BertConfig.tiny(), tbert,
             tbert.BertForSequenceClassification, tbert.BertConfig),
    "vit": (jvit.ViTForImageClassification, jvit.ViTConfig.tiny(), tvit,
            tvit.ViTForImageClassification, tvit.ViTConfig),
    "resnet": (jresnet.ResNetForImageClassification, jresnet.ResNetConfig.tiny(), tresnet,
               tresnet.ResNetForImageClassification, tresnet.ResNetConfig),
}


@pytest.fixture(autouse=True)
def _reset():
    common.reset_states()
    yield
    common.reset_states()


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, (jcls, jcfg, tmod, tcls, tcfg_cls) in FAMILIES.items():
        jmodel = jcls.from_config(jcfg, seed=0)
        tcfg = common.port_config(tcfg_cls, jcfg)
        out[name] = (jmodel, tcfg, common.port_model(tmod, tcls, tcfg,
                                                     common.np_tree(jmodel.params)))
    return out


def _batch(name, rng, b=4, size=32):
    if name == "bert":
        ids = rng.integers(0, 512, size=(b, 16)).astype(np.int32)
        mask = np.ones((b, 16), np.int32)
        mask[1, 10:] = 0
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": (np.arange(16)[None, :] >= 8).astype(np.int32).repeat(b, 0),
                "labels": rng.integers(0, 2, size=(b,)).astype(np.int32)}
    return {"pixel_values": rng.normal(size=(b, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, 3, size=(b,)).astype(np.int32)}


def _check_forward(jmodel, tmodel, batch, tbatch=None):
    ref = jmodel.apply_fn(jmodel.params, **{k: jnp.asarray(v) for k, v in batch.items()})
    out = tmodel(**(tbatch or {k: torch.from_numpy(v) for k, v in batch.items()}))
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref["logits"]),
                               rtol=1e-5, atol=1e-5)
    assert common.rel(float(out.loss), float(ref["loss"])) < 1e-5


#: (family, variant): bert with its key mask, without one, and with ids
#: past its tables; resnet at an even and an odd size, NHWC and NCHW
FORWARD_CASES = [("bert", "masked"), ("bert", "no_mask"), ("bert", "ids_past_tables"),
                 ("vit", "nhwc"), ("vit", "nchw"), ("resnet", "even_32"), ("resnet", "odd_33"),
                 ("resnet", "odd_33_nchw"), ("resnet", "even_34")]


@pytest.mark.parametrize("name,variant", FORWARD_CASES)
def test_forward_logits_and_loss_match_jax(pairs, name, variant):
    jmodel, _, tmodel = pairs[name]
    rng = np.random.default_rng(2)
    size = int(variant.split("_")[1]) if variant.startswith(("even", "odd")) else 32
    batch = _batch(name, rng, size=size)
    tbatch = None
    if variant == "no_mask":
        del batch["attention_mask"], batch["token_type_ids"]
    if variant == "ids_past_tables":
        batch["input_ids"][0, :4] = (600, 512, -1, -600)
        batch["token_type_ids"][2, :3] = (2, 5, -1)
    if variant.endswith("nchw"):
        tbatch = {"pixel_values": torch.from_numpy(batch["pixel_values"]).permute(0, 3, 1, 2),
                  "labels": torch.from_numpy(batch["labels"])}
    _check_forward(jmodel, tmodel, batch, tbatch)


def test_same_padding_is_xla_split():
    """XLA's "SAME": ceil(n / stride) outputs, the odd pad on the high side
    (a strided 3×3 over an even size pads (0, 1), where torch's
    ``padding=1`` would pad (1, 1))."""
    assert tresnet.same_padding(32, 3, 2) == (0, 1)
    assert tresnet.same_padding(33, 3, 2) == (1, 1)
    assert tresnet.same_padding(33, 2, 2) == (0, 1)
    assert tresnet.same_padding(32, 2, 2) == (0, 0)
    assert tresnet.same_padding(16, 3, 1) == (1, 1)
    assert tresnet.same_padding(16, 1, 1) == (0, 0)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_gradients_match_jax(pairs, name):
    jmodel, tcfg, tmodel = pairs[name]
    batch = _batch(name, np.random.default_rng(3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jmodel.apply_fn(p, **jb)["loss"])(jmodel.params)
    tmodel.zero_grad()
    out = tmodel(**{k: torch.from_numpy(v) for k, v in batch.items()})
    out.loss.backward()
    assert common.rel(float(out.loss), float(loss)) < 1e-5
    common.assert_grads_close(tmodel, grads, FAMILIES[name][2], tcfg, rtol=1e-4)
    tmodel.zero_grad()


@pytest.mark.parametrize("mixed_precision", [None, "bf16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_five_line_loop_matches_the_jax_loop(name, mixed_precision):
    jcls, jcfg, tmod, tcls, tcfg_cls = FAMILIES[name]
    batches = [_batch(name, np.random.default_rng(4), b=8)] * 3
    init, jlosses = common.jax_loop(jcls.from_config(jcfg, seed=1), batches, mixed_precision)
    tcfg = common.port_config(tcfg_cls, jcfg)
    losses = common.port_loop(common.port_model(tmod, tcls, tcfg, init), batches,
                              mixed_precision)
    tol = 1e-4 if mixed_precision is None else 2e-2
    assert len(losses) == 3
    for got, ref in zip(losses, jlosses):
        assert common.rel(got, ref) < tol, (losses, jlosses)
    assert losses[-1] < losses[0]
