"""The port's rematerialisation policies (``accelerate_tpu_torch/parallel/
pipeline.py``) and HF llama loader held against the JAX package.

Each name ``LlamaConfig.remat`` takes gives the loss and the gradients of
``remat=False`` bit for bit (the recompute repeats the forward's
arithmetic), in f32, bf16 and fp8 (where the recompute must run under the
fp8 recipe the forward ran under), and JAX's loss and gradients with that
name from the same weights: loss 1e-5 relative, gradients 1e-4 × max(|ref|,
1), the f32 gates of ``test_torch_training.py``. The HF loader: a state
dict in HF's key layout, built here from JAX-initialised weights (nothing
is downloaded), gives JAX's logits through both converters, 1e-5.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.parallel.pipeline import remat_wrap as jremat_wrap  # noqa: E402
from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.parallel import pipeline as tpipeline  # noqa: E402

torch.set_num_threads(1)

#: every name the port takes; True and False besides
POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"]


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _configs(**overrides):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), **overrides)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    return jcfg, tcfg


def _batch(b=2, s=16):
    ids = np.random.default_rng(5).integers(0, 256, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, :4] = 0
    return {"input_ids": ids, "labels": ids.copy(), "attention_mask": mask}


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _port_loss_and_grads(tcfg, init, mixed_precision=None):
    AcceleratorState._reset_state(reset_partial_state=True)
    module = tllama.LlamaForCausalLM(tcfg, device="cpu")
    module.load_state_dict(tllama.params_from_jax(init, tcfg))
    model = Accelerator(cpu=True, mixed_precision=mixed_precision).prepare(module)
    out = model(**{k: torch.from_numpy(v) for k, v in _batch().items()})
    out.loss.backward()
    return float(out.loss), {n: p.grad.clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("remat", [True] + POLICIES)
def test_named_remat_gives_the_same_loss_and_grads_as_none_and_as_jax(remat):
    jcfg, tcfg = _configs(remat=remat)
    _, plain_cfg = _configs(remat=False)
    params = jllama.init_llama_params(jax.random.PRNGKey(0), jcfg)
    init = _np(params)
    loss, grads = _port_loss_and_grads(tcfg, init)
    ref_loss, ref_grads = _port_loss_and_grads(plain_cfg, init)
    assert loss == ref_loss
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=0, msg=name)

    batch = {k: jnp.asarray(v) for k, v in _batch().items()}

    def jloss(p):
        return jllama.llama_apply(jcfg, p, **batch)["loss"]

    jl, jg = jax.value_and_grad(jloss)(params)
    assert abs(loss - float(jl)) / float(jl) < 1e-5
    jgrads = tllama.params_from_jax(_np(jg), tcfg)
    for name, r in jgrads.items():
        r = r.numpy()
        np.testing.assert_allclose(grads[name].numpy(), r, rtol=0,
                                   atol=1e-4 * max(float(np.abs(r).max()), 1.0), err_msg=name)


@pytest.mark.parametrize("mixed_precision", ["bf16", "fp8"])
@pytest.mark.parametrize("remat", ["dots_saveable", "dots_with_no_batch_dims_saveable"])
def test_remat_recomputes_under_the_forwards_precision(mixed_precision, remat):
    """The backward's recompute runs after the call, outside the fp8
    recipe's context: it must still take the fp8 products (and the bf16
    copies) the forward took, so the gradients equal those without remat."""
    _, tcfg = _configs(remat=remat)
    _, plain_cfg = _configs(remat=False)
    init = _np(jllama.init_llama_params(jax.random.PRNGKey(1), jllama.LlamaConfig.tiny()))
    loss, grads = _port_loss_and_grads(tcfg, init, mixed_precision)
    ref_loss, ref_grads = _port_loss_and_grads(plain_cfg, init, mixed_precision)
    assert loss == ref_loss
    for name, g in ref_grads.items():
        torch.testing.assert_close(grads[name], g, rtol=0, atol=0, msg=name)


def test_the_policies_keep_what_their_names_say():
    """Counted on one layer's backward: ``everything_saveable`` recomputes
    no op, the dots policies recompute no projection (``mm``), and
    ``dots_with_no_batch_dims_saveable`` recomputes attention's batched
    products where ``dots_saveable`` keeps them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    _, tcfg = _configs(num_hidden_layers=1)
    init = _np(jllama.init_llama_params(jax.random.PRNGKey(2), _configs(num_hidden_layers=1)[0]))
    counts = {}
    for remat in (True, "everything_saveable", "dots_saveable",
                  "dots_with_no_batch_dims_saveable"):
        module = tllama.LlamaForCausalLM(dataclasses.replace(tcfg, remat=remat), device="cpu")
        module.load_state_dict(tllama.params_from_jax(init, tcfg))
        ids = torch.from_numpy(_batch()["input_ids"])
        x = module.embed_tokens(ids).detach().requires_grad_()
        layer = tpipeline.remat_wrap(tllama._remat_layer, remat)
        w = module.layers[0].weights()
        pos = torch.arange(16)[None].expand(2, 16)
        out = layer(tcfg, x, module.rope_cos, module.rope_sin, pos, None,
                    *(w[n] for n in tllama._LAYER_KEYS))
        with Count() as count:
            out.sum().backward()
        counts[remat] = {op: count.ops.count(op) for op in
                         (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)}
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    # the recompute adds forward products to the backward's own
    assert counts[True][mm] > counts["dots_saveable"][mm] == counts["everything_saveable"][mm]
    assert counts["dots_with_no_batch_dims_saveable"][mm] == counts["dots_saveable"][mm]
    assert counts["dots_with_no_batch_dims_saveable"][bmm] > counts["dots_saveable"][bmm]
    assert counts["dots_saveable"][bmm] == counts["everything_saveable"][bmm]


def test_an_unknown_name_raises_jaxs_message_and_factories_are_not_yet_ported():
    with pytest.raises(ValueError) as ref:
        jremat_wrap(lambda x: x, "dots_saveablee")
    with pytest.raises(ValueError) as got:
        tllama.LlamaConfig.tiny().__class__(remat="dots_saveablee")
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as got:
        tpipeline.remat_wrap(lambda x: x, "dots_saveablee")
    assert str(got.value) == str(ref.value)
    for factory in ("save_only_these_names", "save_any_names_but_these",
                    "offload_dot_with_no_batch_dims"):
        assert hasattr(jax.checkpoint_policies, factory)
        with pytest.raises(ValueError, match="not yet ported"):
            tpipeline.remat_wrap(lambda x: x, factory)
    # every name the port takes is a policy of jax.checkpoint_policies
    for name in POLICIES:
        assert hasattr(jax.checkpoint_policies, name)
    body = object()
    assert tpipeline.remat_wrap(body, False) is body


def _hf_state_dict(params, jcfg):
    """JAX's llama weights in HF transformers' key layout (``[out, in]``
    projections, ``model.`` prefix), as numpy arrays."""
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
             "wo": "self_attn.o_proj", "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    p = _np(params)
    hf = {"model.embed_tokens.weight": p["embed_tokens"], "model.norm.weight": p["norm"]}
    for i in range(jcfg.num_hidden_layers):
        for ours, theirs in names.items():
            hf[f"model.layers.{i}.{theirs}.weight"] = np.ascontiguousarray(p["layers"][ours][i].T)
        hf[f"model.layers.{i}.input_layernorm.weight"] = p["layers"]["attn_norm"][i]
        hf[f"model.layers.{i}.post_attention_layernorm.weight"] = p["layers"]["mlp_norm"][i]
    if not jcfg.tie_word_embeddings:
        hf["lm_head.weight"] = np.ascontiguousarray(p["lm_head"].T)
    return hf


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_convert_hf_llama_state_dict_gives_jaxs_logits(tied):
    jcfg, tcfg = _configs(tie_word_embeddings=tied, num_key_value_heads=2)
    params = jllama.init_llama_params(jax.random.PRNGKey(3), jcfg)
    hf = _hf_state_dict(params, jcfg)
    flat = jllama.convert_hf_llama_state_dict(hf, jcfg)
    jparams = {"embed_tokens": flat["embed_tokens"], "norm": flat["norm"],
               "layers": {k.split(".", 1)[1]: v for k, v in flat.items()
                          if k.startswith("layers.")}}
    if not tied:
        jparams["lm_head"] = flat["lm_head"]
    batch = _batch()
    ref = jllama.llama_apply(jcfg, jax.tree_util.tree_map(jnp.asarray, jparams),
                             input_ids=jnp.asarray(batch["input_ids"]),
                             attention_mask=jnp.asarray(batch["attention_mask"]))["logits"]
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    sd = model.convert_state_dict(hf)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    got = model(input_ids=torch.from_numpy(batch["input_ids"]),
                attention_mask=torch.from_numpy(batch["attention_mask"])).logits
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # torch tensors and keys without the prefix convert alike
    bare = {k.removeprefix("model."): torch.from_numpy(np.array(v)) for k, v in hf.items()}
    again = tllama.convert_hf_llama_state_dict(bare, tcfg)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
