"""The port's training path held against the JAX package: the losses, the
llama forward, and the 5-line ``Accelerator`` loop itself.

Both packages start from the same JAX-initialised weights (carried across
by ``params_from_jax``) and the same numpy batches. The JAX loop runs as
its own tests run it, on the 8-device virtual CPU mesh; the port runs on
the CPU through its plain attention path (``Accelerator(cpu=True)``).
``optax.adamw(lr)`` is held against ``torch.optim.AdamW(lr, betas=(0.9,
0.999), eps=1e-8, weight_decay=1e-4)``: optax's defaults, spelled out,
because torch's default weight decay is 1e-2. Both decay decoupled from the
pre-update parameter, so the updates agree.

Tolerances: f32 losses 1e-4 relative over 5 steps and parameters 2e-5
after one step (the same arithmetic in another order, compounded by Adam's
normalisation); the bf16 loop 2e-2 relative (bf16 rounds at other places
in the two frameworks); single forward passes 1e-5 relative.
"""

import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState, set_seed  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.ops import attention as tattn  # noqa: E402
from accelerate_tpu_torch.ops import layers as tlayers  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin  # noqa: E402

jlayers = importlib.import_module("accelerate_tpu.ops.layers")

torch.set_num_threads(1)


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


def _batch(rng, b=8, s=32, vocab=256):
    ids = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    return {"input_ids": ids, "labels": ids.copy(), "attention_mask": np.ones((b, s), np.int32)}


def _port_model(tcfg, np_params):
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params, tcfg))
    return model


def _np_params(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


# ---------------------------------------------------------------------------
# (a) the losses
# ---------------------------------------------------------------------------


def test_cross_entropy_and_shift_labels_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(2, 6)).astype(np.int64)
    labels[0, 2] = -100
    np.testing.assert_array_equal(tlayers.shift_labels(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jlayers.shift_labels(jnp.asarray(labels))))
    ref = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tlayers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert _rel(float(got), float(ref)) < 1e-6
    all_ignored = torch.full((2, 6), -100)
    assert float(tlayers.cross_entropy_loss(torch.from_numpy(logits), all_ignored)) == 0.0


def test_fused_cross_entropy_chunks_and_matches_jax_value_and_grads():
    """b=2, s=64, chunk_tokens=16: the largest divisor C of 64 with 64 // C
    >= 8 is 8 chunks, each under torch.utils.checkpoint."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 16)).astype(np.float32)
    head = (rng.normal(size=(16, 40)) / 4).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 64)).astype(np.int32)
    labels[1, 10:20] = -100
    shifted = np.asarray(jlayers.shift_labels(jnp.asarray(labels)))

    def jloss(x_, h_):
        return jlayers.fused_cross_entropy(x_, h_, jnp.asarray(shifted), chunk_tokens=16)

    ref, (gx, gh) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_()
    th = torch.from_numpy(head).requires_grad_()
    calls = []
    real = tlayers._chunk_nll
    try:
        tlayers._chunk_nll = lambda *a: calls.append(1) or real(*a)
        got = tlayers.fused_cross_entropy(tx, th, torch.from_numpy(shifted).long(),
                                          chunk_tokens=16)
        forward_calls = len(calls)
        got.backward()
    finally:
        tlayers._chunk_nll = real
    assert forward_calls == 8 and len(calls) == 16  # each chunk recomputed once in backward
    assert _rel(float(got), float(ref)) < 1e-6
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-7)
    plain = tlayers.cross_entropy_loss(torch.from_numpy(x) @ torch.from_numpy(head),
                                       torch.from_numpy(shifted).long())
    assert _rel(float(got), float(plain)) < 1e-6


# ---------------------------------------------------------------------------
# (b) the llama forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True], ids=["full", "left_padded"])
def test_llama_forward_loss_and_logits_match_jax(padded):
    jcfg, tcfg = _configs(num_key_value_heads=2)
    params = jllama.init_llama_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(np.random.default_rng(2), b=2, s=16)
    if padded:
        batch["attention_mask"][0, :5] = 0
    ref = jllama.llama_apply(jcfg, params, **{k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(tcfg, _np_params(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(**tb, return_logits=True)
    assert _rel(float(out.loss), float(ref["loss"])) < 1e-5
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(ref["logits"]),
                               rtol=1e-5, atol=1e-5)
    # with labels the whole-sequence head product is skipped
    assert set(model(**tb)) == {"loss"}
    assert set(model(input_ids=tb["input_ids"])) == {"logits"}


# ---------------------------------------------------------------------------
# (c) the 5-line loop against the JAX Accelerator loop
# ---------------------------------------------------------------------------


def _jax_loop(jcfg, batches, *, clip=None, accumulation=1, mixed_precision=None):
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    accelerator = JAccelerator(gradient_accumulation_steps=accumulation,
                               mixed_precision=mixed_precision)
    model, opt = accelerator.prepare(jllama.LlamaForCausalLM.from_config(jcfg, seed=0),
                                     optax.adamw(1e-3))
    init = _np_params(model.params)
    losses, norms, first = [], [], None
    for batch in batches:
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        with accelerator.accumulate(model):
            out = model(**batch)
            accelerator.backward(out.loss)
            norm = accelerator.clip_grad_norm_(model, clip) if clip is not None else None
            if first is None and accelerator.sync_gradients and accumulation > 1:
                first = _np_params(opt.grads)  # the summed micro-batch gradients
            opt.step()
            opt.zero_grad()
        losses.append(out.loss.item())
        if norm is not None:
            norms.append(float(norm))
        if first is None and accelerator.sync_gradients:
            first = _np_params(model.params)
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    return init, losses, norms, first


def _port_loop(tcfg, init, batches, *, clip=None, accumulation=1, mixed_precision=None,
               scheduler=False):
    accelerator = Accelerator(cpu=True, gradient_accumulation_steps=accumulation,
                              mixed_precision=mixed_precision)
    model = _port_model(tcfg, init)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    objs = [model, opt]
    if scheduler:
        objs.append(torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0))
    model, opt, *sched = accelerator.prepare(*objs)
    losses, norms, first = [], [], None
    for batch in batches:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        with accelerator.accumulate(model):
            out = model(**batch)
            accelerator.backward(out.loss)
            norm = accelerator.clip_grad_norm_(model, clip) if clip is not None else None
            if first is None and accelerator.sync_gradients and accumulation > 1:
                first = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt.step()
            for s in sched:
                s.step()
            opt.zero_grad()
        losses.append(float(out.loss.detach()))
        if norm is not None:
            norms.append(float(norm))
        if first is None and accelerator.sync_gradients:
            first = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return losses, norms, first, sched


def _assert_tree_close(port_sd, jax_tree, tcfg, atol, scaled=False):
    ref = tllama.params_from_jax(jax_tree, tcfg)
    for name, t in port_sd.items():
        r = ref[name].numpy()
        tol = atol * max(float(np.abs(r).max()), 1e-30) if scaled else atol
        np.testing.assert_allclose(t.numpy(), r, rtol=0, atol=tol, err_msg=name)


LOOPS = {
    "plain": dict(),
    "clip": dict(clip=1.0),
    "accumulate_2": dict(accumulation=2),
}


@pytest.mark.parametrize("variant", list(LOOPS))
def test_five_line_loop_matches_the_jax_accelerator_loop(variant):
    kw = LOOPS[variant]
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(3)
    if kw.get("accumulation", 1) > 1:
        batches = [_batch(rng) for _ in range(6)]  # 3 optimizer steps of 2 micro-batches
    else:
        batches = [_batch(rng)] * 5  # memorising a fixed batch
    init, jlosses, jnorms, jfirst = _jax_loop(jcfg, batches, **kw)
    losses, norms, first, sched = _port_loop(tcfg, init, batches, scheduler=True, **kw)
    for got, ref in zip(losses, jlosses):
        assert _rel(got, ref) < 1e-4, (losses, jlosses)
    assert len(losses) == len(jlosses)
    if kw.get("accumulation", 1) > 1:
        # the summed micro-batch gradients at the first sync step, 1e-5 of
        # each leaf's scale; not the parameters after Adam's first step,
        # whose g / (|g| + eps) is ill-conditioned wherever two micro-batch
        # gradients cancel to |g| ~ eps
        _assert_tree_close(first, jfirst, tcfg, atol=1e-5, scaled=True)
    else:
        _assert_tree_close(first, jfirst, tcfg, atol=2e-5)
    if "clip" in kw:
        assert len(norms) == len(jnorms) == 5
        for got, ref in zip(norms, jnorms):
            assert _rel(got, ref) < 1e-4, (norms, jnorms)
        assert norms[0] > 1.0  # the clip was active
    if kw.get("accumulation", 1) == 1:
        assert losses[-1] < losses[0]
    # the scheduler stepped once per optimizer step, never mid-accumulation
    assert sched[0].scheduler.last_epoch == len(batches) // kw.get("accumulation", 1)


def test_bf16_loop_matches_the_jax_bf16_loop():
    jcfg, tcfg = _configs()
    batches = [_batch(np.random.default_rng(4))] * 5
    init, jlosses, _, _ = _jax_loop(jcfg, batches, mixed_precision="bf16")
    losses, _, first, _ = _port_loop(tcfg, init, batches, mixed_precision="bf16")
    for got, ref in zip(losses, jlosses):
        assert _rel(got, ref) < 2e-2, (losses, jlosses)
    assert losses[-1] < losses[0]
    assert all(t.dtype == torch.float32 for t in first.values())  # f32 masters


# ---------------------------------------------------------------------------
# (e) remat, (f) what the port refuses, and the wrappers' bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_remat_gives_the_same_loss_and_grads(mixed_precision):
    """Under bf16 the recompute must see the very bf16 weight copies the
    forward used, not the f32 masters."""
    grads = {}
    for remat in (False, True):
        AcceleratorState._reset_state(reset_partial_state=True)
        _, tcfg = _configs(remat=remat)
        set_seed(0)
        model = tllama.LlamaForCausalLM.from_config(tcfg, seed=5, device="cpu")
        prepared = Accelerator(cpu=True, mixed_precision=mixed_precision).prepare(model)
        batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(5), b=2).items()}
        batch["attention_mask"][1, :4] = 0
        out = prepared(**batch)
        out.loss.backward()
        grads[remat] = (float(out.loss), {n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[True][0] == grads[False][0]
    for name, g in grads[False][1].items():
        torch.testing.assert_close(grads[True][1][name], g, rtol=0, atol=0, msg=name)


def test_accelerator_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match=r"Accelerator\(cpu=True\)"):
        Accelerator()
    assert Accelerator(cpu=True).device == torch.device("cpu")


@pytest.mark.parametrize("kwargs", [
    {"mixed_precision": "fp16"},
    {"mixed_precision": "fp8"},
    {"fsdp_plugin": object()},
    {"deepspeed_plugin": object()},
    {"megatron_lm_plugin": object()},
    {"mesh_plugin": object()},
    {"context_parallel_plugin": object()},
], ids=lambda kw: next(iter(kw)) + ("=" + kw["mixed_precision"] if "mixed_precision" in kw else ""))
def test_features_not_yet_ported_raise(kwargs):
    with pytest.raises(ValueError, match="not yet ported"):
        Accelerator(cpu=True, **kwargs)


def test_other_unported_options_raise():
    with pytest.raises(ValueError, match="not yet ported"):
        tllama.LlamaConfig.tiny().__class__(remat="dots_saveable")
    with pytest.raises(ValueError, match="not yet ported"):
        GradientAccumulationPlugin(num_steps=2, fuse_in_step=True)
    with pytest.raises(ValueError, match="bogus"):
        Accelerator(cpu=True, mixed_precision="bogus")


def test_backward_refuses_a_non_tensor_and_the_state_is_shared():
    accelerator = Accelerator(cpu=True, mixed_precision="bf16")
    with pytest.raises(TypeError, match="loss tensor"):
        accelerator.backward(1.0)
    assert AcceleratorState().mixed_precision == "bf16" and Accelerator().device.type == "cpu"
    with pytest.raises(ValueError, match="already initialized"):
        AcceleratorState(mixed_precision="no")
    assert accelerator.is_main_process and accelerator.num_processes == 1
    accelerator.wait_for_everyone()
    AcceleratorState._reset_state(reset_partial_state=True)
    assert not AcceleratorState._shared_state


def test_optimizer_steps_and_clears_only_at_sync_steps():
    accelerator = Accelerator(cpu=True, gradient_accumulation_steps=2)
    w = torch.nn.Parameter(torch.ones(3))
    opt = accelerator.prepare(torch.optim.SGD([w], lr=0.5))
    opt.step()
    assert opt.step_was_skipped  # no gradient at all
    for micro in range(2):
        with accelerator.accumulate():
            accelerator.backward((w * 2.0).sum())
            opt.step()
            opt.zero_grad()
            if micro == 0:  # not a sync step: grads kept, weights untouched
                assert not accelerator.sync_gradients
                torch.testing.assert_close(w.grad, torch.full((3,), 1.0))
                torch.testing.assert_close(w.detach(), torch.ones(3))
    assert accelerator.sync_gradients and w.grad is None
    torch.testing.assert_close(w.detach(), torch.zeros(3))  # 1 - 0.5 * (1 + 1)
    assert not opt.step_was_skipped
    norm = accelerator.clip_grad_norm_([w], 1.0)
    assert isinstance(norm, torch.Tensor) and float(norm) == 0.0
