"""The port's precision policies held against the JAX package: the fp16
dynamic loss scaler and the fp16 loop, the kwargs handlers, ``"int8"``,
the autocast islands, and the flash kernels' plain versions at f16.

Both packages start from the same JAX-initialised weights (carried across
by ``params_from_jax``) and the same numpy batches; the JAX loop runs as
its own tests run it, on the virtual CPU mesh, and the port on the CPU
(``Accelerator(cpu=True)``). Tolerances: the fp16 loop's losses 1e-3
relative and its weights 1e-2 after six AdamW steps (the model runs in
f16, whose 10-bit mantissa rounds at other places in the two frameworks;
measured 1e-4 and 3e-3); the scaler's schedule, the skipped steps and the
scales are exact. The f32 (``"int8"``) loop: 1e-4 relative, as in
``test_torch_training.py``. The plain flash kernels at f16 against JAX's
Pallas kernels in interpret mode on the same f16 values: outputs 4e-3 and
gradients 8e-3 × max(|ref|, 1) in f32 (the bf16 gates, 3e-2 and 5e-2,
scaled by f16's 8× finer mantissa), and where a loss-scaled dO overflows
dS to inf in f16, the non-finite entries of the gradients are the same.
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
from accelerate_tpu.optimizer import LossScaler as JLossScaler  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu.state import GradientState as JGradState  # noqa: E402
from accelerate_tpu.utils import dataclasses as jdc  # noqa: E402
from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    AcceleratorState,
    AutocastKwargs,
    FP8RecipeKwargs,
    GradientState,
    GradScalerKwargs,
    InitProcessGroupKwargs,
    LossScaler,
)
from accelerate_tpu_torch.generation import generate  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.ops import flash_attention as tfa  # noqa: E402

jfa = importlib.import_module("accelerate_tpu.ops.flash_attention")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _configs():
    jcfg = jllama.LlamaConfig.tiny()
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    return jcfg, tcfg


def _batch(seed, b=8, s=32, vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)
    return {"input_ids": ids, "labels": ids.copy(), "attention_mask": np.ones((b, s), np.int32)}


def _np_params(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _port_model(tcfg, np_params):
    model = tllama.LlamaForCausalLM(tcfg, device="cpu")
    model.load_state_dict(tllama.params_from_jax(np_params, tcfg))
    return model


def _jax_loop(batches, mixed_precision, handlers=(), clip=None, accumulation=1,
              optimizer=None, clip_each_micro_batch=False):
    """The JAX Accelerator loop; returns the initial weights and, a step,
    the loss, ``step_was_skipped``, the scale and the weights after."""
    jcfg, _ = _configs()
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    accelerator = JAccelerator(mixed_precision=mixed_precision, kwargs_handlers=list(handlers),
                               gradient_accumulation_steps=accumulation)
    model, opt = accelerator.prepare(jllama.LlamaForCausalLM.from_config(jcfg, seed=0),
                                     optimizer or optax.adamw(1e-3))
    init = _np_params(model.params)
    rows = []
    for batch in batches:
        with accelerator.accumulate(model):
            out = model(**{k: jnp.asarray(v) for k, v in batch.items()})
            accelerator.backward(out.loss)
            norm = None
            if clip is not None and (clip_each_micro_batch or accelerator.sync_gradients):
                norm = float(accelerator.clip_grad_norm_(model, clip))
            opt.step()
            opt.zero_grad()
        scaler = accelerator.scaler
        rows.append((out.loss.item(), opt.step_was_skipped,
                     scaler.get_scale() if scaler is not None else None, norm))
    final = _np_params(model.params)
    JAccState._reset_state(reset_partial_state=True)
    JGradState._reset_state()
    return init, rows, final


def _port_loop(init, batches, mixed_precision, handlers=(), clip=None, accumulation=1,
               sgd_lr=None, clip_each_micro_batch=False, scheduler=False):
    _, tcfg = _configs()
    accelerator = Accelerator(cpu=True, mixed_precision=mixed_precision,
                              kwargs_handlers=list(handlers),
                              gradient_accumulation_steps=accumulation)
    module = _port_model(tcfg, init)
    if sgd_lr is not None:
        opt = torch.optim.SGD(module.parameters(), lr=sgd_lr)
    else:
        opt = torch.optim.AdamW(module.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    objs = [module, opt] + ([torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)]
                            if scheduler else [])
    model, opt, *sched = accelerator.prepare(*objs)
    rows = []
    for batch in batches:
        with accelerator.accumulate(model):
            out = model(**{k: torch.from_numpy(v) for k, v in batch.items()})
            accelerator.backward(out.loss)
            norm = None
            if clip is not None and (clip_each_micro_batch or accelerator.sync_gradients):
                norm = float(accelerator.clip_grad_norm_(model, clip))
            opt.step()
            for s in sched:
                s.step()
            opt.zero_grad()
        scaler = accelerator.scaler
        rows.append((float(out.loss.detach()), opt.step_was_skipped,
                     scaler.get_scale() if scaler is not None else None, norm))
    return rows, module, sched


def _assert_weights_close(module, jax_tree, atol):
    _, tcfg = _configs()
    ref = tllama.params_from_jax(jax_tree, tcfg)
    for name, t in module.state_dict().items():
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=0, atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the loss scaler
# ---------------------------------------------------------------------------


def test_loss_scaler_schedule_and_state_dict_match_jax_step_by_step():
    oks = [True, True, False, True, True, True, False, False, True, True, True, True]
    kw = dict(init_scale=1024.0, growth_factor=2.0, backoff_factor=0.25, growth_interval=3)
    jscaler, tscaler = JLossScaler(**kw), LossScaler(**kw)
    for ok in oks:
        jscaler.update(ok)
        tscaler.update(ok)
        assert tscaler.get_scale() == jscaler.get_scale()
        assert tscaler.state_dict() == jscaler.state_dict()
    assert set(tscaler.state_dict()) == {"scale", "growth_factor", "backoff_factor",
                                         "growth_interval", "_growth_tracker"}
    assert tscaler.scale.dtype == torch.float32 and tscaler._good_steps.dtype == torch.int32
    again = LossScaler()
    again.load_state_dict(jscaler.state_dict())
    assert again.state_dict() == jscaler.state_dict()
    with pytest.raises(ValueError, match="growth_factor"):
        LossScaler(growth_factor=1.0)
    with pytest.raises(ValueError, match="backoff_factor"):
        LossScaler(backoff_factor=1.5)


# ---------------------------------------------------------------------------
# the fp16 loop against JAX's mixed_precision="fp16" loop
# ---------------------------------------------------------------------------

FP16_LOOPS = {
    # the default scale: step 4 overflows at 2^17 after one growth, and the
    # scale grows again two steps later
    "default_scale": dict(init_scale=65536.0, steps=6),
    # forced overflow: seven skipped steps back the scale off to 2^17
    "forced_overflow": dict(init_scale=2.0 ** 24, steps=10),
}


@pytest.mark.parametrize("case", list(FP16_LOOPS))
def test_fp16_loop_matches_the_jax_fp16_loop(case):
    """Losses, skipped steps, scales and weights, with a clip on every step
    (growth every 2 finite steps, so both growth and backoff happen). SGD at
    lr 0.1, as the int8 test: Adam's g / (|g| + eps) moves every weight by
    about lr whatever its gradient, so the weights would not test the
    update. The weights must agree within 3e-4 (measured 6.8e-5 and 2.4e-5,
    f16 gradients) and have moved by ten times that (measured 0.012)."""
    kw = FP16_LOOPS[case]
    batches = [_batch(3)] * kw["steps"]
    handler = dict(init_scale=kw["init_scale"], growth_interval=2)
    init, jrows, jfinal = _jax_loop(batches, "fp16", [jdc.GradScalerKwargs(**handler)], clip=1.0,
                                    optimizer=optax.sgd(0.1))
    rows, module, sched = _port_loop(init, batches, "fp16", [GradScalerKwargs(**handler)],
                                     clip=1.0, scheduler=True, sgd_lr=0.1)
    assert [r[1] for r in rows] == [r[1] for r in jrows]  # the same skipped steps
    assert [r[2] for r in rows] == [r[2] for r in jrows]  # the same scale after each
    for got, ref in zip(rows, jrows):
        assert _rel(got[0], ref[0]) < 1e-3, (rows, jrows)
        if not got[1]:
            assert _rel(got[3], ref[3]) < 1e-3, (rows, jrows)  # the unscaled norm
    skipped = sum(r[1] for r in rows)
    assert skipped >= 1 and skipped < len(rows)
    if case == "forced_overflow":
        assert [r[1] for r in rows[:7]] == [True] * 7
    _assert_weights_close(module, jfinal, atol=3e-4)
    _, tcfg = _configs()
    before = tllama.params_from_jax(init, tcfg)
    moved = max((t - before[n]).abs().max().item() for n, t in module.state_dict().items())
    assert moved > 3e-3
    # the scheduler stepped on the taken steps only
    assert sched[0].scheduler.last_epoch == len(rows) - skipped


def test_fp16_clip_operates_on_unscaled_grads():
    """(JAX ``tests/test_accelerator.py:212``.) With a scale of 1024 the norm
    the clip returns is the true gradient norm, JAX's; a clip to 0.5 then
    one SGD step at lr 1 moves the weights by 0.5 exactly."""
    batches = [_batch(5)]
    handler = dict(init_scale=1024.0)
    init, jrows, _ = _jax_loop(batches, "fp16", [jdc.GradScalerKwargs(**handler)], clip=1e9)
    rows, _, _ = _port_loop(init, batches, "fp16", [GradScalerKwargs(**handler)], clip=1e9)
    _, f32_rows, _ = _jax_loop(batches, None, clip=1e9)
    assert not rows[0][1] and _rel(rows[0][3], jrows[0][3]) < 1e-3
    assert _rel(rows[0][3], f32_rows[0][3]) < 5e-2  # true units, at f16's precision
    rows, module, _ = _port_loop(init, batches, "fp16", [GradScalerKwargs(**handler)], clip=0.5,
                                 sgd_lr=1.0)
    _, tcfg = _configs()
    before = tllama.params_from_jax(init, tcfg)
    delta = torch.sqrt(sum(((t - before[n]) ** 2).sum() for n, t in module.state_dict().items()))
    assert abs(float(delta) - 0.5) < 1e-3


def test_fp16_clip_mid_accumulation_then_a_second_micro_batch():
    """JAX's ``_accumulate_grads`` rule: once a clip unscaled the first
    micro-batch's gradients, the second's scaled contribution is unscaled
    before it is added. SGD, two micro-batches, a clip after each; the
    weights after the step equal JAX's."""
    batches = [_batch(6), _batch(7)]
    handler = dict(init_scale=1024.0)
    init, jrows, jfinal = _jax_loop(batches, "fp16", [jdc.GradScalerKwargs(**handler)], clip=1e9,
                                    accumulation=2, optimizer=optax.sgd(0.5),
                                    clip_each_micro_batch=True)
    rows, module, _ = _port_loop(init, batches, "fp16", [GradScalerKwargs(**handler)], clip=1e9,
                                 accumulation=2, sgd_lr=0.5, clip_each_micro_batch=True)
    for got, ref in zip(rows, jrows):
        assert _rel(got[3], ref[3]) < 1e-3, (rows, jrows)
    assert not rows[1][1] and not jrows[1][1]
    # gradients at f16's precision (measured 3e-4 apart), times lr 0.5
    _assert_weights_close(module, jfinal, atol=1e-3)
    _, tcfg = _configs()
    before = tllama.params_from_jax(init, tcfg)
    moved = max((t - before[n]).abs().max().item() for n, t in module.state_dict().items())
    assert moved > 1e-3  # true units: a scaled gradient would have moved them ~1024x


def test_int8_runs_at_f32_as_in_the_jax_package():
    """JAX's ``compute_dtype`` has no int8 entry, so its loop runs at f32:
    the port's losses and its weights after three SGD steps equal JAX's at
    the f32 gates of ``test_torch_training.py`` (SGD: Adam's first step,
    g / (|g| + eps), is ill-conditioned where |g| ~ eps)."""
    batches = [_batch(4)] * 3
    init, jrows, jfinal = _jax_loop(batches, "int8", optimizer=optax.sgd(0.1))
    rows, module, _ = _port_loop(init, batches, "int8", sgd_lr=0.1)
    for got, ref in zip(rows, jrows):
        assert _rel(got[0], ref[0]) < 1e-4
    assert Accelerator().compute_dtype is None and Accelerator().scaler is None
    _assert_weights_close(module, jfinal, atol=2e-5)


# ---------------------------------------------------------------------------
# kwargs handlers
# ---------------------------------------------------------------------------


def test_kwargs_handlers_dispatch_and_refusals():
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[GradScalerKwargs(init_scale=8.0, growth_interval=5),
                                       AutocastKwargs()])
    assert acc.scaler.get_scale() == 8.0 and acc.scaler.growth_interval == 5
    assert acc.compute_dtype == torch.float16
    model, opt = acc.prepare(torch.nn.Linear(4, 4), torch.optim.SGD([torch.nn.Parameter(
        torch.zeros(1))], lr=0.1))
    assert opt.scaler is acc.scaler
    AcceleratorState._reset_state(reset_partial_state=True)
    assert Accelerator(cpu=True, mixed_precision="fp16",
                       kwargs_handlers=[GradScalerKwargs(enabled=False)]).scaler is None
    AcceleratorState._reset_state(reset_partial_state=True)
    assert Accelerator(cpu=True, mixed_precision="bf16").scaler is None
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, mixed_precision="fp8",
                      kwargs_handlers=[FP8RecipeKwargs(fp8_format="E4M3")])
    assert acc.compute_dtype == torch.bfloat16
    prepared = acc.prepare(torch.nn.Linear(4, 4))
    assert prepared.fp8_recipe.fp8_format == "E4M3"
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, kwargs_handlers=[InitProcessGroupKwargs()])
    assert acc.init_handler.timeout.total_seconds() == 1800 and acc.state.backend is None
    # the JAX package ignores these; the port refuses them, naming their item
    for handler, item in ((jdc.ProfileKwargs(), 23), (jdc.DistributedDataParallelKwargs(), 18)):
        AcceleratorState._reset_state(reset_partial_state=True)
        with pytest.raises(ValueError, match=f"not yet ported \\(ROADMAP item {item}\\)"):
            Accelerator(cpu=True, kwargs_handlers=[handler])
    with pytest.raises(ValueError, match="not yet ported"):
        Accelerator(cpu=True, kwargs_handlers=[object()])
    # the handlers' fields are JAX's
    for name in ("GradScalerKwargs", "AutocastKwargs"):
        port = {f.name: f.default for f in dataclasses.fields(globals()[name])}
        ref = {f.name: f.default for f in dataclasses.fields(getattr(jdc, name))}
        assert port == ref, name


def test_init_process_group_kwargs_reach_the_process_group(monkeypatch):
    """``InitProcessGroupKwargs``' timeout and coordinator replace the
    launch environment's and the fixed 10-minute default; only the fields
    set away from their defaults are passed (JAX's ``to_kwargs``), so a
    handler that leaves the timeout alone keeps the 10 minutes."""
    import datetime

    from accelerate_tpu_torch import state as tstate

    seen = {}

    def fake_init(**kwargs):
        seen.update(kwargs)
        return None

    monkeypatch.setattr(tstate, "initialize_distributed", fake_init)
    Accelerator(cpu=True, kwargs_handlers=[InitProcessGroupKwargs(
        coordinator_address="127.0.0.1:29511", timeout=datetime.timedelta(seconds=42))])
    assert seen["timeout"] == datetime.timedelta(seconds=42)
    assert seen["coordinator_address"] == "127.0.0.1:29511"
    AcceleratorState._reset_state(reset_partial_state=True)
    seen.clear()
    Accelerator(cpu=True)
    assert "timeout" not in seen  # the mesh module's default applies
    AcceleratorState._reset_state(reset_partial_state=True)
    seen.clear()
    Accelerator(cpu=True, kwargs_handlers=[InitProcessGroupKwargs(num_processes=1)])
    assert seen["num_processes"] == 1 and "timeout" not in seen


# ---------------------------------------------------------------------------
# autocast islands
# ---------------------------------------------------------------------------


def test_autocast_disabled_island():
    """(JAX ``tests/test_hooks.py:89``.) Both policies are suspended inside
    the island and restored after it."""
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    model = acc.prepare_model(torch.nn.Linear(4, 4))
    assert model.compute_dtype == torch.bfloat16 and model.fp8_recipe is not None
    with acc.autocast(autocast_handler=AutocastKwargs(enabled=False)):
        assert model.compute_dtype is None and model.fp8_recipe is None
    assert model.compute_dtype == torch.bfloat16 and model.fp8_recipe is not None
    with acc.autocast(autocast_handler=AutocastKwargs(enabled=True)):
        assert model.compute_dtype == torch.bfloat16
    with acc.autocast():
        assert model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("mixed_precision", ["bf16", "fp16", "fp8"])
def test_autocast_island_binds_at_call_time(mixed_precision):
    """(JAX ``tests/test_hooks.py:163``.) A call made inside the island runs
    at full precision: the f32 module's own logits, bit for bit; outside it
    the policy applies again."""
    _, tcfg = _configs()
    module = tllama.LlamaForCausalLM.from_config(tcfg, seed=1, device="cpu")
    ids = torch.as_tensor(_batch(8, b=2, s=8)["input_ids"])
    ref = module(input_ids=ids).logits
    acc = Accelerator(cpu=True, mixed_precision=mixed_precision)
    model = acc.prepare(module)
    with acc.autocast(autocast_handler=AutocastKwargs(enabled=False)):
        inside = model(input_ids=ids).logits
    outside = model(input_ids=ids).logits
    assert torch.equal(inside, ref), "the island call was downcast"
    assert not torch.equal(outside, inside), "the policy did not apply outside the island"
    assert outside.dtype == torch.float32  # half outputs come back as f32


@pytest.mark.parametrize("mixed_precision", ["bf16", "fp8"])
def test_cached_generation_respects_autocast_island(mixed_precision):
    """(JAX ``tests/test_generation.py:250``.) ``generate()`` reads the
    policy when called: inside the island it gives the f32 module's tokens,
    outside it runs the policy, and the two keep one program each, keyed by
    the policy (dtype and fp8 format)."""
    _, tcfg = _configs()
    module = tllama.LlamaForCausalLM.from_config(tcfg, seed=2, device="cpu")
    ids = np.random.default_rng(8).integers(0, 256, size=(1, 5)).astype(np.int32)
    ref = generate(module, ids, max_new_tokens=3, use_cache=True)
    acc = Accelerator(cpu=True, mixed_precision=mixed_precision)
    prepared = acc.prepare_model(module)
    with acc.autocast(autocast_handler=AutocastKwargs(enabled=False)):
        full_precision = generate(prepared, ids, max_new_tokens=3, use_cache=True)
    low = generate(prepared, ids, max_new_tokens=3, use_cache=True)
    np.testing.assert_array_equal(full_precision.numpy(), ref.numpy())
    assert full_precision.shape == low.shape == (1, 8)
    policies = {key[-1] for key in prepared._generation_programs}
    fp8 = "HYBRID" if mixed_precision == "fp8" else None
    assert policies == {(torch.float32, None), (torch.bfloat16, fp8)}
    # the island again replays its kept program rather than adding one
    with acc.autocast(autocast_handler=AutocastKwargs(enabled=False)):
        again = generate(prepared, ids, max_new_tokens=3, use_cache=True)
    np.testing.assert_array_equal(again.numpy(), ref.numpy())
    assert len(prepared._generation_programs) == 2


# ---------------------------------------------------------------------------
# B1-B3 at f16: the plain versions against JAX's Pallas kernels
# ---------------------------------------------------------------------------

F16_CASES = {
    "causal_s64": dict(causal=True),
    "non_causal_s64": dict(causal=False),
    "gqa_4_2_s200_pad130": dict(causal=True, b=2, s=200, h=4, n_kv=2, pad=130),
    "hd16_s129": dict(causal=True, h=4, d=16, s=129),
}


def _inputs(b=1, s=64, h=2, n_kv=None, d=32, seed=0):
    rng = np.random.default_rng(seed)
    n_kv = n_kv or h
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, n_kv, d), (b, s, n_kv, d), (b, s, h, d)))


def _f16_flash_pair(q, k, v, do, mask, causal):
    jm = None if mask is None else jnp.asarray(mask)

    def fn(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, segment_mask=jm, causal=causal, interpret=True)

    ref_o, vjp = jax.vjp(fn, *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    ref = [np.asarray(ref_o, np.float32)] + [np.asarray(g, np.float32)
                                             for g in vjp(jnp.asarray(do, jnp.float16))]
    tq, tk, tv = (torch.from_numpy(x).to(torch.float16).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask),
                              causal=causal)
    out.backward(torch.from_numpy(do).to(torch.float16))
    assert out.dtype == torch.float16 and all(t.grad.dtype == torch.float16 for t in (tq, tk, tv))
    got = [out.detach().float().numpy()] + [t.grad.float().numpy() for t in (tq, tk, tv)]
    return got, ref


@pytest.mark.parametrize("case", list(F16_CASES))
def test_plain_flash_f16_matches_jax_pallas_kernels(case):
    kw = dict(F16_CASES[case])
    causal, pad = kw.pop("causal"), kw.pop("pad", None)
    q, k, v, do = _inputs(**kw)
    mask = None
    if pad is not None:
        mask = np.ones(q.shape[:2], bool)
        mask[:, :pad] = False
    got, ref = _f16_flash_pair(q, k, v, do, mask, causal)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=4e-3)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=0, atol=8e-3 * max(float(np.abs(r).max()), 1.0))


def test_plain_flash_f16_overflows_where_jax_does():
    """dO scaled by 65536 (the loss scaler's default): dS = P (dP - δ) scale
    passes f16's 65504 and rounds to inf where it is cast for dS K and
    dSᵀ Q, in both packages, so the loss scaler sees the same overflow."""
    q, k, v, do = _inputs(seed=3)
    got, ref = _f16_flash_pair(q, k, v, do * 65536.0, None, True)
    overflowed = False
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r))
        overflowed = overflowed or not np.isfinite(r).all()
        finite = np.isfinite(r)
        if finite.any():
            np.testing.assert_allclose(g[finite], r[finite], rtol=0,
                                       atol=8e-3 * max(float(np.abs(r[finite]).max()), 1.0))
    assert overflowed
    assert np.isfinite(got[0]).all()
