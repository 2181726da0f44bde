"""The port's swap preemption (``serving/radix.py`` ``SwapPool``, the
scheduler's ``pick_victim``/``requeue_preempted`` and the engine's
``_swap_out``, restore and swap-then-truncate ladder) held against the JAX
engine on the same ``params_from_jax`` weights.

* ``SwapPool`` runs in lockstep with JAX's: the same capacity and bytes a
  block, the same handles, the same rows back byte for byte (scales too when
  quantized), the same errors.
* A 9-block pool with ``swap_gb`` gives the JAX engine's tokens, finish
  reasons and swap counters (both engines synchronous, so they schedule
  alike), at f32 and int8 KV, with the prefix cache on and off; the tokens
  equal a full-residency run's, and the async engine gives the same.
* Priority: an interactive arrival swaps out the youngest batch request,
  the same one JAX picks, never itself.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.serving import radix as jradix  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.serving import radix as tradix  # noqa: E402

torch.set_num_threads(1)

VOCAB = 64
GEOMETRY = dict(num_slots=3, block_size=8, max_seq_len=64, prefill_chunk=8, decode_burst=4)
JAX_EXTRAS = dict(async_dispatch=False, flight_history=0, usage_accounting=False)
SWAP_KEYS = ("preemptions", "swapped_out_blocks", "swapped_in_blocks", "out_of_blocks_total",
             "swap_used_blocks", "swap_capacity_blocks", "swap_pool_host_bytes",
             "allocated_blocks")


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=32, layers=2, heads=4, seq=96),
        num_key_value_heads=2,
    )
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg))
    return jmodel, tmodel


def _port(tmodel, **kw):
    return tserving.InferenceEngine(tmodel, tserving.EngineConfig(**{**GEOMETRY, **kw}),
                                    device="cpu")


def _jax(jmodel, **kw):
    return jserving.InferenceEngine(
        jmodel, jserving.EngineConfig(**{**GEOMETRY, **JAX_EXTRAS, **kw}))


@pytest.mark.parametrize("quantized", [False, True])
def test_swap_pool_lockstep_with_jax(quantized):
    store_t, store_j = (torch.int8, np.int8) if quantized else (torch.float32, np.float32)
    args = dict(num_layers=2, block_size=4, num_kv_heads=2, head_dim=8, capacity_gb=5e-6,
                quantized=quantized)
    jp = jradix.SwapPool(dtype=store_j, **args)
    tp = tradix.SwapPool(dtype=store_t, **args)
    assert (tp.capacity_blocks, tp.bytes_per_block) == (jp.capacity_blocks, jp.bytes_per_block)
    assert tp.capacity_blocks >= 3
    rng = np.random.default_rng(0)
    held = []
    for step in range(3 * tp.capacity_blocks):
        if held and (step % 3 == 2 or not jp.can_hold(1)):
            h = held.pop(0)
            rows_j, rows_t = jp.load(h), tp.load(h)
            for a, b in zip(rows_j, rows_t):
                if a is None:
                    assert b is None
                else:
                    assert b.numpy().tobytes() == np.asarray(a).tobytes()
            jp.release(h)
            tp.release(h)
        else:
            k = (rng.normal(size=(2, 4, 2, 8)) * 40).astype(store_j)
            v = (rng.normal(size=(2, 4, 2, 8)) * 40).astype(store_j)
            sc = [rng.random((2, 4, 2)).astype(np.float32) for _ in range(2)] if quantized \
                else [None, None]
            h = jp.store(k, v, *sc)
            assert tp.store(torch.from_numpy(k), torch.from_numpy(v),
                            *(None if x is None else torch.from_numpy(x) for x in sc)) == h
            held.append(h)
        assert (tp.used_blocks, tp.free_blocks) == (jp.used_blocks, jp.free_blocks)
        assert tp.can_hold(2) == jp.can_hold(2)
    for pool in (jp, tp):
        with pytest.raises(ValueError, match="double release of swap handle"):
            pool.release(10_000)
        with pytest.raises(ValueError, match="is not held"):
            pool.load(10_000)
    while jp.can_hold(1):
        jp.store(np.zeros((2, 4, 2, 8), store_j), np.zeros((2, 4, 2, 8), store_j),
                 *([np.ones((2, 4, 2), np.float32)] * 2 if quantized else []))
        tp.store(torch.zeros((2, 4, 2, 8), dtype=store_t), torch.zeros((2, 4, 2, 8), dtype=store_t),
                 *([torch.ones((2, 4, 2))] * 2 if quantized else []))
    for pool, zeros in ((jp, np.zeros((2, 4, 2, 8), store_j)),
                        (tp, torch.zeros((2, 4, 2, 8), dtype=store_t))):
        with pytest.raises(RuntimeError, match="swap pool exhausted"):
            pool.store(zeros, zeros, *([zeros[..., 0]] * 2 if quantized else []))
    if quantized:
        with pytest.raises(ValueError, match="needs scale rows"):
            tradix.SwapPool(dtype=store_t, **args).store(torch.zeros((2, 4, 2, 8), dtype=store_t),
                                                         torch.zeros((2, 4, 2, 8), dtype=store_t))


def _prompts():
    return [list(range(i, i + 8)) for i in range(3)]


def _run(engine, budgets=(30, 30, 30)):
    reqs = [engine.add_request(p, b) for p, b in zip(_prompts(), budgets)]
    engine.run_until_idle(max_iterations=5000)
    return reqs


@pytest.mark.parametrize("kv_dtype,prefix_cache", [("f32", False), ("f32", True),
                                                    ("int8", False)])
def test_nine_block_pool_swaps_like_jax(weights, kv_dtype, prefix_cache):
    """Three requests that each need 5 blocks, in 8 usable blocks: swap
    preemption completes every one of them untruncated, with JAX's tokens
    and counters, and the full-residency run's tokens."""
    jmodel, tmodel = weights
    kw = dict(kv_dtype=kv_dtype, prefix_cache=prefix_cache, num_blocks=9, swap_gb=0.01)
    teng = _port(tmodel, async_dispatch=False, **kw)
    jeng = _jax(jmodel, per_slot_sampling=False, **kw)
    treqs, jreqs = _run(teng), _run(jeng)
    tokens = [(list(r.output_tokens), r.finish_reason) for r in jreqs]
    assert [(list(r.output_tokens), r.finish_reason) for r in treqs] == tokens
    assert [r.finish_reason for r in treqs] == ["length"] * 3
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    ts, js = teng.stats(), jeng.stats()
    assert {k: ts[k] for k in SWAP_KEYS} == {k: js[k] for k in SWAP_KEYS}
    assert ts["preemptions"] >= 1 and ts["swapped_out_blocks"] == ts["swapped_in_blocks"] > 0
    assert ts["swap_used_blocks"] == 0  # every handle came home
    full = [(list(r.output_tokens), r.finish_reason)
            for r in _run(_port(tmodel, kv_dtype=kv_dtype, prefix_cache=prefix_cache))]
    assert full == tokens
    async_reqs = _run(_port(tmodel, **kw))
    assert [(list(r.output_tokens), r.finish_reason) for r in async_reqs] == tokens
    # without the swap tier the same pool truncates, as JAX's does
    no_swap = _run(_port(tmodel, async_dispatch=False, **{**kw, "swap_gb": 0.0}))
    assert any(r.finish_reason == "out_of_blocks" for r in no_swap)


def test_priority_victims_match_jax(weights):
    """An interactive arrival under pool pressure swaps out a batch request,
    the one JAX's engine picks, never another interactive one or itself."""
    jmodel, tmodel = weights
    kw = dict(num_slots=2, prefix_cache=False, num_blocks=8, swap_gb=0.01)

    def drive(engine):
        b1 = engine.add_request(list(range(8)), 20, priority="batch")
        b2 = engine.add_request(list(range(2, 10)), 20, priority="batch")
        for _ in range(4):
            engine.step()
        i1 = engine.add_request(list(range(5, 13)), 8, priority="interactive")
        engine.run_until_idle(max_iterations=5000)
        return [b1, b2, i1], engine.stats()

    (tb1, tb2, ti1), ts = drive(_port(tmodel, async_dispatch=False, **kw))
    (jb1, jb2, ji1), js = drive(_jax(jmodel, per_slot_sampling=False, **kw))
    assert [r.preemptions for r in (tb1, tb2, ti1)] == [r.preemptions for r in (jb1, jb2, ji1)]
    assert ti1.preemptions == 0 and tb1.preemptions + tb2.preemptions == ts["preemptions"] >= 1
    assert [list(r.output_tokens) for r in (tb1, tb2, ti1)] == [
        list(r.output_tokens) for r in (jb1, jb2, ji1)]
    assert all(r.finish_reason == "length" for r in (tb1, tb2, ti1))
    assert {k: ts[k] for k in SWAP_KEYS} == {k: js[k] for k in SWAP_KEYS}
