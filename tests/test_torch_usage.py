"""The port's usage ledger (``serving/usage.py``, a copy of the JAX module)
and deadlines (``add_request(deadline_ms=)``, ``SlotScheduler.
expire_deadlines``) held against the JAX package.

* The module's functions give JAX's results: ``normalize_tenant``,
  ``cap_by_key`` and a ledger driven through the same edges.
* The conservation matrix of the JAX engine's own test: in every scenario
  (chunked prefill, a radix hit with copy-on-write, swap preemption, a
  deadline, speculative decoding), at f32 and int8 KV, with async dispatch
  on and off, the per-request decode shares sum to the ledger's
  ``device_wait`` total (which equals the flight recorder's, the same
  floats), and the per-request block-seconds to the pool integral.
* Deadlines run on a patched ``time.perf_counter`` (a clock the test moves
  between iterations), so nothing depends on the wall clock: the port
  finishes what the JAX engine finishes, in the same iteration, with the
  same partial output; async and sync ports agree; an expired queued
  request that owns swap handles releases them.
"""

import dataclasses
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu.serving import usage as jusage  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.serving import usage as tusage  # noqa: E402

torch.set_num_threads(1)

VOCAB = 64
GEOMETRY = dict(num_slots=3, block_size=8, max_seq_len=64, prefill_chunk=8)
JAX_EXTRAS = dict(async_dispatch=False, flight_history=0, usage_accounting=False)


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


def _prompts(seed, sizes=(5, 11, 17, 3, 9)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=n).tolist() for n in sizes]


# ---------------------------------------------------------------------------
# the module against JAX's
# ---------------------------------------------------------------------------


def test_normalize_tenant_and_cap_by_key_match_jax():
    for value in ("acme", "  acme  ", "", "   ", None, 7, "x" * 100, ["a"], "other"):
        assert tusage.normalize_tenant(value) == jusage.normalize_tenant(value)
    rng = np.random.default_rng(0)
    entries = {f"t{i}": {"device_seconds": float(rng.random()), "requests": int(i),
                         "tokens": 3 * i, "flag": True, "name": "x"} for i in range(12)}
    entries["other"] = {"device_seconds": 0.5, "requests": 1, "tokens": 2}
    entries["t3"]["device_seconds"] = entries["t4"]["device_seconds"]  # a tie, broken by name
    for top_k in (0, 3, 8, 20):
        assert tusage.cap_by_key(entries, top_k) == jusage.cap_by_key(entries, top_k)
    assert tusage.USAGE_SCHEMA == jusage.USAGE_SCHEMA
    assert tusage.DEFAULT_TOP_K == jusage.DEFAULT_TOP_K


class _Req:
    def __init__(self, rid, tenant, priority="interactive"):
        self.request_id, self.tenant, self.priority = rid, tenant, priority
        self.trace_id = None
        self.blocks, self.swap_plan, self.output_tokens = [], [], []
        self.finish_reason = None


def test_ledger_matches_jax_through_the_same_edges(monkeypatch):
    """Both ledgers driven through one edge sequence on one fake clock give
    the same snapshot and the same answer-row summaries."""
    clock = [100.0]
    monkeypatch.setattr("time.perf_counter", lambda: clock[0])
    ledgers = (jusage.UsageLedger(top_k=2), tusage.UsageLedger(top_k=2))
    reqs = [[_Req(i, f"t{i % 3}", ("interactive", "batch")[i % 2]) for i in range(5)]
            for _ in ledgers]
    summaries = ([], [])
    for led, rs in zip(ledgers, reqs):
        for r in rs:
            led.begin(r)
    for step in range(30):
        clock[0] += 0.25
        for side, (led, rs) in enumerate(zip(ledgers, reqs)):
            r = rs[step % 5]
            if step % 4 == 0:
                r.blocks = r.blocks + [step]
                led.update_blocks(r)
            if step % 7 == 3 and r.blocks:
                r.swap_plan = [(0, 1)]
                led.update_blocks(r)
                led.accrue_swap(r, bytes_out=4096)
            led.accrue_decode(0.01 * (step + 1), [(x.request_id, 1 + (x.request_id % 2))
                                                  for x in rs[:3]])
            led.accrue_prefill(r, 0.003)
            led.accrue_spec(r, 4, step % 5)
            led.accrue_grammar(r)
            if step == 20:
                r.output_tokens = [1, 2, 3]
                r.finish_reason = "length"
                summaries[side].append(led.finish(r))
                assert led.finish(r) is None  # exactly once
    clock[0] += 1.0
    assert summaries[1] == summaries[0]
    assert ledgers[1].snapshot() == ledgers[0].snapshot()
    ledgers[0].reset(), ledgers[1].reset()
    assert ledgers[1].snapshot() == ledgers[0].snapshot()


# ---------------------------------------------------------------------------
# conservation on the port's engine
# ---------------------------------------------------------------------------


def _conserved(snap, rel=1e-9):
    assert math.isclose(snap["decode_device_seconds"], snap["device_wait_seconds"],
                        rel_tol=rel, abs_tol=1e-12), snap
    assert math.isclose(snap["block_seconds"], snap["pool_block_seconds"],
                        rel_tol=rel, abs_tol=1e-12), snap


def _drive_mixed(eng):
    return [eng.add_request(p, 3 + 4 * i, tenant=f"t{i % 3}")
            for i, p in enumerate(_prompts(0))]


def _drive_radix_cow(eng):
    base = [i % 60 for i in range(20)]
    r1 = eng.add_request(base, 6, tenant="warm")
    eng.run_until_idle(max_iterations=5000)
    r2 = eng.add_request(base[:19] + [61], 6, tenant="hit")
    return [r1, r2]


def _drive_swap(eng):
    return [eng.add_request(list(range(i, i + 8)), 30, tenant=f"t{i}") for i in range(2)]


def _drive_deadline(eng):
    doomed = eng.add_request([5, 6, 7], 8, deadline_ms=0.001, tenant="doomed")
    return [doomed] + [eng.add_request(p, 6, tenant="survivor")
                       for p in _prompts(3, sizes=(5, 9))]


SCENARIOS = {
    "chunked_prefill": (_drive_mixed, dict(decode_burst=1)),
    "radix_cow": (_drive_radix_cow, dict(prefix_cache=True)),
    "swap_preempt": (_drive_swap, dict(num_slots=2, num_blocks=6, swap_gb=0.01,
                                       prefix_cache=False)),
    "deadline": (_drive_deadline, {}),
    "spec_k3": (_drive_mixed, dict(spec_k=3, draft="early_exit:1")),
}


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_conservation_matrix(weights, scenario, kv_dtype):
    _, tmodel = weights
    drive, cfg_kw = SCENARIOS[scenario]
    for async_dispatch in (True, False):
        eng = _port(tmodel, async_dispatch=async_dispatch, kv_dtype=kv_dtype, **cfg_kw)
        reqs = drive(eng)
        eng.run_until_idle(max_iterations=5000)
        stats = eng.stats()
        snap = stats["usage"]
        _conserved(snap)
        assert snap["requests_live"] == 0 and snap["requests_finished"] == len(reqs)
        # the ledger's decode total is the flight recorder's device_wait
        assert math.isclose(snap["device_wait_seconds"],
                            eng._flight.phase_totals_s["device_wait"],
                            rel_tol=1e-9, abs_tol=1e-12)
        for r in reqs:
            assert r.usage is not None and r.usage["device_time_s"] >= 0.0
            assert r.usage["kv_block_seconds"] >= 0.0
        if scenario == "swap_preempt":
            assert stats["preemptions"] >= 1 and snap["swap_bytes"] > 0
            assert sum(v["swap_bytes"] for v in snap["by_tenant"].values()) == snap["swap_bytes"]
        elif scenario == "deadline":
            assert reqs[0].finish_reason == "deadline_exceeded" and reqs[0].usage is not None
            assert "doomed" in snap["by_tenant"]
        elif scenario == "spec_k3":
            assert snap["spec_drafted_tokens"] == stats["spec_drafted_tokens"] > 0
        elif scenario == "radix_cow":
            assert stats["prefix_hit_tokens"] > 0
            assert all(v["block_seconds"] > 0 for v in snap["by_tenant"].values())


def test_flight_disabled_engine_stamps_its_own_device_wait(weights):
    _, tmodel = weights
    for async_dispatch in (True, False):
        eng = _port(tmodel, async_dispatch=async_dispatch, flight_history=0)
        reqs = _drive_mixed(eng)
        eng.run_until_idle(max_iterations=5000)
        snap = eng.stats()["usage"]
        _conserved(snap)
        assert snap["device_wait_seconds"] > 0 and all(r.usage for r in reqs)


def test_tenant_round_trip_and_disabled_path(weights):
    _, tmodel = weights
    eng = _port(tmodel)
    reqs = [eng.add_request([1 + i, 2, 3], 4, tenant=t)
            for i, t in enumerate(("acme", "  acme  ", None, ""))]
    eng.run_until_idle(max_iterations=5000)
    assert [r.tenant for r in reqs] == ["acme", "acme", "default", "default"]
    by = eng.stats()["usage"]["by_tenant"]
    assert by["acme"]["requests"] == 2 and by["default"]["requests"] == 2
    off = _port(tmodel, usage_accounting=False)
    assert off.usage is None
    req = off.add_request([1, 2, 3], 4, tenant="acme")
    off.run_until_idle(max_iterations=5000)
    assert req.tenant == "acme" and req.usage is None and "usage" not in off.stats()


# ---------------------------------------------------------------------------
# deadlines on a test-driven clock
# ---------------------------------------------------------------------------


class _Clock:
    """``time.perf_counter`` for both engines: it stands still inside an
    iteration and the test moves it between iterations."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _step_log(engine, clock, reqs, iterations=60, tick=0.010):
    """Step until idle; returns ``{request index: (iteration it finished,
    tokens, finish reason)}``."""
    done = {}
    for it in range(iterations):
        if not (engine.scheduler.has_work() or engine._inflight is not None):
            break  # the JAX engine has no has_work()
        for req in engine.step():
            done[next(i for i, r in enumerate(reqs) if r is req)] = (
                it, list(req.output_tokens), req.finish_reason)
        clock.now += tick
    return done


def _deadline_batch(engine):
    prompts = _prompts(5, sizes=(6, 10, 4, 13))
    # 25 ms: running, expires mid-decode; 5 ms: expires in prefill; 500 ms:
    # finishes; 15 ms: queued behind the three slots, expires waiting
    budgets = (25.0, 5.0, 500.0, 15.0)
    return [engine.add_request(p, 20, deadline_ms=d) for p, d in zip(prompts, budgets)]


def test_deadlines_finish_what_jax_finishes_in_the_same_iteration(weights, monkeypatch):
    jmodel, tmodel = weights
    clock = _Clock()
    monkeypatch.setattr("time.perf_counter", clock)
    logs = []
    for make in (lambda: _jax(jmodel, per_slot_sampling=False, decode_burst=2),
                 lambda: _port(tmodel, async_dispatch=False, decode_burst=2)):
        clock.now = 1000.0
        engine = make()
        reqs = _deadline_batch(engine)
        logs.append(_step_log(engine, clock, reqs))
    jlog, tlog = logs
    assert tlog == jlog
    reasons = {i: r for i, (_, _, r) in tlog.items()}
    assert reasons == {0: "deadline_exceeded", 1: "deadline_exceeded", 2: "length",
                       3: "deadline_exceeded"}
    assert tlog[0][1] and not tlog[3][1]  # partial output kept; the queued one had none
    # async dispatch defers an in-flight member's expiry to the harvest
    # point: the same tokens (one iteration later), the same reasons
    clock.now = 1000.0
    engine = _port(tmodel, decode_burst=2)
    alog = _step_log(engine, clock, _deadline_batch(engine))
    assert {i: v[1:] for i, v in alog.items()} == {i: v[1:] for i, v in tlog.items()}
    assert engine.stats()["deadline_expired_total"] == 3
    assert engine.stats()["allocated_blocks"] == 0


def test_add_request_deadline_validation_matches_jax(weights):
    jmodel, tmodel = weights
    jeng, teng = _jax(jmodel), _port(tmodel)
    for bad in (0, -5, "soon", float("nan"), [1]):
        with pytest.raises(ValueError) as ref:
            jeng.add_request([1, 2], 4, deadline_ms=bad)
        with pytest.raises(ValueError) as got:
            teng.add_request([1, 2], 4, deadline_ms=bad)
        assert str(got.value) == str(ref.value)
    assert teng.add_request([1, 2], 4, deadline_ms="250").deadline is not None
    assert teng.scheduler.deadline_live == 1


def test_expired_queued_request_releases_its_swap_handles(weights, monkeypatch):
    """A preempted request waits in the queue with swap handles; its deadline
    passes there: the handles and its references on shared blocks go back,
    and the survivor finishes untruncated."""
    _, tmodel = weights
    clock = _Clock()
    monkeypatch.setattr("time.perf_counter", clock)
    eng = _port(tmodel, async_dispatch=False, num_slots=2, num_blocks=6, swap_gb=0.01,
                prefix_cache=False, decode_burst=2)
    keep = eng.add_request(list(range(8)), 30)
    doomed = eng.add_request(list(range(1, 9)), 30, deadline_ms=10_000)
    for _ in range(200):
        eng.step()
        clock.now += 0.001
        if doomed.preemptions and doomed.swap_plan:
            break
    assert doomed.swap_plan and doomed.slot is None
    assert eng.stats()["swap_used_blocks"] > 0
    clock.now += 20.0  # past the deadline while it waits
    eng.run_until_idle(max_iterations=5000)
    assert doomed.finish_reason == "deadline_exceeded" and doomed.swap_plan == []
    assert keep.finish_reason == "length" and len(keep.output_tokens) == 30
    st = eng.stats()
    assert st["swap_used_blocks"] == 0 and st["allocated_blocks"] == 0
    _conserved(st["usage"])
