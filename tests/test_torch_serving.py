"""The port's serving stack (``accelerate_tpu_torch/serving/`` and the
``serve`` command) held against the JAX package.

* The block allocator and the slot scheduler are copies of the JAX
  modules: every unit case runs against both.
* The engine's greedy tokens are **identical** to the JAX
  ``InferenceEngine`` on the same weights (the JAX engine in its
  synchronous, single-lane, no-prefix-cache configuration — the path the
  port carries), over mixed-length prompts with chunked prefill and a
  decode burst, at f32 and int8 KV. A mismatch reports the top-2 logit
  margin of the port at the step where the streams part.
* ``serve --device cpu`` answers stdin JSONL rows (a ``trace_id`` is
  echoed); without ``--device cpu`` on a box with no card the engine
  refuses to start.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402
from accelerate_tpu_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = pytest.mark.parametrize("pkg", [jserving, tserving], ids=["jax", "port"])

# ---------------------------------------------------------------------------
# block freelist and slot scheduler: the same cases on both packages
# ---------------------------------------------------------------------------


@PACKAGES
def test_allocator_accounting_no_leak(pkg):
    alloc = pkg.BlockAllocator(num_blocks=9)
    assert alloc.free_count == 8
    a, b = alloc.allocate(3), alloc.allocate(5)
    assert alloc.free_count == 0 and alloc.allocated_count == 8
    assert not alloc.can_allocate(1)
    alloc.free(a)
    alloc.free(b)
    assert alloc.free_count == 8 and alloc.allocated_count == 0
    assert pkg.NULL_BLOCK not in a + b


@PACKAGES
def test_allocator_rejects_double_free_null_and_overdraft(pkg):
    alloc = pkg.BlockAllocator(num_blocks=4)
    blocks = alloc.allocate(2)
    alloc.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        alloc.free(blocks)
    with pytest.raises(ValueError, match="null block"):
        alloc.free([0])
    with pytest.raises(RuntimeError, match="out of KV blocks"):
        alloc.allocate(4)


@PACKAGES
def test_allocator_refcounts(pkg):
    alloc = pkg.BlockAllocator(num_blocks=5)
    blocks = alloc.allocate(2)
    alloc.incref(blocks)
    with pytest.raises(ValueError, match="shared"):
        alloc.free(blocks)
    assert alloc.decref(blocks) == [] and alloc.decref(blocks) == blocks
    assert alloc.free_count == 4


@PACKAGES
def test_blocks_needed(pkg):
    assert [pkg.blocks_needed(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]


def _sched(pkg, num_slots=2, num_blocks=9, block_size=8, max_seq=32):
    return pkg.SlotScheduler(num_slots, pkg.BlockAllocator(num_blocks), block_size, max_seq)


@PACKAGES
def test_scheduler_fcfs_admission_and_eviction(pkg):
    sched = _sched(pkg)
    reqs = [sched.submit(pkg.Request(prompt=[1] * 4, max_new_tokens=4)) for _ in range(3)]
    admitted = sched.admit()
    assert [r.request_id for r in admitted] == [r.request_id for r in reqs[:2]]
    assert sched.queue_depth == 1 and sched.occupancy == 1.0
    assert all(r.state is pkg.RequestState.PREFILL and r.blocks for r in admitted)
    admitted[0].state = pkg.RequestState.FINISHED
    assert sched.evict_finished() == [reqs[0]] and admitted[0].blocks == []
    assert sched.admit() == [reqs[2]] and reqs[2].slot == 0


@PACKAGES
def test_scheduler_admission_bounded_by_freelist(pkg):
    sched = _sched(pkg, num_slots=3, num_blocks=5)
    for _ in range(3):
        sched.submit(pkg.Request(prompt=[1] * 9, max_new_tokens=4))
    assert len(sched.admit()) == 2 and sched.queue_depth == 1


@PACKAGES
def test_scheduler_rejects_what_can_never_run(pkg):
    sched = _sched(pkg, max_seq=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        sched.submit(pkg.Request(prompt=[1] * 10, max_new_tokens=10))
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(pkg.Request(prompt=[], max_new_tokens=2))
    with pytest.raises(ValueError, match="priority"):
        sched.submit(pkg.Request(prompt=[1], max_new_tokens=2, priority="urgent"))
    small = _sched(pkg, num_blocks=4, max_seq=64)
    with pytest.raises(ValueError, match="KV blocks"):
        small.submit(pkg.Request(prompt=[1] * 40, max_new_tokens=4))


@PACKAGES
def test_priority_admission_order(pkg):
    sched = _sched(pkg, num_slots=3)
    b1 = sched.submit(pkg.Request(prompt=[1] * 4, max_new_tokens=4, priority="batch"))
    b2 = sched.submit(pkg.Request(prompt=[2] * 4, max_new_tokens=4, priority="batch"))
    i1 = sched.submit(pkg.Request(prompt=[3] * 4, max_new_tokens=4))
    assert [r.request_id for r in sched.admit()] == [r.request_id for r in (i1, b1, b2)]


@PACKAGES
def test_grow_for_decode(pkg):
    sched = _sched(pkg, num_slots=1, num_blocks=3, max_seq=64)
    req = sched.submit(pkg.Request(prompt=[1] * 8, max_new_tokens=4))
    sched.admit()
    req.prefill_pos, req.output_tokens = 8, [1] * 3
    assert sched.grow_for_decode(req, tokens_ahead=8) and len(req.blocks) == 2  # budget cap
    sched = _sched(pkg, num_slots=1, num_blocks=9, max_seq=64)
    req = sched.submit(pkg.Request(prompt=[1] * 8, max_new_tokens=40))
    sched.admit()
    req.prefill_pos, req.output_tokens = 8, [1] * 9
    assert sched.grow_for_decode(req, tokens_ahead=1) and len(req.blocks) == 3
    assert sched.grow_for_decode(req, tokens_ahead=16) and len(req.blocks) == 4
    sched.allocator.allocate(sched.allocator.free_count)
    req.output_tokens = [1] * 21  # context 28: a burst of 8 needs a fifth block
    assert not sched.grow_for_decode(req, tokens_ahead=8)  # pool exhausted


# ---------------------------------------------------------------------------
# engine: greedy tokens identical to the JAX engine on the same weights
# ---------------------------------------------------------------------------

GEOMETRY = dict(num_slots=3, block_size=8, max_seq_len=64, prefill_chunk=8, decode_burst=4)
PROMPT_LENS = (5, 11, 17, 3)
BUDGETS = (6, 9, 4, 12)


@pytest.fixture(scope="module")
def weights():
    """A GQA tiny llama: the JAX model and the port's copy of its weights."""
    jcfg = dataclasses.replace(
        jllama.LlamaConfig.tiny(vocab_size=64, hidden_size=32, layers=2, heads=4, seq=96),
        num_key_value_heads=2,
    )
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg)
    )
    return jmodel, tmodel


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 64, size=n).astype(np.int32) for n in PROMPT_LENS]


def _run(engine, prompts):
    reqs = [engine.add_request(p, b) for p, b in zip(prompts, BUDGETS)]
    done = engine.run_until_idle(max_iterations=2000)
    assert len(done) == len(reqs)
    return [list(r.output_tokens) for r in reqs]


def _top2_margin(model, prompt, tokens) -> float:
    """The port's top-2 logit gap after ``prompt + tokens`` (one f32
    prefill chunk through the plain paged step): how close to a tie the
    pick was where the two engines parted."""
    c = model.config
    ids = torch.as_tensor(np.concatenate([prompt, np.asarray(tokens, np.int32)]))[None]
    n = ids.shape[1]
    mb = -(-n // 8)
    shape = (c.num_hidden_layers, mb + 1, 8, c.num_key_value_heads, c.head_dim)
    out = model.paged_step(ids, {"k": torch.zeros(shape), "v": torch.zeros(shape)},
                           torch.arange(1, mb + 1, dtype=torch.int32)[None],
                           torch.zeros(1, dtype=torch.int32))
    top = torch.topk(out.logits[0, -1], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_engine_greedy_tokens_identical_to_jax(weights, kv_dtype):
    jmodel, tmodel = weights
    prompts = _prompts()
    jengine = jserving.InferenceEngine(jmodel, jserving.EngineConfig(
        **GEOMETRY, kv_dtype=kv_dtype, prefix_cache=False, per_slot_sampling=False,
        async_dispatch=False, flight_history=0, usage_accounting=False,
    ))
    tengine = tserving.InferenceEngine(
        tmodel, tserving.EngineConfig(**GEOMETRY, kv_dtype=kv_dtype), device="cpu"
    )
    ref, got = _run(jengine, prompts), _run(tengine, prompts)
    for i, (g, r) in enumerate(zip(got, ref)):
        if g != r:
            t = next((j for j, (a, b) in enumerate(zip(g, r)) if a != b), min(len(g), len(r)))
            margin = _top2_margin(tmodel, prompts[i], g[:t])
            pytest.fail(f"request {i} parts from JAX at token {t}: port {g} vs jax {r}; "
                        f"port top-2 logit margin there {margin:.3e}")
    assert [len(g) for g in got] == list(BUDGETS)
    stats = tengine.stats()
    assert stats["completed"] == len(prompts) and stats["allocated_blocks"] == 0
    assert stats["kv_dtype"] == ("float32" if kv_dtype == "f32" else "int8")
    assert stats["kv_bytes_per_token"] == jengine.stats()["kv_bytes_per_token"]
    assert stats["paged_attention_launches"] == 0  # the plain version on the CPU
    assert stats["tokens_emitted"] == sum(BUDGETS)


def test_engine_eos_stream_and_out_of_blocks(weights):
    _, tmodel = weights
    prompts = _prompts()
    greedy = _run(tserving.InferenceEngine(
        tmodel, tserving.EngineConfig(**GEOMETRY), device="cpu"), prompts)
    eos = greedy[1][2]  # request 1's third token
    engine = tserving.InferenceEngine(
        tmodel, tserving.EngineConfig(**GEOMETRY, eos_token_id=eos), device="cpu")
    req = engine.add_request(prompts[1], BUDGETS[1])
    engine.run_until_idle()
    stop = greedy[1].index(eos) + 1
    assert req.output_tokens == greedy[1][:stop] and req.finish_reason == "eos"
    streamed = list(tserving.InferenceEngine(
        tmodel, tserving.EngineConfig(**GEOMETRY), device="cpu").stream(prompts[2], BUDGETS[2]))
    assert streamed == greedy[2]
    # 4 usable blocks of 8: the prompt admits with 2, growth runs dry at 32
    tight = tserving.InferenceEngine(
        tmodel, tserving.EngineConfig(**{**GEOMETRY, "num_blocks": 5}), device="cpu")
    req = tight.add_request(prompts[2], 40)
    tight.add_request(prompts[0], 8)
    tight.run_until_idle()
    assert req.finish_reason == "out_of_blocks"
    assert tight.stats()["out_of_blocks_total"] >= 1 and tight.stats()["allocated_blocks"] == 0


def test_engine_refuses_unported_request_fields(weights):
    """Every ``add_request`` option of the JAX engine is ported now (request
    tracing landed): ``trace_id`` survives when well formed and is generated
    otherwise, as in JAX; an option neither engine has still raises."""
    _, tmodel = weights
    engine = tserving.InferenceEngine(tmodel, tserving.EngineConfig(**GEOMETRY), device="cpu")
    kept = engine.add_request([1, 2, 3], 4, trace_id="0af7651916cd43dd", upstream_hop=True)
    assert kept.trace_id == "0af7651916cd43dd"
    made = engine.add_request([1, 2, 3], 4, trace_id={"x": 1})
    assert isinstance(made.trace_id, str) and len(made.trace_id) == 16
    with pytest.raises(TypeError, match="unexpected keyword"):
        engine.add_request([1, 2, 3], 4, beam_width=2)
    engine.add_request([1, 2, 3], 4, sampling=None)  # unset: served as usual
    assert engine.scheduler.queue_depth == 3


def test_engine_without_a_device_needs_cuda(weights):
    _, tmodel = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserving.InferenceEngine(tmodel, tserving.EngineConfig(**GEOMETRY))


def test_engine_sampling_is_seeded(weights):
    _, tmodel = weights
    prompts = _prompts()

    def sample(seed):
        cfg = tserving.EngineConfig(**GEOMETRY, do_sample=True, temperature=1.5, seed=seed)
        return _run(tserving.InferenceEngine(tmodel, cfg, device="cpu"), prompts)

    first = sample(7)
    assert sample(7) == first and sample(8) != first


def test_cpu_engine_launches_no_kernel(weights):
    _, tmodel = weights
    before = tpa.launches
    _run(tserving.InferenceEngine(tmodel, tserving.EngineConfig(**GEOMETRY), device="cpu"),
         _prompts())
    assert tpa.launches == before


# ---------------------------------------------------------------------------
# serve: stdin JSONL through the entry point
# ---------------------------------------------------------------------------


def _serve(args, rows, timeout=240):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    stdin = "".join((r if isinstance(r, str) else json.dumps(r)) + "\n" for r in rows)
    proc = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", "serve", *args],
                          input=stdin, capture_output=True, text=True, cwd=REPO,
                          timeout=timeout, env=env)
    return proc, [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]


def test_serve_cpu_answers_jsonl_rows():
    rows = [
        {"id": "a", "prompt": [1, 2, 3, 4, 5], "max_new_tokens": 6},
        {"id": "b", "prompt": list(range(40)), "max_new_tokens": 3, "priority": "batch"},
        {"id": "c", "prompt": [9, 9], "trace_id": "0af7651916cd43dd8448eb211c80319c"},
        {"id": "d", "prompt": [1] * 200, "max_new_tokens": 4},
        "{not json",
        {"id": "e", "prompt": [9, 9], "max_new_tokens": 5,
         "sampling": {"do_sample": True, "temperature": 0.5, "seed": 4}},
        {"id": "f", "prompt": [7, 8, 9], "max_new_tokens": 4, "tenant": " acme ",
         "deadline_ms": 600000},
    ]
    proc, out = _serve(["--device", "cpu", "--preset", "tiny", "--max-seq-len", "128",
                        "--prefill-chunk", "16", "--decode-burst", "4"], rows)
    assert proc.returncode == 0, proc.stderr
    by_id = {r.get("id"): r for r in out}
    assert len(by_id["a"]["tokens"]) == 6 and by_id["a"]["finish_reason"] == "length"
    assert len(by_id["b"]["tokens"]) == 3 and by_id["b"]["prompt_tokens"] == 40
    assert all(0 <= t < 256 for t in by_id["a"]["tokens"] + by_id["b"]["tokens"])
    assert by_id["c"]["trace_id"] == "0af7651916cd43dd8448eb211c80319c"
    assert len(by_id["c"]["tokens"]) >= 1 and "error" not in by_id["c"]
    assert "max_seq_len" in by_id["d"]["error"]
    assert any("bad JSON" in r.get("error", "") for r in out)
    assert len(by_id["e"]["tokens"]) == 5 and by_id["e"]["finish_reason"] == "length"
    # a tenant and a deadline are served; the row echoes the tenant and the
    # usage ledger's costs
    assert by_id["f"]["tenant"] == "acme" and by_id["a"]["tenant"] == "default"
    assert len(by_id["f"]["tokens"]) == 4 and by_id["f"]["finish_reason"] == "length"
    assert by_id["f"]["device_time_s"] > 0 and by_id["f"]["swap_bytes"] == 0
    assert "served 5 requests" in proc.stderr
    assert "paged_attention launches 0" in proc.stderr


def test_serve_defaults_to_the_card_and_refuses_without_one():
    proc, out = _serve(["--preset", "tiny"], [], timeout=120)
    assert proc.returncode == 2
    assert "device='cpu'" in out[0]["error"]


def test_pick_next_token_matches_jax_greedy_and_eos():
    """Greedy takes the first maximal index in both packages (ties
    included); finished rows keep emitting eos."""
    from accelerate_tpu import generation as jgen
    from accelerate_tpu_torch import generation as tgen

    logits = np.asarray([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 0.0, 3.0], [0.0, 0.0, 0.0, 1.0]],
                        np.float32)
    finished = np.asarray([False, True, False])
    jtok, _, jfin = jgen.pick_next_token(jax.numpy.asarray(logits), jax.random.PRNGKey(0),
                                         finished, 3, 1.0, False, True)
    ttok, tfin = tgen.pick_next_token(torch.from_numpy(logits), None,
                                      torch.from_numpy(finished), 3, 1.0, False, True)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    assert tgen.scale_logits(torch.ones(2), 0.0).tolist() == [1e6, 1e6]  # the shared floor
