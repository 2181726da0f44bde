"""The port's engine with its static operand buffers, its captured programs
and double-buffered dispatch, held against the JAX engine.

* Greedy tokens with ``async_dispatch`` on and off are identical to each
  other and to the JAX engine on the same ``params_from_jax`` weights, at
  f32 and int8 KV: mixed prompts with chunked prefill and a decode burst,
  an eos that lands mid-burst, a pool that runs dry (``out_of_blocks``),
  and ``stream()`` (the scenarios of ``tests/test_async_engine.py`` that
  the port carries).
* Queue C's C1: a burst or a padded prefill chunk that runs past the RoPE
  table gives JAX's tokens instead of raising.
* The capture preconditions the CPU can check: every decode and prefill
  operand keeps its ``data_ptr()`` across dispatches and holds the
  dispatch's operands; no capture happens on the CPU
  (``decode_compiles == prefill_compiles == 0``).
* ``serve --sync-engine`` and ``ACCELERATE_SYNC_ENGINE=1`` reach
  ``EngineConfig.async_dispatch``.
* On the card the training entry point refuses a head dim the flash
  kernels do not take, before any step (Queue C's C2b), checked here by the
  check alone.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import accelerate_tpu.serving as jserving  # noqa: E402
import accelerate_tpu_torch.serving as tserving  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

torch.set_num_threads(1)

GEOMETRY = dict(num_slots=3, block_size=8, max_seq_len=64, prefill_chunk=8, decode_burst=4)
PROMPT_LENS = (5, 11, 17, 3, 9)
BUDGETS = (6, 9, 4, 12, 7)
#: the JAX engine in the configuration the port carries
JAX_ONLY = dict(prefix_cache=False, per_slot_sampling=False, async_dispatch=False,
                flight_history=0, usage_accounting=False)


def _pair(jcfg):
    """The JAX model of ``jcfg`` and the port's copy of its weights."""
    jmodel = jllama.LlamaForCausalLM.from_config(jcfg, seed=0)
    fields = {f.name for f in dataclasses.fields(tllama.LlamaConfig)}
    tcfg = tllama.LlamaConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in fields})
    tmodel = tllama.LlamaForCausalLM(tcfg, device="cpu")
    tmodel.load_state_dict(
        tllama.params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params), tcfg)
    )
    return jmodel, tmodel


@pytest.fixture(scope="module")
def weights():
    """A GQA tiny llama (head dim 8)."""
    return _pair(dataclasses.replace(
        jllama.LlamaConfig.tiny(vocab_size=64, hidden_size=32, layers=2, heads=4, seq=96),
        num_key_value_heads=2,
    ))


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 64, size=n).astype(np.int32) for n in PROMPT_LENS]


def _port(tmodel, **kw):
    return tserving.InferenceEngine(tmodel, tserving.EngineConfig(**{**GEOMETRY, **kw}),
                                    device="cpu")


def _jax(jmodel, **kw):
    return jserving.InferenceEngine(jmodel, jserving.EngineConfig(**{**GEOMETRY, **JAX_ONLY, **kw}))


def _drive_mixed(engine, prompts):
    """Staggered arrivals: three requests, two steps, then two more, so
    admissions and prefill chunks land while a round is in flight."""
    reqs = [engine.add_request(p, b) for p, b in zip(prompts[:3], BUDGETS[:3])]
    for _ in range(2):
        engine.step()
    reqs += [engine.add_request(p, b) for p, b in zip(prompts[3:], BUDGETS[3:])]
    engine.run_until_idle(max_iterations=2000)
    return reqs


def _drive_out_of_blocks(engine, prompts):
    """4 usable blocks of 8: the long request admits with 3 and runs dry."""
    reqs = [engine.add_request(prompts[2], 40), engine.add_request(prompts[0], 8)]
    engine.run_until_idle(max_iterations=2000)
    return reqs


SCENARIOS = {
    "mixed": (_drive_mixed, {}),
    "out_of_blocks": (_drive_out_of_blocks, {"num_blocks": 5}),
}


def _outputs(reqs):
    return [(list(r.output_tokens), r.finish_reason) for r in reqs]


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_async_and_sync_tokens_identical_to_jax(weights, scenario, kv_dtype):
    jmodel, tmodel = weights
    drive, kw = SCENARIOS[scenario]
    prompts = _prompts()
    ref = _outputs(drive(_jax(jmodel, kv_dtype=kv_dtype, **kw), prompts))
    legs = {}
    for async_dispatch in (True, False):
        engine = _port(tmodel, kv_dtype=kv_dtype, async_dispatch=async_dispatch, **kw)
        legs[async_dispatch] = _outputs(drive(engine, prompts))
        stats = engine.stats()
        assert stats["allocated_blocks"] == 0 and engine._inflight is None
        assert stats["async_dispatch"] is async_dispatch
    assert legs[True] == legs[False] == ref
    if scenario == "out_of_blocks":
        assert ref[0][1] == "out_of_blocks"
    else:
        assert [len(t) for t, _ in ref] == list(BUDGETS)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_mid_burst_eos_identical_to_jax(weights, kv_dtype):
    """Request 1's third token is its eos: it lands in the middle of its
    first decode burst (token 0 comes from the prefill)."""
    jmodel, tmodel = weights
    prompts = _prompts()
    greedy = _outputs(_drive_mixed(_port(tmodel, kv_dtype=kv_dtype), prompts))
    eos = greedy[1][0][2]
    ref = _outputs(_drive_mixed(_jax(jmodel, kv_dtype=kv_dtype, eos_token_id=eos), prompts))
    for async_dispatch in (True, False):
        got = _outputs(_drive_mixed(
            _port(tmodel, kv_dtype=kv_dtype, eos_token_id=eos, async_dispatch=async_dispatch),
            prompts))
        assert got == ref
    stop = greedy[1][0].index(eos) + 1
    assert ref[1] == (greedy[1][0][:stop], "eos")


def test_stream_async_identical_to_jax(weights):
    jmodel, tmodel = weights
    prompt = _prompts()[3]
    ref = list(_jax(jmodel).stream(prompt, 11))
    engine = _port(tmodel)
    engine.add_request(_prompts()[0], 9)  # a neighbour decodes underneath
    assert list(engine.stream(prompt, 11)) == ref and len(ref) == 11
    engine.run_until_idle()
    assert list(_port(tmodel, async_dispatch=False).stream(prompt, 11)) == ref


def test_async_round_is_harvested_one_step_late(weights):
    """The round dispatched by a step stays in flight until the next step's
    harvest point; the synchronous loop lands it in the same step."""
    _, tmodel = weights
    prompt = _prompts()[0]
    for async_dispatch in (True, False):
        engine = _port(tmodel, async_dispatch=async_dispatch)
        req = engine.add_request(prompt, 9)
        engine.step()  # the whole prompt in one chunk, then the first burst
        assert len(req.output_tokens) == (1 if async_dispatch else 1 + GEOMETRY["decode_burst"])
        assert (engine._inflight is not None) is async_dispatch
        engine.step()
        assert len(req.output_tokens) == 1 + GEOMETRY["decode_burst"] * (
            1 if async_dispatch else 2)


# ---------------------------------------------------------------------------
# C1: positions past the RoPE table
# ---------------------------------------------------------------------------

C1_CASES = {
    # a burst runs 7 lane-steps past the table: 100 + 28 = 128 positions
    "burst": dict(seq=128, cfg=dict(max_seq_len=128, decode_burst=8), prompt=100, new=28),
    # the padded tail of the last chunk (positions 96..127) passes row 99
    "chunk": dict(seq=100, cfg=dict(max_seq_len=100, prefill_chunk=32), prompt=99, new=1),
}


@pytest.mark.parametrize("case", sorted(C1_CASES))
def test_positions_past_the_rope_table_give_jax_tokens(case):
    spec = C1_CASES[case]
    jmodel, tmodel = _pair(jllama.LlamaConfig.tiny(vocab_size=64, hidden_size=64, layers=2,
                                                   heads=4, seq=spec["seq"]))
    prompt = np.random.default_rng(2).integers(0, 64, size=spec["prompt"]).astype(np.int32)
    jengine = jserving.InferenceEngine(jmodel, jserving.EngineConfig(**spec["cfg"], **JAX_ONLY))
    jreq = jengine.add_request(prompt, spec["new"])
    jengine.run_until_idle(max_iterations=1000)
    for async_dispatch in (True, False):
        engine = tserving.InferenceEngine(
            tmodel, tserving.EngineConfig(**spec["cfg"], async_dispatch=async_dispatch),
            device="cpu")
        req = engine.add_request(prompt, spec["new"])
        engine.run_until_idle(max_iterations=1000)
        assert req.output_tokens == list(jreq.output_tokens)
        assert req.finish_reason == jreq.finish_reason == "length"
        assert len(req.output_tokens) == spec["new"]


def test_apply_rope_clamps_into_the_table():
    from accelerate_tpu_torch.ops.layers import apply_rope, rope_frequencies

    cos, sin = rope_frequencies(8, 4)
    x = torch.randn(1, 3, 2, 8)
    past = apply_rope(x, cos, sin, torch.tensor([[3, 4, 9]]))
    last = apply_rope(x, cos, sin, torch.tensor([[3, 3, 3]]))
    torch.testing.assert_close(past, last, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# static operands: what a CUDA graph needs of them
# ---------------------------------------------------------------------------


def _operand_ptrs(engine):
    ptrs = {f"decode.{k}": v.data_ptr() for k, v in engine._decode_ops.views.items()}
    ptrs.update({f"prefill.{k}": v.data_ptr() for k, v in engine._prefill_ops.views.items()})
    ptrs["decode.out"] = engine._decode_out.data_ptr()
    ptrs["prefill.out"] = engine._prefill_out.data_ptr()
    ptrs.update({f"pages.{k}": v.data_ptr() for k, v in engine._pages.items()})
    return ptrs


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_operands_keep_their_pointers_across_dispatches(weights, kv_dtype):
    _, tmodel = weights
    engine = _port(tmodel, kv_dtype=kv_dtype)
    prompts = _prompts()
    for p, b in zip(prompts[:3], (20, 20, 20)):
        engine.add_request(p, b)
    first = _operand_ptrs(engine)
    dispatches = 0
    while dispatches < 3:
        engine.step()
        if engine._inflight is not None:
            dispatches += 1
            assert _operand_ptrs(engine) == first
            ops = engine._decode_ops.views
            # the buffers hold this dispatch's operands
            np.testing.assert_array_equal(ops["tables"].numpy(), engine._block_tables)
            live = engine._inflight
            assert sorted(np.flatnonzero(ops["active"].numpy()[:, 0])) == sorted(
                r.slot for r in live)
            for r in live:
                assert ops["pos0"][r.slot] == r.context_len
    engine.run_until_idle()
    assert _operand_ptrs(engine) == first
    stats = engine.stats()
    assert stats["decode_compiles"] == stats["prefill_compiles"] == 0  # no capture on the CPU
    assert all(g["replays"] == 0 for g in stats["cuda_graphs"].values())
    assert stats["paged_attention_launches"] == stats["paged_attention_decode_launches"] == 0


def test_prefill_first_token_is_picked_at_the_last_index(weights):
    """The prefill program returns one token, picked at the static ``last``
    index; it equals the argmax of the paged step's logits there."""
    _, tmodel = weights
    engine = _port(tmodel)
    prompt = _prompts()[1]  # 11 ids: chunks of 8 and 3
    req = engine.add_request(prompt, 1)
    engine.run_until_idle()
    assert engine._prefill_ops.views["last"].item() == 2
    c = tmodel.config
    shape = (c.num_hidden_layers, 3, 8, c.num_key_value_heads, c.head_dim)
    out = tmodel.paged_step(torch.as_tensor(prompt)[None],
                            {"k": torch.zeros(shape), "v": torch.zeros(shape)},
                            torch.arange(1, 3, dtype=torch.int32)[None],
                            torch.zeros(1, dtype=torch.int32))
    assert req.output_tokens == [int(out.logits[0, -1].argmax())]


# ---------------------------------------------------------------------------
# config and CLI plumbing
# ---------------------------------------------------------------------------


def test_engine_config_defaults_match_jax():
    port, ref = tserving.EngineConfig(), jserving.EngineConfig()
    assert port.async_dispatch is ref.async_dispatch is True
    assert port.flight_history == ref.flight_history == 256


def test_serve_sync_engine_flag_and_env_reach_the_engine(monkeypatch):
    """``--sync-engine`` turns double-buffered dispatch off;
    ACCELERATE_SYNC_ENGINE=1 sets the default (0 or empty means async)."""
    from accelerate_tpu_torch.commands import serve
    from accelerate_tpu_torch.commands.accelerate_cli import build_parser

    def parse(*argv):
        return build_parser().parse_args(["serve", *argv])

    monkeypatch.delenv("ACCELERATE_SYNC_ENGINE", raising=False)
    assert parse().sync_engine is False
    assert parse("--sync-engine").sync_engine is True
    monkeypatch.setenv("ACCELERATE_SYNC_ENGINE", "1")
    assert parse().sync_engine is True
    engine = serve._make_engine(parse("--device", "cpu", "--max-seq-len", "64"))
    assert engine.config.async_dispatch is False
    monkeypatch.setenv("ACCELERATE_SYNC_ENGINE", "0")
    assert parse().sync_engine is False
    engine = serve._make_engine(parse("--device", "cpu", "--max-seq-len", "64"))
    assert engine.config.async_dispatch is True


def test_training_refuses_head_dims_the_flash_kernels_do_not_take():
    """C2b: on the card, ``prepare()`` refuses a model whose head dim B1-B3
    do not take, before any step; the CPU's plain attention takes any."""
    from accelerate_tpu_torch.accelerator import check_kernel_head_dim
    from accelerate_tpu_torch.ops.flash_attention import HEAD_DIMS

    tiny = tllama.LlamaForCausalLM.from_config(tllama.LlamaConfig.tiny(), device="cpu")
    assert tiny.config.head_dim == 16
    with pytest.raises(ValueError, match=r"head dims \(64, 128\)"):
        check_kernel_head_dim(tiny, torch.device("cuda"))
    check_kernel_head_dim(tiny, torch.device("cpu"))
    wide = tllama.LlamaForCausalLM.from_config(tllama.LlamaConfig.tiny(hidden_size=256),
                                               device="cpu")
    assert wide.config.head_dim == 64 and 64 in HEAD_DIMS
    check_kernel_head_dim(wide, torch.device("cuda"))
