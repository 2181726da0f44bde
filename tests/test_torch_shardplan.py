"""The port's HBM pre-flight (``accelerate_tpu_torch/analysis/shardplan.py``,
``InferenceEngine(hbm_budget_gb=)``, ``serve --auto-blocks``) against the
JAX package's on the same configurations.

``engine_preflight`` must give JAX's ``params_bytes``, ``pool_bytes``,
``total_bytes`` and swap-tier bytes, and ``--auto-blocks`` JAX's
``num_blocks``, for the tiny preset and the flagship, in f32 and bf16, for
every kv dtype, with swap on and off. The JAX flagship's params are built
with ``jax.eval_shape`` and the port's on the ``meta`` device, so neither
allocates 700M parameters here. The port's SP004 refuses where JAX's does,
before any pool allocates; the speculative draft is where the two differ
(see :func:`test_the_early_exit_draft_adds_no_bytes`).
"""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu.analysis import shardplan as jshard  # noqa: E402
from accelerate_tpu.commands import serve as jserve_cmd  # noqa: E402
from accelerate_tpu.models import llama as jllama  # noqa: E402
from accelerate_tpu_torch.analysis import shardplan as tshard  # noqa: E402
from accelerate_tpu_torch.commands import serve as tserve_cmd  # noqa: E402
from accelerate_tpu_torch.models import llama as tllama  # noqa: E402

KV_DTYPES = ("auto", "f32", "bf16", "int8", "fp8")
#: the JAX and the torch storage dtype of each kv policy, per params dtype
_STORE = {
    "f32": (np.dtype("float32"), torch.float32),
    "bf16": (np.dtype(jnp.bfloat16), torch.bfloat16),
    "int8": (np.dtype("int8"), torch.int8),
    "fp8": (np.dtype(jnp.float8_e4m3fn), torch.float8_e4m3fn),
}


def _configs(preset):
    if preset == "tiny":
        kw = dict(vocab_size=256, hidden_size=64, layers=2, heads=4, seq=1024)
        return jllama.LlamaConfig.tiny(**kw), tllama.LlamaConfig.tiny(**kw)
    return jllama.LlamaConfig.flagship_700m(), tllama.LlamaConfig.flagship_700m()


def _models(preset, dtype):
    """The JAX params as abstract shapes and the port's model on ``meta``."""
    jcfg, tcfg = _configs(preset)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jparams = jax.eval_shape(
        lambda key: jllama.init_llama_params(key, jcfg, dtype=jdtype), jax.random.PRNGKey(0))
    tmodel = tllama.LlamaForCausalLM(
        tcfg, dtype=torch.float32 if dtype == "f32" else torch.bfloat16,
        device=torch.device("meta"))
    return jparams, jcfg, tmodel


def _store(kv, dtype):
    return _STORE[dtype if kv == "auto" else kv]


@pytest.mark.parametrize("swap_gb", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_engine_preflight_matches_jax(preset, dtype, swap_gb):
    jparams, cfg, tmodel = _models(preset, dtype)
    num_slots, bs, max_seq = 8, 16, 1024
    pool_shape = (cfg.num_hidden_layers, num_slots * (max_seq // bs) + 1, bs,
                  cfg.num_key_value_heads, cfg.head_dim)
    keys = ("params_bytes", "pool_bytes", "total_bytes", "budget_bytes", "headroom_bytes",
            "over", "swap_pool_host_bytes")
    for kv in KV_DTYPES:
        jstore, tstore = _store(kv, dtype)
        for budget in (0.01, 2.0, 80.0):
            ref = jshard.engine_preflight(jparams, None, None, pool_shape, jstore, budget,
                                          swap_gb=swap_gb or None)
            got = tshard.engine_preflight(tmodel, None, None, pool_shape, tstore, budget,
                                          swap_gb=swap_gb or None)
            assert {k: got.get(k) for k in keys} == {k: ref.get(k) for k in keys}, (kv, budget)
    if preset == "flagship" and dtype == "bf16":
        assert got["params_bytes"] == 1_404_668_928  # the flagship's bf16 weights
        assert got["over"] is False and ref["over"] is False


def _serve_args(preset, dtype, kv, hbm_gb, num_slots=8, max_seq_len=1024):
    return argparse.Namespace(preset=preset, dtype=dtype, kv_dtype=kv, hbm_gb=hbm_gb,
                              num_slots=num_slots, block_size=16, max_seq_len=max_seq_len)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("preset", ["tiny", "flagship"])
def test_auto_num_blocks_matches_jax(preset, dtype, capsys):
    """``serve --auto-blocks`` picks JAX's ``num_blocks`` for every kv dtype
    at budgets that cap it at full residency, cut it below, and refuse."""
    jparams, jcfg, tmodel = _models(preset, dtype)
    jmodel = argparse.Namespace(params=jparams, config=jcfg)
    budgets = (0.0012, 0.002, 0.004, 0.05) if preset == "tiny" else (1.2, 1.6, 3.0, 80.0)
    picked = {}
    for kv in KV_DTYPES:
        for gb in budgets:
            args = _serve_args(preset, dtype, kv, gb)
            try:
                ref = jserve_cmd._auto_num_blocks(args, jmodel, None)
            except ValueError as e:
                assert "SP004" in str(e)
                with pytest.raises(ValueError, match="SP004"):
                    tserve_cmd._auto_num_blocks(args, tmodel)
                picked[kv, gb] = "refused"
                continue
            assert tserve_cmd._auto_num_blocks(args, tmodel) == ref, (kv, gb)
            picked[kv, gb] = ref
    capsys.readouterr()
    full = 8 * (1024 // 16) + 1
    assert full in picked.values()  # a budget that holds full residency
    assert "refused" in picked.values()  # one that cannot hold one request
    assert any(isinstance(n, int) and n < full for n in picked.values())  # and one between


def test_auto_blocks_needs_a_budget_on_the_cpu():
    """On the CPU there is no card memory to size against: ``--auto-blocks``
    without ``--hbm-gb`` refuses with SP004, as JAX's does on a backend
    that reports no limit; the port's budget function reads ``None`` there."""
    from accelerate_tpu_torch.utils.device import device_hbm_bytes

    assert device_hbm_bytes("cpu") is None
    model = tllama.LlamaForCausalLM.from_config(tllama.LlamaConfig.tiny(), device="cpu")
    with pytest.raises(ValueError, match="SP004: --auto-blocks needs an HBM budget"):
        tserve_cmd._auto_num_blocks(_serve_args("tiny", "f32", "auto", None, max_seq_len=64),
                                    model)


@pytest.fixture(scope="module")
def tiny_pair():
    """The same tiny llama in both packages, on the CPU."""
    kw = dict(vocab_size=64, hidden_size=32, layers=2, heads=4, seq=96)
    jmodel = jllama.LlamaForCausalLM.from_config(jllama.LlamaConfig.tiny(**kw), seed=0)
    tmodel = tllama.LlamaForCausalLM.from_config(tllama.LlamaConfig.tiny(**kw), device="cpu")
    return jmodel, tmodel


def _engines(tiny_pair, **cfg):
    from accelerate_tpu.serving import EngineConfig as JConfig
    from accelerate_tpu.serving import InferenceEngine as JEngine
    from accelerate_tpu_torch.serving import EngineConfig as TConfig
    from accelerate_tpu_torch.serving import InferenceEngine as TEngine

    jmodel, tmodel = tiny_pair
    base = dict(num_slots=2, block_size=8, max_seq_len=64)
    return (lambda: JEngine(jmodel, JConfig(**base, **cfg)),
            lambda: TEngine(tmodel, TConfig(**base, **cfg), device="cpu"))


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_sp004_refuses_where_jax_refuses(tiny_pair, kv_dtype, monkeypatch):
    """Over budget both engines refuse with SP004 before a pool allocates
    (the port's pool constructor is never reached); under it both start
    with the same report, and the port's live pools weigh what it predicted."""
    jeng, teng = _engines(tiny_pair, hbm_budget_gb=1e-6, kv_dtype=kv_dtype)
    with pytest.raises(ValueError, match="SP004"):
        jeng()
    allocated = []
    real_zeros = torch.zeros

    def zeros(*a, **kw):
        allocated.append(a)
        return real_zeros(*a, **kw)

    monkeypatch.setattr(torch, "zeros", zeros)
    with pytest.raises(ValueError, match="SP004: engine refuses to start"):
        teng()
    assert allocated == [], "a pool allocated before the SP004 refusal"
    monkeypatch.undo()

    jeng, teng = _engines(tiny_pair, hbm_budget_gb=1.0, kv_dtype=kv_dtype, swap_gb=0.01)
    jrep, tengine = jeng().hbm_preflight, teng()
    trep = tengine.hbm_preflight
    assert trep == jrep and trep["over"] is False and trep["swap_pool_host_bytes"] > 0
    assert trep["total_bytes"] == trep["params_bytes"] + trep["pool_bytes"]
    live = sum(t.numel() * t.element_size() for t in tengine._pages.values())
    assert live == trep["pool_bytes"]
    stats = tengine.stats()
    assert stats["hbm_preflight"] == trep
    assert stats["hbm_bytes_source"] == "estimate"  # the CPU reports no device memory
    assert stats["hbm_used_bytes"] == trep["params_bytes"] + trep["pool_bytes"]
    assert stats["hbm_limit_bytes"] == 1 << 30


def test_the_early_exit_draft_adds_no_bytes(tiny_pair):
    """Where the packages part: with speculation armed the JAX pre-flight
    prices a ``draft_params`` tier (its compiled spec executable
    materialises the layer-stacked slice of the first N layers), while the
    port's ``early_exit:N`` draft runs the target's own layers in place
    (``llama_early_exit_apply`` calls ``paged_step(num_layers=N)`` on the
    same modules and pools) and allocates no copy: ``draft_bytes`` is 0, and
    everything else equals JAX's."""
    jeng, teng = _engines(tiny_pair, hbm_budget_gb=1.0, spec_k=2, draft="early_exit:1")
    jrep, trep = jeng().hbm_preflight, teng().hbm_preflight
    assert jrep["draft_bytes"] > 0 and jrep["draft_layers"] == trep["draft_layers"] == 1
    assert trep["draft_bytes"] == 0
    assert trep["total_bytes"] == trep["params_bytes"] + trep["pool_bytes"]
    for key in ("params_bytes", "pool_bytes", "budget_bytes"):
        assert trep[key] == jrep[key]
    assert tshard.plan_draft_params(tiny_pair[1], None, None, 1) == []


def test_mesh_placement_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP item 18"):
        tshard.engine_preflight({}, None, object(), (1, 2, 8, 1, 8), torch.float32, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP item 18"):
        tshard.plan_params({}, {"tp": 2})


def test_kv_storage_names_match_jax():
    for kv in KV_DTYPES:
        for compute in ("float32", "bfloat16"):
            assert tshard.kv_storage_name(kv, compute) == jshard.kv_storage_name(kv, compute)
