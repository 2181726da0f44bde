"""Mixtral's routing in the port against JAX's ``moe_ffn`` on the same
layer weights and inputs: the top-k order under ties and the capacity
overflow it decides (outputs and ``aux_loss`` at 1e-5, f32).

A zero router makes every probability equal: ``jax.lax.top_k`` then picks
the lowest expert indices, in index order, and the flat ``(token, choice)``
order fills expert 0 and 1's buffers first; the port must drop exactly the
tokens JAX drops.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_zoo_common as common  # noqa: E402

from accelerate_tpu.models import mixtral as jmix  # noqa: E402
from accelerate_tpu_torch.models import _params  # noqa: E402
from accelerate_tpu_torch.models import mixtral as tmix  # noqa: E402

torch.set_num_threads(1)

#: name -> (experts, top_k, capacity_factor, zero router)
CASES = {
    "zero_router_overflow": (4, 2, 0.5, True),
    "zero_router_no_drop": (4, 2, 4.0, True),
    "random_router_overflow_top1": (2, 1, 0.25, False),
    "random_router_overflow_top2": (4, 2, 0.5, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_routing_and_aux_loss_match_jax(case):
    experts, top_k, cf, zero = CASES[case]
    jcfg = dataclasses.replace(jmix.MixtralConfig.tiny(hidden_size=32, experts=experts,
                                                       top_k=top_k), capacity_factor=cf)
    params = jmix.init_mixtral_params(jax.random.key(0), jcfg)
    if zero:
        params["layers"]["router"] = jnp.zeros_like(params["layers"]["router"])
    layer = jax.tree.map(lambda leaf: leaf[0], params["layers"])
    x = np.random.default_rng(1).normal(size=(2, 8, 32)).astype(np.float32)
    y_ref, aux_ref = jmix.moe_ffn(jcfg, layer, jnp.asarray(x))

    tcfg = common.port_config(tmix.MixtralConfig, jcfg)
    model = common.port_model(tmix, tmix.MixtralForCausalLM, tcfg, common.np_tree(params))
    with torch.no_grad():
        y, aux = tmix.moe_ffn(tcfg, _params.weights(model.layers[0]), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(aux_ref)) < 1e-5 * max(1.0, abs(float(aux_ref)))
    dropped = np.all(np.asarray(y_ref).reshape(-1, 32) == 0, axis=1)
    np.testing.assert_array_equal(np.all(y.numpy().reshape(-1, 32) == 0, axis=1), dropped)
    if "overflow" in case:
        assert dropped.any() and not dropped.all()  # the capacity did bind


def test_top_k_breaks_ties_to_the_lower_index_as_jax():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]], np.float32)
    vals_ref, idx_ref = jax.lax.top_k(jnp.asarray(probs), 2)
    vals, idx = tmix.top_k_routes(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_ref))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_smoke_reads_the_einsums_and_their_backward_nodes_from_a_profiled_step(remat):
    """``chip_smoke.einsum_ms_from_trace`` on a tiny Mixtral step profiled
    on the CPU: every einsum of ``moe_ffn`` (four a layer, and again in the
    recompute under remat), and of the step's ``BmmBackward0`` nodes exactly
    those the einsums made: one a layer for each of combine, the gather
    into the experts and the scatter back (dispatch's one-hot operands need
    no gradient), none of the expert products' or attention's."""
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(tmix.MixtralConfig.tiny(hidden_size=32), remat=remat)
    model = tmix.MixtralForCausalLM.from_config(cfg, seed=0, device="cpu")
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 16)))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(input_ids=ids, labels=ids).loss.backward()
    got = smoke.einsum_ms_from_trace(prof, "cpu_time_total")
    L = cfg.num_hidden_layers
    assert got["calls"] == 4 * L * (2 if remat else 1)
    assert got["forward_ms"] > 0 and got["backward_ms"] > 0
    all_bmm = sum(e.name == "BmmBackward0" for e in prof.events())
    assert got["backward_nodes"]["BmmBackward0"] == 3 * L < all_bmm
