"""The port's context parallelism (``accelerate_tpu_torch/parallel/context.py``)
held against the JAX package's ``context_parallel_attention`` on its
8-device CPU mesh.

At cp 4 on 4 gloo ranks, causal and not, with a kv padding mask, GQA on
and off, each of ``ring`` (the einsum ring on the CPU), ``ulysses`` and
``allgather`` runs through the attention dispatcher as a model calls it
(``Accelerator(mesh_plugin=MeshPlugin(cp=4), context_parallel_plugin=...)``),
each rank on its chunk of the sequence, and is held against JAX's on the
same arrays: the outputs within JAX's 3e-4 (``tests/test_attention.py``),
the gradients of ``sum(out * do)`` within 5e-4 × their scale. JAX's
divisibility errors are raised with JAX's words. The ranks run once a
session; ``tests/test_torch_ring_flash.py`` reads the same launch.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch_dist_workers as dist_workers  # noqa: E402
import torch_shard_workers as workers  # noqa: E402

from accelerate_tpu.mesh import build_mesh  # noqa: E402
from accelerate_tpu.parallel.context import context_parallel_attention as jcp  # noqa: E402
from accelerate_tpu.utils.dataclasses import MeshPlugin as JMeshPlugin  # noqa: E402
from accelerate_tpu_torch import AcceleratorState, GradientState, debug_launcher  # noqa: E402
from accelerate_tpu_torch.parallel.context import (  # noqa: E402
    context_parallel_attention,
    sequence_chunk,
)

CP = 4


@pytest.fixture(autouse=True)
def _reset_states():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def cp_launch(tmp_path_factory) -> dict:
    """``{(mode, causal, n_kv): per-rank results}`` of every case of
    ``workers.CP_CASES`` (one launch of 4 gloo ranks a session)."""
    cases = [workers.cp_case(*c) for c in workers.CP_CASES]
    ranks = dist_workers.shared_result(tmp_path_factory, "torch_cp_attention_4", lambda: debug_launcher(
        workers.cp_attention_cases, (cases,), num_processes=CP, timeout=300))
    return {c: sorted((r[i] for r in ranks), key=lambda r: r["idx"])
            for i, c in enumerate(workers.CP_CASES)}


def assemble(parts, key):
    return np.concatenate([p[key] for p in parts], axis=1)


def jax_reference(case: dict, body):
    """``body(q, k, v, mask)`` and the gradients of ``sum(out * do)`` in
    q, k and v, on the JAX side."""
    q, k, v = (jnp.asarray(case[x]) for x in "qkv")
    mask = jnp.asarray(case["mask"]).astype(bool)
    do = jnp.asarray(case["do"])

    def loss(q, k, v):
        return (body(q, k, v, mask) * do).sum()

    out = jax.jit(lambda q, k, v: body(q, k, v, mask))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def check(parts, out, grads):
    np.testing.assert_allclose(assemble(parts, "o"), out, rtol=0, atol=3e-4)
    for key, g in zip(("dq", "dk", "dv"), grads):
        scale = max(float(np.abs(g).max()), 1.0)
        np.testing.assert_allclose(assemble(parts, key), g, rtol=0, atol=5e-4 * scale,
                                   err_msg=key)


@pytest.fixture
def cp_results(tmp_path_factory):
    return cp_launch(tmp_path_factory)


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("mode", ["ring", "ulysses", "allgather"])
def test_cp_attention_matches_jax_at_cp4(cp_results, mode, causal, n_kv):
    parts = cp_results[(mode, causal, n_kv)]
    case = workers.cp_case(mode, causal, n_kv)
    mesh = build_mesh(JMeshPlugin(dp=1, cp=CP, devices=jax.devices()[:CP]))
    body = functools.partial(jcp, mesh=mesh, mode=mode, causal=causal)
    check(parts, *jax_reference(case, lambda q, k, v, m: body(q, k, v, m)))
    # the dispatcher took the mode the Accelerator's plugin set, on the cp mesh
    assert parts[0]["ctx"][0] == "ring" and parts[0]["ctx"][1]["cp"] == CP


def test_ulysses_head_divisibility_error_has_jax_words():
    """Two heads over a cp extent of 4: both packages refuse before any
    collective, in the same words."""
    q = np.zeros((1, 8, 2, 4), np.float32)
    mesh = build_mesh(JMeshPlugin(dp=1, cp=CP, devices=jax.devices()[:CP]))
    with pytest.raises(ValueError) as want:
        jcp(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), mesh=mesh, mode="ulysses")
    t = torch.zeros(1, 2, 2, 4)
    with pytest.raises(ValueError) as got:
        context_parallel_attention(t, t, t, mesh={"cp": CP, "tp": 1}, group=None,
                                   mode="ulysses")
    assert str(got.value) == str(want.value)


def test_sequence_divisibility_error_has_jax_words():
    """A sequence of 10 over cp 4: the prepared model's cut refuses as
    JAX's attention does."""
    mesh = build_mesh(JMeshPlugin(dp=1, cp=CP, devices=jax.devices()[:CP]))
    x = jnp.zeros((1, 10, 4, 4), jnp.float32)
    with pytest.raises(ValueError) as want:
        jcp(x, x, x, mesh=mesh, mode="ring")
    with pytest.raises(ValueError) as got:
        sequence_chunk(torch.zeros(1, 10), 0, CP)
    assert str(got.value) == str(want.value)
