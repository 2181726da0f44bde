"""Rematerialisation (port of ``remat_wrap`` from
``accelerate_tpu/parallel/pipeline.py``; the GPipe stages, ``decode_stack``
and ``prefill_layer_stack`` are ROADMAP item 18).

``remat`` is ``False`` (save everything), ``True`` (recompute the whole
layer in the backward) or the name of a ``jax.checkpoint_policies`` policy,
mapped onto ``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``
with a selective-checkpoint policy over aten ops
(``create_selective_checkpoint_contexts``):

* ``"nothing_saveable"``: as ``True``;
* ``"everything_saveable"``: every aten op's output is kept;
* ``"dots_saveable"`` / ``"checkpoint_dots"``: the outputs of JAX's
  "dots" (matrix products: ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
  ``dot``, and the fp8 ``_scaled_mm``) are kept, the elementwise work
  between them recomputed;
* ``"dots_with_no_batch_dims_saveable"`` /
  ``"checkpoint_dots_with_no_batch_dims"``: only the products without a
  batch dim (``mm``, ``addmm``, ``mv``, ``dot``, ``_scaled_mm``: the
  llama's projections, each ``[tokens, in] @ [in, out]``); attention's
  batched products are recomputed.

What JAX saves (``jax.ad_checkpoint.print_saved_residuals`` over one
tiny llama layer on the CPU): under ``dots_saveable`` with its flash
kernels, the six projection outputs of the layer and nothing of attention
(the ``pallas_call`` forward is recomputed, as under ``True``); with the
``lax.scan`` attention also its two batched score products, which
``dots_with_no_batch_dims_saveable`` recomputes; under
``everything_saveable`` every intermediate, the flash forward's output and
lse included. The port saves the same products, with one difference: the
flash kernels are a ``ctypes`` call that the policy cannot see, so on the
card ``everything_saveable`` runs the forward kernel (B1) again in the
recompute where JAX keeps its output (under ``True`` and the dots policies
both recompute it). The other names of ``jax.checkpoint_policies``
are factories over named residuals (``save_only_these_names``, ...), which
the port's layers do not name: they raise "not yet ported". A name
``jax.checkpoint_policies`` does not have raises JAX's own message.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten

#: aten products without a batch dim, and the batched ones
_DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default, _aten.mv.default, _aten.dot.default,
                  _aten._scaled_mm.default)
_DOTS_BATCHED = (_aten.bmm.default, _aten.baddbmm.default)

#: the policies ``remat`` takes by name: ``None`` recomputes everything, else
#: the aten ops whose outputs are kept (``"all"``: every op's)
_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": _DOTS_NO_BATCH + _DOTS_BATCHED,
    "checkpoint_dots": _DOTS_NO_BATCH + _DOTS_BATCHED,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}

#: the other names of ``jax.checkpoint_policies``: policy factories over
#: named residuals
_FACTORIES = ("save_only_these_names", "save_any_names_but_these",
              "save_anything_except_these_names", "save_from_both_policies",
              "save_and_offload_only_these_names", "offload_dot_with_no_batch_dims")


def remat_policy(remat):
    """Check ``remat`` and return what :func:`remat_wrap` keeps for it:
    ``False`` (no remat), ``None`` (recompute everything) or a policy entry
    of :data:`_POLICIES`."""
    if remat is False or remat is None:
        return False
    if remat is True:
        return None
    if isinstance(remat, str):
        if remat in _POLICIES:
            return _POLICIES[remat]
        if remat in _FACTORIES:
            raise ValueError(f"remat policy {remat!r} is not yet ported: the port's layers "
                             "name no residuals; use a policy name such as 'dots_saveable'")
        raise ValueError(
            f"unknown remat policy {remat!r}: expected a "
            "jax.checkpoint_policies name, e.g. 'dots_saveable' or "
            "'dots_with_no_batch_dims_saveable'"
        )
    raise ValueError(f"remat must be a bool or a policy name, got {remat!r}")


def _keep(ops, ctx, func, *args, **kwargs):
    if ops == "all" or func in ops:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _forward_contexts(inner=None):
    """A checkpoint's ``context_fn``: the recompute, which the backward runs
    after the forward's contexts have exited, runs under the forward's fp8
    state (:func:`~accelerate_tpu_torch.ops.fp8.checkpoint_contexts`) and
    its attention context (Mixtral's routing reads the batch's groups
    there). ``inner`` is a selective-checkpoint policy's ``context_fn``."""
    from ..ops.attention import attention_context_as, get_attention_context
    from ..ops.fp8 import checkpoint_contexts

    forward, recompute = checkpoint_contexts(inner)
    return forward, _both(recompute, attention_context_as(get_attention_context()))


def remat_wrap(body, remat):
    """``body`` with the configured rematerialisation: itself for
    ``False``, else a function that runs it under
    ``torch.utils.checkpoint`` with the named policy (the whole body
    recomputed for ``True``). The recompute sees the fp8 recipe the forward
    ran under (:func:`~accelerate_tpu_torch.ops.fp8.checkpoint_contexts`)
    and its attention context, with the groups a prepared model's call
    bound (:func:`_forward_contexts`)."""
    policy = remat_policy(remat)
    if policy is False:
        return body
    inner = None
    if policy is not None:
        inner = functools.partial(create_selective_checkpoint_contexts,
                                  functools.partial(_keep, policy))
    kwargs = {"use_reentrant": False,
              "context_fn": functools.partial(_forward_contexts, inner)}

    @functools.wraps(body)
    def wrapped(*args):
        return checkpoint(body, *args, **kwargs)

    return wrapped
