"""The serving engine's HBM pre-flight: per-device bytes of the params and
the paged pools, priced from shapes before anything allocates (the
single-device part of ``accelerate_tpu/analysis/shardplan.py``).

The JAX package's shard-check prices a placement over a mesh; the port runs
one engine on one card, so every mesh axis here is 1, every leaf is
replicated (``bytes_per_device == bytes_global``), and what is left is
counting bytes the same way:

* :func:`plan_params` — every tensor of the model's state dict;
* :func:`plan_kv_pool` — the two paged pools ``[layers, num_blocks,
  block_size, n_kv, head_dim]`` at the real head dim (the pool is never
  padded), plus the two f32 scale arrays of an int8/fp8 pool;
* :func:`plan_swap_pool` — the host swap tier, reported, never budgeted;
* :func:`plan_draft_params` — the speculative draft's own bytes: none, see
  there;
* :func:`engine_preflight` — SP004, the refusal ``InferenceEngine`` raises
  before its pools allocate when params + pools exceed ``hbm_budget_gb``;
* :func:`auto_num_blocks` — ``serve --auto-blocks``: as many blocks as fit.

Placement over a mesh (``parse_mesh_spec``, ``mesh_sizes_of``, the
partition rules) is ROADMAP item 18: a ``mesh`` or ``rules`` argument
raises. Pure Python over ``.shape`` / ``.dtype``; no CUDA call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: storage-dtype names the kv pool treats as quantized (scale arrays ride
#: beside the payload); "fp8" is the CLI spelling of float8_e4m3fn
_KV_QUANTIZED_DTYPES = ("int8", "fp8", "float8_e4m3fn")

#: itemsize of dtype names plain numpy does not resolve
_EXT_DTYPE_ITEMSIZE = {
    "bfloat16": 2,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "fp8": 1,
}

#: where mesh placement is ported
_MESH_ITEM = "ROADMAP item 18"


@dataclass
class LeafPlan:
    """One tensor's placement + cost under the plan (one device: always
    replicated, ``bytes_per_device == bytes_global``)."""

    path: str
    shape: tuple[int, ...]
    dtype: str
    tier: str  # "params" | "draft_params" | "kv_pool"
    spec: str
    source: str
    rule_index: int | None
    dropped: tuple
    bytes_global: int
    bytes_per_device: int

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "tier": self.tier,
            "spec": self.spec,
            "source": self.source,
            "rule_index": self.rule_index,
            "dropped": [list(d) for d in self.dropped],
            "bytes_global": self.bytes_global,
            "bytes_per_device": self.bytes_per_device,
        }


def _dtype_name(dtype) -> str:
    """``torch.bfloat16`` / ``np.float32`` / ``"bf16"``-free names → the
    numpy-style name (``"bfloat16"``, ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _leaf_nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    name = _dtype_name(dtype)
    try:
        itemsize = np.dtype(name).itemsize
    except TypeError:
        itemsize = _EXT_DTYPE_ITEMSIZE[name]
    return n * itemsize


def kv_storage_name(kv_dtype: str | None, compute_dtype: str = "float32") -> str:
    """CLI ``kv_dtype`` policy name → the storage dtype string the planners
    price blocks with. ONE mapping for ``serve --auto-blocks`` and the
    engine (both must price exactly what the engine allocates); ``auto``
    follows the params' compute dtype, matching ``EngineConfig``."""
    if kv_dtype in (None, "auto"):
        return compute_dtype
    return {
        "f32": "float32",
        "bf16": "bfloat16",
        "int8": "int8",
        "fp8": "float8_e4m3fn",
    }[kv_dtype]


def _single_device(mesh=None, rules=None) -> None:
    if mesh is not None or rules:
        raise NotImplementedError(
            f"placement over a mesh (a mesh or partition rules) is not yet ported "
            f"({_MESH_ITEM}): the port plans one engine on one card"
        )


def _replicated(path, shape, dtype, tier) -> LeafPlan:
    nbytes = _leaf_nbytes(shape, dtype)
    return LeafPlan(
        path=path, shape=tuple(int(d) for d in shape), dtype=_dtype_name(dtype), tier=tier,
        spec="PartitionSpec()", source="replicated", rule_index=None, dropped=(),
        bytes_global=nbytes, bytes_per_device=nbytes,
    )


def _state_items(params):
    """``(name, tensor-like)`` pairs of a module's state dict (each tensor
    once: a tied weight is one allocation) or of a ``{name: tensor}``
    mapping. Only ``.shape`` and ``.dtype`` are read."""
    if hasattr(params, "state_dict"):
        params = params.state_dict(keep_vars=True)
    seen = set()
    for name, t in params.items():
        if id(t) in seen:
            continue
        seen.add(id(t))
        yield name, t


def plan_params(params, mesh_sizes: dict | None = None, rules=None,
                tier: str = "params") -> list[LeafPlan]:
    """One replicated leaf per tensor of the model's state dict (a module or
    its ``state_dict()``): the engine's weights on the card. ``mesh_sizes``
    other than all-ones and ``rules`` are ROADMAP item 18 and raise."""
    if mesh_sizes and any(int(n) != 1 for n in mesh_sizes.values()):
        _single_device(mesh=mesh_sizes)
    _single_device(rules=rules)
    return [_replicated(name, tuple(t.shape), t.dtype, tier)
            for name, t in _state_items(params)]


def plan_kv_pool(
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    num_slots: int,
    block_size: int,
    max_seq_len: int,
    mesh_sizes: dict | None = None,
    num_blocks: int | None = None,
    dtype: str = "float32",
) -> list[LeafPlan]:
    """The serving engine's two paged pools, ``[layers, num_blocks,
    block_size, n_kv, head_dim]`` at the real head dim. ``num_blocks``
    defaults to the engine's full residency (slots × per-slot max + the
    null block). Quantized storage (``int8``/``fp8``/``float8_e4m3fn``) adds
    the two f32 scale arrays ``[layers, num_blocks, block_size, n_kv]``, so
    predicted pool bytes are byte-exact against the engine's pools."""
    if mesh_sizes and any(int(n) != 1 for n in mesh_sizes.values()):
        _single_device(mesh=mesh_sizes)
    blocks_per_slot = -(-max_seq_len // block_size)  # ceil
    if num_blocks is None:
        num_blocks = num_slots * blocks_per_slot + 1
    dtype = _dtype_name(dtype)
    quantized = dtype in _KV_QUANTIZED_DTYPES
    if dtype == "fp8":
        dtype = "float8_e4m3fn"
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    leaves = [_replicated(f"kv_pool.{name}", shape, dtype, "kv_pool") for name in ("k", "v")]
    if quantized:
        leaves += [_replicated(f"kv_pool.{name}", shape[:-1], "float32", "kv_pool")
                   for name in ("k_scale", "v_scale")]
    return leaves


def plan_swap_pool(
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    block_size: int,
    swap_gb: float,
    dtype: str = "float32",
) -> dict:
    """Host footprint of the engine's KV swap tier (``EngineConfig(swap_gb=
    ...)``): pinned host memory, deliberately outside the device totals. A
    block is the K and V rows of every layer (plus the f32 scales of a
    quantized pool), as :class:`~accelerate_tpu_torch.serving.radix.SwapPool`
    lays it out."""
    dtype = _dtype_name(dtype)
    quantized = dtype in _KV_QUANTIZED_DTYPES
    if dtype == "fp8":
        dtype = "float8_e4m3fn"
    block_shape = (num_layers, block_size, num_kv_heads, head_dim)
    per_block = 2 * _leaf_nbytes(block_shape, dtype)  # K + V
    if quantized:
        per_block += 2 * _leaf_nbytes(block_shape[:-1], "float32")  # scales
    blocks = max(0, int(swap_gb * (1 << 30)) // per_block) if per_block else 0
    return {
        "swap_gb": float(swap_gb),
        "swap_blocks": blocks,
        "bytes_per_block": per_block,
        "swap_pool_host_bytes": blocks * per_block,
    }


def plan_draft_params(params, mesh_sizes: dict | None, rules, draft_layers: int,
                      stacked_prefix: str = "layers") -> list[LeafPlan]:
    """The speculative draft's own device bytes: none. The port's
    ``early_exit:N`` draft (:func:`~accelerate_tpu_torch.models.llama.llama_early_exit_apply`)
    runs the target's first N layers in place, through the same modules and
    over the target's own pools, so it allocates no weight copy. (The JAX
    package prices a draft tier because its compiled spec executable
    materialises the layer-stacked slice as a transient buffer; a module
    list has no stacked leaves to slice.) Returns ``[]``; the arguments are
    the JAX signature's."""
    _single_device(rules=rules)
    return []


def _gb(nbytes: int) -> str:
    return f"{nbytes / (1 << 30):.3f} GiB"


def engine_preflight(
    params,
    rules,
    mesh,
    pool_shape: tuple[int, ...],
    pool_dtype,
    hbm_budget_gb: float,
    swap_gb: float | None = None,
    draft_layers: int | None = None,
    stacked_prefix: str = "layers",
) -> dict:
    """The serving engine's capacity check, run BEFORE the pools allocate:
    predicted bytes of the params (``params``: the model or its state dict)
    + the two paged pools of ``pool_shape`` in ``pool_dtype``, against the
    budget.

    Returns ``{params_bytes, pool_bytes, total_bytes, budget_bytes,
    headroom_bytes, over}`` — the engine raises on ``over`` (SP004: refuse
    to start, never run out of memory mid-request). With ``swap_gb``,
    ``swap_pool_host_bytes`` reports the host tier beside, outside
    ``total_bytes``. With ``draft_layers`` (speculation armed),
    ``draft_bytes`` is reported and added: 0 (:func:`plan_draft_params`)."""
    _single_device(mesh=mesh, rules=rules)
    params_bytes = sum(p.bytes_per_device for p in plan_params(params))
    draft_bytes = 0
    if draft_layers:
        draft_bytes = sum(p.bytes_per_device for p in plan_draft_params(
            params, None, None, draft_layers, stacked_prefix=stacked_prefix))
    pool_bytes = sum(p.bytes_per_device for p in plan_kv_pool(
        num_layers=pool_shape[0],
        num_blocks=pool_shape[1],
        block_size=pool_shape[2],
        num_kv_heads=pool_shape[3],
        head_dim=pool_shape[4],
        num_slots=1,  # num_blocks is explicit; slots only feed the default
        max_seq_len=pool_shape[2],
        dtype=_dtype_name(pool_dtype),
    ))
    budget = int(hbm_budget_gb * (1 << 30))
    total = params_bytes + draft_bytes + pool_bytes
    report = {
        "params_bytes": params_bytes,
        "pool_bytes": pool_bytes,
        "total_bytes": total,
        "budget_bytes": budget,
        "headroom_bytes": budget - total,
        "over": total > budget,
    }
    if draft_layers:
        report["draft_bytes"] = draft_bytes
        report["draft_layers"] = int(draft_layers)
    if swap_gb:
        report["swap_pool_host_bytes"] = plan_swap_pool(
            num_layers=pool_shape[0],
            num_kv_heads=pool_shape[3],
            head_dim=pool_shape[4],
            block_size=pool_shape[2],
            swap_gb=swap_gb,
            dtype=_dtype_name(pool_dtype),
        )["swap_pool_host_bytes"]
    return report


def auto_num_blocks(
    budget_bytes: int,
    params_bytes: int,
    per_block_bytes: int,
    full_residency_blocks: int,
    min_blocks: int,
    reserve_frac: float = 0.05,
) -> tuple[int, int]:
    """Size the paged pool from the budget instead of a hand-picked
    constant: as many blocks as fit under ``budget*(1-reserve) - params``,
    capped at full residency (more is pure waste). Returns
    ``(num_blocks, headroom_bytes)``; raises ValueError (the SP004
    refusal) when even ``min_blocks`` don't fit."""
    avail = int(budget_bytes * (1.0 - reserve_frac)) - params_bytes
    fit = avail // per_block_bytes if per_block_bytes > 0 else 0
    n = int(min(full_residency_blocks, fit))
    if n < min_blocks:
        raise ValueError(
            f"SP004: HBM budget {_gb(budget_bytes)} leaves room for {max(fit, 0)} "
            f"KV block(s) after {_gb(params_bytes)} of params "
            f"({per_block_bytes / 1e6:.2f} MB/block/device) — need at least "
            f"{min_blocks} to admit one request. Shrink max_seq_len/block_size, "
            f"or raise --hbm-gb"
        )
    headroom = budget_bytes - params_bytes - n * per_block_bytes
    return n, headroom
