#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``accelerate_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of ``accelerate_tpu``. Phases (each raises on
failure, so the script exits non-zero and prints no result):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every CUDA kernel of the port from ``accelerate_tpu_torch/csrc``
   into ``build/torch_kernels`` (nvcc, sm_90a), with the build seconds and
   each kernel instance's registers, spills and static shared memory from
   ptxas (the flash kernels and every instance of the paged kernel's split
   and combine kernels), and the blocks a SM holds of the bf16 flash kernels
   and of the paged kernels' timed instances (with the split kernel's
   dynamic shared memory), from the CUDA runtime's occupancy calculator on
   the card. Fails if a wgmma flash kernel or B4's bf16 hd-128 split
   instance spills;
3. the paged-attention kernel against its plain PyTorch version on the
   card: decode (s=1) and prefill-chunk (s=32) queries, hd=128, bs=16, MHA
   12/12 and GQA 32/8, ``idx`` on and beside block edges, f32 / bf16 /
   int8 / fp8 pools written through ``write_paged_kv``, table tails on the
   null block, which holds garbage; then hd=64, a one-tile table, bf16
   queries on an int8 pool; block sizes 8 and 32; one batch whose rows'
   valid lengths are 1, 127, 128, 129 and 1000 (and 32..1000 in a chunk, MHA
   and GQA); s=5; then hd=16 (MHA 4/4) and hd=32 (GQA 8/2) in every pool
   with f32 and bf16 queries, and the mixed-length batch at hd=16. Gates:
   f32 ``atol=rtol=1e-5``; bf16 outputs ``atol=2e-2`` in f32; int8 / fp8
   (and a bf16 pool under f32 queries) ``atol=rtol=1e-4`` on the same
   stored bytes. Each case launches twice and requires bit-identical
   outputs;
4. the flagship llama's paged step in f32, kernel against plain: one
   64-token prefill chunk then 8 decode steps, max |Δ logits| <= 1e-3;
5. the main path: ``python -m accelerate_tpu_torch serve --preset flagship
   --dtype bf16 --num-slots 8 --max-seq-len 1024`` answering 12 JSONL
   requests (prompts of 16-900 ids, 64 new tokens each) in a fresh process
   (so its kernel counts start at 0). The engine replays its decode burst
   and prefill chunk from CUDA graphs: its stderr summary and its ``serve
   stats`` line must show one capture of each (``decode_compiles``,
   ``prefill_compiles``), the burst's capture 8 × 16 launches, all decode,
   the chunk's 16, none decode, and launches = eager (the warm-ups) +
   replays × captured, split into decode (one query a row) and other.
   Then the same engine in-process with ``--kv-dtype int8`` and 4
   requests, the wrapper's counters set to 0 just before and read just
   after (they count the warm-ups and what each capture recorded; the
   engine multiplies by the replays), under the same checks; then ``serve
   --preset tiny`` on its defaults (f32, head dim 16) answering 6 requests;
5b. the 12 requests through the graph engine with async dispatch on and
   off, which must give identical tokens, and each request alone through
   ``paged_step`` in an eager Python loop at the engine's shapes: where a
   request parts from that reference, the first divergence and the
   reference's top-2 logit margin are printed, and a divergence whose gap
   exceeds 2^-5 of the reference's largest |logit| (four bf16 ulps at the
   top) fails;
5c. two engines with one seed and ``do_sample=True``: identical tokens,
   and the generator's Philox offset advancing on every replay;
6. times at the flagship decode shape (8 slots, context 512, bf16, the 16
   layers' pools rotated so L2 does not hold them), at context 1024 (the
   table's ``mb · bs``), and at the prefill chunk (b 1, s 32, the chunk's
   last query at context 512 and 896): the kernel (CUDA events around the
   Python wrapper), the device time a launch of its split kernel and of its
   combine kernel under ``torch.profiler``, the plain version,
   ``scaled_dot_product_attention`` over the pre-gathered span with the
   chunk's causal-offset mask (the gather excluded; its kernels' device
   time a call, and CUDA events around it), and the bound — the larger of
   the bytes of valid K/V + q + out over 3.35 TB/s and the flops over 989
   TFLOP/s. Printed in the ``{"kernels": [...]}`` line. A profiler window
   that shows no kernel row is taken again once, then the script fails: no
   library time reads 0.0;
7. where a flagship decode step's time goes on the graph engine: four
   legs, async and sync alternating, each its own engine past prefill,
   four timed ``step()`` calls (wall per decode step, tokens/s, the flight
   recorder's ``host_fraction`` and per-phase p50) and two under
   ``torch.profiler`` (device time and busy share, launches and top kernels
   per step); then one paged step eager against the same step replayed
   from a CUDA graph. Printed as one ``{"serve_breakdown": {...}}`` line
   with phase 5's serve numbers and phases 5b-5c;
8. the flash-attention kernels (forward, backward dq, backward dk/dv)
   against their plain versions on the card, on seeded numpy inputs: the
   flagship shape (b 8, s 1024, 12 × 128) and GQA 32/8 at hd 64 and 128,
   causal and not, s = 1000 (not a tile multiple), a left-padded key mask
   with fully masked rows, f32 and bf16, and four bf16 cases at the edges
   of the bf16 kernels' tiles: s = 129 (one row past a 128-row tile),
   s = 200 with a left pad of 130 (a whole query tile fully masked), GQA
   32/8 × 128 at s = 1000 (a multiple of neither the 64-key nor the 128-row
   tile) and s = 200 non-causal with a left pad of 130 (masked keys inside
   a key tile off the diagonal). Gates (the JAX tests' own): f32 output 2e-5, lse 1e-5,
   dq/dk/dv 2e-4 × max(|ref|, 1); bf16 output 3e-2, lse 1e-5 and grads
   5e-2 × max(|ref|, 1), compared in f32. The f32 cases with no mask also
   hold the kernels' grads to autograd through the plain
   ``dot_product_attention`` at the same gate;
9. one training forward and backward at flagship width (2 layers, b 2,
   s 512, one left-padded row), attention through the kernels against the
   plain autograd.Function, in f32 (loss within 1e-5 relative, every
   parameter's grad within 1e-4 × max(|ref|, 1)) and in bf16 weights and
   activations (loss 2e-2 relative, grads 5e-2 × max(|ref|, 1): bf16
   outputs differ by an ulp where sums run in another order, and the
   difference crosses two layers and the loss);
10. the training main path: the flagship (16 layers, 8 × 1024 tokens)
    through the 5-line ``Accelerator(mixed_precision="bf16")`` loop with
    ``torch.optim.AdamW`` at optax's ``adamw(1e-4)`` settings, 2 warm-up
    and 10 timed steps, the flash counters set to 0 just before and read
    just after (16 launches of each per step); finite, falling loss;
    tokens/s, MFU against 989 TFLOP/s and peak memory; then the same model
    through a hand-written PyTorch step, for ``vs_raw``;
11. where a train step's time goes: one step under ``torch.profiler``
    (device busy share, top kernels, the flash kernels' share and their
    device time per launch). Printed as one ``{"train_breakdown": {...}}``
    line;
12. the flash kernels timed at the flagship shape (b 8, s 1024, 12 × 128,
    bf16, causal) beside their plain versions, ``scaled_dot_product_attention``
    (forward for B1; its backward alone, ``autograd.grad`` over one
    retained forward, for the B2+B3 pair) and their bounds; each kernel
    with its achieved TFLOP/s, by CUDA events around the Python wrapper
    (min, median and max of the repeats) and by phase 11's profiler time
    per launch (the kernel alone, without the wrapper's host cost); the
    library call by its kernels' device time a call under the profiler
    (``library_ms``: as a Python call its host cost can exceed its
    kernels'), and by events (min, median and max).

The ``{"kernels": [...]}`` line lists all four kernels. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
SERVE_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_key(mangled: str):
    """``kernel<args>`` of a kernel template from its mangled name, as the
    C++ runtime's demangler writes it (``paged_attention_kernel<128,
    __nv_bfloat16, __nv_bfloat16, false>``), or None for any other name."""
    m = re.search(r"(\w+<[^()]*>)\(", torch._C._demangle(mangled))
    return m.group(1) if m else None


def ptxas_report(log: str) -> dict:
    """``{"kernel<args>": {"registers": n, "spill_stores": bytes, "spill_loads":
    bytes, "static_smem": bytes}}`` for every kernel instance in nvcc's
    ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_key(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if name and m:
            out[name] = {"spill_stores": int(m.group(1)), "spill_loads": int(m.group(2))}
            continue
        m = re.search(r"Used (\d+) registers", line)
        if name and m and name in out:
            out[name]["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
            name = None
    return out


#: B4's instances at the timed decode shape (hd 128, bf16 queries and pool)
PAGED_TIMED = ("paged_attention_kernel<128, __nv_bfloat16, __nv_bfloat16, false>",
               "combine_splits_kernel<128, __nv_bfloat16>")


def occupancy_report() -> tuple[dict, int]:
    """``({"kernel<args>": blocks}, bytes)``: resident blocks an SM holds of
    each bf16 flash kernel and of B4's timed instances, from the CUDA
    runtime's occupancy calculator on this card, for the threads and shared
    memory each is launched with; and the dynamic shared memory of B4's
    split kernel at the decode shape."""
    import ctypes

    from accelerate_tpu_torch import _build

    blocks, combine, smem, out = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), {}
    flash = _build.load("flash_attention.cu")
    for which, name in enumerate(FLASH_KERNELS):
        for hd in (64, 128):
            if flash.flash_attention_blocks_per_sm(which, hd, ctypes.byref(blocks)):
                raise AssertionError(f"the occupancy query failed for {name} at hd {hd}")
            out[f"{name}_wgmma_kernel<{hd}>"] = blocks.value
    paged = _build.load("paged_attention.cu")
    if paged.paged_attention_blocks_per_sm(ctypes.byref(blocks), ctypes.byref(combine),
                                           ctypes.byref(smem)):
        raise AssertionError("the occupancy query failed for the paged kernels")
    out[PAGED_TIMED[0]], out[PAGED_TIMED[1]] = blocks.value, combine.value
    return out, smem.value


def flash_kernel_pattern(name: str) -> str:
    """A profiler row of kernel family ``name`` (``flash_bwd_dq``): the f32
    kernel ``flash_bwd_dq_kernel`` or the bf16 ``flash_bwd_dq_wgmma_kernel``."""
    return rf"\b{name}_(wgmma_)?kernel\b"


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


# -- phase 3 ----------------------------------------------------------------


_STORE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          "fp8": torch.float8_e4m3fn}


def _filled_pools(rng, *, b, s, nh, n_kv, hd, bs, mb, idx, pool, q_dtype, dev):
    """Pools written through the port's ``write_paged_kv`` for positions
    ``0 .. idx[b]+s-1`` of each row, tables partly filled (tails on block 0),
    and the null block then overwritten with garbage that must never be
    attended."""
    from accelerate_tpu_torch.ops.layers import write_paged_kv

    store = _STORE[pool]
    bt = torch.zeros((b, mb), dtype=torch.int32)
    nxt = 1
    for i, ix in enumerate(idx):
        for j in range(min((ix + s - 1) // bs + 1, mb)):
            bt[i, j] = nxt
            nxt += 1
    nb = nxt + 3
    bt = bt.to(dev)
    kp = torch.zeros((nb, bs, n_kv, hd), dtype=store, device=dev)
    vp = torch.zeros_like(kp)
    quant = pool in ("int8", "fp8")
    ks = torch.ones((nb, bs, n_kv), device=dev) if quant else None
    vs = torch.ones_like(ks) if quant else None
    span = max(idx) + s
    k = torch.as_tensor(rng.normal(size=(b, span, n_kv, hd)).astype("float32"), device=dev)
    v = torch.as_tensor(rng.normal(size=(b, span, n_kv, hd)).astype("float32"), device=dev)
    pos = torch.arange(span, device=dev)[None, :].expand(b, span)
    lens = torch.as_tensor([ix + s for ix in idx], device=dev)
    write_paged_kv(kp, vp, k, v, bt, pos, write_mask=pos < lens[:, None],
                   k_scale_l=ks, v_scale_l=vs)
    garbage = torch.full((bs, n_kv, hd), 100.0, device=dev)
    kp[0] = garbage.to(store)
    vp[0] = (-garbage).to(store)
    if quant:
        ks[0] = 50.0
        vs[0] = 50.0
    q = torch.as_tensor(rng.normal(size=(b, s, nh, hd)).astype("float32"), device=dev)
    return q.to(_STORE[q_dtype]), kp, vp, ks, vs, bt, torch.as_tensor(idx, dtype=torch.int32,
                                                                       device=dev)


#: ``idx`` (the first query's position) of phase 3's rows: on and beside
#: block edges, then the mixed-length batch (valid lengths idx + s)
EDGE_IDX = (0, 1, 15, 16, 17, 31, 32, 100, 255, 511)


def _kernel_cases():
    """(pool, q dtype, s, nh, n_kv, hd, bs, mb, idx): the flagship shapes (hd
    128, MHA 12/12) and GQA 32/8 at decode and prefill-chunk s in every pool
    dtype, with 40-entry tables; hd 64 and a table of one 64-key tile, and
    bf16 queries on an int8 pool (a bf16 model serving int8 KV). Then the
    edges of the kernel's design: block sizes 8 and 32 (tiles that straddle
    pages, pages larger than a warp's 16 keys); one batch whose rows' valid
    lengths run 1, 127, 128, 129, 1000 (so the rows use different numbers of
    splits), at decode and in a 32-query chunk; GQA 32/8 chunks at s = 32
    (eight 16-row tiles a kv head) over that batch; and s = 5 (rows that do
    not fill a 16-row tile). Last, head dims 16 (MHA 4/4, the tiny preset's
    shape) and 32 (GQA 8/2) in every pool dtype with f32 and bf16 queries,
    and the mixed-length batch at hd 16."""
    def edge(s, bs, mb):
        return tuple(i for i in EDGE_IDX if i + s <= mb * bs)

    cases = [(pool, "bf16" if pool == "bf16" else "f32", s, nh, n_kv, 128, 16, 40,
              edge(s, 16, 40))
             for pool in ("f32", "bf16", "int8", "fp8")
             for nh, n_kv in ((12, 12), (32, 8)) for s in (1, 32)]
    cases += [(pool, q, s, 8, 2, 64, 16, 8, edge(s, 16, 8))
              for pool, q in (("f32", "f32"), ("bf16", "bf16")) for s in (1, 32)]
    cases += [("int8", "bf16", s, 12, 12, 128, 16, 40, edge(s, 16, 40)) for s in (1, 32)]
    for bs in (8, 32):
        mb = 640 // bs
        cases += [(pool, q, s, nh, n_kv, 128, bs, mb, edge(s, bs, mb))
                  for pool, q, s, nh, n_kv in (("bf16", "bf16", 1, 12, 12),
                                               ("bf16", "bf16", 32, 32, 8),
                                               ("f32", "f32", 1, 12, 12),
                                               ("int8", "bf16", 32, 12, 12))]
    mixed = {1: (0, 126, 127, 128, 999), 32: (0, 95, 96, 97, 968)}  # lengths 1/32 .. 1000
    cases += [(pool, q, 1, 12, 12, 128, 16, 64, mixed[1])
              for pool, q in (("bf16", "bf16"), ("f32", "f32"), ("int8", "bf16"), ("fp8", "f32"))]
    cases += [("bf16", "bf16", 32, nh, n_kv, 128, 16, 64, mixed[32])
              for nh, n_kv in ((12, 12), (32, 8))]
    cases += [("f32", "f32", 32, 32, 8, 128, 16, 64, mixed[32])]
    cases += [(pool, q, 5, nh, n_kv, 128, 16, 40, edge(5, 16, 40))
              for pool, q, nh, n_kv in (("bf16", "bf16", 12, 12), ("bf16", "bf16", 32, 8),
                                        ("f32", "f32", 32, 8))]
    # head dims 16 (the tiny preset's, MHA 4/4) and 32 (GQA 8/2): every pool
    # with f32 and bf16 queries, then the mixed-length batch at hd 16
    cases += [(pool, q, s, nh, n_kv, hd, 16, 8, edge(s, 16, 8))
              for hd, nh, n_kv in ((16, 4, 4), (32, 8, 2))
              for pool in ("f32", "bf16", "int8", "fp8") for q in ("f32", "bf16")
              for s in (1, 32)]
    cases += [(pool, q, 1, 4, 4, 16, 16, 64, mixed[1])
              for pool, q in (("bf16", "bf16"), ("f32", "f32"))]
    return cases


def check_kernel_vs_plain(dev) -> dict:
    """Gates: f32 ``atol=rtol=1e-5``; a bf16 output (bf16 queries) ``atol=2e-2``
    compared in f32; int8 / fp8 pools ``atol=rtol=1e-4`` on the same
    quantized bytes. Every case launches the kernel twice and requires
    bit-identical outputs (the splits merge in a fixed order)."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    errs: dict = {}
    for pool, q_dtype, s, nh, n_kv, hd, bs, mb, idx in _kernel_cases():
        q, kp, vp, ks, vs, bt, ix = _filled_pools(
            rng, b=len(idx), s=s, nh=nh, n_kv=n_kv, hd=hd, bs=bs, mb=mb, idx=idx,
            pool=pool, q_dtype=q_dtype, dev=dev,
        )
        out = pa.paged_attention(q, kp, vp, bt, ix, ks, vs)
        again = pa.paged_attention(q, kp, vp, bt, ix, ks, vs)
        ref = pa.paged_attention(q, kp, vp, bt, ix, ks, vs, impl="plain")
        torch.cuda.synchronize()
        what = (f"{pool} pool, {q_dtype} q, s={s}, nh={nh}, n_kv={n_kv}, hd={hd}, bs={bs}, "
                f"mb={mb}, lengths {min(idx) + s}..{max(idx) + s}")
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"kernel output not finite ({what})")
        if not torch.equal(out, again):
            raise AssertionError(f"two launches of the kernel differ ({what})")
        err = (out.float() - ref.float()).abs().max().item()
        if q_dtype == "bf16":
            ok = torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=0)
        else:
            tol = 1e-5 if pool == "f32" else 1e-4
            ok = torch.allclose(out, ref, atol=tol, rtol=tol)
        log(f"  paged_attention {what}: max |kernel - plain| = {err:.3e}, "
            f"bit-identical twice {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"paged_attention kernel disagrees ({what})")
        key = f"{pool}/{q_dtype}"
        errs[key] = max(errs.get(key, 0.0), err)
    return errs


# -- phase 4 ----------------------------------------------------------------


def check_flagship_forward(dev) -> float:
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.flagship_700m()
    model = LlamaForCausalLM.from_config(cfg, seed=0, dtype=torch.float32, device=dev)
    bs, mb, chunk, steps = 16, 64, 64, 8
    nb = mb + 1
    shape = (cfg.num_hidden_layers, nb, bs, cfg.num_key_value_heads, cfg.head_dim)
    bt = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)[None, :]
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, chunk), generator=gen, device=dev)
    logits, fed = {}, []
    for impl in (None, "plain"):  # the plain run is fed the kernel run's tokens
        pages = {"k": torch.zeros(shape, device=dev), "v": torch.zeros(shape, device=dev)}
        out = model.paged_step(prompt, pages, bt, torch.zeros(1, dtype=torch.int32, device=dev),
                               attn_impl=impl)
        seq = [out.logits[0]]
        for t in range(steps):
            if impl is None:
                fed.append(seq[-1][-1:].argmax(-1)[None])  # [1, 1] greedy pick
            pos = torch.full((1,), chunk + t, dtype=torch.int32, device=dev)
            out = model.paged_step(fed[t], pages, bt, pos, attn_impl=impl)
            seq.append(out.logits[0])
        logits[impl] = seq
    torch.cuda.synchronize()
    diff = max((a - b).abs().max().item() for a, b in zip(logits[None], logits["plain"]))
    if not all(torch.isfinite(x).all() for x in logits[None]):
        raise AssertionError("flagship logits not finite")
    if logits[None][0].shape != (chunk, cfg.vocab_size):
        raise AssertionError(f"flagship prefill logits shape {tuple(logits[None][0].shape)}")
    log(f"  flagship f32 paged step ({chunk}-token prefill + {steps} decode steps): "
        f"max |Δ logits| kernel vs plain = {diff:.3e}")
    if not diff <= 1e-3:
        raise AssertionError("flagship logits: kernel and plain disagree beyond 1e-3")
    return diff


# -- phase 5 ----------------------------------------------------------------

SERVE_ARGS = ["serve", "--preset", "flagship", "--dtype", "bf16", "--num-slots", "8",
              "--max-seq-len", "1024"]


def _requests(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    lens = np.linspace(16, 900, n).astype(int)
    return [
        {"id": i, "prompt": rng.integers(1, 32000, size=int(L)).tolist(), "max_new_tokens": 64}
        for i, L in enumerate(lens)
    ]


def _check_rows(rows: list[dict], n: int, what: str) -> None:
    if len(rows) != n:
        raise AssertionError(f"{what}: {len(rows)} answers for {n} requests")
    for row in rows:
        if "error" in row:
            raise AssertionError(f"{what}: request {row.get('id')} failed: {row['error']}")
        toks = row["tokens"]
        if not (len(toks) == 64 or row["finish_reason"] == "eos"):
            raise AssertionError(f"{what}: request {row['id']} gave {len(toks)} tokens")
        if not all(0 <= t < 32000 for t in toks):
            raise AssertionError(f"{what}: request {row['id']} emitted an id outside the vocab")


def _serve_stats(stderr: str, what: str) -> dict:
    """The engine's ``stats()`` from serve's ``serve stats: {...}`` line."""
    lines = [ln for ln in stderr.splitlines() if ln.startswith("serve stats: ")]
    if not lines:
        raise AssertionError(f"{what} printed no stats line:\n{stderr[-2000:]}")
    return json.loads(lines[-1][len("serve stats: "):])


def check_graph_counts(stats: dict, layers: int, burst: int, what: str) -> dict:
    """One capture of each program, and the launch counts the engine reports
    equal to its eager launches plus replays × the launches each capture
    recorded: the decode burst ``burst × layers`` launches, all decode; the
    prefill chunk ``layers``, none decode. The eager launches are the two
    warm-ups before the captures and nothing else."""
    graphs = stats["cuda_graphs"]
    if stats["decode_compiles"] != 1 or stats["prefill_compiles"] != 1:
        raise AssertionError(f"{what}: decode_compiles {stats['decode_compiles']}, "
                             f"prefill_compiles {stats['prefill_compiles']} (each must be 1)")
    dec, pre = graphs["decode"], graphs["prefill"]
    if (dec["launches_captured"], dec["decode_launches_captured"]) != (burst * layers,) * 2:
        raise AssertionError(f"{what}: the decode capture recorded {dec}, not "
                             f"{burst * layers} decode launches")
    if (pre["launches_captured"], pre["decode_launches_captured"]) != (layers, 0):
        raise AssertionError(f"{what}: the prefill capture recorded {pre}, not {layers} "
                             "launches with more than one query a row")
    eager = stats["paged_attention_eager_launches"]
    total = eager + sum(g["replays"] * g["launches_captured"] for g in graphs.values())
    decode = stats["paged_attention_decode_launches"]
    launches = {"total": stats["paged_attention_launches"], "decode": decode,
                "other": stats["paged_attention_launches"] - decode,
                "eager": eager, "decode_replays": dec["replays"],
                "prefill_replays": pre["replays"]}
    if total != launches["total"] or not 0 < decode < total:
        raise AssertionError(f"{what}: launches {launches} are not eager {eager} + replays × "
                             f"captured ({graphs})")
    if eager != dec["launches_captured"] + pre["launches_captured"]:
        raise AssertionError(f"{what}: {eager} eager launches, not one warm-up of each program "
                             "(the engine ran a burst or a chunk outside its graphs)")
    return launches


def run_serve_subprocess() -> dict:
    reqs = _requests(12, seed=0)
    stdin = "".join(json.dumps(r) + "\n" for r in reqs)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch", *SERVE_ARGS],
        input=stdin, capture_output=True, text=True, cwd=REPO, timeout=SERVE_TIMEOUT_S,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    _check_rows(rows, len(reqs), "serve (bf16 KV)")
    summary = [ln for ln in proc.stderr.splitlines() if ln.startswith("served ")]
    m = re.search(r"paged_attention launches (\d+) \(decode (\d+), other (\d+)\)",
                  summary[-1] if summary else "")
    if m is None:
        raise AssertionError(f"serve printed no launch summary:\n{proc.stderr[-2000:]}")
    printed = {"total": int(m.group(1)), "decode": int(m.group(2)), "other": int(m.group(3))}
    log(f"  serve subprocess: {len(rows)} answers in {wall:.1f} s; {summary[-1]}")
    if printed["decode"] + printed["other"] != printed["total"]:
        raise AssertionError(f"serve's paged-attention launch counts are wrong: {printed}")
    stats = _serve_stats(proc.stderr, "serve (bf16 KV)")
    launches = check_graph_counts(stats, 16, 8, "serve (bf16 KV)")
    if {k: launches[k] for k in printed} != printed:
        raise AssertionError(f"serve's summary {printed} and stats {launches} disagree")
    return {"launches": launches, "wall_s": wall, "tokens_per_sec": stats["tokens_per_sec"],
            "host_fraction": stats["host_fraction"], "tokens": stats["tokens_emitted"],
            "iteration_phases_s": stats["iteration_phases_s"]}


def run_serve_int8_inprocess() -> dict:
    from accelerate_tpu_torch.commands import serve
    from accelerate_tpu_torch.commands.accelerate_cli import build_parser
    from accelerate_tpu_torch.ops import paged_attention as pa

    args = build_parser().parse_args([*SERVE_ARGS, "--kv-dtype", "int8"])
    pa.launches = pa.decode_launches = 0
    engine = serve._make_engine(args)
    reqs = _requests(4, seed=1)
    handles = [engine.add_request(r["prompt"], r["max_new_tokens"]) for r in reqs]
    engine.run_until_idle()
    # the wrapper counts what it launched or recorded into a capture; the
    # engine multiplies the captures by their replays
    recorded = {"total": pa.launches, "decode": pa.decode_launches}
    stats = engine.stats()
    rows = [serve._result_dict(h, r["id"]) for h, r in zip(handles, reqs)]
    _check_rows(rows, len(reqs), "serve (int8 KV, in-process)")
    launches = check_graph_counts(stats, 16, 8, "serve (int8 KV, in-process)")
    graphs = stats["cuda_graphs"]
    if recorded["total"] != launches["eager"] + sum(g["launches_captured"]
                                                    for g in graphs.values()):
        raise AssertionError(f"int8 serve: the wrapper counted {recorded}, not the eager "
                             f"launches and the captures ({launches}, {graphs})")
    log(f"  serve int8 KV in-process: {len(rows)} answers, paged_attention launches {launches} "
        f"(the wrapper counted {recorded}: warm-ups and captures), kv_dtype {stats['kv_dtype']}")
    del engine
    torch.cuda.empty_cache()
    return launches


def run_serve_tiny_defaults() -> dict:
    """``serve --preset tiny`` on its defaults (f32, head dim 16) on the card."""
    rng = np.random.default_rng(4)
    reqs = [{"id": i, "prompt": rng.integers(1, 256, size=int(n)).tolist(), "max_new_tokens": 16}
            for i, n in enumerate((3, 40, 200, 17, 90, 5))]
    stdin = "".join(json.dumps(r) + "\n" for r in reqs)
    proc = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", "serve", "--preset",
                           "tiny"], input=stdin, capture_output=True, text=True, cwd=REPO,
                          timeout=SERVE_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"serve --preset tiny exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    if len(rows) != len(reqs) or any("error" in r or len(r["tokens"]) != 16 for r in rows):
        raise AssertionError(f"serve --preset tiny did not answer every request: {rows}")
    stats = _serve_stats(proc.stderr, "serve --preset tiny")
    launches = check_graph_counts(stats, 2, 8, "serve --preset tiny")
    log(f"  serve --preset tiny (head dim 16, f32): {len(rows)} answers; "
        f"{[ln for ln in proc.stderr.splitlines() if ln.startswith('served ')][-1]}")
    return launches


# -- phase 5b, 5c -------------------------------------------------------------

#: a divergence from the eager reference within this share of the
#: reference's largest |logit| (four bf16 ulps at the top) is rounding: the
#: logits are bf16, so picks an ulp apart are ties
BF16_NOISE = 2.0 ** -5


def _flagship_engine(model, **kw):
    from accelerate_tpu_torch.serving import EngineConfig, InferenceEngine

    return InferenceEngine(model, EngineConfig(num_slots=8, max_seq_len=1024, **kw),
                           device="cuda")


def _eager_reference(model, prompt, new_tokens, cfg):
    """One request alone through ``model.paged_step`` in a Python loop, at
    the engine's shapes (prefill chunks ``[1, c]``; decode steps ``[num_slots,
    1]`` with the request in slot 0 and every other lane inactive), greedy.
    Returns its tokens and each pick's logits (f32)."""
    dev = torch.device("cuda")
    c, bs, n = cfg.prefill_chunk, cfg.block_size, cfg.num_slots
    mb = cfg.blocks_per_slot
    mc = model.config
    shape = (mc.num_hidden_layers, mb + 1, bs, mc.num_key_value_heads, mc.head_dim)
    pages = {"k": torch.zeros(shape, dtype=model.dtype, device=dev),
             "v": torch.zeros(shape, dtype=model.dtype, device=dev)}
    tables = torch.zeros((n, mb), dtype=torch.int32, device=dev)
    tables[0] = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)
    for start in range(0, len(prompt), c):
        piece = prompt[start:start + c]
        chunk = torch.zeros((1, c), dtype=torch.int32, device=dev)
        chunk[0, :len(piece)] = torch.as_tensor(piece, dtype=torch.int32)
        valid = torch.zeros((1, c), dtype=torch.int32, device=dev)
        valid[0, :len(piece)] = 1
        out = model.paged_step(chunk, pages, tables[:1],
                               torch.tensor([start], dtype=torch.int32, device=dev),
                               paged_write_mask=valid)
    picks = [out.logits[0, len(piece) - 1].float()]  # the last chunk, at the prompt's last id
    tokens = [int(picks[-1].argmax())]
    active = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    active[0] = 1
    for t in range(new_tokens - 1):
        toks = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        toks[0, 0] = tokens[-1]
        pos = torch.zeros((n,), dtype=torch.int32, device=dev)
        pos[0] = len(prompt) + t
        out = model.paged_step(toks, pages, tables, pos, paged_write_mask=active)
        picks.append(out.logits[0, -1].float())
        tokens.append(int(picks[-1].argmax()))
    return tokens, picks


def check_graph_engine_parity(model) -> dict:
    """The 12 phase-5 requests, greedy, through the graph engine with async
    dispatch on and off (bit-identical tokens), each against the eager
    reference: where a request parts from it, the first divergence and the
    reference's top-2 logit margin there are printed, and a divergence whose
    gap (the reference's logit of its pick over that of the engine's) is
    above ``BF16_NOISE`` × its largest |logit| fails."""
    reqs = _requests(12, seed=0)
    legs, walls = {}, {}
    for async_dispatch in (True, False):
        engine = _flagship_engine(model, async_dispatch=async_dispatch)
        handles = [engine.add_request(r["prompt"], r["max_new_tokens"]) for r in reqs]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_until_idle()
        torch.cuda.synchronize()
        walls[async_dispatch] = time.perf_counter() - t0
        legs[async_dispatch] = [list(h.output_tokens) for h in handles]
        check_graph_counts(engine.stats(), 16, 8, f"graph engine (async {async_dispatch})")
        cfg = engine.config
        del engine
    torch.cuda.empty_cache()
    if legs[True] != legs[False]:
        bad = [i for i, (a, b) in enumerate(zip(legs[True], legs[False])) if a != b]
        raise AssertionError(f"async and sync graph engines differ on requests {bad}")
    log(f"  async and sync graph engines: identical tokens for {len(reqs)} requests "
        f"({walls[True]:.2f} s and {walls[False]:.2f} s to drain)")
    matched, diverged = 0, []
    for r, got in zip(reqs, legs[True]):
        ref, picks = _eager_reference(model, r["prompt"], r["max_new_tokens"], cfg)
        if got == ref:
            matched += 1
            continue
        t = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
        logits = picks[t]
        top = torch.topk(logits, 2).values
        margin = float(top[0] - top[1])
        gap = float(logits[ref[t]] - logits[got[t]])
        noise = BF16_NOISE * float(logits.abs().max())
        diverged.append({"id": r["id"], "token": t, "top2_margin": margin, "gap": gap,
                         "noise": noise})
        log(f"  request {r['id']} parts from the eager reference at token {t}: engine "
            f"{got[t]} vs reference {ref[t]}; reference top-2 margin {margin:.4e}, gap "
            f"{gap:.4e}, bf16 noise {noise:.4e}")
        if gap > noise:
            raise AssertionError(f"request {r['id']}: a divergence above bf16 noise")
    log(f"  eager reference: {matched} of {len(reqs)} requests identical, {len(diverged)} part "
        "within bf16 noise")
    return {"identical_async_sync": True, "matched_reference": matched, "diverged": diverged,
            "drain_s": {"async": walls[True], "sync": walls[False]}}


def check_sampled_pair(model) -> dict:
    """Two engines with the same seed and ``do_sample=True`` give the same
    tokens; the generator the graphs draw from advances on every replay."""
    reqs = _requests(4, seed=5)
    outs, offsets = [], []
    for _ in range(2):
        engine = _flagship_engine(model, do_sample=True, temperature=1.0, seed=11)
        gen = engine._generator
        handles = [engine.add_request(r["prompt"], r["max_new_tokens"]) for r in reqs]
        engine.step()
        engine.step()
        torch.cuda.synchronize()
        seen = [gen.get_offset()]
        for _ in range(2):
            engine.step()
            torch.cuda.synchronize()
            seen.append(gen.get_offset())
        engine.run_until_idle()
        outs.append([list(h.output_tokens) for h in handles])
        offsets.append(seen)
        check_graph_counts(engine.stats(), 16, 8, "sampled engine")
        del engine
    torch.cuda.empty_cache()
    if outs[0] != outs[1]:
        raise AssertionError("two sampled engines with the same seed gave different tokens")
    if not all(a < b for seen in offsets for a, b in zip(seen, seen[1:])):
        raise AssertionError(f"the generator did not advance on every replay: {offsets}")
    _check_rows([{"id": i, "tokens": t, "finish_reason": "length"} for i, t in enumerate(outs[0])],
                len(reqs), "sampled engine")
    log(f"  sampled pair (seed 11, temperature 1.0): identical tokens for {len(reqs)} requests; "
        f"generator offsets {offsets[0]}")
    return {"identical": True, "generator_offsets": offsets[0]}


# -- phase 6 ----------------------------------------------------------------


def _time_spread(fn, calls: int, repeats: int) -> list:
    """``[min, median, max]`` over ``repeats`` of the mean per-call time of
    ``calls`` calls, by CUDA events, after a warm-up."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(calls):
            fn(i)
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / calls)
    samples.sort()
    return [samples[0], samples[len(samples) // 2], samples[-1]]


def _time_ms(fn, calls: int, repeats: int) -> float:
    """The median of :func:`_time_spread`."""
    return _time_spread(fn, calls, repeats)[1]


PAGED_KERNELS = ("paged_attention_kernel", "combine_splits_kernel")
#: what the kernels line carries of B4's other timed shapes
PAGED_TIMED_KEYS = ("kernel_ms", "profiler_ms_per_launch", "plain_ms", "library_ms",
                    "library_events_ms", "bound_ms", "hbm_share_split_kernel")


def _profiled_rows(fn, calls: int) -> list:
    """The kernel rows of ``calls`` calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    return _kernel_rows(prof)


def _profiled_ms_per_call(fn, calls: int) -> float:
    """Device time a call of ``fn``: every kernel it runs, without the host
    time between them (a library call whose host cost exceeds its kernels'
    time shows more by events than here). A window in which the profiler
    saw no kernel row is taken once more, then raises: a time of 0.0 is
    never returned."""
    for _ in range(2):
        rows = _profiled_rows(fn, calls)
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3 / calls
    raise AssertionError("the profiler saw no kernel row in two windows of the library call")


def _profiled_ms_per_launch(fn, calls: int, names) -> dict:
    """Device time a launch of each kernel in ``names`` over ``calls`` calls
    of ``fn`` under ``torch.profiler`` (kernel rows whose name holds it)."""
    rows = _profiled_rows(fn, calls)
    out = {}
    for name in names:
        hits = [e for e in rows if name in e.key]
        launches = sum(e.count for e in hits)
        if not launches:
            raise AssertionError(f"the profiler saw no {name} launch")
        out[name] = sum(e.self_device_time_total for e in hits) / 1e3 / launches
    return out


def time_paged_shape(dev, b: int = 8, s: int = 1, ctx: int = 512) -> dict:
    """B4 timed at ``b`` rows of ``s`` queries whose last query sits at
    position ``ctx - 1`` (decode: 8 slots, s = 1; the prefill chunk: b = 1,
    s = 32), flagship heads (12 × 128), bf16, 16-key pages in a 64-entry
    table, the 16 layers' pools rotated so L2 does not hold them."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import paged_attention as pa

    layers, nh, hd, bs, mb = 16, 12, 128, 16, 64
    nb = b * mb + 1
    gen = torch.Generator(device=dev).manual_seed(2)
    bt = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = ctx // bs
    bt[:, :used] = torch.arange(1, b * used + 1, dtype=torch.int32, device=dev).reshape(b, used)
    start = ctx - s  # the first query's position
    idx = torch.full((b,), start, dtype=torch.int32, device=dev)
    pools = [
        (torch.randn((nb, bs, nh, hd), generator=gen, device=dev).to(torch.bfloat16),
         torch.randn((nb, bs, nh, hd), generator=gen, device=dev).to(torch.bfloat16))
        for _ in range(layers)
    ]
    qs = [torch.randn((b, s, nh, hd), generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(layers)]
    # the span gathered ahead of time for the library call: [b, h, ctx, hd]
    gathered = [
        tuple(p[bt[:, :used].long()].reshape(b, ctx, nh, hd).transpose(1, 2).contiguous()
              for p in pair)
        for pair in pools
    ]
    # query i sees keys <= start + i (all of them at decode)
    mask = (torch.arange(ctx, device=dev)[None, :]
            <= start + torch.arange(s, device=dev)[:, None])[None, None]
    lq = [x.transpose(1, 2).contiguous() for x in qs]

    def kernel(i):
        kp, vp = pools[i % layers]
        return pa.paged_attention(qs[i % layers], kp, vp, bt, idx)

    def plain(i):
        kp, vp = pools[i % layers]
        return pa.paged_attention(qs[i % layers], kp, vp, bt, idx, impl="plain")

    def library(i):
        k, v = gathered[i % layers]
        return F.scaled_dot_product_attention(lq[i % layers], k, v, attn_mask=mask)

    err = (kernel(0).float() - plain(0).float()).abs().max().item()
    ref = library(0).transpose(1, 2).float()
    lib_err = (kernel(0).float() - ref).abs().max().item()
    kernel_ms = _time_ms(kernel, calls=160, repeats=9)
    device_ms = _profiled_ms_per_launch(kernel, 160, PAGED_KERNELS)
    plain_ms = _time_ms(plain, calls=16, repeats=5)
    library_ms = _time_ms(library, calls=160, repeats=9)
    library_device_ms = _profiled_ms_per_call(library, 160)
    pairs = b * nh * sum(start + i + 1 for i in range(s))  # (query, key) pairs attended
    kv_bytes = 2 * b * ctx * nh * hd * 2                   # valid K and V, bf16, read once
    io_bytes = 2 * b * s * nh * hd * 2 + b * mb * 4 + b * 4  # q, out, tables, idx
    flops = 4 * pairs * hd                                 # QK^T and PV on the tensor cores
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    split_ms = device_ms["paged_attention_kernel"]
    log(f"  b={b} s={s} ctx={ctx} bf16: kernel {kernel_ms:.4f} ms (events around the "
        f"wrapper; profiler a launch: split {split_ms:.4f} ms, "
        f"combine {device_ms['combine_splits_kernel']:.4f} ms), plain {plain_ms:.4f} ms, "
        f"sdpa (span pre-gathered, gather excluded) {library_device_ms:.4f} ms a call by the "
        f"profiler ({library_ms:.4f} ms by events), "
        f"bound {max(bytes_ms, ops_ms):.4f} ms ({kv_bytes / 1e6:.2f} MB of K/V, the split kernel at "
        f"{(kv_bytes + io_bytes) / (split_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of HBM's rate); "
        f"|kernel - plain| {err:.2e}, |kernel - sdpa| {lib_err:.2e}")
    return {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_device_ms,
        "profiler_ms_per_launch": device_ms, "library_events_ms": library_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "hbm_share_split_kernel": (kv_bytes + io_bytes) / (split_ms * 1e-3) / HBM_BYTES_PER_S,
        "shape": {"rows": b, "queries": s, "context": ctx, "n_heads": nh, "n_kv": nh,
                  "head_dim": hd, "block_size": bs, "max_blocks": mb, "dtype": "bf16",
                  "layers_rotated": layers},
        "library_call": "scaled_dot_product_attention over the pre-gathered span, "
                        "boolean mask (causal offset in a chunk); gather excluded",
    }


# -- phase 7 ----------------------------------------------------------------


def _kernel_rows(prof) -> list:
    """The profiler's device rows that are kernels: user annotations (such
    as the optimizer's ``Optimizer.step`` range) also appear on the device
    timeline, span other kernels, and would count their time twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _engine_leg(model, async_dispatch: bool, bursts: int = 4) -> dict:
    """One leg of phase 7: the graph engine (8 slots, prompts of 100 ids,
    128 new tokens) past admission and prefill, then ``bursts`` timed
    ``step()`` calls (the host clock, synchronised before and after), their
    flight-recorder summary, and two more steps under ``torch.profiler``
    (kernel rows only; synchronised before, so exactly the two rounds they
    dispatch run in the window). Returns the numbers and the engine."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.serving import RequestState

    engine = _flagship_engine(model, async_dispatch=async_dispatch)
    rng = np.random.default_rng(3)
    for _ in range(engine.config.num_slots):
        engine.add_request(rng.integers(1, 32000, size=100).tolist(), 128)
    while engine.scheduler.queue_depth or engine.scheduler.active(RequestState.PREFILL):
        engine.step()  # admission and chunked prefill; the graphs are captured here
    engine.step()
    steps = bursts * engine.config.decode_burst
    torch.cuda.synchronize()
    engine.reset_stats()
    t0 = time.perf_counter()
    for _ in range(bursts):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    stats = engine.stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            engine.step()
        torch.cuda.synchronize()
    kernels = _kernel_rows(prof)
    prof_steps = 2 * engine.config.decode_burst
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / prof_steps
    if not device_ms > 0:
        raise AssertionError("the profiler saw no kernel in the serve window")
    paged_ms = sum(e.self_device_time_total for e in kernels
                   if "paged_attention" in e.key or "combine_splits" in e.key) / 1e3 / prof_steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    check_graph_counts(engine.stats(), 16, 8, f"phase 7 engine (async {async_dispatch})")
    # the decode graph alone, replayed on an idle card (the last round's
    # operands again: the same writes): the host time of the replay call,
    # and the wall from the call until the card is idle, against the
    # burst's device time
    graph = engine._programs["decode"].graph
    launch_ms, burst_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.replay()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        launch_ms.append((t1 - t0) * 1e3)
        burst_ms.append((time.perf_counter() - t0) * 1e3)
    return {
        "async_dispatch": async_dispatch,
        "decode_steps_timed": steps,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels) / prof_steps,
        "paged_attention_share_of_device": paged_ms / device_ms,
        "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / 1e3 / prof_steps
                                    for e in top},
        "tokens_per_s": stats["tokens_per_sec"],
        "host_fraction": stats["host_fraction"],
        "overlap_hidden_s": stats["overlap_hidden_s"],
        "iteration_p50_s": stats["iteration_p50_s"],
        "phase_p50_ms": {p: v["p50"] * 1e3 for p, v in stats["iteration_phases_s"].items()},
        "decode_graph_replay_call_ms": sorted(launch_ms)[1],
        "decode_graph_replay_to_idle_ms": sorted(burst_ms)[1],
        "decode_graph_device_ms": device_ms * engine.config.decode_burst,
    }, engine


def serve_breakdown(model) -> dict:
    """Where a flagship decode step's time goes on the graph engine (bf16,
    8 slots): async and sync legs alternating (async, sync, async, sync),
    each its own engine; then one paged step over the last engine's pools,
    eager against replayed from a CUDA graph of its own."""
    legs, engine = [], None
    for async_dispatch in (True, False, True, False):
        engine = None  # the previous leg's pools go before the next leg's
        leg, engine = _engine_leg(model, async_dispatch)
        legs.append(leg)
        log(f"  {'async' if async_dispatch else 'sync '} graph engine: decode step wall "
            f"{leg['wall_ms_per_step']:.3f} ms, device {leg['device_ms_per_step']:.3f} ms "
            f"(busy {leg['device_busy_share']:.1%}), {leg['kernels_per_step']:.0f} kernels; "
            f"{leg['tokens_per_s']:.1f} tok/s; host_fraction {leg['host_fraction']:.4f}; "
            f"phase p50 ms {json.dumps({k: round(v, 4) for k, v in leg['phase_p50_ms'].items()})}; "
            f"the decode graph on an idle card: replay call "
            f"{leg['decode_graph_replay_call_ms']:.3f} ms, call to idle "
            f"{leg['decode_graph_replay_to_idle_ms']:.3f} ms, device "
            f"{leg['decode_graph_device_ms']:.3f} ms")

    # one decode step over the engine's pools, every lane inactive (writes
    # land in the null block), eager and replayed from a graph
    n = engine.config.num_slots
    toks = torch.zeros((n, 1), dtype=torch.int32, device="cuda")
    tables = torch.as_tensor(engine._block_tables, device="cuda")
    pos = torch.full((n,), 100, dtype=torch.int32, device="cuda")
    lanes = torch.zeros((n, 1), dtype=torch.bool, device="cuda")

    def step():
        return model.paged_step(toks, engine._pages, tables, pos, paged_write_mask=lanes)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    reps = 20
    graph_ms = _time_ms(lambda i: graph.replay(), calls=reps, repeats=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / reps
    log(f"  one paged step: eager {eager_ms:.2f} ms vs replayed from a graph {graph_ms:.2f} ms")
    del graph, engine
    torch.cuda.empty_cache()
    return {"legs": legs, "eager_step_ms": eager_ms, "graph_replay_step_ms": graph_ms}


# -- phase 8 ----------------------------------------------------------------

FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _flash_counts() -> dict:
    from accelerate_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.fwd_launches, "flash_bwd_dq": fa.bwd_dq_launches,
            "flash_bwd_dkv": fa.bwd_dkv_launches}


def _zero_flash_counts() -> None:
    from accelerate_tpu_torch.ops import flash_attention as fa

    fa.fwd_launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0


def _flash_cases():
    """(b, s, nh, n_kv, hd, causal, left pad or 0, dtype)."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        (8, 1024, 12, 12, 128, True, 0, f32),      # the flagship training shape
        (8, 1024, 12, 12, 128, True, 0, bf16),
        (8, 1024, 12, 12, 128, False, 0, bf16),
        (2, 1024, 32, 8, 128, True, 0, f32),       # GQA 32/8
        (2, 1024, 32, 8, 128, False, 0, bf16),
        (2, 1024, 32, 8, 64, True, 0, bf16),
        (2, 1024, 32, 8, 64, False, 0, f32),
        (4, 1000, 12, 12, 128, True, 0, bf16),     # s not a multiple of the 64 tile
        (4, 1000, 12, 12, 128, True, 77, f32),     # left-padded: rows 0..76 fully masked
        (4, 1000, 32, 8, 64, True, 130, bf16),
        (2, 1000, 32, 8, 64, False, 130, f32),
        (2, 129, 12, 12, 128, True, 0, bf16),      # one row past a 128-row tile
        (2, 200, 32, 8, 64, True, 130, bf16),      # query tile 0 (rows 0..127) fully masked
        (2, 1000, 32, 8, 128, True, 0, bf16),      # GQA at flagship width, no tile multiple
        (2, 200, 32, 8, 128, False, 130, bf16),    # keys 128, 129 masked in key tile 128..191
    ]


def _flash_inputs(rng, b, s, nh, n_kv, hd, pad, dtype, dev):
    def draw(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev).to(dtype)

    q, do = draw(b, s, nh, hd), draw(b, s, nh, hd)
    k, v = draw(b, s, n_kv, hd), draw(b, s, n_kv, hd)
    mask = None
    if pad:
        mask = torch.ones((b, s), dtype=torch.bool, device=dev)
        mask[:, :pad] = False
    return q, k, v, do, mask


def _scaled_err(got, ref) -> float:
    """max |got - ref| / max(|ref|, 1), in f32."""
    return ((got.float() - ref.float()).abs().max() / max(ref.float().abs().max().item(), 1.0)).item()


def check_flash_vs_plain(dev) -> dict:
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.layers import causal_attention, dot_product_attention

    rng = np.random.default_rng(8)
    errs = {name: {"f32": 0.0, "bf16": 0.0} for name in FLASH_KERNELS}
    autograd_err = 0.0
    for b, s, nh, n_kv, hd, causal, pad, dtype in _flash_cases():
        q, k, v, do, mask = _flash_inputs(rng, b, s, nh, n_kv, hd, pad, dtype, dev)
        f32 = dtype == torch.float32
        o, lse = fa.flash_fwd(q, k, v, mask, causal=causal, impl="cuda")
        dq, dk, dv = fa.flash_bwd(q, k, v, mask, o, lse, do, causal=causal, impl="cuda")
        ro, rlse = fa.flash_fwd(q, k, v, mask, causal=causal, impl="plain")
        # the plain backward from the plain forward's (o, lse)
        rdq, rdk, rdv = fa.flash_bwd(q, k, v, mask, ro, rlse, do, causal=causal, impl="plain")
        torch.cuda.synchronize()
        what = (f"b={b} s={s} nh={nh} n_kv={n_kv} hd={hd} causal={causal} pad={pad} "
                f"{'f32' if f32 else 'bf16'}")
        outs = (o, lse, dq, dk, dv)
        if not all(torch.isfinite(t.float()).all() for t in outs):
            raise AssertionError(f"flash kernel output not finite ({what})")
        if (lse == fa.NEG_INF).ne(rlse == fa.NEG_INF).any():
            raise AssertionError(f"flash kernel: fully masked rows differ ({what})")
        o_err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        g_errs = [_scaled_err(g, r) for g, r in ((dq, rdq), (dk, rdk), (dv, rdv))]
        o_gate, g_gate = (2e-5, 2e-4) if f32 else (3e-2, 5e-2)
        ok = o_err <= o_gate and lse_err <= 1e-5 and max(g_errs) <= g_gate
        if pad and causal:  # rows with no valid key: output 0, dq 0
            ok = ok and o[:, :pad].abs().max().item() == 0.0 and dq[:, :pad].abs().max().item() == 0.0
        line = (f"  flash {what}: |o| {o_err:.2e} |lse| {lse_err:.2e} "
                f"dq/dk/dv {g_errs[0]:.2e}/{g_errs[1]:.2e}/{g_errs[2]:.2e}")
        if f32 and not pad:
            # the kernels' grads against autograd through the reference attention
            rq, rk, rv = (t.detach().clone().requires_grad_() for t in (q, k, v))
            ref = causal_attention(rq, rk, rv) if causal else dot_product_attention(rq, rk, rv)
            ref.backward(do)
            a_errs = [_scaled_err(g, r.grad) for g, r in ((dq, rq), (dk, rk), (dv, rv))]
            a_errs.append((o - ref.detach()).abs().max().item())
            autograd_err = max(autograd_err, *a_errs[:3])
            ok = ok and max(a_errs[:3]) <= 2e-4 and a_errs[3] <= 2e-5
            line += f"; vs autograd: grads {max(a_errs[:3]):.2e}, o {a_errs[3]:.2e}"
            del rq, rk, rv, ref
        log(line + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"flash kernels disagree with the plain versions ({what})")
        key = "f32" if f32 else "bf16"
        g_abs = [(g.float() - r.float()).abs().max().item()
                 for g, r in ((dq, rdq), (dk, rdk), (dv, rdv))]
        for name, err in zip(FLASH_KERNELS, (o_err, g_abs[0], max(g_abs[1:]))):
            errs[name][key] = max(errs[name][key], err)
        del q, k, v, do, mask, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return {"by_dtype": errs, "autograd_grad_err_f32": autograd_err}


# -- phase 9 ----------------------------------------------------------------


#: phase 9's gates by dtype: (loss relative, grads × max(|ref|, 1)). f32: the
#: kernels and the plain version agree to f32 rounding. bf16: each output is
#: rounded to bf16, so sums taken in another order move it by an ulp
#: (2^-8 relative), and that difference crosses two layers and the loss.
STEP_GATES = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}


def check_train_step_kernel_vs_plain(dev) -> dict:
    import dataclasses

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops.attention import attention_context

    cfg = dataclasses.replace(LlamaConfig.flagship_700m(), num_hidden_layers=2)
    rng = np.random.default_rng(9)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 512)), device=dev)
    mask = torch.ones((2, 512), dtype=torch.int32, device=dev)
    mask[1, :100] = 0  # a left-padded row: its first 100 queries see no key
    labels = torch.where(mask.bool(), ids, -100)
    out = {}
    for dtype, (loss_gate, grad_gate) in STEP_GATES.items():
        model = LlamaForCausalLM.from_config(cfg, seed=0, dtype=dtype, device=dev)
        results = {}
        for flash_impl in (None, "plain"):
            model.zero_grad(set_to_none=True)
            with attention_context(impl="flash", flash_impl=flash_impl):
                loss = model(ids, attention_mask=mask, labels=labels).loss
                loss.backward()
            results[flash_impl] = (loss.detach().float(), {n: p.grad.detach().clone()
                                                           for n, p in model.named_parameters()})
        torch.cuda.synchronize()
        (loss_k, grads_k), (loss_p, grads_p) = results[None], results["plain"]
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        grad_err = max(_scaled_err(grads_k[n], grads_p[n]) for n in grads_p)
        finite = all(torch.isfinite(g.float()).all() for g in grads_k.values())
        name = "f32" if dtype == torch.float32 else "bf16"
        log(f"  2-layer flagship-width step (b=2, s=512, {name}): loss {loss_k.item():.6f} vs "
            f"{loss_p.item():.6f} (rel {loss_rel:.2e}, gate {loss_gate:g}); max grad err "
            f"{grad_err:.2e} × max(|ref|, 1) (gate {grad_gate:g})")
        if not (finite and loss_rel <= loss_gate and grad_err <= grad_gate):
            raise AssertionError(f"the {name} train step through the kernels disagrees with the "
                                 "plain path")
        out[name] = {"loss_rel_err": loss_rel, "grad_err": grad_err}
        del model, results
        torch.cuda.empty_cache()
    return out


# -- phase 10 ---------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 1024


def _train_flops_per_step(n_params: int, config, bsz: int, seq: int) -> float:
    """6N per token (fwd+bwd matmuls) + causal self-attention term (the
    formula of the repository's train-step benchmark)."""
    tokens = bsz * seq
    attn = 6.0 * config.num_hidden_layers * tokens * seq * config.hidden_size
    return 6.0 * n_params * tokens + attn


def _timed(step, n: int) -> float:
    """Mean ms per step over ``n`` chained steps, synchronised only at the end."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def run_train_loop() -> dict:
    """The main training path: 2 warm-up and 10 timed steps of the 5-line
    loop. Returns the numbers, the per-step launch counts and the live
    objects phase 11 profiles."""
    from torch.func import functional_call

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.flagship_700m(max_position_embeddings=1024)
    accelerator = Accelerator(mixed_precision="bf16")
    module = LlamaForCausalLM.from_config(cfg, seed=0, device=accelerator.device)
    adamw = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)  # optax.adamw(1e-4)
    model, opt = accelerator.prepare(module, torch.optim.AdamW(module.parameters(), **adamw))
    n_params = sum(p.numel() for p in module.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.as_tensor(ids, device=accelerator.device)
    batch = {"input_ids": ids, "labels": ids}
    losses, per_step = [], []

    def step():
        out = model(**batch)
        accelerator.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(out.loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    for _ in range(2):
        step()
        per_step.append(_flash_counts())
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the first timed window: the same 10 steps
    for _ in range(10):
        step()
        per_step.append(_flash_counts())
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / 10
    counts = _flash_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    loss_vals = [x.item() for x in losses]

    deltas = [{k: c[k] - (per_step[i - 1][k] if i else 0) for k in c}
              for i, c in enumerate(per_step)]
    layers = cfg.num_hidden_layers
    log(f"  flagship bf16 loop: losses {['%.4f' % x for x in loss_vals]}")
    log(f"  flash launches in the 12 steps: {counts}; per step {sorted({tuple(d.values()) for d in deltas})}")
    if not all(np.isfinite(loss_vals)):
        raise AssertionError("a train-step loss is not finite")
    if not loss_vals[-1] < loss_vals[0]:
        raise AssertionError("the loss did not fall over 12 steps on a fixed batch")
    if any(d[k] != layers for d in deltas for k in FLASH_KERNELS):
        raise AssertionError(f"each flash kernel must launch {layers} times per step: {deltas}")

    # the same model and batch through a hand-written step: bf16 copies of
    # every weight, loss.backward(), AdamW.step() (ABBA with the loop)
    params = dict(module.named_parameters())
    raw_opt = torch.optim.AdamW(module.parameters(), **adamw)

    def raw_step():
        p16 = {n: p.to(torch.bfloat16) for n, p in params.items()}
        loss = functional_call(module, p16, (), {"input_ids": ids, "labels": ids}).loss
        loss.backward()
        raw_opt.step()
        raw_opt.zero_grad(set_to_none=True)

    for _ in range(2):
        raw_step()
    raw_ms = [_timed(raw_step, 10)]
    raw_ms.append(_timed(raw_step, 10))
    loop_ms_2 = _timed(step, 10)
    raw_mean, loop_mean = sum(raw_ms) / 2, (loop_ms + loop_ms_2) / 2
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops_per_step(n_params, cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = {
        "n_params": n_params,
        "tokens_per_step": tokens,
        "step_ms": loop_ms,
        "step_ms_repeat": loop_ms_2,
        "tokens_per_s": tokens / (loop_ms / 1e3),
        "mfu": flops / (loop_ms / 1e3) / BF16_FLOPS_PER_S,
        "train_flops_per_step": flops,
        "max_memory_allocated_bytes": peak_bytes,
        "raw_step_ms": raw_ms,
        "vs_raw": raw_mean / loop_mean,
        "losses": loss_vals,
        "launches": counts,
        "launches_per_step": deltas[0],
    }
    log(f"  step {loop_ms:.2f} ms (repeat {loop_ms_2:.2f}), {out['tokens_per_s']:.0f} tokens/s, "
        f"MFU {out['mfu']:.4f} of 989 TFLOP/s, peak memory {peak_bytes / 2**30:.2f} GiB; "
        f"raw step {raw_ms[0]:.2f}/{raw_ms[1]:.2f} ms, vs_raw {out['vs_raw']:.4f}")
    return out, (step, module, opt, raw_opt)


# -- phase 11 ---------------------------------------------------------------


def train_breakdown(step, step_ms: float) -> dict:
    """Kernel rows of one flagship train step under ``torch.profiler``; the
    wall time is the unprofiled step of phase 10 (the profiler's host
    overhead inflates wall)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = _kernel_rows(prof)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not device_ms > 0:
        raise AssertionError("the profiler saw no kernel in the train step")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    # flash_*_kernel (f32) and flash_*_wgmma_kernel (bf16)
    rows = {name: [e for e in kernels if re.search(flash_kernel_pattern(name), e.key)]
            for name in FLASH_KERNELS}
    flash_ms = {name: sum(e.self_device_time_total for e in r) / 1e3 for name, r in rows.items()}
    flash_launches = {name: sum(e.count for e in r) for name, r in rows.items()}
    if not all(flash_ms.values()):
        raise AssertionError(f"the profiled train step shows no flash kernel: {flash_ms}")
    flash_total = sum(flash_ms.values())
    out = {
        "step_wall_ms": step_ms,
        "device_ms": device_ms,
        "device_busy_share": device_ms / step_ms,
        "kernels_launched": sum(e.count for e in kernels),
        "flash_ms": flash_ms,
        "flash_kernel_names": {name: sorted({e.key[:90] for e in r}) for name, r in rows.items()},
        "flash_launches": flash_launches,
        "flash_ms_per_launch": {name: flash_ms[name] / flash_launches[name] for name in flash_ms},
        "flash_share_of_device": flash_total / device_ms,
        "flash_share_of_step": flash_total / step_ms,
        "top_kernels_ms": {e.key[:70]: e.self_device_time_total / 1e3 for e in top},
    }
    log(f"  train step: wall {step_ms:.2f} ms, device {device_ms:.2f} ms "
        f"(busy {out['device_busy_share']:.1%}), {out['kernels_launched']} kernels; "
        f"flash kernels {flash_total:.2f} ms = {out['flash_share_of_step']:.1%} of the step")
    return out


# -- phase 12 ---------------------------------------------------------------


def time_flash_kernels(dev, per_launch_ms: dict) -> dict:
    """``per_launch_ms``: phase 11's profiler device time per launch of each
    kernel in the flagship train step (the same shape)."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    b, s, nh, hd = TRAIN_BATCH, TRAIN_SEQ, 12, 128
    rng = np.random.default_rng(12)
    q, k, v, do, _ = _flash_inputs(rng, b, s, nh, nh, hd, 0, torch.bfloat16, dev)
    scale = 1.0 / float(np.sqrt(hd))
    o, lse = fa.flash_fwd(q, k, v, impl="cuda")
    delta = fa._delta(o, do)

    calls, repeats = 20, 7
    spread = {
        "flash_fwd": _time_spread(lambda i: fa._flash_fwd_cuda(q, k, v, None, scale, True),
                                  calls, repeats),
        "flash_bwd_dq": _time_spread(
            lambda i: fa._bwd_dq_cuda(q, k, v, None, lse, delta, do, scale, True), calls, repeats),
        "flash_bwd_dkv": _time_spread(
            lambda i: fa._bwd_dkv_cuda(q, k, v, None, lse, delta, do, scale, True), calls, repeats),
    }
    plain_fwd = _time_ms(lambda i: fa._flash_fwd_plain(q, k, v, None, scale, True), 3, 3)
    plain_bwd = _time_ms(lambda i: fa._flash_bwd_plain(q, k, v, None, o, lse, do, scale, True),
                         3, 3)

    # the library call, which the port never makes: [b, h, s, d] layout
    lq, lk, lv, ldo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_err = (F.scaled_dot_product_attention(lq, lk, lv, is_causal=True).transpose(1, 2).float()
               - o.float()).abs().max().item()
    spread["library_fwd"] = _time_spread(
        lambda i: F.scaled_dot_product_attention(lq, lk, lv, is_causal=True), calls, repeats)
    # its backward alone: one forward, then autograd.grad over it per call
    gq, gk, gv = (t.detach().clone().requires_grad_() for t in (lq, lk, lv))
    lib_out = F.scaled_dot_product_attention(gq, gk, gv, is_causal=True)
    spread["library_bwd"] = _time_spread(
        lambda i: torch.autograd.grad(lib_out, (gq, gk, gv), ldo, retain_graph=True),
        calls, repeats)
    ms = {name: t[1] for name, t in spread.items()}
    lib_device = {  # its kernels' device time a call, without the host time between calls
        "library_fwd": _profiled_ms_per_call(
            lambda i: F.scaled_dot_product_attention(lq, lk, lv, is_causal=True), calls),
        "library_bwd": _profiled_ms_per_call(
            lambda i: torch.autograd.grad(lib_out, (gq, gk, gv), ldo, retain_graph=True), calls),
    }
    for name, (lo, mid, hi) in spread.items():
        log(f"  {name}: min {lo:.4f} / median {mid:.4f} / max {hi:.4f} ms over {repeats} "
            f"repeats of {calls} calls" + (f"; profiler {lib_device[name]:.4f} ms a call"
                                           if name in lib_device else ""))

    pairs = s * (s + 1) / 2 * b * nh  # causal (query, key) pairs
    tile = b * s * nh * hd * 2        # one bf16 [b, s, nh, hd] tensor
    rows = b * nh * s * 4             # one f32 [b, nh, s] tensor
    work = {  # (flops, bytes): each input read once, each output written once
        "flash_fwd": (2 * 2 * pairs * hd, 4 * tile + rows),               # q k v -> o, lse
        "flash_bwd_dq": (3 * 2 * pairs * hd, 5 * tile + 2 * rows),        # q k v dO lse δ -> dq
        "flash_bwd_dkv": (4 * 2 * pairs * hd, 6 * tile + 2 * rows),       # q k v dO lse δ -> dk dv
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        ops_ms = flops / BF16_FLOPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lib = "library_fwd" if name == "flash_fwd" else "library_bwd"
        out[name] = {
            "kernel_ms": ms[name],
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": lib_device[lib],
            "library_events_ms": ms[lib],
            "library_events_spread": spread[lib],
            "ms_spread": spread[name],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "flops": flops,
            "bytes": nbytes,
            "profiler_ms": per_launch_ms[name],
            "tflops": flops / ms[name] / 1e9,
            "tflops_profiler": flops / per_launch_ms[name] / 1e9,
        }
        log(f"  {name}: kernel {ms[name]:.4f} ms ({out[name]['tflops']:.0f} TFLOP/s), profiler "
            f"{per_launch_ms[name]:.4f} ms a launch ({out[name]['tflops_profiler']:.0f} TFLOP/s), "
            f"plain {out[name]['plain_ms']:.4f} ms, "
            f"library {out[name]['library_ms']:.4f} ms a call by the profiler (events "
            f"{out[name]['library_events_ms']:.4f}), bound {out[name]['bound_ms']:.4f} ms "
            f"({out[name]['bound_by']}: {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"  (plain_ms of the two backward kernels is the plain backward, which computes "
        f"dq, dk and dv together; library_ms of both is sdpa's backward alone, the pair); "
        f"|sdpa - flash_fwd| {lib_err:.2e}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from accelerate_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("phase 1: device")
    smi = nvidia_smi()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    log("phase 2: build")
    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    for src, path in built.items():
        log(f"  {src} -> {os.path.relpath(path, REPO)}")
    log(f"  build seconds: {build_s:.2f}")
    ptxas = {src: ptxas_report(_build.build_log(src)) for src in built}
    occupancy, paged_smem = occupancy_report()
    for key, blocks in occupancy.items():
        for report in ptxas.values():
            if key in report:
                report[key]["blocks_per_sm"] = blocks
    ptxas["paged_attention.cu"][PAGED_TIMED[0]]["dynamic_smem"] = paged_smem
    for kname, rep in sorted(kv for report in ptxas.values() for kv in report.items()):
        log(f"  {kname}: {rep.get('registers')} registers, spill stores {rep['spill_stores']} B, "
            f"spill loads {rep['spill_loads']} B, static smem {rep.get('static_smem')} B"
            + (f", dynamic smem {rep['dynamic_smem']} B" if "dynamic_smem" in rep else "")
            + (f", blocks a SM {rep['blocks_per_sm']}" if "blocks_per_sm" in rep else ""))
    flash_ptxas = ptxas["flash_attention.cu"]
    wgmma = {k: v for k, v in flash_ptxas.items() if "_wgmma_kernel<" in k}
    if len(wgmma) != 6 or any(v["spill_stores"] or v["spill_loads"] for v in wgmma.values()):
        raise AssertionError(f"the wgmma flash kernels (3 at hd 64 and 128) must build without "
                             f"spills: {wgmma}")
    b4 = ptxas["paged_attention.cu"][PAGED_TIMED[0]]
    if b4["spill_stores"] or b4["spill_loads"]:
        raise AssertionError(f"B4's bf16 hd-128 instance must build without spills: {b4}")

    log("phase 3: paged_attention kernel against its plain version")
    errs = check_kernel_vs_plain(dev)

    log("phase 4: flagship paged step, kernel against plain")
    logits_diff = check_flagship_forward(dev)
    torch.cuda.empty_cache()

    log("phase 5: serve through the entry point")
    serve_run = run_serve_subprocess()
    launches = serve_run["launches"]
    launches_int8 = run_serve_int8_inprocess()
    launches_tiny = run_serve_tiny_defaults()

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    flagship = LlamaForCausalLM.from_config(LlamaConfig.flagship_700m(), seed=0,
                                            dtype=torch.bfloat16, device=dev)
    log("phase 5b: the graph engine, async and sync, against an eager reference")
    parity = check_graph_engine_parity(flagship)
    log("phase 5c: two sampled graph engines with one seed")
    sampled = check_sampled_pair(flagship)

    log("phase 6: times at the flagship decode shape and the prefill chunk")
    times = time_paged_shape(dev, ctx=512)
    times_1024 = time_paged_shape(dev, ctx=1024)
    prefill = {f"context_{ctx}": time_paged_shape(dev, b=1, s=32, ctx=ctx) for ctx in (512, 896)}

    log("phase 7: where a decode step's time goes on the graph engine")
    breakdown = serve_breakdown(flagship)
    del flagship
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps({"serve_breakdown": breakdown, "serve": serve_run, "parity": parity,
                    "sampled_pair": sampled}))

    log("phase 8: flash-attention kernels against their plain versions")
    flash_errs = check_flash_vs_plain(dev)

    log("phase 9: a flagship-width train step, kernels against plain")
    step_check = check_train_step_kernel_vs_plain(dev)

    log("phase 10: the flagship train step through the 5-line Accelerator loop")
    train, (step, *live) = run_train_loop()

    log("phase 11: where a train step's time goes")
    train_bd = train_breakdown(step, train["step_ms"])
    log(json.dumps({"train_breakdown": train_bd}))
    del step, live
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 12: flash kernels timed at the flagship shape")
    flash_times = time_flash_kernels(dev, train_bd["flash_ms_per_launch"])
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "losses"},
                    "train_step_check": step_check}))

    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
        "replaces": "accelerate_tpu/ops/paged_attention.py:159",
        "replaces_function": "_pallas_kernel",
        "launches": launches["total"],
        "launches_decode": launches["decode"],
        "launches_other": launches["other"],
        "launches_int8_in_process": launches_int8,
        "launches_tiny_preset": launches_tiny,
        "max_abs_err": max(errs.values()),
        "max_abs_err_by_pool": errs,
        "flagship_logits_max_abs_diff": logits_diff,
        "ms": times["kernel_ms"],
        "kernel_ms": times["kernel_ms"],
        "profiler_ms_per_launch": times["profiler_ms_per_launch"],
        "hbm_share_split_kernel": times["hbm_share_split_kernel"],
        "at_context_1024": {k: times_1024[k] for k in PAGED_TIMED_KEYS},
        "at_prefill_chunk": {c: {k: t[k] for k in PAGED_TIMED_KEYS + ("bound_by", "shape")}
                             for c, t in prefill.items()},
        "ptxas": {k: ptxas["paged_attention.cu"][k] for k in PAGED_TIMED},
        "ptxas_all_instances": ptxas["paged_attention.cu"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
        "library_events_ms": times["library_events_ms"],
        "library_call": times["library_call"],
        "timed_shape": times["shape"],
    }]
    replaces = {"flash_fwd": ("accelerate_tpu/ops/flash_attention.py:48", "_fwd_kernel"),
                "flash_bwd_dq": ("accelerate_tpu/ops/flash_attention.py:131", "_bwd_dq_kernel"),
                "flash_bwd_dkv": ("accelerate_tpu/ops/flash_attention.py:184", "_bwd_dkv_kernel")}
    for name in FLASH_KERNELS:
        t = flash_times[name]
        by_dtype = flash_errs["by_dtype"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "accelerate_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces[name][0],
            "replaces_function": replaces[name][1],
            "launches": train["launches"][name],
            "launches_per_train_step": train["launches_per_step"][name],
            "max_abs_err": max(by_dtype.values()),
            "max_abs_err_by_dtype": by_dtype,
            "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"],
            "profiler_ms": t["profiler_ms"],
            "tflops": t["tflops"],
            "tflops_profiler": t["tflops_profiler"],
            "ptxas": {k: v for k, v in flash_ptxas.items() if k.startswith(f"{name}_")},
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_events_ms": t["library_events_ms"],
            "library_events_spread": t["library_events_spread"],
            "library_call": ("scaled_dot_product_attention(is_causal=True) forward"
                             if name == "flash_fwd" else
                             "scaled_dot_product_attention backward alone (autograd.grad "
                             "over one retained forward): the pair flash_bwd_dq + "
                             "flash_bwd_dkv"),
            "timed_shape": {"batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "n_heads": 12, "n_kv": 12,
                            "head_dim": 128, "dtype": "bf16", "causal": True},
        })
    log(json.dumps({"kernels": kernels, "build_s": build_s, "serve_wall_s": serve_run["wall_s"],
                    "total_s": time.perf_counter() - t_start}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
