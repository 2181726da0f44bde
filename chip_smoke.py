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
   the card (B1-B3's instances at hd 256 and 512 and B4's hd-256 instances
   too). Fails if a wgmma flash kernel (B1-B3 up to hd 128, B1 and B2 at
   256) or B4's bf16 hd-128 split instance spills;
3. the paged-attention kernel against its plain PyTorch version on the
   card: decode (s=1) and prefill-chunk (s=32) queries, hd=128, bs=16, MHA
   12/12 and GQA 32/8, ``idx`` on and beside block edges, f32 / bf16 /
   int8 / fp8 pools written through ``write_paged_kv``, table tails on the
   null block, which holds garbage; then hd=64, a one-tile table, bf16
   queries on an int8 pool; block sizes 8 and 32; one batch whose rows'
   valid lengths are 1, 127, 128, 129 and 1000 (and 32..1000 in a chunk, MHA
   and GQA); s=5; then hd=16 (MHA 4/4) and hd=32 (GQA 8/2) in every pool
   with f32 and bf16 queries, and the mixed-length batch at hd=16; the spec
   verify's shape (8 rows, s = 2, 3, 5, first queries on block edges); head
   dims 24, 48 and 80 in every pool with f32 and bf16 queries; C4b: head
   dims 13, 20 and 256 in every pool with f32 and bf16 queries (decode and
   s = 5) and the mixed-length batch at hd 256. Gates:
   f32 ``atol=rtol=1e-5``; bf16 outputs ``atol=2e-2`` in f32; int8 / fp8
   (and a bf16 pool under f32 queries) ``atol=rtol=1e-4`` on the same
   stored bytes. Each case launches twice and requires bit-identical
   outputs;
3d. C4c: head dims 264, 300 and 512 (past 256 the kernel walks column
   blocks of 256) in every pool with f32 and bf16 queries, decode and
   s = 5, and the mixed-length batch at hd 512, under phase 3's gates;
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
   --preset tiny`` on its defaults (f32, head dim 16) answering 6 requests.
   After 5b's greedy run, a mixed batch of 12 requests in-process on the
   flagship (bf16, 8 slots, ``logprobs_topn=4``): greedy; sampled with
   temperature / top-k / top-p and a seed; repetition penalty;
   ``min_tokens`` over an eos id; a stop sequence; a regex and a
   JSON-schema grammar; logprobs. One capture of the plain burst and one of
   the lane burst; every grammar answer matches its regex or validates
   against its schema; the stop sequence is trimmed; no eos before
   ``min_tokens``; the greedy members give 5b's tokens;
5b. the 12 requests through the graph engine with async dispatch on and
   off, which must give identical tokens, and each request alone through
   ``paged_step`` in an eager Python loop at the engine's shapes: where a
   request parts from that reference, the first divergence and the
   reference's top-2 logit margin are printed, and a divergence whose gap
   exceeds 2^-5 of the reference's largest |logit| (four bf16 ulps at the
   top) fails. Then the 12 forced through the lane burst (each asks for
   ``logprobs=1``), which must give the plain burst's tokens; the mixed
   batch's sampled requests alone in reverse admission order in a fresh
   engine, which must give their tokens again; and a shared-prefix batch
   (8 requests, a 512-id prefix and a 5-id header, tails of 16-64 ids, 64
   new tokens each) with the prefix cache on and off: identical tokens,
   hits and copy-on-write copies with it, TTFT p50 and prefill chunks
   printed both ways;
5c. engine-wide ``do_sample=True`` with one seed in two engines and in
   reverse admission order: identical tokens, the lane burst captured
   once and the plain burst never;
5e. the front door: ``serve --http 0 --logging-dir`` with phase 5's flags
   in a fresh process. ``/healthz`` reads ``starting``, then ``ready``;
   phase 5's 12 requests as greedy SSE completions (client TTFT, TPOT and
   tokens/s, ``/metrics`` scraped under load and timed), their deltas an
   in-order split of phase 5's tokens; then 16 requests at once with a
   1 s ``/profile`` window opened just before them: 10 of phase 5's greedy
   (non-stream completions, SSE, ``/generate``: phase 5's tokens), a chat,
   a JSON-schema answer (validated) and 4 seeded sampled requests (sent
   again in reverse: the same tokens), whose lane burst is captured inside
   the window; the window's kernel summary must name B4's two kernels over
   at least one flight iteration; 6 fresh prompts timed (tok/s);
   ``/metrics`` parsed and equal to ``/stats``; one
   capture of each program and B4's launches = eager + replays ×
   captured; SIGTERM with 8 requests of 200 tokens in flight: all
   answered, the flight drain written, exit 0;
5f. workload replay: ``serve --trace bursty-diurnal:7:4:8`` (stdin mode)
   on the flagship answers every scheduled request with its budget, and
   ``WORKLOAD.json``'s digest equals a recomputation;
5g. the fleet: ``python -m accelerate_tpu_torch route --replicas 2`` over
   two ``serve --http`` replicas of the flagship on the one card (phase 5's
   flags, ``--respawn``, ``--chaos-spec r0:kill@7``, ``--http PORT``):
   phase 5's 12 requests as greedy SSE through the router's OpenAI door,
   then the same 12 prompts as JSONL rows on route's stdin (the replicas'
   ``POST /generate``), replica 0 killed at its 7th request mid graph
   replay. Every request answered exactly once, greedy tokens equal phase
   5's or parting within 5b's margin rule, replica 0 respawned once (dead
   to ready timed), replica 1's and the respawned replica 0's ``/stats``
   one capture of each program and B4's launches = eager + replays ×
   captured (replica 0's after one fresh request, its TPOT printed beside
   phase 5's); SIGTERM to route drains, exit 0, no fleet process alive and ``nvidia-smi``'s
   compute apps back to the list before the fleet.
   Tok/s, client TTFT and TPOT printed beside phase 5e's single replica;
5h. the HBM pre-flight: ``serve --auto-blocks`` on the flagship (the chosen
   ``num_blocks`` printed; predicted params + pool bytes equal the tensors
   on the card), and ``--hbm-gb 1``: SP004 before any pool allocates
   (``torch.cuda.memory_allocated`` shows the weights only), serve exit 2;
5i. the fleet with an armed SLO objective: ``route --replicas 1 --respawn
   --max-replicas 2 --logging-dir`` over the tiny llama on the card with
   ``ACCELERATE_SLO_MAX_ERROR_RATE=0.01``; route prints that the policy is
   armed, three of six requests carry a 1 ms deadline, the supervisor
   writes a ``scale_decision`` row whose evidence names a dominant phase,
   SIGTERM drains (exit 0), and ``slo report`` and ``monitor --once`` read
   the fleet's directory and exit 0;
5d. speculative decoding (``spec_k`` 4, ``early_exit:2``) on the flagship:
   the 12 requests greedy against 5b's plain tokens under 5b's margin rule
   (a divergence's logits from an eager prefill of the shared prefix), one
   capture of the spec round recording 4 × 2 draft launches and 16 verify
   launches; 4 seeded sampled requests through the lane spec round in two
   admission orders, identical; a 72-block pool with ``swap_gb`` giving the
   full-residency tokens of 8 requests with swaps > 0; swap-out and swap-in
   of a 512-id request timed (ms a block, GB/s); a request whose 600 ms
   deadline passes mid decode finishing ``deadline_exceeded`` while 3
   others keep their tokens; the usage ledger conserved on every engine;
6. times at the flagship decode shape (8 slots, context 512, bf16, the 16
   layers' pools rotated so L2 does not hold them), at context 1024 (the
   table's ``mb · bs``), and at the prefill chunk (b 1, s 32, the chunk's
   last query at context 512 and 896), at the spec verify (8 slots, s = 5,
   context 512) and at decode with head dims 80 and 24 (12 heads), 256
   (8 heads, C4b) and 512 (4 heads, C4c): the
   kernel (CUDA events around the
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
   greedy legs, async and sync alternating, then one async leg with all 8
   slots sampled (temperature 0.8, top-p 0.9: the lane burst) and one async
   greedy spec leg (a round's numbers, with its accept rate), each its
   own engine past prefill,
   four timed ``step()`` calls (wall per decode step, tokens/s, the flight
   recorder's ``host_fraction`` and per-phase p50) and two under
   ``torch.profiler`` (device time and busy share, launches and top kernels
   per step); then one paged step eager against the same step replayed
   from a CUDA graph. Printed as one ``{"serve_breakdown": {...}}`` line
   with phase 5's serve numbers and phases 5b-5c;
7b. ``generate()`` on the flagship at bf16 for time, at ``bench.py``'s decode
   shape (8 × 128 random ids, ``use_cache=True``, 8 and 136 new tokens):
   the first call of a length captures the decode step and the second
   captures nothing; replays one a token; B1 launched once a layer a call
   (the prefill); decode tok/s by difference, a step's wall and device
   time (the profiler over replays of the captured step); sampling twice
   with one seed gives the same tokens; a speculative call (k 4, a 4-layer
   draft) timed a round;
7c. ``generate()`` on the flagship at f32 for equality: 8 prompts
   right-padded to 128 ids (lengths 17-128), 32 new tokens; greedy tokens
   identical through the cached path with the kernels, with
   ``flash_impl="plain"``, the full-forward loop and speculative decoding
   (k 4, a 4-layer draft on its own weights); an eos that stops a row
   mid-chunk; the prefill's logits, B1 against plain, within 2e-5 × the
   largest |logit|;
7d. B1 against its plain forward at ``generate()``'s shapes (causal,
   right-padded key masks, s 128, 137 and 160, f32 and bf16, GQA), phase
   8's gates, each launched twice and bit-identical; B1 timed at the
   prefill shape (b 8, s 128, 12 × 128, bf16, the key mask) beside its
   plain version, sdpa with the same mask and the bound;
8. the flash-attention kernels (forward, backward dq, backward dk/dv)
   against their plain versions on the card, on seeded numpy inputs: the
   flagship shape (b 8, s 1024, 12 × 128) and GQA 32/8 at hd 64 and 128,
   hd 16 (MHA 4/4) and hd 32 (GQA 8/2) in f32 and bf16, causal and not,
   s = 129 and 1000 with a left-padded mask, and hd 24, 48 and 80 (and,
   C4b, 20 and 36, handed to the kernels zero-padded, and 256) at s = 129,
   1000 (left-padded) and 200 (not causal) (each case off hd 64 and 128
   launched twice and required bit-identical),
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
8b. ``LlamaConfig.tiny()`` (head dim 16) trained 20 steps through
   ``Accelerator(mixed_precision="bf16").prepare(...)`` on a fixed batch:
   finite, falling loss, each flash kernel launched once a layer a step;
   then B1-B3 at hd 16, 32, 24 and 80 at that shape (b 8, s 128, 4 heads,
   bf16, causal) by events and by the profiler, beside sdpa and the bound
   counted on the real head dim;
8c. C4b: a tiny llama with four 256-wide heads (hidden 1024) trained the
   same way (finite, falling loss, each kernel once a layer a step); B1-B3
   at hd 256 (b 8, s 1024, 8 heads, bf16, causal) timed as in 8b (on
   their 256-wide wgmma instances; their registers, spills and blocks a SM
   in the kernels line);
8d. C4c: B1-B3 at head dims 264, 300 and 512 (column blocks of 256) at
   s = 129, at 1000 left-padded and at 200 not causal, f32 and bf16, under
   phase 8's gates and launched twice; a tiny llama with two 512-wide heads
   (hidden 1024) trained 20 steps (finite, falling loss, each kernel once a
   layer a step) and its f32 paged step kernel against plain as in phase
   4; B1-B3 timed at hd 512 (b 8, s 1024, 8 heads, bf16, causal) beside
   sdpa, whose backend is named (PyTorch's flash backend stops at 256);
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

13. the data-parallel loop as users write it, in a process of its own
    (this script with ``--ddp-loop``) under the launch environment
    (``ACCELERATE_COORDINATOR_ADDR``, a ``file://`` store of its own,
    ``ACCELERATE_NUM_PROCESSES=1``, ``ACCELERATE_PROCESS_ID=0``):
    ``prepare(model, opt, train_dl, eval_dl,
    sched)`` on the flagship (bf16 over f32 masters, 8 × 1024 ids a step
    from a ``torch.utils.data.DataLoader``), ``accumulate``, ``backward``
    (whose gradient all-reduce runs under the NCCL group at world size 1),
    2 warm-up, 6 timed and 1 profiled step; then an eval pass of 37 rows, 4
    a batch, through ``gather_for_metrics`` (B1 at those shapes is held
    against its plain version in phase 8). The loop runs with the loader's
    default (no prefetch thread) and again with the thread
    (``prefetch_batches=2``). It
    fails unless the group is NCCL, an NCCL kernel ran in the profiled
    step, each flash kernel launched 16 times a step (counters set to 0
    just before, read just after), ``gather_for_metrics`` returned the 37
    rows in order, and the losses (1e-5 relative; bitwise expected) and
    the eval predictions (exactly) equal those of the same loop on the
    same batches in the same process after ``_reset_state`` took the group
    down. Prints tokens/s, MFU, the all-reduce's device ms and the
    loader's fetch ms with and without the thread.

14. the train step's precision and memory policies on the flagship (8 ×
    1024 ids, f32 masters, AdamW, a clip on unscaled gradients, a
    scheduler). 14a: B1-B3 at f16 against their plain versions (the
    flagship shape, GQA with a fully masked query tile, hd 16, 80, 256, 264
    and 512; gates o 4e-3, grads 8e-3 × max(|ref|, 1): bf16's scaled by
    f16's finer mantissa), and timed at the flagship shape beside sdpa at
    f16 (``max_abs_err_fp16`` and ``ms_fp16`` in the kernels line). 14b:
    the fp16 loop (``GradScalerKwargs(init_scale=2**16)``), 2 warm-up, 6
    timed and 1 profiled step: tokens/s, the scale after each step and the
    skipped steps (``step_was_skipped`` on exactly the steps whose scale
    backed off), 16 launches of each f16 flash kernel a step (counters and
    profile), and the host read of the finite flag (the
    ``step/finite_flag`` range); then a run from ``2**40`` that must back
    off and then take 3 steps. 14c: ``fp8_matmul`` on the fp8 tensor cores
    against its plain version at ``[8192, 1536] × [1536, 4096]`` and ``×
    [1536, 32000]`` (forward and both gradients, bf16, within 1e-2 of max
    |ref|) and timed beside bf16 ``torch.matmul``; the loop under fp8
    (tokens/s, fp8 GEMMs a step, falling loss); an ``autocast`` island's
    logits equal to the f32 module's; ``generate()`` under the fp8 policy
    (one captured decode step with fp8 products in it) and inside an
    island (the f32 module's tokens). 14d: the bf16 step at ``remat``
    False, True and ``"dots_saveable"``: step ms, device ms of a profiled
    step, peak memory (``max_memory_allocated``), every step's loss within
    1e-3 of ``remat=False``'s. 14b opens with the same loop at bf16, the yardstick in the same
    process.
    ``python3 chip_smoke.py --phase 14`` runs phases 1, 2 and 14 alone and
    prints no verdict.

15. the model zoo. 15a: Mixtral-8x7B's width (hidden 4096, 32 query and 8
    kv heads × 128, 8 experts top-2, ff 14336, vocab 32000, ``remat=True``)
    cut to 2 of its 32 layers: B1-B3 against their plain versions at 32/8 ×
    128 (b 4, s 1024; bf16, f32, and a left-padded case) and timed there
    beside sdpa with ``enable_gqa=True``; then the 5-line loop at b 4 ×
    1024 (bf16 over f32 masters, AdamW one tensor at a time): the first
    loss through the kernels within 2e-2 of the plain path, 2 warm-up and 5
    timed steps with the flash counters set to 0 just before and read just
    after (B1 2 × 2 a step under remat, B2 and B3 2), a falling loss,
    tokens/s, peak memory, one profiled step (device ms, kernels, B1-B3's
    share), MFU over the active parameters (``6 × (attention + 2 of 8
    experts + router + head) × tokens + 6 × L × tokens × s × h`` against 989
    TFLOP/s) and the dispatch/combine einsums' share of the profiled step
    (the ``aten::einsum`` calls, their recompute and the backward nodes
    autograd made for them, matched by sequence number). 15b:
    ``generate()`` there: bf16 8 × 128 for time (decode tok/s by
    difference), f32 (``capacity_factor`` 8: no drops) cached with the
    kernels = plain = full-forward. 15c: GPT-J-6B's width (16 × 256, ff
    16384, vocab 50400) cut to 2 of 28 layers: B1-B3 against plain at hd
    256 (f32 left-padded), and B1 and B2's 256-wide wgmma instances (bf16
    and f16 at hd 136, 200 and 256: GQA 8/2, s = 129, 1000 left-padded,
    200 causal and not with a left pad of 130, and GPT-J's shape; the
    gates of phases 8 and 14a, launched twice); the instance each of B1-B3
    launched at hd 128, 136, 200, 256 (bf16, f16, f32) and 512, read from
    the profiler's kernel names (B1 and B2 in bf16 and f16 on wgmma up to
    256; f32 and 512 on the FMA kernels); B1-B3 timed at
    GPT-J's shape; the loop at b 4 × 1024 with its profiled share.
    15d: gpt2, opt-125m, pythia-1.4b, bert-base (a key mask that pads every
    other row on the right), vit-base-patch16-224 (s 197), resnet50d and
    t5-small at their published sizes: B1-B3 against their plain versions
    at each attention family's training shape and mask (f32 and bf16, the
    gates of phase 8), the f32 logits with the kernels within 1e-3 of plain
    at the training batch, the first loss with the kernels within 2e-2 of
    plain, 4 steps (one launch of each flash kernel a layer a step; resnet
    and T5 none), a falling loss, and f32 greedy ``generate()`` tokens with
    the kernels equal to plain for the LMs and T5. Phase 15 logs its own
    seconds. ``python3 chip_smoke.py --phase 15`` runs phases 1, 2 and 15
    alone and prints no verdict.

16. big-model inference at OPT-30B's width (hidden 7168, 56 × 128 heads,
    ff 28672, vocab 50272, tied head) cut to 8 of its 48 layers, fp16,
    random weights from seed 0 written as a sharded ``.safetensors``
    checkpoint (10.6 GB) under the temporary directory or ``build/``
    (whichever has more room; removed after). 16a: ``init_empty_weights``
    → ``load_checkpoint_and_dispatch(device_map="auto")`` over a budget
    that puts 3 layers on the card, 3 on the host and the rest on disk →
    ``generate()`` of 8 tokens from 4 right-padded prompts of 64-128 ids,
    the flash counters at 0 around it (B1 8 × 8 launches); gates: every
    step's logits bit-equal to the same plan with every tier on the card
    (``device_map={"": 0}``), greedy tokens equal, peak memory below
    resident + 3 × the largest segment + 1 GiB and below the model; then
    two warm tokens and one cold (``posix_fadvise(DONTNEED)`` on the
    offload files) timed: load s, s a token, bytes streamed, GB/s, copy
    and compute ms (events). 16b: ``load_and_quantize_model`` int8 and nf4
    with one layer on the card, one on the host, the rest on disk, 4
    tokens each: the int8 GEMM and the native nibble decoder must run, no
    segment may take the dequantize retry. 16c: B1 at the streamed shape
    (b 4, s 136, 56 × 128, f16, the prompts' key mask) against its plain
    version at phase 8's f16 gates, launched twice with equal bits, timed
    against sdpa. ``python3 chip_smoke.py --phase 16`` runs phases 1, 2
    and 16 alone and prints no verdict.

17. the training loop's state on the flagship (bf16 over f32 masters,
    AdamW, a decaying ``LambdaLR``, 8 × 1024 ids a step from a
    ``DataLoader``; under the temporary directory or ``build/``, whichever
    has more room: it must hold 3 × the 8.4 GB state + the 2.8 GB model,
    and is removed after). 17a, in processes of their own (this script
    with ``--p17-loop``): an uninterrupted run of the batches; a run with
    ``ProjectConfiguration(automatic_checkpoint_naming=True,
    total_limit=2)``, ``fault_tolerance=True``, ``log_with="jsonl"`` and
    the watchdog that trains 2 steps, saves (sync), trains 2, saves async
    (the next 2 steps overlap the write), trains 2 and is sent SIGTERM: the
    next batch's ``backward`` takes the emergency save and the process
    exits 143 with ``PREEMPTED.json``; a relaunch with
    ``ACCELERATE_AUTO_RESUME=true`` trains 3 steps. Gates: every loss of
    both equal to the uninterrupted run's (1e-5 relative, bitwise
    expected), B1-B3 16 launches each a step, both kept checkpoints'
    manifests valid, the sentinel consumed, the tracker's JSONL holding
    every logged step, the telemetry's checkpoint and preemption rows.
    Prints the state's GB, the sync save's s and GB/s, the async save's
    blocking s and the step ms during its write against before it, the
    load s and the emergency save's s. 17b: ``save_model`` into 1 GB
    shards, then ``load_checkpoint_and_dispatch`` with the whole model on
    the card: logits bit-equal to the trained model's. 17c:
    ``find_executable_batch_size`` from 128 × 1024: the sizes tried, at
    least one real ``torch.OutOfMemoryError``, ``memory_allocated`` at the
    start of every try equal to its level before the first. 17d: the hang
    watchdog (2 s floor) fires on a step held past it; the report carries
    the card's memory and the port's monitor reads the heartbeat (fired,
    wedged). ``python3 chip_smoke.py --phase 17`` runs phases 1, 2 and 17
    alone and prints no verdict.

The ``{"kernels": [...]}`` line lists all four kernels. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM bf16 tensor cores, dense
FP8_FLOPS_PER_S = 1979e12   # H100 SXM fp8 tensor cores, dense
SERVE_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(msg, flush=True)


#: when main() started: each phase's heading carries the seconds since
_T0 = [time.perf_counter()]


def log_phase(msg: str) -> None:
    log(f"{msg} [{time.perf_counter() - _T0[0]:.1f} s]")


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


#: the head dims B1-B3 are built at (a head dim runs at the first that holds it)
FLASH_BUILT_HDS = (16, 32, 48, 64, 80, 96, 112, 128)
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
#: B4's instances at the timed decode shape (hd 128, bf16 queries and pool)
PAGED_TIMED = ("paged_attention_kernel<128, __nv_bfloat16, __nv_bfloat16, false, false>",
               "combine_splits_kernel<128, __nv_bfloat16, false>")
#: B4's instances at head dim 256 (C4b), bf16 queries and pool
PAGED_WIDE = ("paged_attention_kernel<256, __nv_bfloat16, __nv_bfloat16, false, false>",
              "combine_splits_kernel<256, __nv_bfloat16, false>")
#: B4's column-block instances past head dim 256 (C4c), bf16 queries and pool
PAGED_COLS = ("paged_attention_kernel<256, __nv_bfloat16, __nv_bfloat16, false, true>",
              "combine_splits_kernel<256, __nv_bfloat16, true>")
#: the C++ names of the kernels' storage types, by dtype name
FLASH_TYPE_NAMES = {"f32": "float", "bf16": "__nv_bfloat16", "f16": "__half"}


def flash_instances(hd: int, dtype: str) -> dict:
    """``{"flash_fwd": "kernel<args>", ...}``: the instance each of B1-B3
    launches at head dim ``hd`` (a multiple of 8) in ``dtype`` ("f32",
    "bf16" or "f16"), by the dispatch of ``csrc/flash_attention.cu``. Up to
    128 f32 takes the FMA kernels and bf16 / f16 the wgmma ones, at hd
    rounded up to 16; from 136 to 256 bf16 and f16 take the wgmma
    instances at 256 and f32 the wide FMA ones; past 256 every dtype takes
    the column-block FMA instance."""
    t = FLASH_TYPE_NAMES[dtype]
    if hd > 256:
        return {n: f"{n}_kernel<256, 32, {t}, true>" for n in FLASH_KERNELS}
    if hd > 128:
        return {n: f"{n}_wgmma_kernel<256, {t}>" if dtype != "f32"
                else f"{n}_kernel<256, 32, {t}, false>" for n in FLASH_KERNELS}
    width = -(-hd // 16) * 16
    if dtype == "f32":
        return {n: f"{n}_kernel<{width}, 64, float, false>" for n in FLASH_KERNELS}
    return {n: f"{n}_wgmma_kernel<{width}, {t}>" for n in FLASH_KERNELS}


#: B1-B3's bf16 instances from head dim 136 to 256: the tensor-core
#: instances at a 256-wide staging (B3's splits its warpgroups by role)
FLASH_WIDE = tuple(flash_instances(256, "bf16").values())
#: and past 256 (C4c): their column-block instances
FLASH_COLS = tuple(flash_instances(512, "bf16").values())


def occupancy_report() -> tuple[dict, dict]:
    """``({"kernel<args>": blocks}, {"kernel<args>": bytes})``: resident
    blocks an SM holds of each bf16 flash kernel (the instances that run at
    hd 256 and 512 too) and of B4's instances at hd 128 and 256, from the CUDA
    runtime's occupancy calculator on this card, for the threads and shared
    memory each is launched with; and the dynamic shared memory of B4's
    split kernels at the decode shape."""
    import ctypes

    from accelerate_tpu_torch import _build

    blocks, combine, smem, out = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), {}
    flash = _build.load("flash_attention.cu")
    for which, name in enumerate(FLASH_KERNELS):
        for hd in FLASH_BUILT_HDS:
            if flash.flash_attention_blocks_per_sm(which, hd, ctypes.byref(blocks)):
                raise AssertionError(f"the occupancy query failed for {name} at hd {hd}")
            out[f"{name}_wgmma_kernel<{hd}, __nv_bfloat16>"] = blocks.value
        for hd, names in ((256, FLASH_WIDE), (512, FLASH_COLS)):
            if flash.flash_attention_blocks_per_sm(which, hd, ctypes.byref(blocks)):
                raise AssertionError(f"the occupancy query failed for {name} at hd {hd}")
            out[names[which]] = blocks.value
    paged = _build.load("paged_attention.cu")
    smem_bytes = {}
    for hd, names in ((128, PAGED_TIMED), (256, PAGED_WIDE), (512, PAGED_COLS)):
        if paged.paged_attention_blocks_per_sm(hd, ctypes.byref(blocks), ctypes.byref(combine),
                                               ctypes.byref(smem)):
            raise AssertionError(f"the occupancy query failed for the paged kernels at hd {hd}")
        out[names[0]], out[names[1]] = blocks.value, combine.value
        smem_bytes[names[0]] = smem.value
    return out, smem_bytes


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
#: the spec verify's 8 rows: first queries on and beside block edges
VERIFY_IDX = (0, 14, 15, 16, 31, 47, 255, 510)


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
    not fill a 16-row tile). Then head dims 16 (MHA 4/4, the tiny preset's
    shape) and 32 (GQA 8/2) in every pool dtype with f32 and bf16 queries,
    and the mixed-length batch at hd 16. Last, the spec verify's shape (8
    rows, s = 2, 3 and 5, first queries on block edges) and head dims 24, 48
    and 80 in every pool with f32 and bf16 queries."""
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
    # the speculative verify (8 slots, s = k+1 = 2, 3, 5) on block edges
    cases += [(pool, pool if pool == "bf16" else "f32", s, 12, 12, 128, 16, 40, VERIFY_IDX)
              for pool in ("bf16", "int8", "f32") for s in (2, 3, 5)]
    # head dims off the built widths (24 -> 32, 48 -> 64, 80 -> 128; an
    # int8/fp8 row of 24 or 80 bytes is copied 8 bytes at a time): every
    # pool with f32 and bf16 queries, decode and a chunk
    cases += [(pool, q, s, nh, n_kv, hd, 16, 8, edge(s, 16, 8))
              for hd, nh, n_kv in ((24, 4, 4), (48, 8, 2), (80, 4, 2))
              for pool in ("f32", "bf16", "int8", "fp8") for q in ("f32", "bf16")
              for s in (1, 5)]
    return cases + c4b_kernel_cases()


def c4b_kernel_cases():
    """C4b: head dims 13 (an odd bf16 row: element by element, the bf16
    query tile too), 20 (a bf16 row of 40 bytes: 8-byte copies; a 1-byte
    row of 20: element by element) and 256 (the fifth staged width; an f32
    pool's one-stage ring) in every pool with f32 and bf16 queries, decode
    and s = 5; then the mixed-length batch at hd 256."""
    mixed = (0, 126, 127, 128, 999)
    cases = [(pool, q, s, nh, n_kv, hd, 16, 8, tuple(i for i in EDGE_IDX if i + s <= 128))
             for hd, nh, n_kv in ((13, 4, 2), (20, 4, 2), (256, 8, 2))
             for pool in ("f32", "bf16", "int8", "fp8") for q in ("f32", "bf16")
             for s in (1, 5)]
    cases += [(pool, q, 1, 8, 8, 256, 16, 64, mixed)
              for pool, q in (("bf16", "bf16"), ("f32", "f32"), ("int8", "bf16"))]
    return cases


def c4c_kernel_cases():
    """C4c: head dims past 256, walked in column blocks of 256: 264 (a
    ragged 8-column last block; an int8/fp8 row of 264 bytes goes as 8-byte
    copies), 300 (an odd multiple of 4: a bf16 row of 600 bytes as 8-byte
    copies, an int8 row element by element, the bf16 query tile element by
    element) and 512 (two whole blocks) in every pool with f32 and bf16
    queries, decode and s = 5; then the mixed-length batch at hd 512."""
    mixed = (0, 126, 127, 128, 999)
    cases = [(pool, q, s, nh, n_kv, hd, 16, 8, tuple(i for i in EDGE_IDX if i + s <= 128))
             for hd, nh, n_kv in ((264, 4, 2), (300, 4, 2), (512, 4, 2))
             for pool in ("f32", "bf16", "int8", "fp8") for q in ("f32", "bf16")
             for s in (1, 5)]
    cases += [(pool, q, 1, 4, 4, 512, 16, 64, mixed)
              for pool, q in (("bf16", "bf16"), ("f32", "f32"), ("int8", "bf16"))]
    return cases


def check_kernel_vs_plain(dev, cases=None) -> dict:
    """Gates: f32 ``atol=rtol=1e-5``; a bf16 output (bf16 queries) ``atol=2e-2``
    compared in f32; int8 / fp8 pools ``atol=rtol=1e-4`` on the same
    quantized bytes. Every case launches the kernel twice and requires
    bit-identical outputs (the splits merge in a fixed order). ``cases``
    defaults to :func:`_kernel_cases`."""
    from accelerate_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    errs: dict = {}
    for pool, q_dtype, s, nh, n_kv, hd, bs, mb, idx in cases or _kernel_cases():
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


def check_flagship_forward(dev, cfg=None) -> float:
    """The paged step of ``cfg`` (the flagship by default) in f32, kernel
    against plain: a 64-token prefill chunk then 8 decode steps."""
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = cfg or LlamaConfig.flagship_700m()
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
    what = f"{cfg.num_hidden_layers} layers, head dim {cfg.head_dim}"
    if not all(torch.isfinite(x).all() for x in logits[None]):
        raise AssertionError(f"paged-step logits not finite ({what})")
    if logits[None][0].shape != (chunk, cfg.vocab_size):
        raise AssertionError(f"prefill logits shape {tuple(logits[None][0].shape)} ({what})")
    log(f"  f32 paged step ({what}; {chunk}-token prefill + {steps} decode steps): "
        f"max |Δ logits| kernel vs plain = {diff:.3e}")
    if not diff <= 1e-3:
        raise AssertionError(f"paged-step logits: kernel and plain disagree beyond 1e-3 ({what})")
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


def check_graph_counts(stats: dict, layers: int, burst: int, what: str,
                       captures: dict | None = None) -> dict:
    """The captures of each program (``captures``: program -> count; by
    default one plain burst, one prefill chunk and no lane burst), and the
    launch counts the engine reports equal to its eager launches plus
    replays × the launches each capture recorded: a burst (plain or lane)
    ``burst × layers`` launches, all decode; the prefill chunk ``layers``,
    none decode. The eager launches are the warm-ups before the captures and
    nothing else."""
    captures = {"decode": 1, "prefill": 1, "lane_decode": 0, **(captures or {})}
    graphs = stats["cuda_graphs"]
    got = {"decode": stats["decode_compiles"], "prefill": stats["prefill_compiles"],
           "lane_decode": stats["lane_decode_compiles"]}
    if got != captures:
        raise AssertionError(f"{what}: captures {got}, expected {captures}")
    expect = {"decode": (burst * layers,) * 2, "lane_decode": (burst * layers,) * 2,
              "prefill": (layers, 0)}
    for name, g in graphs.items():
        recorded = (g["launches_captured"], g["decode_launches_captured"])
        if captures[name] and recorded != expect[name]:
            raise AssertionError(f"{what}: the {name} capture recorded {g}, not {expect[name]} "
                                 "(launches, launches with one query a row)")
        if g["replays"] != (g["runs"] if captures[name] else 0):
            raise AssertionError(f"{what}: {name} ran {g['runs']} times but replayed "
                                 f"{g['replays']} (a dispatch ran outside its graph)")
    eager = stats["paged_attention_eager_launches"]
    total = eager + sum(g["replays"] * g["launches_captured"] for g in graphs.values())
    decode = stats["paged_attention_decode_launches"]
    launches = {"total": stats["paged_attention_launches"], "decode": decode,
                "other": stats["paged_attention_launches"] - decode,
                "eager": eager, "decode_replays": graphs["decode"]["replays"],
                "lane_decode_replays": graphs["lane_decode"]["replays"],
                "prefill_replays": graphs["prefill"]["replays"]}
    if total != launches["total"] or not 0 < decode < total:
        raise AssertionError(f"{what}: launches {launches} are not eager {eager} + replays × "
                             f"captured ({graphs})")
    if eager != sum(g["launches_captured"] for g in graphs.values()):
        raise AssertionError(f"{what}: {eager} eager launches, not one warm-up of each captured "
                             "program (the engine ran a burst or a chunk outside its graphs)")
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
            "iteration_phases_s": stats["iteration_phases_s"],
            "ttft_s": stats["ttft_s"], "tpot_s": stats["tpot_s"], "rows": rows}


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
            "drain_s": {"async": walls[True], "sync": walls[False]}}, legs[True]


#: a JSON schema whose canonical form is bounded (``{"ok":true}`` or
#: ``{"ok":false}``), so a greedy answer reaches its final state
LANE_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"}}, "required": ["ok"]}
LANE_REGEX = "[a-f][a-f][a-f][a-f]x"  # the grammar's regexes have no {n} counts
#: the sampled requests of phase 5's mixed batch: (request index, sampling)
LANE_SAMPLED = {
    4: {"do_sample": True, "temperature": 0.8, "top_k": 40, "top_p": 0.9, "seed": 21},
    5: {"do_sample": True, "temperature": 1.0, "top_p": 0.95, "seed": 22},
    10: {"do_sample": True, "temperature": 0.7, "seed": 23, "logprobs": 2},
}


def _lane_batch(greedy):
    """Phase 5's mixed batch over the 12 phase-5 prompts, from their greedy
    tokens: ``(eos, [(max_new_tokens, add_request options)] * 12)``. The
    eos is a token request 2 emits early that requests 0, 1, 3, 9 and 11
    never emit in their greedy runs; greedy requests 0, 1 and 11 outlive
    every other request, so the batch's tail replays the plain burst."""
    keep = {t for i in (0, 1, 3, 9, 11) for t in greedy[i]}
    eos = next(t for t in greedy[2][2:32] if t not in keep)
    opts = [
        (64, {}),
        (64, {}),
        (32, {"sampling": {"min_tokens": 12}}),
        (32, {"sampling": {"stop": [greedy[3][5:7]]}}),
        (24, {"sampling": LANE_SAMPLED[4]}),
        (24, {"sampling": LANE_SAMPLED[5]}),
        (24, {"sampling": {"repetition_penalty": 1.3}}),
        (24, {"grammar": {"type": "regex", "pattern": LANE_REGEX}}),
        (24, {"grammar": {"type": "json_schema", "schema": LANE_SCHEMA}}),
        (24, {"logprobs": 4}),
        (24, {"sampling": LANE_SAMPLED[10]}),
        (64, {}),
    ]
    return eos, opts


def check_lane_batch(model, greedy) -> dict:
    """The mixed batch on the flagship (bf16, 8 slots, ``logprobs_topn=4``):
    greedy, sampled (temperature / top-k / top-p, seeded), repetition
    penalty, ``min_tokens`` over an eos, a stop sequence, a regex and a
    JSON-schema grammar, and logprobs, in one engine. One capture of each
    burst (plain and lane); every grammar answer matches its regex or
    validates against its schema; the stop sequence is trimmed; no eos
    before ``min_tokens``; the greedy requests give phase 5b's tokens."""
    from accelerate_tpu_torch.serving.grammar import validate_instance

    reqs = _requests(12, seed=0)
    eos, opts = _lane_batch(greedy)
    engine = _flagship_engine(model, eos_token_id=eos, logprobs_topn=4)
    handles = [engine.add_request(r["prompt"], n, **kw) for r, (n, kw) in zip(reqs, opts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    launches = check_graph_counts(stats, 16, 8, "mixed lane batch", {"lane_decode": 1})
    out = [list(h.output_tokens) for h in handles]
    if not all(0 <= t < 32000 for toks in out for t in toks):
        raise AssertionError("the mixed batch emitted an id outside the vocab")
    for i in (0, 1, 11):
        if out[i] != greedy[i]:
            raise AssertionError(f"greedy request {i} of the mixed batch parts from phase 5b")
    if out[9] != greedy[9][:24] or [e["top"][0][0] for e in handles[9].logprobs] != out[9]:
        raise AssertionError("the logprobs request's tokens or top ids part from greedy")
    if any(len(e["top"]) != 4 for e in handles[9].logprobs):
        raise AssertionError("the logprobs request did not get its top 4")
    if eos in out[2][:12] or len(out[2]) < 12:
        raise AssertionError(f"min_tokens 12: eos {eos} came early in {out[2]}")
    stop = greedy[3][5:7]  # trimmed where it first ends the greedy tokens
    cut = next(n for n in range(2, 8) if greedy[3][n - 2:n] == stop) - 2
    if out[3] != greedy[3][:cut] or handles[3].finish_reason != "stop":
        raise AssertionError(f"the stop sequence was not trimmed: {out[3]}, "
                             f"{handles[3].finish_reason}")
    texts = {i: bytes(out[i]).decode("latin-1") for i in (7, 8)}
    if handles[7].finish_reason != "stop" or not re.fullmatch(LANE_REGEX, texts[7]):
        raise AssertionError(f"the regex answer {texts[7]!r} does not match {LANE_REGEX}")
    if handles[8].finish_reason != "stop":
        raise AssertionError(f"the JSON-schema answer {texts[8]!r} did not finish")
    validate_instance(LANE_SCHEMA, json.loads(texts[8]))
    log(f"  mixed lane batch (eos {eos}): {len(handles)} answers in {wall:.2f} s, "
        f"{stats['tokens_per_sec']:.1f} tok/s; regex {texts[7]!r}, schema {texts[8]!r}; "
        f"decode_compiles {stats['decode_compiles']}, lane_decode_compiles "
        f"{stats['lane_decode_compiles']}; bursts plain {launches['decode_replays']}, lane "
        f"{launches['lane_decode_replays']}; first-token picks {stats['first_token_picks']}")
    del engine
    torch.cuda.empty_cache()
    sampled = {i: out[i] for i in LANE_SAMPLED}
    return {"eos": eos, "wall_s": wall, "tokens_per_sec": stats["tokens_per_sec"],
            "launches": launches, "regex_answer": texts[7], "schema_answer": texts[8],
            "finish_reasons": [h.finish_reason for h in handles]}, (eos, sampled)


def check_lane_parity(model, greedy, eos, sampled) -> dict:
    """The 12 greedy requests forced through the lane burst (each asks for
    ``logprobs=1``) give phase 5b's plain-burst tokens; the mixed batch's
    sampled requests, resubmitted alone in reverse admission order to a
    fresh engine, give their tokens again."""
    reqs = _requests(12, seed=0)
    engine = _flagship_engine(model, logprobs_topn=1)
    handles = [engine.add_request(r["prompt"], r["max_new_tokens"], logprobs=1) for r in reqs]
    engine.run_until_idle()
    check_graph_counts(engine.stats(), 16, 8, "greedy through the lanes",
                       {"decode": 0, "lane_decode": 1})
    lanes = [list(h.output_tokens) for h in handles]
    if lanes != greedy:
        bad = [i for i, (a, b) in enumerate(zip(lanes, greedy)) if a != b]
        raise AssertionError(f"greedy through the lane burst parts from the plain burst on {bad}")
    del engine
    engine = _flagship_engine(model, eos_token_id=eos, logprobs_topn=4)
    again = {i: engine.add_request(reqs[i]["prompt"], 24, sampling=LANE_SAMPLED[i])
             for i in sorted(sampled, reverse=True)}
    engine.run_until_idle()
    if {i: list(h.output_tokens) for i, h in again.items()} != sampled:
        raise AssertionError("the sampled requests did not reproduce in reverse order")
    del engine
    torch.cuda.empty_cache()
    log(f"  lane burst: the {len(reqs)} greedy requests give the plain burst's tokens; "
        f"{len(sampled)} sampled requests reproduce alone in reverse admission order")
    return {"greedy_through_lanes_identical": True, "sampled_reproduce_reversed": True}


def check_prefix_cache(model) -> dict:
    """A chat-shaped batch: 8 requests share a 512-id prefix (a system
    prompt) and a 5-id turn header, then distinct tails (16-64 ids with the
    header), 64 new tokens each. The first request runs alone until its
    first token (its prompt is then cached); the other 7 arrive together.
    With the cache and without, the tokens are identical; with it, the 7
    hit the prefix and each owes one copy-on-write copy (the header ends
    inside a block). TTFT p50 and prefill chunks dispatched, both ways."""
    rng = np.random.default_rng(14)
    prefix = rng.integers(1, 32000, size=517).tolist()
    prompts = [prefix + rng.integers(1, 32000, size=int(n) - 5).tolist()
               for n in np.linspace(16, 64, 8)]
    runs = {}
    for cache in (True, False):
        engine = _flagship_engine(model, prefix_cache=cache)
        first = engine.add_request(prompts[0], 64)
        while not first.output_tokens:
            engine.step()
        handles = [first] + [engine.add_request(p, 64) for p in prompts[1:]]
        engine.run_until_idle()
        torch.cuda.synchronize()
        stats = engine.stats()
        check_graph_counts(stats, 16, 8, f"prefix cache {cache}")
        runs[cache] = {
            "tokens": [list(h.output_tokens) for h in handles],
            "ttft_p50_s": float(np.percentile([h.ttft_s for h in handles[1:]], 50)),
            "prefill_chunks": stats["cuda_graphs"]["prefill"]["runs"],
            "prefix_hit_tokens": stats["prefix_hit_tokens"],
            "cow_copies": stats["cow_copies"],
            "radix_inserted_blocks": stats.get("radix_inserted_blocks", 0),
            "tokens_per_sec": stats["tokens_per_sec"],
        }
        del engine
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    log(f"  shared-prefix batch: with the cache TTFT p50 {on['ttft_p50_s'] * 1e3:.2f} ms, "
        f"{on['prefill_chunks']} prefill chunks, {on['prefix_hit_tokens']} hit tokens, "
        f"{on['cow_copies']} copy-on-write copies, {on['tokens_per_sec']:.1f} tok/s; without: "
        f"TTFT p50 {off['ttft_p50_s'] * 1e3:.2f} ms, {off['prefill_chunks']} prefill chunks, "
        f"{off['tokens_per_sec']:.1f} tok/s")
    if on["tokens"] != off["tokens"]:
        bad = [i for i, (a, b) in enumerate(zip(on["tokens"], off["tokens"])) if a != b]
        raise AssertionError(f"the prefix cache changed the tokens of requests {bad}")
    if not (on["prefix_hit_tokens"] > 0 and on["cow_copies"] >= 1):
        raise AssertionError(f"the shared-prefix batch did not hit the cache: {on}")
    return {k: {n: v for n, v in r.items() if n != "tokens"} for k, r in
            (("cache_on", on), ("cache_off", off))}


def check_sampled_pair(model) -> dict:
    """Engine-wide ``do_sample=True`` (the default sampling params every
    request inherits, seed 11): two engines with one seed give the same
    tokens, and so does a third that admits the requests in reverse order.
    Every burst replays the lane graph; the plain one is never captured."""
    reqs = _requests(4, seed=5)
    outs = []
    for order in (range(4), range(4), range(3, -1, -1)):
        engine = _flagship_engine(model, do_sample=True, temperature=1.0, seed=11)
        handles = {i: engine.add_request(reqs[i]["prompt"], reqs[i]["max_new_tokens"])
                   for i in order}
        engine.run_until_idle()
        outs.append([list(handles[i].output_tokens) for i in range(4)])
        check_graph_counts(engine.stats(), 16, 8, "sampled engine",
                           {"decode": 0, "lane_decode": 1})
        del engine
    torch.cuda.empty_cache()
    if not outs[0] == outs[1] == outs[2]:
        raise AssertionError("sampled engines with one seed gave different tokens (same order: "
                             f"{outs[0] == outs[1]}, reversed: {outs[0] == outs[2]})")
    _check_rows([{"id": i, "tokens": t, "finish_reason": "length"} for i, t in enumerate(outs[0])],
                len(reqs), "sampled engine")
    log(f"  sampled engines (seed 11, temperature 1.0): identical tokens for {len(reqs)} "
        "requests in two engines and in reverse admission order")
    return {"identical": True, "identical_reversed": True}


# -- phase 5d -----------------------------------------------------------------

#: the spec engine of phase 5d and phase 7's spec leg
SPEC = {"spec_k": 4, "draft": "early_exit:2"}


def check_spec_counts(stats: dict, layers: int, what: str, sampled: bool = False) -> dict:
    """One capture of the spec round (``decode_compiles``; of its lane twin,
    ``lane_decode_compiles``, instead when every request samples), one of
    the prefill chunk; each spec capture recorded ``k`` draft steps of
    ``N`` layers at one query a row and one verify through every layer at
    ``k+1``; launches = eager (the warm-ups) + replays × captured."""
    k, n = SPEC["spec_k"], int(SPEC["draft"].split(":")[1])
    got = {"decode": stats["decode_compiles"], "lane": stats["lane_decode_compiles"],
           "prefill": stats["prefill_compiles"]}
    if got != {"decode": int(not sampled), "lane": int(sampled), "prefill": 1}:
        raise AssertionError(f"{what}: captures {got}")
    graphs = stats["cuda_graphs"]
    for name in ("lane_spec_decode",) if sampled else ("spec_decode",):
        g = graphs[name]
        if (g["launches_captured"], g["decode_launches_captured"]) != (k * n + layers, k * n):
            raise AssertionError(f"{what}: the {name} capture recorded {g}, not "
                                 f"{k * n + layers} launches ({k * n} with one query a row)")
        if g["replays"] != g["runs"]:
            raise AssertionError(f"{what}: {name} ran outside its graph: {g}")
    eager = stats["paged_attention_eager_launches"]
    total = eager + sum(g["replays"] * g["launches_captured"] for g in graphs.values())
    if total != stats["paged_attention_launches"] or eager != sum(
            g["launches_captured"] for g in graphs.values()):
        raise AssertionError(f"{what}: launches {stats['paged_attention_launches']} are not "
                             f"eager {eager} + replays × captured ({graphs})")
    return {"total": total, "decode": stats["paged_attention_decode_launches"],
            "spec_rounds": graphs["spec_decode"]["replays"],
            "lane_spec_rounds": graphs.get("lane_spec_decode", {}).get("replays", 0)}


def _divergence(model, prompt, got, ref, cfg) -> dict | None:
    """Where ``got`` parts from ``ref`` (two greedy runs of one request):
    the logits of the shared prefix's next position by an eager
    ``paged_step`` run (the prompt and the prefix prefilled in chunks), their
    top-2 margin, and the gap between the two picks there against
    ``BF16_NOISE`` × the largest |logit|. None when they agree."""
    if got == ref:
        return None
    t = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), min(len(got), len(ref)))
    if t >= min(len(got), len(ref)):
        return {"token": t, "length_only": True, "gap": float("inf"), "noise": 0.0}
    _, picks = _eager_reference(model, prompt + ref[:t], 1, cfg)
    logits = picks[0]
    top = torch.topk(logits, 2).values
    return {"token": t, "got": got[t], "ref": ref[t],
            "top2_margin": float(top[0] - top[1]),
            "gap": abs(float(logits[ref[t]] - logits[got[t]])),
            "noise": BF16_NOISE * float(logits.abs().max())}


def check_spec_swap_deadline(model, greedy) -> dict:
    """Phase 5d on the flagship (bf16, 8 slots): the 12 phase-5 requests
    through the greedy spec engine (``spec_k`` 4, ``early_exit:2``) against
    5b's plain-engine tokens under 5b's margin rule; four seeded sampled
    requests through the lane spec program in two admission orders; one
    capture of each spec program; a tight pool with ``swap_gb`` against the
    full-residency tokens (swaps > 0); a request whose deadline passes mid
    decode finishing ``deadline_exceeded`` while the others keep their
    tokens; and the usage ledger conserved on each engine."""
    from accelerate_tpu_torch.serving import RequestState

    out = {}
    reqs = _requests(12, seed=0)
    engine = _flagship_engine(model, **SPEC)
    handles = [engine.add_request(r["prompt"], r["max_new_tokens"]) for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    launches = check_spec_counts(stats, 16, "greedy spec engine")
    _usage_conserved(stats, "greedy spec engine")
    cfg = engine.config
    del engine
    spec = [list(h.output_tokens) for h in handles]
    matched, diverged = 0, []
    for r, got, ref in zip(reqs, spec, greedy):
        d = _divergence(model, r["prompt"], got, ref, cfg)
        if d is None:
            matched += 1
            continue
        diverged.append({"id": r["id"], **d})
        log(f"  spec request {r['id']} parts from the plain engine at token {d['token']}: "
            f"{d.get('got')} vs {d.get('ref')}; top-2 margin {d.get('top2_margin', 0):.4e}, gap "
            f"{d['gap']:.4e}, bf16 noise {d['noise']:.4e}")
        if d["gap"] > d["noise"]:
            raise AssertionError(f"spec request {r['id']}: a divergence above bf16 noise")
    out["greedy"] = {"matched_plain": matched, "diverged": diverged, "wall_s": wall,
                     "tokens_per_sec": stats["tokens_per_sec"], "launches": launches,
                     "spec_accept_rate": stats["spec_accept_rate"],
                     "spec_drafted_tokens": stats["spec_drafted_tokens"],
                     "spec_accepted_tokens": stats["spec_accepted_tokens"]}
    log(f"  greedy spec engine (spec_k {SPEC['spec_k']}, {SPEC['draft']}): {matched} of "
        f"{len(reqs)} requests give the plain engine's tokens, {len(diverged)} part within bf16 "
        f"noise; accept rate {stats['spec_accept_rate']:.3f}; {wall:.2f} s, "
        f"{stats['tokens_per_sec']:.1f} tok/s; {launches}")

    # sampled, through the lane spec program, in two admission orders
    sreqs = _requests(4, seed=5)
    outs = []
    for order in (range(4), range(3, -1, -1)):
        engine = _flagship_engine(model, **SPEC)
        hs = {i: engine.add_request(sreqs[i]["prompt"], 32,
                                    sampling={**SAMPLED_LEG, "seed": 31 + i}) for i in order}
        engine.run_until_idle()
        outs.append([list(hs[i].output_tokens) for i in range(4)])
        st = engine.stats()
        check_spec_counts(st, 16, "sampled spec engine", sampled=True)
        _usage_conserved(st, "sampled spec engine")
        del engine
    if outs[0] != outs[1] or any(len(t) != 32 for t in outs[0]):
        raise AssertionError("sampled spec requests did not reproduce in reverse order")
    out["sampled"] = {"reproduce_reversed": True,
                      "rejection_accept_rate": st["rejection_accept_rate"]}
    log(f"  sampled spec engine: 4 seeded requests reproduce in reverse admission order; "
        f"rejection accept rate {st['rejection_accept_rate']:.3f}")

    # a tight pool with the swap tier against full residency
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 32000, size=100).tolist() for _ in range(8)]
    runs = {}
    for name, kw in (("full", {}), ("tight", {"num_blocks": 72, "swap_gb": 1.0})):
        engine = _flagship_engine(model, **kw)
        hs = [engine.add_request(p, 128) for p in prompts]
        engine.run_until_idle()
        st = engine.stats()
        check_graph_counts(st, 16, 8, f"swap engine ({name})")
        _usage_conserved(st, f"swap engine ({name})")
        runs[name] = ([list(h.output_tokens) for h in hs], st)
        del engine
    tight = runs["tight"][1]
    if runs["tight"][0] != runs["full"][0]:
        bad = [i for i, (a, b) in enumerate(zip(runs["tight"][0], runs["full"][0])) if a != b]
        raise AssertionError(f"swap preemption changed the tokens of requests {bad}")
    if not (tight["preemptions"] > 0 and tight["swapped_out_blocks"] == tight["swapped_in_blocks"]
            > 0 and tight["out_of_blocks_total"] == 0 and tight["swap_used_blocks"] == 0):
        raise AssertionError(f"the tight pool did not swap as it should: {tight}")
    out["swap"] = {k: tight[k] for k in ("preemptions", "swapped_out_blocks", "swapped_in_blocks",
                                         "swap_capacity_blocks", "swap_pool_host_bytes",
                                         "tokens_per_sec")}
    out["swap"]["full_residency_tokens_per_sec"] = runs["full"][1]["tokens_per_sec"]
    log(f"  tight pool (72 blocks, swap 1 GiB): the full-residency tokens for 8 requests; "
        f"{tight['preemptions']} preemptions, {tight['swapped_out_blocks']} blocks out and in")
    out["swap"]["timing"] = time_swap(model)

    # a deadline that passes mid-decode
    engine = _flagship_engine(model)
    base = [engine.add_request(p, 64) for p in prompts[:3]]
    doomed = engine.add_request(prompts[3], 512 - 100, deadline_ms=600.0)
    engine.run_until_idle()
    st = engine.stats()
    _usage_conserved(st, "deadline engine")
    del engine
    if doomed.finish_reason != "deadline_exceeded" or not doomed.output_tokens:
        raise AssertionError(f"the deadline request finished {doomed.finish_reason} with "
                             f"{len(doomed.output_tokens)} tokens")
    if [list(h.output_tokens) for h in base] != [t[:64] for t in runs["full"][0][:3]]:
        raise AssertionError("a deadline changed the other requests' tokens")
    if doomed.state is not RequestState.FINISHED or st["deadline_expired_total"] != 1:
        raise AssertionError(f"deadline accounting is wrong: {st['deadline_expired_total']}")
    out["deadline"] = {"partial_tokens": len(doomed.output_tokens),
                       "deadline_expired_total": st["deadline_expired_total"]}
    log(f"  deadline 600 ms: finished deadline_exceeded after {len(doomed.output_tokens)} "
        "tokens; the other 3 requests unchanged; usage conserved on every engine")
    torch.cuda.empty_cache()
    return out


def _usage_conserved(stats: dict, what: str) -> None:
    """The usage ledger's two conservation identities (JAX's): the decode
    shares sum to the device-wait total; the block-seconds to the pool
    integral."""
    u = stats["usage"]
    for a, b in ((u["decode_device_seconds"], u["device_wait_seconds"]),
                 (u["block_seconds"], u["pool_block_seconds"])):
        if not abs(a - b) <= 1e-9 * max(abs(b), 1e-3):
            raise AssertionError(f"{what}: usage not conserved ({a} vs {b})")


def time_swap(model) -> dict:
    """Swap-out and swap-in of one request's blocks at the flagship's block
    shape (16 layers × 16 keys × 12 heads × 128, bf16, K and V): a 512-id
    prompt (32 blocks) prefilled, then ``_swap_out`` (gather on the card, one
    copy into pinned memory behind an event, the host pool's row copy) and
    the restore at re-admission (one copy up, an ``index_copy_`` a pool),
    each timed on the host clock around a synchronised card; GB/s of the
    swapped bytes."""
    from accelerate_tpu_torch.serving import RequestState

    rng = np.random.default_rng(19)
    out = {"out_ms": [], "in_ms": []}
    engine = _flagship_engine(model, swap_gb=1.0, async_dispatch=False)
    req = engine.add_request(rng.integers(1, 32000, size=512).tolist(), 256)
    while not req.output_tokens:  # prefilled: decoding, its first burst harvested
        engine.step()
    if req.state is not RequestState.DECODE:
        raise AssertionError(f"the swap request is {req.state}, not decoding")
    for _ in range(3):
        before = engine._swapped_out_blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not engine._swap_out(req):
            raise AssertionError("the swap pool could not take the request")
        t1 = time.perf_counter()
        engine._admit_and_place()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if req.slot is None or req.swap_plan:
            raise AssertionError("the swapped request was not restored")
        n = engine._swapped_out_blocks - before
        out["out_ms"].append((t1 - t0) * 1e3)
        out["in_ms"].append((t2 - t1) * 1e3)
    engine.run_until_idle()
    nbytes = n * engine._swap.bytes_per_block
    del engine
    out.update(blocks=n, bytes=nbytes, bytes_per_block=nbytes // n,
               out_ms_per_block=sorted(out["out_ms"])[1] / n,
               in_ms_per_block=sorted(out["in_ms"])[1] / n,
               out_gb_per_s=nbytes / (sorted(out["out_ms"])[1] * 1e-3) / 1e9,
               in_gb_per_s=nbytes / (sorted(out["in_ms"])[1] * 1e-3) / 1e9)
    log(f"  swap at the flagship block shape: {n} blocks of {nbytes // n} B; out "
        f"{out['out_ms_per_block']:.4f} ms a block ({out['out_gb_per_s']:.2f} GB/s), in "
        f"{out['in_ms_per_block']:.4f} ms a block ({out['in_gb_per_s']:.2f} GB/s); median of 3")
    return out


# -- phase 5e, 5f -------------------------------------------------------------

#: the front door's HTTP timeouts (a request, a wait for a state)
HTTP_TIMEOUT_S = 300


def _http(base: str, path: str, body: dict | None = None):
    """``(status, text)`` of one GET (``body`` None) or JSON POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _json(base: str, path: str, body: dict | None = None) -> dict:
    status, text = _http(base, path, body)
    out = json.loads(text)
    if status != 200:
        raise AssertionError(f"{path} answered {status}: {out}")
    return out


def _sse(base: str, body: dict) -> dict:
    """One streamed completion, timed on the client: ``{"deltas", "ttft_s",
    "tpot_s", "tokens", "finish_reason"}`` (``deltas``: each chunk's text;
    TTFT to the first chunk that carries text; TPOT over the rest of the
    tokens)."""
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps({**body, "stream": True}).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    first = last = None
    chunks, done = [], 0
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line:
                continue
            if not line.startswith("data: "):
                raise AssertionError(f"SSE frame without data: {line!r}")
            if line == "data: [DONE]":
                done += 1
                continue
            chunk = json.loads(line[6:])
            if "error" in chunk:
                raise AssertionError(f"SSE error chunk: {chunk}")
            if chunk["choices"][0]["text"]:
                last = time.perf_counter()
                first = first or last
            chunks.append(chunk)
    finals = [c for c in chunks if c["choices"][0]["finish_reason"]]
    if done != 1 or len(finals) != 1 or finals[0] is not chunks[-1]:
        raise AssertionError(f"SSE stream: {done} [DONE] and {len(finals)} finish chunks")
    n = finals[0]["usage"]["completion_tokens"]
    return {"deltas": [c["choices"][0]["text"] for c in chunks if c["choices"][0]["text"]],
            "ttft_s": first - t0, "tpot_s": (last - first) / max(n - 1, 1), "tokens": n,
            "finish_reason": finals[0]["choices"][0]["finish_reason"]}


def _concurrent(calls) -> list:
    """Run the zero-argument ``calls`` at once, one thread each; their
    results in order (an exception is re-raised)."""
    import threading

    out = [None] * len(calls)

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT_S)
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


def _pct(values, q) -> float:
    return float(np.percentile(values, q))


def _splits(deltas, tokens) -> bool:
    """True when the SSE delta texts are the byte-vocabulary decodes of
    consecutive, non-empty runs of ``tokens`` covering all of them (each
    chunk decodes alone, so a chunk boundary inside a UTF-8 sequence shows
    as replacement characters: the texts are compared run by run)."""
    from accelerate_tpu_torch.serving.openai_api import decode_tokens

    reach = {0}  # token positions some split of the deltas so far can end at
    for text in deltas:
        reach = {j for i in reach for j in range(i + 1, len(tokens) + 1)
                 if decode_tokens(tokens[i:j]) == text}
    return len(tokens) in reach


def _timed_sse_batch(base, reqs) -> dict:
    """``reqs`` as greedy SSE completions, all at once: client TTFT and TPOT
    p50/p99 and tokens/s over the batch's wall."""
    t0 = time.perf_counter()
    answers = _concurrent([lambda r=r: _sse(base, {"prompt": r["prompt"], "temperature": 0,
                                                   "max_tokens": r["max_new_tokens"]})
                           for r in reqs])
    wall = time.perf_counter() - t0
    ttft = [a["ttft_s"] for a in answers]
    tpot = [a["tpot_s"] for a in answers]
    return {"answers": answers, "wall_s": wall,
            "tokens_per_sec": sum(a["tokens"] for a in answers) / wall,
            "ttft_s": {"p50": _pct(ttft, 50), "p99": _pct(ttft, 99)},
            "tpot_s": {"p50": _pct(tpot, 50), "p99": _pct(tpot, 99)}}


def _kernel_summary(manifest: dict) -> dict:
    path = next(p for p in manifest["artifacts"] if p.endswith("kernel_summary.json"))
    with open(path) as f:
        return json.load(f)


#: tokens each request of the front door's SIGTERM drain asks for
DRAIN_NEW = 100


def run_front_door(phase5: dict) -> dict:
    """``serve --http`` on the flagship in a fresh process (so its counts
    start at 0), driven as clients drive it: the lifecycle; phase 5's
    requests as its first traffic, greedy SSE, timed on the client and
    equal to phase 5's stdin rows (both runs include the first captures);
    16 requests at once: greedy non-stream and SSE completions and
    ``/generate`` (phase 5's tokens), chat, a JSON-schema answer and
    seeded sampled requests that reproduce, with a ``/profile`` window
    opened just before them (the lane burst's capture falls inside it);
    a timed batch of 6 fresh prompts of phase 5's lengths (no prefix-cache
    hits); ``/healthz``,
    ``/stats`` and ``/metrics`` timed, ``/metrics`` against ``/stats``; one
    capture of each program and B4's launches = eager + replays × captured;
    a SIGTERM with requests in flight: every one answered, the flight drain
    written, exit 0."""
    import threading

    from accelerate_tpu_torch.metrics.openmetrics import parse_openmetrics, sample_value
    from accelerate_tpu_torch.serving.grammar import validate_instance
    from accelerate_tpu_torch.serving.openai_api import decode_tokens

    logging_dir = os.path.join(REPO, "build", "front_door")
    os.makedirs(logging_dir, exist_ok=True)
    t_spawn = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch", *SERVE_ARGS, "--http", "0",
         "--logging-dir", logging_dir],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    stderr_lines: list = []
    try:
        line = proc.stderr.readline()
        stderr_lines.append(line)
        m = re.search(r"http://127\.0\.0\.1:(\d+)", line)
        if m is None:
            raise AssertionError(f"serve --http printed no address: {line!r}")
        threading.Thread(target=lambda: stderr_lines.extend(proc.stderr), daemon=True).start()
        base = f"http://127.0.0.1:{m.group(1)}"
        states = []
        while not states or states[-1] != "ready":
            if proc.poll() is not None or time.perf_counter() - t_spawn > HTTP_TIMEOUT_S:
                raise AssertionError(f"serve --http never got ready: {states[-3:]}\n"
                                     + "".join(stderr_lines)[-3000:])
            states.append(_json(base, "/healthz")["state"])
            time.sleep(0.05)
        ready_s = time.perf_counter() - t_spawn
        if states[0] != "starting":
            raise AssertionError(f"/healthz did not answer `starting` first: {states[:3]}")
        status, text = _http(base, "/nowhere")
        if status != 404:
            raise AssertionError(f"an unknown path answered {status}")

        reqs = _requests(12, seed=0)  # phase 5's requests
        ref = {r["id"]: r["tokens"] for r in phase5["rows"]}
        marks = {"ready": time.perf_counter()}  # each step's end, for its seconds

        # (1) the first traffic, as in phase 5: its 12 as greedy SSE (the
        # plain burst and the prefill chunk are captured inside), scrapes
        # under load
        scrapes = []
        stop_scraping = threading.Event()

        def scrape():
            while not stop_scraping.is_set():
                t0 = time.perf_counter()
                text = _http(base, "/metrics")[1]
                scrapes.append(time.perf_counter() - t0)
                parse_openmetrics(text)
                time.sleep(0.1)

        scraper = threading.Thread(target=scrape)
        scraper.start()
        timed = _timed_sse_batch(base, reqs)
        stop_scraping.set()
        scraper.join(HTTP_TIMEOUT_S)
        for r, a in zip(reqs, timed["answers"]):
            if not _splits(a["deltas"], ref[r["id"]]) or a["tokens"] != len(ref[r["id"]]):
                raise AssertionError(f"SSE answer {r['id']} differs from phase 5's tokens")
        marks["first_traffic"] = time.perf_counter()

        # (2) 16 requests at once, a /profile window opened just before them:
        # 10 of phase 5's greedy (4 non-stream completions, 3 SSE, 3 /generate),
        # a chat, a JSON-schema answer and 4 sampled with seeds; the last six
        # need the lane burst, whose capture falls inside the window
        schema = {"type": "object", "properties": {"ok": {"type": "boolean"}},
                  "required": ["ok"]}
        sampled = [{"id": f"s{i}", "prompt": reqs[i]["prompt"][:64], "max_new_tokens": 32,
                    "sampling": {"do_sample": True, "temperature": 0.8, "top_p": 0.9,
                                 "seed": 100 + i}} for i in range(4)]
        stats_before = _json(base, "/stats")
        profile = {}
        profiler = threading.Thread(target=lambda: profile.update(
            _json(base, "/profile?seconds=1")))
        profiler.start()
        time.sleep(0.2)
        greedy = [r for r in reqs[:10]]
        calls = [lambda r=r: _json(base, "/v1/completions", {
                     "prompt": r["prompt"], "temperature": 0, "max_tokens": 64})
                 for r in greedy[:4]]
        calls += [lambda r=r: _sse(base, {"prompt": r["prompt"], "temperature": 0,
                                          "max_tokens": 64}) for r in greedy[4:7]]
        calls += [lambda r=r: _json(base, "/generate", r) for r in greedy[7:10]]
        calls += [lambda: _json(base, "/v1/chat/completions", {
                      "messages": [{"role": "user", "content": "Say hello."}],
                      "temperature": 0, "max_tokens": 16}),
                  lambda: _json(base, "/v1/chat/completions", {
                      "messages": [{"role": "user", "content": "Reply in JSON."}],
                      "temperature": 0, "max_tokens": 24, "response_format": {
                          "type": "json_schema", "json_schema": {"schema": schema}}})]
        calls += [lambda r=r: _json(base, "/generate", r) for r in sampled]
        answers = _concurrent(calls)
        profiler.join(HTTP_TIMEOUT_S)
        for r, a in zip(greedy[:4], answers[:4]):
            if a["choices"][0]["text"] != decode_tokens(ref[r["id"]]):
                raise AssertionError(f"completion {r['id']} differs from phase 5's tokens")
        for r, a in zip(greedy[4:7], answers[4:7]):
            if not _splits(a["deltas"], ref[r["id"]]):
                raise AssertionError(f"SSE completion {r['id']} differs from phase 5's tokens")
        for r, a in zip(greedy[7:10], answers[7:10]):
            if a["tokens"] != ref[r["id"]]:
                raise AssertionError(f"/generate {r['id']} differs from phase 5's tokens")
        chat, structured = answers[10], answers[11]
        if chat["object"] != "chat.completion" or chat["usage"]["completion_tokens"] < 1:
            raise AssertionError(f"the chat answer is malformed: {chat}")
        validate_instance(schema, json.loads(structured["choices"][0]["message"]["content"]))
        again = _concurrent([lambda r=r: _json(base, "/generate", r) for r in sampled[::-1]])
        if [a["tokens"] for a in answers[12:]] != [a["tokens"] for a in again[::-1]]:
            raise AssertionError("the seeded sampled requests did not reproduce")
        summary = _kernel_summary(profile)
        named = {k: sum(v["launches"] for n, v in summary.items() if k in n)
                 for k in PAGED_KERNELS}
        if not all(named.values()) or profile["flight_iterations"] < 1:
            raise AssertionError(f"/profile saw B4 {named} and {profile['flight_iterations']} "
                                 "flight iterations")

        marks["mixed_16_profiled"] = time.perf_counter()
        # (3) fresh prompts of phase 5's lengths (no prefix-cache hits), 6
        # of them (the smoke run's time budget; the /profile window of (2)
        # is the one the phase keeps)
        timed_plain = _timed_sse_batch(base, _requests(6, seed=1))

        marks["fresh_batches"] = time.perf_counter()
        # (4) idle: the routes timed, /metrics against /stats, the captures
        # and B4's launches
        idle_ms = {}
        for route in ("/healthz", "/stats", "/metrics"):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                text = _http(base, route)[1]
                times.append((time.perf_counter() - t0) * 1e3)
            idle_ms[route] = {"p50": _pct(times, 50), "max": max(times)}
        families = parse_openmetrics(text)
        stats = _json(base, "/stats")
        for family, key in (("accelerate_serving_completed", "completed"),
                            ("accelerate_serving_iterations", "iterations"),
                            ("accelerate_serving_decode_compiles", "decode_compiles")):
            if sample_value(families, family) != stats[key]:
                raise AssertionError(f"/metrics {family} {sample_value(families, family)} != "
                                     f"/stats {key} {stats[key]}")
        launches = check_graph_counts(stats, 16, 8, "serve --http",
                                      captures={"lane_decode": 1})
        if (stats_before["decode_compiles"], stats_before["prefill_compiles"]) != (1, 1):
            raise AssertionError(f"captures before the profiled batch: {stats_before}")

        marks["idle_routes"] = time.perf_counter()
        # (5) SIGTERM with 8 requests in flight
        drain_reqs = [{"id": f"d{i}", "prompt": reqs[i]["prompt"], "max_new_tokens": DRAIN_NEW}
                      for i in range(8)]
        drained = []
        senders = [threading.Thread(target=lambda r=r: drained.append(
            _json(base, "/generate", r))) for r in drain_reqs]
        for t in senders:
            t.start()
        deadline = time.perf_counter() + HTTP_TIMEOUT_S
        while True:
            h = _json(base, "/healthz")
            if h["active_slots"] + h["queue_depth"] >= 8:
                break
            if time.perf_counter() > deadline:
                raise AssertionError(f"the drain batch never got admitted: {h}")
            time.sleep(0.01)
        t_term = time.perf_counter()
        proc.send_signal(__import__("signal").SIGTERM)
        for t in senders:
            t.join(HTTP_TIMEOUT_S)
        rc = proc.wait(timeout=HTTP_TIMEOUT_S)
        drain_s = time.perf_counter() - t_term
        marks["drain"] = time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    stderr = "".join(stderr_lines)
    if rc != 0 or "(drained on SIGTERM)" not in stderr:
        raise AssertionError(f"serve --http exited {rc} on SIGTERM:\n{stderr[-3000:]}")
    if sorted(r["id"] for r in drained) != sorted(r["id"] for r in drain_reqs) or any(
            len(r["tokens"]) != DRAIN_NEW for r in drained):
        raise AssertionError(f"the drain lost requests: {[r.get('id') for r in drained]}")
    if not any(n.startswith(f"FLIGHT_DRAIN_{proc.pid}") for n in os.listdir(logging_dir)):
        raise AssertionError("the SIGTERM drain wrote no flight drain file")
    final = _serve_stats(stderr, "serve --http")
    final_launches = check_graph_counts(final, 16, 8, "serve --http (after the drain)",
                                        captures={"lane_decode": 1})
    out = {
        "ready_s": ready_s, "healthz_states": [states[0], states[-1]],
        "client": {k: timed[k] for k in ("wall_s", "tokens_per_sec", "ttft_s", "tpot_s")},
        "client_fresh": {k: timed_plain[k] for k in ("wall_s", "tokens_per_sec", "ttft_s",
                                                     "tpot_s")},
        "phase5_stdin": {k: phase5[k] for k in ("tokens_per_sec", "ttft_s", "tpot_s",
                                                "wall_s")},
        "iteration_p50_s": stats.get("iteration_p50_s"),
        "route_ms_idle": idle_ms,
        "metrics_scrape_ms": {"idle": idle_ms["/metrics"]["p50"],
                              "under_load_p50": _pct(scrapes, 50) * 1e3,
                              "under_load_max": max(scrapes) * 1e3, "n": len(scrapes)},
        "profile": {"flight_iterations": profile["flight_iterations"], "seconds":
                    profile["seconds"], "b4_launches_named": named,
                    "lane_capture_inside": stats_before["lane_decode_compiles"] == 0},
        "launches": launches, "launches_after_drain": final_launches,
        "captures": {k: final[k] for k in ("decode_compiles", "prefill_compiles",
                                           "lane_decode_compiles")},
        "drain_s": drain_s, "answered_in_drain": len(drained),
        "step_s": {k: marks[k] - t for k, t in zip(list(marks)[1:], marks.values())},
    }
    log(f"  serve --http: ready in {ready_s:.1f} s ({states[0]} -> ready); 12 greedy SSE "
        f"{timed['tokens_per_sec']:.1f} tok/s, client TTFT p50/p99 "
        f"{timed['ttft_s']['p50'] * 1e3:.1f}/{timed['ttft_s']['p99'] * 1e3:.1f} ms, TPOT "
        f"{timed['tpot_s']['p50'] * 1e3:.2f}/{timed['tpot_s']['p99'] * 1e3:.2f} ms (phase 5 "
        f"stdin {phase5['tokens_per_sec']:.1f} tok/s); fresh prompts "
        f"{timed_plain['tokens_per_sec']:.1f} tok/s; /profile under load named "
        f"{named} over {profile['flight_iterations']} iterations (lane capture inside: "
        f"{out['profile']['lane_capture_inside']}); idle ms {idle_ms}; /metrics "
        f"p50 {out['metrics_scrape_ms']['under_load_p50']:.2f} ms under load; captures "
        f"{out['captures']}; B4 launches {launches}; SIGTERM drained {len(drained)} in "
        f"{drain_s:.2f} s, exit {rc}; seconds by step "
        f"{ {k: round(v, 1) for k, v in out['step_s'].items()} }")
    return out


def run_workload_replay() -> dict:
    """``serve --trace`` on the flagship in stdin mode: the answered count
    equals the schedule's length, every answer has its budget of tokens,
    and the ``WORKLOAD.json`` digest equals a recomputation."""
    from accelerate_tpu_torch.serving.workload import (
        WORKLOAD_FILENAME,
        generate_schedule,
        parse_trace_spec,
        schedule_digest,
    )

    spec = "bursty-diurnal:7:4:8"
    schedule = generate_schedule(parse_trace_spec(spec))
    logging_dir = os.path.join(REPO, "build", "workload")
    os.makedirs(logging_dir, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch", *SERVE_ARGS, "--trace", spec,
         "--logging-dir", logging_dir],
        input="", capture_output=True, text=True, cwd=REPO, timeout=SERVE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"serve --trace exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    budgets = {e["payload"]["id"]: e["payload"]["max_new_tokens"] for e in schedule}
    if sorted(r["id"] for r in rows) != sorted(budgets) or any(
            len(r["tokens"]) != budgets[r["id"]] for r in rows):
        raise AssertionError(f"serve --trace answered {len(rows)} of {len(schedule)}")
    with open(os.path.join(logging_dir, WORKLOAD_FILENAME)) as f:
        manifest = json.load(f)
    if manifest["schedule_sha256"] != schedule_digest(schedule):
        raise AssertionError("the workload manifest's digest is not the schedule's")
    stats = _serve_stats(proc.stderr, "serve --trace")
    launches = check_graph_counts(stats, 16, 8, "serve --trace")
    log(f"  serve --trace {spec}: {len(rows)} of {len(schedule)} answered in {wall:.1f} s, "
        f"digest {manifest['schedule_sha256'][:16]}..., launches {launches}")
    return {"spec": spec, "requests": len(schedule), "answered": len(rows), "wall_s": wall,
            "schedule_sha256": manifest["schedule_sha256"], "launches": launches}


# -- phase 5g, 5h -------------------------------------------------------------

#: phase 5g: the fleet over two flagship replicas on the one card, replica 0
#: killed (SIGKILL, mid graph replay) at its 7th request
FLEET_ARGS = ["route", "--replicas", "2", "--preset", "flagship", "--dtype", "bf16",
              "--num-slots", "8", "--max-seq-len", "1024", "--respawn",
              "--health-interval", "0.2", "--chaos-spec", "r0:kill@7"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_trail(logging_dir: str) -> list:
    path = os.path.join(logging_dir, "router", "replicas.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _latest_replicas(rows: list) -> dict:
    latest = {}
    for r in rows:
        if r.get("replica_id") is not None:
            latest[r["replica_id"]] = r
    return latest


def _wait_for(cond, what: str, timeout: float = HTTP_TIMEOUT_S, poll: float = 0.1):
    deadline = time.perf_counter() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(poll)


def _gpu_pids() -> list:
    """The pids ``nvidia-smi`` lists as compute processes on the card, one
    entry a process (a sandbox's pid namespace may show them under other
    pids than its own: the count is compared too)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def _check_greedy(model, cfg, reqs, answers, ref, what: str) -> list:
    """Each answer's tokens equal phase 5's for its prompt, or part from them
    only within bf16 noise (5b's margin rule); the divergences."""
    diverged = []
    for r, got in zip(reqs, answers):
        d = _divergence(model, r["prompt"], got, ref[r["ref"]], cfg)
        if d is None:
            continue
        diverged.append({"id": r["id"], **d})
        log(f"  {what} request {r['id']} parts from phase 5 at token {d['token']}: "
            f"gap {d['gap']:.4e}, bf16 noise {d['noise']:.4e}")
        if d["gap"] > d["noise"]:
            raise AssertionError(f"{what} request {r['id']}: a divergence above bf16 noise")
    return diverged


def run_fleet(model, phase5: dict, front_door: dict) -> dict:
    """``route --replicas 2`` over two ``serve --http`` flagship replicas on
    the card, chaos ``r0:kill@7``, driven as clients drive it: phase 5's 12
    requests as greedy SSE through the router's OpenAI door, then the same
    12 prompts again as JSONL rows on route's stdin (dispatched to the
    replicas' ``POST /generate``; replica 0's 7th request kills it mid graph
    replay and the requests it held are rescued to replica 1). Gates: every
    request answered exactly once; greedy tokens equal phase 5's or part
    within 5b's margin rule; replica 0 respawned once and the fleet back to
    two ready (spawn to ready timed); replica 1's ``/stats`` (then the
    respawned replica 0's) one capture of each program and B4's launches
    = eager + replays × captured (replica 0's after one fresh request of
    400 tokens, its TPOT printed beside phase 5's). Last, SIGTERM to route: drained, exit 0, no fleet process alive and
    ``nvidia-smi``'s compute apps as before the fleet. Tok/s, client TTFT
    and TPOT p50/p99 printed beside phase 5e's single replica."""
    import signal
    import threading

    from accelerate_tpu_torch.serving import EngineConfig

    cfg = EngineConfig(num_slots=8, max_seq_len=1024)
    logging_dir = os.path.join(REPO, "build", "fleet")
    shutil.rmtree(logging_dir, ignore_errors=True)  # the trail appends: start it empty
    os.makedirs(logging_dir)
    port = _free_port()
    stderr_path = os.path.join(logging_dir, "route.stderr")
    ref = {r["id"]: r["tokens"] for r in phase5["rows"]}
    reqs = _requests(12, seed=0)
    gpu_before = _gpu_pids()
    t_spawn = time.perf_counter()
    with open(stderr_path, "w") as stderr_file:
        proc = subprocess.Popen(
            [sys.executable, "-m", "accelerate_tpu_torch", *FLEET_ARGS, "--http", str(port),
             "--logging-dir", logging_dir],
            cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=stderr_file,
            text=True)
    rows_out: list = []
    threading.Thread(target=lambda: rows_out.extend(json.loads(line) for line in proc.stdout
                                                    if line.strip()), daemon=True).start()

    def stderr_text():
        with open(stderr_path) as f:
            return f.read()

    def stdin_rows(payloads):
        for p in payloads:
            proc.stdin.write(json.dumps(p) + "\n")
        proc.stdin.flush()

    def answered(ids):
        return {r.get("id") for r in rows_out} >= set(ids)

    try:
        _wait_for(lambda: "route: fleet ready" in stderr_text() or proc.poll() is not None,
                  "the fleet to report ready")
        if proc.poll() is not None:
            raise AssertionError(f"route exited {proc.returncode}:\n{stderr_text()[-3000:]}")
        ready_s = time.perf_counter() - t_spawn
        base = f"http://127.0.0.1:{port}"
        def door_up():  # route mounts its OpenAI door after the fleet is ready
            try:
                return _http(base, "/healthz")[0] == 200
            except OSError:
                return False

        _wait_for(door_up, "the router's door")
        first = _latest_replicas(_fleet_trail(logging_dir))
        pids0 = {r: row["pid"] for r, row in first.items()}
        urls = {r: row["base_url"] for r, row in first.items()}

        # wave A: phase 5's 12 as greedy SSE through the router's door (the
        # router answers whole completions: TTFT on the client is the
        # request's latency)
        wave_a = _timed_sse_batch(base, reqs)
        for r, a in zip(reqs, wave_a["answers"]):
            if not _splits(a["deltas"], ref[r["id"]]) or a["tokens"] != len(ref[r["id"]]):
                raise AssertionError(f"fleet SSE answer {r['id']} differs from phase 5's tokens")

        # wave B: the same 12 prompts as /generate rows (prefix affinity sends
        # each back to the replica that served it; replica 0's 7th kills it)
        wave_b = [{"id": 100 + r["id"], "prompt": r["prompt"], "max_new_tokens": 64,
                   "ref": r["id"]} for r in reqs]
        t_b = time.perf_counter()
        stdin_rows({k: v for k, v in p.items() if k != "ref"} for p in wave_b)
        _wait_for(lambda: answered(p["id"] for p in wave_b) or proc.poll() is not None,
                  "wave B's answers")
        wave_b_wall = time.perf_counter() - t_b
        by_id = {r["id"]: r for r in rows_out}
        errors = [by_id[p["id"]] for p in wave_b if "error" in by_id[p["id"]]]
        if errors:
            raise AssertionError(f"wave B lost requests to the kill: {errors}")
        diverged = _check_greedy(model, cfg, wave_b, [by_id[p["id"]]["tokens"] for p in wave_b],
                                 ref, "fleet /generate")

        # replica 0 respawned once, the fleet back to two ready
        def recovered():
            latest = _latest_replicas(_fleet_trail(logging_dir))
            return (len(latest) == 2 and all(r["state"] == "ready" for r in latest.values())
                    and latest[0].get("restarts") == 1 and latest)
        latest = _wait_for(recovered, "replica 0's respawn to report ready")
        gpu_during = _gpu_pids()
        trail = _fleet_trail(logging_dir)
        dead_ts = next(r["ts"] for r in trail if r.get("replica_id") == 0
                       and r["state"] == "dead")
        ready_ts = next(r["ts"] for r in trail if r.get("replica_id") == 0
                        and r.get("restarts") == 1 and r["state"] == "ready")
        respawn_ready_s = ready_ts - dead_ts
        urls[0] = latest[0]["base_url"]
        stats_r1 = _json(urls[1], "/stats")
        launches_r1 = check_graph_counts(stats_r1, 16, 8, "fleet replica 1")

        # one fresh prompt on the respawned replica 0 (the fleet idle,
        # least-loaded picks it), so its graphs are captured and its counts
        # read. (The SIGSTOP wedge of replica 1 and its rescue, ~80 s with
        # the second respawn, are cut for the smoke run's time budget.)
        fresh = _requests(4, seed=7)[1]["prompt"]  # 310 ids: with 400 new, under 1024
        fresh_req = {"id": 201, "prompt": fresh, "max_new_tokens": 400}
        seen = {}

        def decoding_on_r0():
            refused = [r for r in rows_out if r.get("id") == 201 and "error" in r]
            if refused:
                raise AssertionError(f"the respawned replica's request was refused: {refused}")
            seen[0] = _json(urls[0], "/healthz")["active_slots"]
            return seen[0] > 0 or answered([201])

        stdin_rows([fresh_req])
        try:
            _wait_for(decoding_on_r0, "the respawned replica 0 to take the fresh request",
                      timeout=120, poll=0.005)
        except AssertionError as e:
            raise AssertionError(f"{e}: active slots {seen}\n{stderr_text()[-2000:]}") from None
        _wait_for(lambda: answered([201]), "the respawned replica 0's answer")
        fresh_row = next(r for r in rows_out if r.get("id") == 201)
        if "error" in fresh_row or len(fresh_row["tokens"]) != 400:
            raise AssertionError(f"the respawned replica's request: {fresh_row}")
        stats_r0 = _json(urls[0], "/stats")
        launches_r0 = check_graph_counts(stats_r0, 16, 8, "fleet replica 0 (respawned)")

        # SIGTERM: drain, exit 0
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=HTTP_TIMEOUT_S)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:  # a failed gate: drain, then make sure
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
            for row in _fleet_trail(logging_dir):
                if row.get("pid") and row.get("replica_id") is not None:
                    try:
                        os.kill(row["pid"], signal.SIGKILL)
                    except OSError:
                        pass
    trail = _fleet_trail(logging_dir)
    fleet_pids = {r["pid"] for r in trail if r.get("pid") and r.get("replica_id") is not None}
    if rc != 0:
        raise AssertionError(f"route exited {rc} on SIGTERM:\n{stderr_text()[-3000:]}")
    ids = sorted(r.get("id") for r in rows_out)
    expect = sorted([p["id"] for p in wave_b] + [fresh_req["id"]])
    if ids != expect:
        raise AssertionError(f"the fleet's stdin answers {ids} are not one each of {expect}")
    totals = [r for r in trail if r.get("kind") == "router"][-1]
    restarts = {rid: r.get("restarts") for rid, r in _latest_replicas(trail).items()}
    if totals.get("respawns") != 1 or restarts[0] != 1 or restarts[1]:
        raise AssertionError(f"respawns {totals.get('respawns')}, restarts {restarts}: replica "
                             "0 must be respawned exactly once, replica 1 never")
    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except OSError:
            return False

    _wait_for(lambda: not any(alive(p) for p in fleet_pids), "the fleet's processes to exit",
              timeout=30)
    _wait_for(lambda: _gpu_pids() == gpu_before, "nvidia-smi to list what it listed before "
              "the fleet", timeout=30)
    gpu_after = _gpu_pids()
    if (fleet_pids | {proc.pid}) & set(gpu_after):
        raise AssertionError(f"fleet processes still on the card: {gpu_after}")
    engine_b = [by_id[p["id"]] for p in wave_b]
    out = {
        "chaos": "r0:kill@7", "ready_s": ready_s, "respawn_dead_to_ready_s": respawn_ready_s,
        "first_pids": pids0,
        "wave_a_sse": {k: wave_a[k] for k in ("wall_s", "tokens_per_sec", "ttft_s", "tpot_s")},
        "wave_b_generate": {
            "wall_s": wave_b_wall,
            "tokens_per_sec": sum(len(r["tokens"]) for r in engine_b) / wave_b_wall,
            "engine_ttft_s": {"p50": _pct([r["ttft_s"] for r in engine_b], 50),
                              "p99": _pct([r["ttft_s"] for r in engine_b], 99)},
            "engine_tpot_s": {"p50": _pct([r["tpot_s"] for r in engine_b], 50),
                              "p99": _pct([r["tpot_s"] for r in engine_b], 99)}},
        "diverged": diverged,
        "fresh_on_respawned_r0": {"tpot_s": fresh_row["tpot_s"],
                                  "phase5_tpot_p50_s": phase5["tpot_s"]["p50"]},
        "launches_replica1": launches_r1, "launches_replica0_respawned": launches_r0,
        "launches": {"total": launches_r1["total"] + launches_r0["total"],
                     "decode": launches_r1["decode"] + launches_r0["decode"]},
        "respawns": totals.get("respawns"), "requeues": totals.get("requeues"),
        "drain_s": drain_s, "gpu_pids_before": gpu_before,
        "gpu_pids_during": gpu_during, "gpu_pids_after": gpu_after,
        "fleet_pids": sorted(fleet_pids),
        "single_replica_5e": {k: front_door["client"][k] for k in ("tokens_per_sec", "ttft_s",
                                                                   "tpot_s")},
    }
    log(f"  route: 2 replicas ready in {ready_s:.1f} s; wave A 12 SSE "
        f"{wave_a['tokens_per_sec']:.1f} tok/s, client TTFT p50/p99 "
        f"{wave_a['ttft_s']['p50'] * 1e3:.1f}/{wave_a['ttft_s']['p99'] * 1e3:.1f} ms, TPOT "
        f"{wave_a['tpot_s']['p50'] * 1e3:.2f}/{wave_a['tpot_s']['p99'] * 1e3:.2f} ms (phase 5e "
        f"one replica {front_door['client']['tokens_per_sec']:.1f} tok/s, TTFT p50 "
        f"{front_door['client']['ttft_s']['p50'] * 1e3:.1f} ms); wave B 12 /generate through "
        f"r0:kill@7 {out['wave_b_generate']['tokens_per_sec']:.1f} tok/s, engine TTFT p50/p99 "
        f"{out['wave_b_generate']['engine_ttft_s']['p50'] * 1e3:.1f}/"
        f"{out['wave_b_generate']['engine_ttft_s']['p99'] * 1e3:.1f} ms, TPOT "
        f"{out['wave_b_generate']['engine_tpot_s']['p50'] * 1e3:.2f}/"
        f"{out['wave_b_generate']['engine_tpot_s']['p99'] * 1e3:.2f} ms; {len(diverged)} part "
        f"from phase 5 within noise; replica 0 dead to ready again {respawn_ready_s:.1f} s; "
        f"a fresh request on it TPOT {fresh_row['tpot_s'] * 1e3:.2f} ms (phase 5 p50 "
        f"{phase5['tpot_s']['p50'] * 1e3:.2f} ms); "
        f"B4 launches replica 1 {launches_r1}, "
        f"respawned replica 0 {launches_r0}; {totals.get('respawns')} respawns, "
        f"{totals.get('requeues')} requeues; SIGTERM drained in {drain_s:.2f} s, exit {rc}; "
        f"nvidia-smi compute apps {len(gpu_before)} before, {len(gpu_during)} with the fleet "
        f"up, {len(gpu_after)} after; no fleet process alive")
    return out


def run_preflight(dev) -> dict:
    """Phase 5h: ``serve --auto-blocks`` on the flagship sizes the pool
    against the card (the chosen ``num_blocks`` printed), and the
    pre-flight's predicted params + pool bytes equal the bytes of those
    tensors on the card; with ``--hbm-gb 1`` the engine refuses SP004 before
    any pool allocates (``torch.cuda.memory_allocated`` shows only the
    weights), and the entry point exits 2 with the error row."""
    import contextlib
    import io

    from accelerate_tpu_torch.analysis.shardplan import plan_kv_pool, plan_params
    from accelerate_tpu_torch.commands import serve
    from accelerate_tpu_torch.commands.accelerate_cli import build_parser
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.serving import EngineConfig, InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    args = build_parser().parse_args([*SERVE_ARGS, "--auto-blocks"])
    err = io.StringIO()
    m0 = torch.cuda.memory_allocated()
    with contextlib.redirect_stderr(err):
        engine = serve._make_engine(args)
    auto_line = err.getvalue().strip().splitlines()[-1]
    m_engine = torch.cuda.memory_allocated() - m0
    mc = engine.model.config
    num_blocks = engine.allocator.num_blocks
    predicted_params = sum(p.bytes_per_device for p in plan_params(engine.model))
    predicted_pool = sum(p.bytes_per_device for p in plan_kv_pool(
        num_layers=mc.num_hidden_layers, num_kv_heads=mc.num_key_value_heads,
        head_dim=mc.head_dim, num_slots=1, block_size=args.block_size,
        max_seq_len=args.max_seq_len, num_blocks=num_blocks, dtype="bfloat16"))
    actual_params = sum(t.numel() * t.element_size() for t in engine.model.state_dict().values())
    actual_pool = sum(t.numel() * t.element_size() for t in engine._pages.values())
    if (predicted_params, predicted_pool) != (actual_params, actual_pool):
        raise AssertionError(f"pre-flight predicted params {predicted_params} + pools "
                             f"{predicted_pool}, the card holds {actual_params} + {actual_pool}")
    log(f"  {auto_line}")
    log(f"  --auto-blocks: num_blocks {num_blocks}; predicted params {predicted_params} + pools "
        f"{predicted_pool} B = the tensors on the card; memory_allocated grew "
        f"{m_engine} B (the rest: operand and output buffers)")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    m_empty = torch.cuda.memory_allocated()
    model = LlamaForCausalLM.from_config(LlamaConfig.flagship_700m(), seed=0,
                                         dtype=torch.bfloat16, device=dev)
    m_weights = torch.cuda.memory_allocated()
    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    try:
        InferenceEngine(model, EngineConfig(num_slots=8, max_seq_len=1024, hbm_budget_gb=1.0),
                        device=dev)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("the flagship engine started under a 1 GiB budget")
    m_refused = torch.cuda.memory_allocated()
    if "SP004" not in refusal or m_refused != m_weights or m_weights - m_empty < weights:
        raise AssertionError(f"SP004 refusal {refusal!r}: memory_allocated {m_empty} -> "
                             f"{m_weights} (weights {weights}) -> {m_refused}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    args = build_parser().parse_args([*SERVE_ARGS, "--hbm-gb", "1"])
    out_buf = io.StringIO()
    with contextlib.redirect_stdout(out_buf), contextlib.redirect_stderr(io.StringIO()):
        rc = serve.serve_command(args)
    row = json.loads(out_buf.getvalue().strip().splitlines()[-1])
    if rc != 2 or "SP004" not in row.get("error", ""):
        raise AssertionError(f"serve --hbm-gb 1 exited {rc} with {row}")
    log(f"  --hbm-gb 1: refused before any pool ({refusal[:120]}...); memory_allocated "
        f"{m_weights - m_empty} B after the weights ({weights} B), {m_refused - m_empty} B after "
        f"the refusal; serve exit {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"auto_blocks": num_blocks, "auto_line": auto_line,
            "predicted_params_bytes": predicted_params, "predicted_pool_bytes": predicted_pool,
            "memory_allocated_engine_bytes": m_engine, "refusal": refusal,
            "allocated_after_refusal_bytes": m_refused - m_empty, "weights_bytes": weights,
            "serve_exit": rc}


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


#: profiler windows a measurement takes before it gives up: a window in
#: which the profiler saw no kernel row at all (it happens, rarely, over a
#: long run of windows in one process) is taken again
PROFILER_TRIES = 4


def _library_rows(fn, calls: int) -> list:
    """The kernel rows of ``calls`` calls of ``fn`` from the first of
    :data:`PROFILER_TRIES` windows that saw any; raises if none did."""
    for _ in range(PROFILER_TRIES):
        rows = _profiled_rows(fn, calls)
        if rows:
            return rows
    raise AssertionError(f"the profiler saw no kernel row in {PROFILER_TRIES} windows of the "
                         "library call")


def _profiled_ms_per_call(fn, calls: int, rows=None) -> float:
    """Device time a call of ``fn``: every kernel it runs, without the host
    time between them (a library call whose host cost exceeds its kernels'
    time shows more by events than here), from ``rows`` when given (a window
    already taken) or a new window. A time of 0.0 is never returned."""
    rows = rows or _library_rows(fn, calls)
    return sum(e.self_device_time_total for e in rows) / 1e3 / calls


def _profiled_ms_per_launch(fn, calls: int, names) -> dict:
    """Device time a launch of each kernel in ``names`` over ``calls`` calls
    of ``fn`` under ``torch.profiler`` (kernel rows whose name holds it),
    from the first of :data:`PROFILER_TRIES` windows that saw them all."""
    for _ in range(PROFILER_TRIES):
        rows = _profiled_rows(fn, calls)
        hits = {name: [e for e in rows if name in e.key] for name in names}
        if all(sum(e.count for e in h) for h in hits.values()):
            return {name: sum(e.self_device_time_total for e in h) / 1e3 / sum(e.count for e in h)
                    for name, h in hits.items()}
    raise AssertionError(f"the profiler saw no launch of some of {list(names)} in "
                         f"{PROFILER_TRIES} windows")


def time_paged_shape(dev, b: int = 8, s: int = 1, ctx: int = 512, hd: int = 128,
                     nh: int = 12) -> dict:
    """B4 timed at ``b`` rows of ``s`` queries whose last query sits at
    position ``ctx - 1`` (decode: 8 slots, s = 1; the spec verify: 8 slots,
    s = 5; the prefill chunk: b = 1, s = 32), flagship heads (12 × 128, or
    ``nh`` × ``hd``), bf16, 16-key pages in a 64-entry table, the 16 layers'
    pools rotated so L2 does not hold them."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import paged_attention as pa

    layers, bs, mb = 16, 16, 64
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
    lib_rows = _library_rows(library, 160)
    library_device_ms = _profiled_ms_per_call(None, 160, rows=lib_rows)
    backend = _sdpa_backend(lib_rows)
    pairs = b * nh * sum(start + i + 1 for i in range(s))  # (query, key) pairs attended
    kv_bytes = 2 * b * ctx * nh * hd * 2                   # valid K and V, bf16, read once
    io_bytes = 2 * b * s * nh * hd * 2 + b * mb * 4 + b * 4  # q, out, tables, idx
    flops = 4 * pairs * hd                                 # QK^T and PV on the tensor cores
    bytes_ms = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    split_ms = device_ms["paged_attention_kernel"]
    log(f"  b={b} s={s} ctx={ctx} {nh} x {hd} bf16: kernel {kernel_ms:.4f} ms (events around the "
        f"wrapper; profiler a launch: split {split_ms:.4f} ms, "
        f"combine {device_ms['combine_splits_kernel']:.4f} ms), plain {plain_ms:.4f} ms, "
        f"sdpa (span pre-gathered, gather excluded) {library_device_ms:.4f} ms a call by the "
        f"profiler ({library_ms:.4f} ms by events; {backend}), "
        f"bound {max(bytes_ms, ops_ms):.4f} ms ({kv_bytes / 1e6:.2f} MB of K/V, the split kernel at "
        f"{(kv_bytes + io_bytes) / (split_ms * 1e-3) / HBM_BYTES_PER_S:.1%} of HBM's rate); "
        f"|kernel - plain| {err:.2e}, |kernel - sdpa| {lib_err:.2e}")
    return {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_device_ms,
        "library_backend": backend,
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


#: phase 7's sampled leg: every slot samples (a seed each)
SAMPLED_LEG = {"do_sample": True, "temperature": 0.8, "top_p": 0.9}


def _engine_leg(model, async_dispatch: bool, bursts: int = 4, sampled: bool = False,
                spec: bool = False) -> dict:
    """One leg of phase 7: the graph engine (8 slots, prompts of 100 ids,
    128 new tokens; greedy, or with ``sampled`` every slot sampling through
    the lane burst, or with ``spec`` the greedy spec round) past admission
    and prefill, then ``bursts`` timed ``step()`` calls (the host clock,
    synchronised before and after), their flight-recorder summary, and two
    more steps under ``torch.profiler`` (kernel rows only; synchronised
    before, so exactly the two rounds they dispatch run in the window). A
    plain leg's numbers are a decode step's (a burst is ``decode_burst``
    steps); a spec leg's are a round's. Returns the numbers and the
    engine."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.serving import RequestState

    engine = _flagship_engine(model, async_dispatch=async_dispatch, **(SPEC if spec else {}))
    per = 1 if spec else engine.config.decode_burst  # steps a dispatch
    rng = np.random.default_rng(3)
    for i in range(engine.config.num_slots):
        engine.add_request(rng.integers(1, 32000, size=100).tolist(), 128,
                           sampling={**SAMPLED_LEG, "seed": i} if sampled else None)
    while engine.scheduler.queue_depth or engine.scheduler.active(RequestState.PREFILL):
        engine.step()  # admission and chunked prefill; the graphs are captured here
    engine.step()
    steps = bursts * per
    torch.cuda.synchronize()
    engine.reset_stats()
    t0 = time.perf_counter()
    for _ in range(bursts):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    stats = engine.stats()
    spec_counts = {k: stats[k] for k in ("spec_drafted_tokens", "spec_accepted_tokens",
                                         "spec_accept_rate")} if spec else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            engine.step()
        torch.cuda.synchronize()
    kernels = _kernel_rows(prof)
    prof_steps = 2 * per
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / prof_steps
    if not device_ms > 0:
        raise AssertionError("the profiler saw no kernel in the serve window")
    paged_ms = sum(e.self_device_time_total for e in kernels
                   if "paged_attention" in e.key or "combine_splits" in e.key) / 1e3 / prof_steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    program = "spec_decode" if spec else "lane_decode" if sampled else "decode"
    if spec:
        check_spec_counts(engine.stats(), 16, "phase 7 spec engine")
    else:
        check_graph_counts(engine.stats(), 16, 8, f"phase 7 engine (async {async_dispatch}, "
                           f"sampled {sampled})",
                           {"decode": 0, "lane_decode": 1} if sampled else None)
    # the decode graph alone, replayed on an idle card (the last round's
    # operands again: the same writes): the host time of the replay call,
    # and the wall from the call until the card is idle, against the
    # burst's device time
    graph = engine._programs[program].graph
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
        "sampled": sampled,
        "program": program,
        "per": "spec round" if spec else "decode step",
        "decode_steps_timed": steps,
        **spec_counts,
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
        "decode_graph_device_ms": device_ms * per,
    }, engine


def serve_breakdown(model) -> dict:
    """Where a flagship decode step's time goes on the graph engine (bf16,
    8 slots): greedy async and sync legs alternating (async, sync, async,
    sync), then an async leg with all 8 slots sampled (temperature 0.8, top-p
    0.9: the lane burst) and an async greedy spec leg (``spec_k`` 4,
    ``early_exit:2``: its numbers are a round's), each its own engine; then
    one paged step over the last engine's pools, eager against replayed from
    a CUDA graph of its own."""
    legs, engine = [], None
    for async_dispatch, sampled, spec in ((True, False, False), (False, False, False),
                                          (True, False, False), (False, False, False),
                                          (True, True, False), (True, False, True)):
        engine = None  # the previous leg's pools go before the next leg's
        leg, engine = _engine_leg(model, async_dispatch, sampled=sampled, spec=spec)
        legs.append(leg)
        log(f"  {'async' if async_dispatch else 'sync '} {leg['program']} graph engine"
            f"{' (8 sampled slots)' if sampled else ''}"
            + (f" (spec_k {SPEC['spec_k']}, {SPEC['draft']}: accept rate "
               f"{leg['spec_accept_rate']:.3f}, {leg['spec_accepted_tokens']} of "
               f"{leg['spec_drafted_tokens']} drafts)" if spec else "")
            + f": {leg['per']} wall "
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


# -- phase 7b, 7c, 7d: generate() -------------------------------------------

#: bench.py's decode shape (``_mode_decode``): batch, prompt, the short and
#: the long generation whose difference gives decode tokens/s
DECODE_BATCH, DECODE_PROMPT, DECODE_SHORT, DECODE_LONG = 8, 128, 8, 136
#: phase 7c: 8 prompts right-padded to 128 ids, real lengths 17-128
GEN_LENGTHS = (17, 33, 50, 64, 81, 100, 115, 128)
GEN_NEW = 32


def _generation_counts() -> tuple:
    from accelerate_tpu_torch import generation

    return generation.captures, generation.replays


def _ragged_prompts(vocab: int, seed: int, lengths=GEN_LENGTHS, width: int = 128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(len(lengths), width)).astype(np.int32)
    mask = (np.arange(width)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


def _decode_program(model, total: int):
    """The decode program ``generate()`` keeps on ``model`` for a cache of
    ``total`` positions."""
    for key, prog in model.__dict__["_generation_programs"].items():
        if key[0] == "decode" and key[2] == total:
            return prog
    raise AssertionError(f"no decode program of cache length {total} on the model")


def time_generate(model) -> dict:
    """``generate()`` on the flagship at bf16 for time, at bench.py's decode
    shape (8 × 128 random ids, ``use_cache=True``): each length called
    twice (the first captures the decode step, the second must not), then
    timed; decode tok/s by differencing 8 and 136 new tokens; B1's launches
    a call; a decode step's wall (replays back to back) and device time
    (the profiler over replays of the captured step). Then sampling twice
    with one seed (the tokens must be identical), and a greedy speculative
    call (``num_draft_tokens`` 4, a 4-layer draft of the flagship's widths
    on its own weights) whose tokens must equal plain greedy decoding: its
    time a round."""
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import flash_attention as fa

    cfg = model.config
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, size=(DECODE_BATCH, DECODE_PROMPT)).astype(np.int32)
    out = {"shape": {"batch": DECODE_BATCH, "prompt": DECODE_PROMPT, "short": DECODE_SHORT,
                     "long": DECODE_LONG, "dtype": "bf16"}}
    walls, tokens = {}, {}
    for n_new in (DECODE_SHORT, DECODE_LONG):
        calls = []
        for call in range(2):
            before = _generation_counts()
            _zero_flash_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = generate(model, ids, max_new_tokens=n_new, use_cache=True)
            wall = time.perf_counter() - t0
            after = _generation_counts()
            calls.append({"wall_s": wall, "captures": after[0] - before[0],
                          "replays": after[1] - before[1],
                          "flash_fwd_launches": fa.fwd_launches})
            if got.shape != (DECODE_BATCH, DECODE_PROMPT + n_new):
                raise AssertionError(f"generate() returned {tuple(got.shape)}")
            tokens.setdefault(n_new, got)
            if not torch.equal(got, tokens[n_new]):
                raise AssertionError("two greedy generate() calls gave different tokens")
        if [c["captures"] for c in calls] != [1, 0]:
            raise AssertionError(f"captures {[c['captures'] for c in calls]}: the first call "
                                 "must capture the decode step once and the second not at all")
        if any(c["flash_fwd_launches"] != cfg.num_hidden_layers for c in calls):
            raise AssertionError(f"B1 launches a generate() call {calls}: one a layer (the "
                                 "prefill) expected")
        if any(c["replays"] != n_new - 1 for c in calls):
            raise AssertionError(f"replays {calls}: one a decoded token after the first")
        timed = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(model, ids, max_new_tokens=n_new, use_cache=True)
            timed.append(time.perf_counter() - t0)
        walls[n_new] = sorted(timed)[1]
        out[f"new_{n_new}"] = {"calls": calls, "timed_wall_s": timed}
    step_s = (walls[DECODE_LONG] - walls[DECODE_SHORT]) / (DECODE_LONG - DECODE_SHORT)
    out["decode_tok_s"] = DECODE_BATCH / step_s
    out["wall_short_s"], out["wall_long_s"] = walls[DECODE_SHORT], walls[DECODE_LONG]
    out["step_wall_ms"] = step_s * 1e3

    # the captured step alone: replays back to back (wall), and the
    # profiler's kernel time a replay (device); the program's step counter
    # and positions are set back so these replays stay inside the cache
    prog = _decode_program(model, DECODE_PROMPT + DECODE_LONG)
    graph = prog.program.graph
    reps = 20

    def replay(i):
        graph.replay()

    def rewind():
        prog.step.zero_()
        prog.pos.fill_(DECODE_PROMPT)

    rewind()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        replay(i)
    torch.cuda.synchronize()
    out["replay_wall_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    rewind()
    rows = _library_rows(replay, reps)
    rewind()
    out["step_device_ms"] = sum(e.self_device_time_total for e in rows) / 1e3 / reps
    out["kernels_per_step"] = sum(e.count for e in rows) / reps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    out["top_kernels_ms_per_step"] = {e.key[:80]: e.self_device_time_total / 1e3 / reps
                                      for e in top}
    out["top_kernels_launches_per_step"] = {e.key[:80]: e.count / reps for e in top}
    log(f"  generate() bf16, {DECODE_BATCH} × {DECODE_PROMPT} ids: {DECODE_SHORT} new tokens "
        f"{walls[DECODE_SHORT]:.4f} s, {DECODE_LONG} new tokens {walls[DECODE_LONG]:.4f} s → "
        f"decode {out['decode_tok_s']:.1f} tok/s, {out['step_wall_ms']:.3f} ms a step by "
        f"difference; captures {[c['captures'] for c in out[f'new_{DECODE_LONG}']['calls']]}, "
        f"replays {[c['replays'] for c in out[f'new_{DECODE_LONG}']['calls']]}, B1 launches a "
        f"call {out[f'new_{DECODE_LONG}']['calls'][0]['flash_fwd_launches']}; the captured step: "
        f"{out['replay_wall_ms']:.3f} ms wall a replay back to back, {out['step_device_ms']:.3f} "
        f"ms device, {out['kernels_per_step']:.0f} kernels; top kernels ms a step "
        f"{json.dumps({k: round(v, 4) for k, v in out['top_kernels_ms_per_step'].items()})}")

    # sampling: one seed, two calls, the same tokens
    kw = dict(max_new_tokens=GEN_NEW, use_cache=True, do_sample=True, temperature=0.8, seed=5)
    a = generate(model, ids, **kw)
    b = generate(model, ids, **kw)
    if not torch.equal(a, b):
        raise AssertionError("sampling with one seed gave different tokens on two calls")
    if torch.equal(a, tokens[DECODE_LONG][:, :DECODE_PROMPT + GEN_NEW]):
        raise AssertionError("sampled tokens equal the greedy ones: the draw had no effect")
    out["sampled_equal_on_two_calls"] = True

    # speculative decoding at bf16: its tokens and its time a round
    draft = LlamaForCausalLM.from_config(LlamaConfig(**{**cfg.__dict__, "num_hidden_layers": 4}),
                                         seed=1, dtype=torch.bfloat16, device=model.device)
    spec_kw = dict(max_new_tokens=DECODE_LONG, draft_model=draft, num_draft_tokens=4)
    generate(model, ids, **spec_kw)  # captures the round
    before = _generation_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec = generate(model, ids, **spec_kw)
    spec_wall = time.perf_counter() - t0
    rounds = _generation_counts()[1] - before[1]
    divergences = _spec_divergences(model, spec, tokens[DECODE_LONG])
    out["spec"] = {"wall_s": spec_wall, "rounds": rounds, "round_ms": spec_wall * 1e3 / rounds,
                   "rows_parting_from_plain_greedy": len(divergences), "num_draft_tokens": 4,
                   "draft_layers": 4, "divergences": divergences}
    log(f"  speculative generate() bf16 (k 4, 4-layer draft): {spec_wall:.4f} s for "
        f"{DECODE_LONG} new tokens, {rounds} rounds, {out['spec']['round_ms']:.3f} ms a round "
        f"(prefills included); rows parting from plain greedy at bf16: {len(divergences)}, "
        "each within bf16 noise (5b's margin rule)")
    del draft
    torch.cuda.empty_cache()
    return out


def _spec_divergences(model, spec, plain) -> list:
    """5b's margin rule for each row where bf16 speculative output parts
    from plain greedy: the logits at the first parting position by an eager
    forward of the shared prefix (no cache), their top-2 margin, and the gap
    between the two picks there, which must lie within ``BF16_NOISE`` × the
    largest |logit|. A fault that shows only at bf16 in the verify chunk or
    the cache's cast would part by more."""
    out = []
    for r in torch.nonzero((spec != plain).any(dim=1)).flatten().tolist():
        t = int(torch.nonzero(spec[r] != plain[r])[0])
        got, ref = int(spec[r, t]), int(plain[r, t])
        with torch.no_grad():
            logits = model(input_ids=plain[r:r + 1, :t].long().to(model.device)).logits
        logits = logits[0, -1].float()
        top = torch.topk(logits, 2).values
        d = {"row": r, "position": t, "spec": got, "plain": ref,
             "top2_margin": float(top[0] - top[1]),
             "gap": abs(float(logits[ref] - logits[got])),
             "noise": BF16_NOISE * float(logits.abs().max())}
        out.append(d)
        log(f"  row {r} parts from plain greedy at position {t}: speculative {got} vs plain "
            f"{ref}; eager top-2 margin {d['top2_margin']:.4e}, gap {d['gap']:.4e}, bf16 noise "
            f"{d['noise']:.4e}")
        if d["gap"] > d["noise"]:
            raise AssertionError(f"speculative row {r}: a divergence above bf16 noise")
    return out


def check_generate_f32(dev) -> dict:
    """``generate()`` on the flagship at f32 for equality (random weights
    from seed 0): greedy tokens identical through the cached path with the
    kernels, the same path with ``flash_impl="plain"`` and the full-forward
    loop, on 8 prompts right-padded to 128 ids (real lengths 17-128) with
    32 new tokens; one row with an eos that stops it mid-chunk; the
    prefill's logits with B1 against plain; greedy speculative decoding
    (``num_draft_tokens`` 4, a 4-layer draft on its own weights) equal to
    plain greedy. The flash counters are set to 0 just before the cached
    call and read just after: the prefill launched B1 once a layer."""
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.attention import attention_context

    cfg = LlamaConfig.flagship_700m()
    model = LlamaForCausalLM.from_config(cfg, seed=0, dtype=torch.float32, device=dev)
    ids, mask = _ragged_prompts(cfg.vocab_size, seed=3)
    kw = dict(max_new_tokens=GEN_NEW, attention_mask=mask)
    _zero_flash_counts()
    cached = generate(model, ids, use_cache=True, **kw)
    launches = fa.fwd_launches
    if launches != cfg.num_hidden_layers:
        raise AssertionError(f"B1 launched {launches} times in a cached generate(): one a layer")
    with attention_context(flash_impl="plain"):
        plain = generate(model, ids, use_cache=True, **kw)
    if fa.fwd_launches != launches:
        raise AssertionError("flash_impl='plain' launched the kernel")
    _zero_flash_counts()
    full = generate(model, ids, **kw)
    full_launches = fa.fwd_launches
    if full_launches != cfg.num_hidden_layers * GEN_NEW:
        raise AssertionError(f"the full-forward loop launched B1 {full_launches} times")
    lengths = mask.sum(axis=1)
    for what, other in (("flash_impl='plain'", plain), ("the full-forward loop", full)):
        if not torch.equal(cached, other):
            rows = [int(r) for r in torch.nonzero((cached != other).any(dim=1)).flatten()]
            raise AssertionError(f"greedy tokens of the cached path differ from {what} in "
                                 f"rows {rows}")
    for r, length in enumerate(lengths):
        if cached[r, length:length + GEN_NEW].numel() != GEN_NEW:
            raise AssertionError(f"row {r}: {GEN_NEW} new tokens expected")

    # eos mid-chunk: row 0's 10th greedy token ends it
    row0 = ids[:1, :lengths[0]]
    eos = int(cached[0, lengths[0] + 9])
    eos_out = {}
    for name, use_cache, ctx in (("cached", True, None), ("plain", True, "plain"),
                                 ("full_forward", False, None)):
        with attention_context(flash_impl=ctx):
            eos_out[name] = generate(model, row0, max_new_tokens=GEN_NEW, eos_token_id=eos,
                                     use_cache=use_cache)
    first = int(np.argmax(cached[0, lengths[0]:].cpu().numpy() == eos))
    want = lengths[0] + first + 1
    for name, got in eos_out.items():
        if got.shape != (1, want) or not torch.equal(got, eos_out["cached"]):
            raise AssertionError(f"eos case ({name}): shape {tuple(got.shape)}, {want} expected")

    # the prefill's logits, B1 against plain
    ids_t, mask_t = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
    with torch.no_grad():
        ref = model(input_ids=ids_t, attention_mask=mask_t, use_cache=True,
                    max_cache_len=128 + GEN_NEW)
        with attention_context(flash_impl="plain"):
            pl = model(input_ids=ids_t, attention_mask=mask_t, use_cache=True,
                       max_cache_len=128 + GEN_NEW)
    valid = mask_t.bool()
    logits_err = (ref.logits - pl.logits).abs()[valid].max().item()
    cache_err = max((ref.kv_cache[n] - pl.kv_cache[n]).abs().max().item() for n in "kv")
    scale = max(pl.logits[valid].abs().max().item(), 1.0)
    log(f"  f32 prefill (b 8, s 128, right-padded): max |Δ logits| B1 vs plain {logits_err:.3e} "
        f"(max |logit| {scale:.3f}), |Δ kv_cache| {cache_err:.3e}")
    if not logits_err <= 2e-5 * scale:
        raise AssertionError(f"prefill logits: B1 and plain disagree beyond 2e-5 × {scale:.3f}")
    del ref, pl

    # speculative decoding at f32 equals plain greedy
    draft = LlamaForCausalLM.from_config(LlamaConfig(**{**cfg.__dict__, "num_hidden_layers": 4}),
                                         seed=1, dtype=torch.float32, device=dev)
    spec = generate(model, ids, draft_model=draft, num_draft_tokens=4, **kw)
    if not torch.equal(spec, cached):
        rows = [int(r) for r in torch.nonzero((spec != cached).any(dim=1)).flatten()]
        raise AssertionError(f"speculative tokens differ from plain greedy in rows {rows}")
    log(f"  f32 greedy generate() on {len(GEN_LENGTHS)} right-padded prompts (lengths "
        f"{GEN_LENGTHS[0]}-{GEN_LENGTHS[-1]}), {GEN_NEW} new tokens: cached with the kernels = "
        f"flash_impl='plain' = the full-forward loop = speculative (k 4, 4-layer draft); eos "
        f"{eos} stops row 0 after {first + 1} tokens in every path; B1 launches: {launches} a "
        f"cached call, {full_launches} in the full-forward loop")
    del model, draft
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd_launches_cached_call": launches,
            "flash_fwd_launches_full_forward": full_launches,
            "prefill_logits_max_abs_diff": logits_err, "prefill_kv_cache_max_abs_diff": cache_err,
            "eos_stop_after": first + 1, "tokens_identical": True}


def _generate_flash_cases():
    """(b, s, nh, n_kv, hd, row lengths, dtype): B1 as ``generate()`` calls
    it, causal with a right-padded key mask: the prefill (s 128, rows 17 to
    128 long), the full-forward loop's buffer (s = 128 + 32 with a padded
    tail), a prompt length that is no tile multiple, and GQA."""
    f32, bf16 = torch.float32, torch.bfloat16
    return [(8, s, 12, 12, 128, lengths, dtype)
            for s, lengths in ((128, GEN_LENGTHS), (160, tuple(n + 7 for n in GEN_LENGTHS)),
                               (137, (1, 9, 64, 100, 128, 129, 136, 137)))
            for dtype in (f32, bf16)] + [
        (2, 200, 32, 8, 128, (77, 200), bf16), (2, 200, 32, 8, 64, (130, 5), f32)]


def check_flash_generate_shapes(dev) -> dict:
    """B1 against its plain forward at ``generate()``'s shapes (phase 8's
    gates: output 2e-5 f32 / 3e-2 bf16, lse 1e-5), forward only, each case
    launched twice and required bit-identical."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(13)
    errs = {"f32": 0.0, "bf16": 0.0}
    for b, s, nh, n_kv, hd, lengths, dtype in _generate_flash_cases():
        q, k, v, _, _ = _flash_inputs(rng, b, s, nh, n_kv, hd, 0, dtype, dev)
        mask = torch.as_tensor(np.arange(s)[None, :] < np.asarray(lengths)[:, None], device=dev)
        o, lse = fa.flash_fwd(q, k, v, mask, causal=True, impl="cuda")
        o2, lse2 = fa.flash_fwd(q, k, v, mask, causal=True, impl="cuda")
        ro, rlse = fa.flash_fwd(q, k, v, mask, causal=True, impl="plain")
        f32 = dtype == torch.float32
        what = (f"b={b} s={s} nh={nh} n_kv={n_kv} hd={hd} lengths={lengths} "
                f"{'f32' if f32 else 'bf16'}")
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"B1: two launches differ ({what})")
        if not torch.isfinite(o.float()).all():
            raise AssertionError(f"B1 output not finite ({what})")
        o_err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        ok = o_err <= (2e-5 if f32 else 3e-2) and lse_err <= 1e-5
        log(f"  B1 {what}: |o| {o_err:.2e} |lse| {lse_err:.2e}" + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"B1 disagrees with its plain version ({what})")
        key = "f32" if f32 else "bf16"
        errs[key] = max(errs[key], o_err)
    return errs


def time_flash_prefill(dev) -> dict:
    """B1 at ``generate()``'s prefill shape (b 8, s 128, 12 × 128, bf16,
    causal, a right-padded key mask of lengths 17-128):
    :func:`time_flash_masked`."""
    return time_flash_masked(dev, DECODE_BATCH, DECODE_PROMPT, 12, 128, GEN_LENGTHS,
                             torch.bfloat16, "the prefill shape")


def time_flash_masked(dev, b, s, nh, hd, row_lengths, dtype, what) -> dict:
    """B1 at ``(b, s, nh × hd)``, causal, with a right-padded key mask of
    ``row_lengths``: events around the wrapper, the profiler's device time
    a launch, the plain version, and sdpa with the same boolean mask (its
    kernels' device time a call); the bound counts the (query, key) pairs
    this mask leaves, and of K and V only the rows it leaves (a row's
    first ``length`` keys), against the 16-bit tensor-core peak (bf16 and
    f16 alike)."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(14)
    q, k, v, _, _ = _flash_inputs(rng, b, s, nh, nh, hd, 0, dtype, dev)
    lengths = np.asarray(row_lengths)
    mask = torch.as_tensor(np.arange(s)[None, :] < lengths[:, None], device=dev)
    scale = 1.0 / float(np.sqrt(hd))
    fn = lambda i: fa._flash_fwd_cuda(q, k, v, mask, scale, True)  # noqa: E731
    spread = _time_spread(fn, 20, 5)
    pattern = re.compile(flash_kernel_pattern("flash_fwd"))
    for _ in range(PROFILER_TRIES):
        rows_ = [e for e in _profiled_rows(fn, 20) if pattern.search(e.key)]
        launches = sum(e.count for e in rows_)
        if launches:
            break
    else:
        raise AssertionError(f"the profiler saw no B1 launch at {what}")
    plain_ms = _time_ms(lambda i: fa._flash_fwd_plain(q, k, v, mask, scale, True), 3, 3)
    lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    allowed = torch.tril(torch.ones(s, s, dtype=torch.bool, device=dev))[None, None] \
        & mask[:, None, None, :]
    lib = lambda i: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=allowed)  # noqa: E731
    lib_rows = _library_rows(lib, 20)
    o, _ = fa.flash_fwd(q, k, v, mask, causal=True, impl="cuda")
    lib_err = (lib(0).transpose(1, 2).float() - o.float()).abs().max().item()
    # the pairs this mask leaves: query i of a row of length L reads keys
    # 0..min(i, L-1)
    pairs = float(sum(np.minimum(np.arange(s) + 1, n).sum() for n in lengths)) * nh
    flops = 2 * 2 * pairs * hd
    # q and o in full, k and v up to each row's length (no query reads a key
    # past it), lse, the mask
    nbytes = (2 * b * s + 2 * int(lengths.sum())) * nh * hd * 2 + b * nh * s * 4 + b * s
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {
        "shape": {"batch": b, "seq": s, "n_heads": nh, "head_dim": hd,
                  "dtype": FLASH_DTYPE_NAMES[dtype], "causal": True,
                  "key_mask_lengths": [int(n) for n in lengths]},
        "ms": spread[1], "ms_spread": spread,
        "profiler_ms": sum(e.self_device_time_total for e in rows_) / 1e3 / launches,
        "plain_ms": plain_ms,
        "library_ms": _profiled_ms_per_call(None, 20, rows=lib_rows),
        "library_backend": _sdpa_backend(lib_rows),
        "library_max_abs_diff": lib_err,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    log(f"  B1 at {what} (b {b}, s {s}, {nh} × {hd}, {FLASH_DTYPE_NAMES[dtype]}, causal, key "
        f"mask of lengths {lengths.min()}-{lengths.max()}): {out['ms']:.4f} ms by events, "
        f"{out['profiler_ms']:.4f} ms a launch by the profiler, bound {out['bound_ms']:.6f} ms "
        f"({out['bound_by']}), plain {plain_ms:.3f} ms, sdpa with the mask "
        f"{out['library_ms']:.4f} ms ({out['library_backend']}; |Δ| {lib_err:.2e})")
    return out


# -- phase 5i: the fleet with an armed objective -------------------------------

#: phase 5i: one supervised replica of the tiny llama on the card under an
#: error-rate objective that its requests with a 1 ms deadline break
SLO_FLEET_ENV = {"ACCELERATE_SLO_MAX_ERROR_RATE": "0.01"}


def run_fleet_slo(device: str = "cuda") -> dict:
    """``route --replicas 1 --respawn --max-replicas 2 --logging-dir`` with
    an armed ``ACCELERATE_SLO_*`` objective: route prints that the policy
    is armed; six requests go through the replica, three with a deadline of
    1 ms (answered with an error row each, which breaks the error-rate
    objective); the supervisor writes a ``scale_decision`` row whose
    evidence names a dominant phase; SIGTERM drains (exit 0); then ``slo
    report`` and ``monitor --once`` read the fleet's directory and exit 0."""
    import signal
    import threading

    logging_dir = os.path.join(REPO, "build", "fleet_slo")
    shutil.rmtree(logging_dir, ignore_errors=True)
    os.makedirs(logging_dir)
    stderr_path = os.path.join(logging_dir, "route.stderr")
    env = {**os.environ, **SLO_FLEET_ENV}
    args = ["route", "--replicas", "1", "--respawn", "--max-replicas", "2", "--preset", "tiny",
            "--max-seq-len", "256", "--device", device, "--health-interval", "0.2",
            "--logging-dir", logging_dir]
    t0 = time.perf_counter()
    with open(stderr_path, "w") as stderr_file:
        proc = subprocess.Popen([sys.executable, "-m", "accelerate_tpu_torch", *args], cwd=REPO,
                                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                stderr=stderr_file, text=True)

    answers: list = []
    threading.Thread(target=lambda: answers.extend(json.loads(line) for line in proc.stdout
                                                   if line.strip()), daemon=True).start()

    def stderr_text():
        with open(stderr_path) as f:
            return f.read()

    try:
        _wait_for(lambda: "route: fleet ready" in stderr_text() or proc.poll() is not None,
                  "the fleet to report ready")
        if proc.poll() is not None:
            raise AssertionError(f"route exited {proc.returncode}:\n{stderr_text()[-3000:]}")
        ready_s = time.perf_counter() - t0
        if "route: SLO scaling policy armed (max_error_rate)" not in stderr_text():
            raise AssertionError("route did not arm the SLO policy:\n" + stderr_text()[-3000:])
        rng = np.random.default_rng(4)  # the tiny llama's vocabulary is 256 ids
        reqs = [{"id": i, "prompt": rng.integers(1, 256, size=8 + 9 * i).tolist(),
                 "max_new_tokens": 16} for i in range(6)]
        for r in reqs[::2]:
            r["deadline_ms"] = 1
        for r in reqs:
            proc.stdin.write(json.dumps(r) + "\n")
        proc.stdin.flush()

        def decided():
            rows = [r for r in _fleet_trail(logging_dir) if r.get("kind") == "scale_decision"]
            return [r for r in rows if r.get("dominant_phase")]

        _wait_for(lambda: len(answers) >= len(reqs), "the answers")
        decisions = _wait_for(decided, "a scale_decision row with a dominant phase", timeout=120)
        decided_s = time.perf_counter() - t0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:  # a failed gate: drain, then make sure
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
            for row in _fleet_trail(logging_dir):
                if row.get("pid") and row.get("replica_id") is not None:
                    try:
                        os.kill(row["pid"], signal.SIGKILL)
                    except OSError:
                        pass
    if rc != 0:
        raise AssertionError(f"route exited {rc} after SIGTERM:\n{stderr_text()[-3000:]}")
    if sorted(a.get("id") for a in answers) != sorted(r["id"] for r in reqs):
        raise AssertionError(f"the fleet did not answer every request once: {answers}")
    expired = sorted(a["id"] for a in answers if "error" in a)
    if any("error" in a for a in answers if a["id"] % 2):
        raise AssertionError(f"a request without a deadline failed: {answers}")
    readers = {}
    for argv in (["slo", "report", logging_dir], ["monitor", logging_dir, "--once"]):
        quiet = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_SLO_")}
        done = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", *argv], cwd=REPO,
                              env=quiet, capture_output=True, text=True, timeout=120)
        if done.returncode != 0:
            raise AssertionError(f"{' '.join(argv[:2])} exited {done.returncode}:\n"
                                 f"{done.stdout[-2000:]}{done.stderr[-2000:]}")
        readers[argv[0]] = done.stdout
    if "fleet" not in readers["monitor"]:
        raise AssertionError("monitor --once shows no fleet panel:\n" + readers["monitor"])
    first = decisions[0]
    log(f"  route with {SLO_FLEET_ENV}: ready {ready_s:.1f} s, policy armed; "
        f"{len(decisions)} scale_decision row(s) with a dominant phase, the first "
        f"{decided_s:.1f} s after spawn: action {first.get('action')}, reason "
        f"{first.get('reason')}, objective {first.get('objective')}, burn "
        f"{first.get('burn_rate')}, phase {first.get('dominant_phase')}; drained, exit 0; "
        f"slo report and monitor --once exit 0")
    return {"ready_s": ready_s, "decided_s": decided_s, "decisions": decisions[:4],
            "answered": len(answers), "expired": expired}


# -- phase 8 ----------------------------------------------------------------


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
        (4, 256, 12, 12, 128, True, 0, bf16),      # phase 13's eval batches (the last: b 1)
        (1, 256, 12, 12, 128, True, 0, bf16),
    ] + [  # the narrow heads, staged as zero-padded 64-column tiles (launched twice)
        (4, s, nh, n_kv, hd, causal, pad, dtype)
        for hd, nh, n_kv in ((16, 4, 4), (32, 8, 2))
        for dtype in (f32, bf16)
        for s, causal, pad in ((129, True, 0), (129, False, 0), (1000, True, 77),
                               (1000, False, 0))
    ] + [  # head dims off the built widths: 24 and 48 staged in one 64-column
        # tile, 80 in two (launched twice)
        (2, s, nh, n_kv, hd, causal, pad, dtype)
        for hd, nh, n_kv in ((24, 4, 2), (48, 4, 4), (80, 8, 2))
        for dtype in (f32, bf16)
        for s, causal, pad in ((129, True, 0), (1000, True, 77), (200, False, 0))
    ] + c4b_flash_cases()


def c4b_flash_cases():
    """C4b: head dims 20 and 36 (handed to the kernels zero-padded to 24
    and 40) and 256 (in bf16 B1-B3's 256-wide wgmma instances; in f32 the
    wide FMA instances), f32 and bf16 (launched twice)."""
    return [
        (2, s, nh, n_kv, hd, causal, pad, dtype)
        for hd, nh, n_kv in ((20, 4, 2), (36, 4, 4), (256, 4, 2))
        for dtype in (torch.float32, torch.bfloat16)
        for s, causal, pad in ((129, True, 0), (1000, True, 77), (200, False, 0))
    ]


def wide_tc_flash_cases():
    """B1-B3's 256-wide tensor-core instances (bf16 and f16 at head dims
    136-256): hd 136 and 200 (120 and 56 of the 256 staged columns past hd;
    200 not a multiple of 16) and 256, GQA 8/2, at s = 129 (one row past a
    128-row query tile; B3's last 64-key block holds one key), at 1000
    left-padded by 77 (fully masked query rows; a multiple of neither the
    32- nor the 64-key tile), at 200 causal with a left pad of 130 (query
    tile 0 fully masked) and at 200 not causal with the same pad (masked
    keys inside key tiles off the diagonal); then GPT-J-6B's training shape
    (b 4, s 1024, 16 × 256, no GQA) in both dtypes. Launched twice each,
    with equal bits: B3's hand-off of P^T between its warpgroups is
    deterministic."""
    return [
        (2, s, 8, 2, hd, causal, pad, dtype)
        for hd in (136, 200, 256)
        for dtype in (torch.bfloat16, torch.float16)
        for s, causal, pad in ((129, True, 0), (1000, True, 77), (200, True, 130),
                               (200, False, 130))
    ] + [(P15_BATCH, P15_SEQ, 16, 16, 256, True, 0, dtype)
         for dtype in (torch.bfloat16, torch.float16)]


#: phase 15c: the (head dim, dtype) pairs whose B1-B3 instances are read
#: from the profiler: the flagship's width, the 256-wide tensor-core
#: instances (hd 136, 200 and 256 in bf16 and f16), the wide FMA ones (f32
#: at 256) and the column blocks (512)
FLASH_INSTANCE_CASES = ((128, "bf16"), (136, "bf16"), (200, "f16"), (256, "bf16"), (256, "f16"),
                        (256, "f32"), (512, "bf16"))


def check_flash_instances(dev) -> dict:
    """``{"head_dim_<hd>_<dtype>": {"flash_fwd": "kernel<args>", ...}}``: the
    B1-B3 instances that one forward and backward through
    ``flash_attention`` (b 1, s 256, 4 query and 2 kv heads, causal)
    launched at each of :data:`FLASH_INSTANCE_CASES`, read from the
    profiler's kernel names. Fails unless they are exactly
    :func:`flash_instances`: bf16 and f16 B1-B3 on their wgmma instances
    up to hd 256, f32 and hd 512 on the FMA ones."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    dtypes = {name: dt for dt, name in FLASH_DTYPE_NAMES.items()}
    rng = np.random.default_rng(151)
    out = {}
    for hd, name in FLASH_INSTANCE_CASES:
        q, k, v, do, _ = _flash_inputs(rng, 1, 256, 4, 2, hd, 0, dtypes[name], dev)
        q, k, v = (t.requires_grad_() for t in (q, k, v))

        def fwd_bwd(i):
            fa.flash_attention(q, k, v, causal=True, impl="cuda").backward(do)

        want = flash_instances(hd, name)
        # a window can miss a row (the first launch in it, seen on the card):
        # one that lacks an expected instance is taken again, while a wrong
        # instance shows in every window and fails
        for _ in range(PROFILER_TRIES):
            seen = {key for key in (kernel_key(e.key) for e in _profiled_rows(fwd_bwd, 3))
                    if key and key.startswith("flash_")}
            if seen == set(want.values()):
                break
        log(f"  hd {hd} {name}: {sorted(seen)}")
        if seen != set(want.values()):
            raise AssertionError(f"B1-B3 at hd {hd} {name} launched {sorted(seen)}, "
                                 f"{sorted(want.values())} expected")
        out[f"head_dim_{hd}_{name}"] = want
        del q, k, v, do
    torch.cuda.empty_cache()
    return out


def c4c_flash_cases():
    """C4c: head dims 264 and 300 (a ragged last column block of 256; 300
    handed to the kernels zero-padded to 304) and 512 (two whole column
    blocks), f32 and bf16, at s = 129, at 1000 left-padded and at 200 not
    causal (launched twice)."""
    return [
        (2, s, nh, n_kv, hd, causal, pad, dtype)
        for hd, nh, n_kv in ((264, 4, 2), (300, 4, 4), (512, 4, 2))
        for dtype in (torch.float32, torch.bfloat16)
        for s, causal, pad in ((129, True, 0), (1000, True, 77), (200, False, 0))
    ]


#: the dtypes the flash kernels take, by name, and their gates against the
#: plain versions (output; grads × max(|ref|, 1)): the JAX tests' f32 and
#: bf16 gates, and for f16 the bf16 ones scaled by its 8× finer mantissa
FLASH_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
FLASH_GATES = {"f32": (2e-5, 2e-4), "bf16": (3e-2, 5e-2), "f16": (4e-3, 8e-3)}


def _flash_inputs(rng, b, s, nh, n_kv, hd, pad, dtype, dev):
    """Random q, k, v, dO and the key mask ``pad`` asks for: 0 none, an int
    the first ``pad`` keys of every row (a left pad shared by the batch),
    ``(step, start)`` the keys from ``start`` on in every ``step``-th row
    (a right pad that differs from row to row, as a padded encoder batch
    has it)."""
    def draw(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev).to(dtype)

    q, do = draw(b, s, nh, hd), draw(b, s, nh, hd)
    k, v = draw(b, s, n_kv, hd), draw(b, s, n_kv, hd)
    mask = None
    if pad:
        mask = torch.ones((b, s), dtype=torch.bool, device=dev)
        if isinstance(pad, tuple):
            step, start = pad
            mask[::step, start:] = False
        else:
            mask[:, :pad] = False
    return q, k, v, do, mask


def _scaled_err(got, ref) -> float:
    """max |got - ref| / max(|ref|, 1), in f32."""
    return ((got.float() - ref.float()).abs().max() / max(ref.float().abs().max().item(), 1.0)).item()


def check_flash_vs_plain(dev, cases=None) -> dict:
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.layers import causal_attention, dot_product_attention

    rng = np.random.default_rng(8)
    errs = {name: {} for name in FLASH_KERNELS}
    autograd_err = 0.0
    for b, s, nh, n_kv, hd, causal, pad, dtype in cases or _flash_cases():
        q, k, v, do, mask = _flash_inputs(rng, b, s, nh, n_kv, hd, pad, dtype, dev)
        f32 = dtype == torch.float32
        o, lse = fa.flash_fwd(q, k, v, mask, causal=causal, impl="cuda")
        dq, dk, dv = fa.flash_bwd(q, k, v, mask, o, lse, do, causal=causal, impl="cuda")
        if hd not in (64, 128):  # staged widths: a second launch gives the same bits
            again = (*fa.flash_fwd(q, k, v, mask, causal=causal, impl="cuda"),
                     *fa.flash_bwd(q, k, v, mask, o, lse, do, causal=causal, impl="cuda"))
            if not all(torch.equal(x, y) for x, y in zip(again, (o, lse, dq, dk, dv))):
                raise AssertionError(f"flash kernels at hd {hd}: two launches differ "
                                     f"(b={b} s={s} causal={causal} pad={pad} {dtype})")
        ro, rlse = fa.flash_fwd(q, k, v, mask, causal=causal, impl="plain")
        # the plain backward from the plain forward's (o, lse)
        rdq, rdk, rdv = fa.flash_bwd(q, k, v, mask, ro, rlse, do, causal=causal, impl="plain")
        torch.cuda.synchronize()
        key = FLASH_DTYPE_NAMES[dtype]
        what = f"b={b} s={s} nh={nh} n_kv={n_kv} hd={hd} causal={causal} pad={pad} {key}"
        outs = (o, lse, dq, dk, dv)
        if not all(torch.isfinite(t.float()).all() for t in outs):
            raise AssertionError(f"flash kernel output not finite ({what})")
        if (lse == fa.NEG_INF).ne(rlse == fa.NEG_INF).any():
            raise AssertionError(f"flash kernel: fully masked rows differ ({what})")
        o_err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        g_errs = [_scaled_err(g, r) for g, r in ((dq, rdq), (dk, rdk), (dv, rdv))]
        o_gate, g_gate = FLASH_GATES[key]
        ok = o_err <= o_gate and lse_err <= 1e-5 and max(g_errs) <= g_gate
        if isinstance(pad, int) and pad and causal:  # rows with no valid key: output 0, dq 0
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
        g_abs = [(g.float() - r.float()).abs().max().item()
                 for g, r in ((dq, rdq), (dk, rdk), (dv, rdv))]
        for name, err in zip(FLASH_KERNELS, (o_err, g_abs[0], max(g_abs[1:]))):
            errs[name][key] = max(errs[name].get(key, 0.0), err)
        del q, k, v, do, mask, o, lse, dq, dk, dv, ro, rlse, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return {"by_dtype": errs, "autograd_grad_err_f32": autograd_err}


def run_tiny_train(hidden_size: int | None = None, heads: int = 4) -> dict:
    """``LlamaConfig.tiny()`` (head dim 16; with ``hidden_size`` its
    ``heads`` heads are ``hidden_size / heads`` wide: 1024 over 4 gives the
    256-wide heads of C4b, over 2 the 512-wide heads of C4c) trained
    through the 5-line loop with
    ``Accelerator(mixed_precision="bf16")``: 20 steps on a fixed batch of 8
    × 128 ids, finite and falling loss, the flash counters set to 0 just
    before and read just after (each kernel 2 launches a step, one a
    layer)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    cfg = (LlamaConfig.tiny() if hidden_size is None
           else LlamaConfig.tiny(hidden_size=hidden_size, heads=heads))
    accelerator = Accelerator(mixed_precision="bf16")
    module = LlamaForCausalLM.from_config(cfg, seed=0, device=accelerator.device)
    model, opt = accelerator.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-3))
    ids = np.random.default_rng(13).integers(0, cfg.vocab_size, size=(8, 128))
    ids = torch.as_tensor(ids, device=accelerator.device)
    steps, losses = 20, []
    _zero_flash_counts()
    for _ in range(steps):
        out = model(input_ids=ids, labels=ids)
        accelerator.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(out.loss.detach())
    torch.cuda.synchronize()
    counts = _flash_counts()
    loss_vals = [x.item() for x in losses]
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    log(f"  tiny llama (head dim {cfg.head_dim}, bf16): losses {loss_vals[0]:.4f} -> "
        f"{loss_vals[-1]:.4f} over {steps} steps; flash launches {counts}")
    if not (all(np.isfinite(loss_vals)) and loss_vals[-1] < loss_vals[0]):
        raise AssertionError(f"the tiny llama's loss is not finite and falling: {loss_vals}")
    if any(counts[k] != steps * cfg.num_hidden_layers for k in FLASH_KERNELS):
        raise AssertionError(f"the tiny llama's steps did not launch each flash kernel once a "
                             f"layer: {counts}")
    return {"head_dim": cfg.head_dim, "losses": loss_vals, "launches": counts}


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


def time_flash_at(dev, b: int, s: int, nh: int, head_dims, dtype=torch.bfloat16,
                  n_kv: int | None = None) -> dict:
    """B1-B3 at ``head_dims`` at one shape (b, s, nh heads, bf16, causal):
    CUDA events around the Python wrapper, the profiler's device time a
    launch, the plain version, sdpa's forward and its backward alone
    (``library_ms``: its kernels' device time a call), and the bound
    counted on the real head dim's work (the padded columns are waste, not
    work). Phase 8b: the tiny llama's training shape (b 8, s 128, 4 heads)
    at hd 16, 32, 24 and 80; C4b: b 8, s 1024, 8 heads at hd 256; phase
    14a: the flagship shape at f16 (``dtype``, sdpa at the same dtype);
    phase 15a: Mixtral's GQA, ``n_kv`` kv heads (sdpa with ``enable_gqa``;
    K and V counted at ``n_kv`` heads in the bound's bytes)."""
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import flash_attention as fa

    n_kv = n_kv or nh
    gqa = {"enable_gqa": True} if n_kv != nh else {}
    out = {}
    for hd in head_dims:
        rng = np.random.default_rng(15 + hd)
        q, k, v, do, _ = _flash_inputs(rng, b, s, nh, n_kv, hd, 0, dtype, dev)
        scale = 1.0 / float(np.sqrt(hd))
        o, lse = fa.flash_fwd(q, k, v, impl="cuda")
        delta = fa._delta(o, do)
        calls = {
            "flash_fwd": lambda i: fa._flash_fwd_cuda(q, k, v, None, scale, True),
            "flash_bwd_dq": lambda i: fa._bwd_dq_cuda(q, k, v, None, lse, delta, do, scale, True),
            "flash_bwd_dkv": lambda i: fa._bwd_dkv_cuda(q, k, v, None, lse, delta, do, scale,
                                                        True),
        }
        plain = {
            "flash_fwd": _time_ms(lambda i: fa._flash_fwd_plain(q, k, v, None, scale, True), 3, 3),
            "bwd": _time_ms(lambda i: fa._flash_bwd_plain(q, k, v, None, o, lse, do, scale,
                                                           True), 3, 3),
        }
        lq, lk, lv, ldo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
        gq, gk, gv = (t.detach().clone().requires_grad_() for t in (lq, lk, lv))
        lib_out = F.scaled_dot_product_attention(gq, gk, gv, is_causal=True, **gqa)
        fwd_rows = _library_rows(
            lambda i: F.scaled_dot_product_attention(lq, lk, lv, is_causal=True, **gqa), 20)
        backend = _sdpa_backend(fwd_rows)
        library = {
            "fwd": _profiled_ms_per_call(None, 20, rows=fwd_rows),
            "bwd": _profiled_ms_per_call(
                lambda i: torch.autograd.grad(lib_out, (gq, gk, gv), ldo, retain_graph=True), 20),
        }
        pairs = s * (s + 1) / 2 * b * nh
        tile, kv_tile = b * s * nh * hd * 2, b * s * n_kv * hd * 2
        rows = b * nh * s * 4
        work = {"flash_fwd": (2 * 2 * pairs * hd, 2 * tile + 2 * kv_tile + rows),
                "flash_bwd_dq": (3 * 2 * pairs * hd, 3 * tile + 2 * kv_tile + 2 * rows),
                "flash_bwd_dkv": (4 * 2 * pairs * hd, 2 * tile + 4 * kv_tile + 2 * rows)}
        for name, fn in calls.items():
            flops, nbytes = work[name]
            ops_ms = flops / BF16_FLOPS_PER_S * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            spread = _time_spread(fn, 20, 5)
            pattern = re.compile(flash_kernel_pattern(name))
            for _ in range(PROFILER_TRIES):  # a window with no kernel row is taken again
                rows_ = [e for e in _profiled_rows(fn, 20) if pattern.search(e.key)]
                launches = sum(e.count for e in rows_)
                if launches:
                    break
            else:
                raise AssertionError(f"the profiler saw no {name} launch at hd {hd} in "
                                     f"{PROFILER_TRIES} windows")
            entry = {
                "shape": {"batch": b, "seq": s, "n_heads": nh, "n_kv": n_kv, "head_dim": hd,
                          "dtype": FLASH_DTYPE_NAMES[dtype], "causal": True},
                "ms": spread[1],
                "ms_spread": spread,
                "profiler_ms": sum(e.self_device_time_total for e in rows_) / 1e3 / launches,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": library["fwd" if name == "flash_fwd" else "bwd"],
                "library_backend": backend,
                "plain_ms": plain["flash_fwd" if name == "flash_fwd" else "bwd"],
            }
            out.setdefault(name, {})[f"head_dim_{hd}"] = entry
            log(f"  {name} hd {hd} (b {b}, s {s}, {nh}/{n_kv} heads, {FLASH_DTYPE_NAMES[dtype]}, "
                f"causal): kernel "
                f"{entry['ms']:.4f} ms by events, {entry['profiler_ms']:.4f} ms a launch by the "
                f"profiler, bound {entry['bound_ms']:.6f} ms ({entry['bound_by']}), sdpa "
                f"{'forward' if name == 'flash_fwd' else 'backward (the pair)'} "
                f"{entry['library_ms']:.4f} ms ({backend}), plain {entry['plain_ms']:.3f} ms")
        del q, k, v, do, o, lse, delta, lq, lk, lv, ldo, gq, gk, gv, lib_out
        torch.cuda.empty_cache()
    return out


def _sdpa_backend(rows) -> str:
    """Which of sdpa's backends ran, from the names of its kernels' profiler
    ``rows`` (PyTorch's flash backend takes head dims up to 256; past that
    the dispatcher picks another): ``cudnn``, ``flash``, ``efficient`` or
    ``math``, with the heaviest kernel's name. cuDNN's kernel names hold
    "flash" too (``cudnn_generated_..._flash_fprop_...``), so it is tested
    first."""
    rows = sorted(rows, key=lambda e: -e.self_device_time_total)
    names = " ".join(e.key for e in rows).lower()
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "mem_eff", "cutlass"))):
        if any(m in names for m in marks):
            break
    else:
        backend = "math"
    return f"{backend} ({rows[0].key[:80]})" if rows else backend



# -- phase 13 ---------------------------------------------------------------

#: phase 13: 2 warm-up, 6 timed and 1 profiled train step; 37 eval rows of
#: 256 ids, 4 a batch
DDP_WARMUP, DDP_TIMED, DDP_EVAL_ROWS, DDP_EVAL_SEQ, DDP_EVAL_BATCH = 2, 6, 37, 256, 4
#: the launch environment phase 13's child reads
DDP_ENV = ("ACCELERATE_COORDINATOR_ADDR", "ACCELERATE_NUM_PROCESSES", "ACCELERATE_PROCESS_ID")


class _TokenRows(torch.utils.data.Dataset):
    """``{"input_ids", "labels"}`` rows of an id matrix (eval rows carry
    ``idx`` instead of labels)."""

    def __init__(self, ids, eval_rows: bool = False):
        self.ids = torch.as_tensor(ids)
        self.eval_rows = eval_rows

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        if self.eval_rows:
            return {"input_ids": self.ids[i], "idx": torch.tensor(i)}
        return {"input_ids": self.ids[i], "labels": self.ids[i]}


def _ddp_loop(trace_dir: str | None, prefetch_batches: int | None = None,
              profiled: bool = False) -> dict:
    """The user's loop once: a fresh ``Accelerator(mixed_precision="bf16")``,
    the flagship from seed 0, the 9 train batches and the eval pass. With
    ``trace_dir`` the port's tracer writes the loader's and the
    all-reduce's spans there; ``profiled`` profiles the step after the
    timed ones; ``prefetch_batches`` overrides the loader's default."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator, DataLoaderConfiguration
    from accelerate_tpu_torch.diagnostics import tracing
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.flagship_700m(max_position_embeddings=1024)
    config = (DataLoaderConfiguration() if prefetch_batches is None
              else DataLoaderConfiguration(prefetch_batches=prefetch_batches))
    accelerator = Accelerator(mixed_precision="bf16", dataloader_config=config)
    module = LlamaForCausalLM.from_config(cfg, seed=0, device=accelerator.device)
    adamw = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    opt = torch.optim.AdamW(module.parameters(), **adamw)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
    rng = np.random.default_rng(13)
    steps = DDP_WARMUP + DDP_TIMED + 1
    train_ids = rng.integers(0, cfg.vocab_size, size=(steps * TRAIN_BATCH, TRAIN_SEQ))
    eval_ids = rng.integers(0, cfg.vocab_size, size=(DDP_EVAL_ROWS, DDP_EVAL_SEQ))
    train_dl = torch.utils.data.DataLoader(_TokenRows(train_ids), batch_size=TRAIN_BATCH,
                                           pin_memory=True)
    eval_dl = torch.utils.data.DataLoader(_TokenRows(eval_ids, eval_rows=True),
                                          batch_size=DDP_EVAL_BATCH, pin_memory=True)
    model, opt, train_dl, eval_dl, sched = accelerator.prepare(module, opt, train_dl, eval_dl,
                                                               sched)
    tracer = tracing.Tracer(logging_dir=trace_dir) if trace_dir else None
    tracing.set_active_tracer(tracer)
    losses, per_step, prof = [], [], None
    _zero_flash_counts()
    t0 = t1 = None
    for i, batch in enumerate(train_dl):
        if i == DDP_WARMUP:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        if i == DDP_WARMUP + DDP_TIMED:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if profiled:
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
        with accelerator.accumulate(model):
            loss = model(**batch).loss
            accelerator.backward(loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        losses.append(loss.detach())
        per_step.append(_flash_counts())
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    train_counts = _flash_counts()
    rows, preds = [], []
    for batch in eval_dl:
        with torch.no_grad():
            logits = model(input_ids=batch["input_ids"]).logits
        preds.append(accelerator.gather_for_metrics(logits.argmax(-1)))
        rows.append(accelerator.gather_for_metrics(batch["idx"]))
    counts = _flash_counts()
    tracing.set_active_tracer(None)
    if tracer is not None:
        tracer.close()
    out = {
        "backend": accelerator.state.backend,
        "prefetch_batches": config.prefetch_batches,
        "distributed_type": str(accelerator.distributed_type),
        "num_processes": accelerator.num_processes,
        "losses": [x.item() for x in losses],
        "step_ms": (t1 - t0) * 1e3 / DDP_TIMED,
        "launches_per_step": [{k: c[k] - (per_step[i - 1][k] if i else 0) for k in c}
                              for i, c in enumerate(per_step)],
        "launches_train": train_counts,
        "launches": counts,
        "eval_rows": torch.cat(rows).tolist(),
        "eval_preds_shape": list(torch.cat(preds).shape),
        "eval_preds": torch.cat(preds).tolist(),
        "n_params": sum(p.numel() for p in module.parameters()),
        "scheduler_steps": sched.scheduler.last_epoch,
    }
    if prof is not None:
        kernels = _kernel_rows(prof)
        nccl = [e for e in kernels if re.search(r"(?i)nccl|onerankreduce", e.key)]
        ranges = [e for e in prof.key_averages() if e.key == "collective/all_reduce_gradients"]
        out["profiled_step_device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
        out["nccl_kernels"] = {e.key[:100]: {"count": e.count,
                                             "device_ms": e.self_device_time_total / 1e3}
                               for e in nccl}
        out["all_reduce_device_ms"] = (max(e.device_time_total for e in ranges) / 1e3
                                       if ranges else None)
        out["all_reduce_kernels"] = sorted({e.key[:80] for e in kernels
                                            if "all_reduce" in e.key or "copy" in e.key.lower()
                                            or "nccl" in e.key.lower()})[:12]
    del model, opt, sched, module, train_dl, eval_dl
    return out


def _spans(trace_dir: str, name: str) -> list:
    """The durations (ms) of the spans named ``name`` the port's tracer wrote."""
    from accelerate_tpu_torch.diagnostics import tracing

    events = []
    for path in tracing.discover_trace_files(trace_dir):
        events += tracing.parse_trace_file(path)
    return [e["dur"] / 1e3 for e in events if e.get("name") == name and e.get("ph") == "X"]


def ddp_loop_child(out_path: str) -> int:
    """Phase 13's process: the loop under the launch environment (NCCL at
    world size 1), with the loader's default (profiled) and with its
    prefetch thread; then, after ``_reset_state`` took the group down and
    without the launch environment, the same loop on the same batches."""
    import torch.distributed as dist

    from accelerate_tpu_torch import AcceleratorState, GradientState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trace_dir = os.path.join(os.path.dirname(out_path), "trace")
    thread_dir = os.path.join(os.path.dirname(out_path), "trace_thread")
    for d in (trace_dir, thread_dir):
        shutil.rmtree(d, ignore_errors=True)
    grouped = _ddp_loop(trace_dir, profiled=True)
    gc.collect()
    torch.cuda.empty_cache()
    thread = _ddp_loop(thread_dir, prefetch_batches=2)
    if not (dist.is_initialized() and dist.get_backend() == "nccl"):
        raise AssertionError(f"the launched loop ran without an NCCL group: {grouped['backend']}")
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    if dist.is_initialized():
        raise AssertionError("_reset_state left the process group up")
    for key in DDP_ENV:
        os.environ.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    plain = _ddp_loop(None)
    if plain["backend"] is not None:
        raise AssertionError(f"the group-less loop brought a group up: {plain['backend']}")
    for run, d in ((grouped, trace_dir), (thread, thread_dir)):
        run["fetch_ms"] = _spans(d, "dataloader/fetch")
        run["all_reduce_host_ms"] = _spans(d, "collective/all_reduce_gradients")
    with open(out_path, "w") as f:
        json.dump({"grouped": grouped, "thread": thread, "plain": plain}, f)
    return 0


def run_ddp_loop() -> dict:
    """Phase 13 from the parent: the child under the launch environment,
    its result checked here."""
    out_dir = os.path.join(REPO, "build", "ddp_loop")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "result.json")
    # the rank meets its group over a FileStore of its own: no port to race for
    store_dir = tempfile.mkdtemp(prefix="ddp_store_")
    env = dict(os.environ, ACCELERATE_COORDINATOR_ADDR=f"file://{store_dir}/store",
               ACCELERATE_NUM_PROCESSES="1", ACCELERATE_PROCESS_ID="0")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--ddp-loop", out_path],
                              env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
        raise AssertionError(f"the data-parallel loop's process exited {proc.returncode}")
    with open(out_path) as f:
        res = json.load(f)
    grouped, thread, plain = res["grouped"], res["thread"], res["plain"]
    if (grouped["backend"], grouped["num_processes"], grouped["distributed_type"]) != ("nccl", 1, "NO"):
        raise AssertionError(f"expected NCCL at world size 1: {grouped['backend']}, "
                             f"{grouped['num_processes']}, {grouped['distributed_type']}")
    nccl = grouped["nccl_kernels"]
    if not nccl or not all(v["device_ms"] > 0 for v in nccl.values()):
        raise AssertionError(f"no NCCL kernel ran in the profiled step: "
                             f"{grouped['all_reduce_kernels']}")
    losses, ref = grouped["losses"], plain["losses"]
    rel = 0.0
    for run in (grouped, thread):
        got = run["losses"]
        if len(got) != len(ref) or not all(np.isfinite(got)):
            raise AssertionError(f"grouped losses {got} differ from the group-less {ref}")
        rel = max(rel, *(abs(a - b) / abs(b) for a, b in zip(got, ref)))
        if not rel <= 1e-5:
            raise AssertionError(f"grouped losses {got} differ from the group-less {ref}")
        # the same weights give the same argmax over the 37 eval rows
        if run["eval_preds"] != plain["eval_preds"]:
            diff = int((np.array(run["eval_preds"]) != np.array(plain["eval_preds"])).sum())
            raise AssertionError(f"gather_for_metrics' predictions differ from the group-less "
                                 f"loop's at {diff} of {DDP_EVAL_ROWS * DDP_EVAL_SEQ} ids "
                                 f"(prefetch_batches {run['prefetch_batches']})")
    for run in (grouped, thread, plain):
        if run["eval_rows"] != list(range(DDP_EVAL_ROWS)) or run["eval_preds_shape"] != [
                DDP_EVAL_ROWS, DDP_EVAL_SEQ]:
            raise AssertionError(f"gather_for_metrics gave rows {run['eval_rows']} and "
                                 f"predictions {run['eval_preds_shape']}")
        layers = 16
        if any(d[k] != layers for d in run["launches_per_step"] for k in FLASH_KERNELS):
            raise AssertionError(f"each flash kernel must launch {layers} times a step: "
                                 f"{run['launches_per_step']}")
    cfg_tokens = TRAIN_BATCH * TRAIN_SEQ
    from accelerate_tpu_torch.models import LlamaConfig

    flops = _train_flops_per_step(grouped["n_params"],
                                  LlamaConfig.flagship_700m(max_position_embeddings=1024),
                                  TRAIN_BATCH, TRAIN_SEQ)
    fetch, fetch_thread = grouped["fetch_ms"], thread["fetch_ms"]
    timed = slice(DDP_WARMUP, DDP_WARMUP + DDP_TIMED)
    out = {
        "wall_s": wall_s,
        "backend": grouped["backend"],
        "step_ms": grouped["step_ms"],
        "step_ms_group_less": plain["step_ms"],
        "step_ms_prefetch_thread": thread["step_ms"],
        "prefetch_batches": grouped["prefetch_batches"],
        "tokens_per_s": cfg_tokens / (grouped["step_ms"] / 1e3),
        "tokens_per_s_group_less": cfg_tokens / (plain["step_ms"] / 1e3),
        "mfu": flops / (grouped["step_ms"] / 1e3) / BF16_FLOPS_PER_S,
        "losses": losses,
        "max_rel_loss_diff_vs_group_less": rel,
        "bitwise_equal_losses": losses == ref and thread["losses"] == ref,
        "eval_preds_equal_group_less": True,
        "nccl_kernels": nccl,
        "all_reduce_device_ms": grouped["all_reduce_device_ms"],
        "all_reduce_host_ms": grouped["all_reduce_host_ms"],
        "all_reduce_host_ms_prefetch_thread": thread["all_reduce_host_ms"],
        "profiled_step_device_ms": grouped["profiled_step_device_ms"],
        "fetch_ms_per_batch": fetch,
        "fetch_ms_mean_timed": float(np.mean(fetch[timed])),
        "fetch_ms_per_batch_prefetch_thread": fetch_thread,
        "fetch_ms_mean_timed_prefetch_thread": float(np.mean(fetch_thread[timed])),
        "eval_rows": len(grouped["eval_rows"]),
        "scheduler_steps": grouped["scheduler_steps"],
        "launches": grouped["launches_train"],
        "launches_with_eval": grouped["launches"],
        "launches_per_step": grouped["launches_per_step"][0],
    }
    log(f"  NCCL at world size 1; step {out['step_ms']:.2f} ms (group-less "
        f"{out['step_ms_group_less']:.2f}, the loader's prefetch thread on "
        f"{out['step_ms_prefetch_thread']:.2f}), {out['tokens_per_s']:.0f} tokens/s "
        f"(group-less {out['tokens_per_s_group_less']:.0f}), MFU {out['mfu']:.4f}; "
        f"all-reduce {out['all_reduce_device_ms']} ms of device time in the profiled step "
        f"(NCCL kernels {json.dumps(nccl)}), host {['%.2f' % x for x in out['all_reduce_host_ms']]} "
        f"ms; loader fetch ms {['%.3f' % x for x in fetch]} (with the thread "
        f"{['%.3f' % x for x in fetch_thread]}); losses and eval predictions equal to the group-less "
        f"loop's (max rel {rel:.2e}, bitwise {out['bitwise_equal_losses']}); "
        f"gather_for_metrics {out['eval_rows']} rows; {wall_s:.1f} s")
    return out


# -- phase 14 ---------------------------------------------------------------

#: phase 14's fp16, fp8 and remat loops: warm-up, timed and profiled steps
P14_WARMUP, P14_TIMED = 2, 6
#: the forced-overflow run's first scale and how many steps it may take to
#: back off and take P14_TAKEN steps
P14_FORCED_SCALE, P14_FORCED_STEPS, P14_TAKEN = 2.0 ** 40, 48, 3
#: fp8_matmul against its plain version: bf16 outputs, relative to max |ref|
#: (one bf16 ulp is 2^-8 of the largest; the two sum in other orders and
#: cuBLASLt applies the inverse scales in its epilogue)
FP8_GATE = 1e-2


def f16_flash_cases():
    """Phase 14a: B1-B3 at f16 — the flagship shape (the wgmma path), GQA
    with a left pad (a fully masked query tile), hd 16 (staged at 64),
    hd 80, hd 256 (the 256-wide wgmma instances) and hd 264 and 512 (column blocks),
    each past hd 64 and 128 launched twice."""
    f16 = torch.float16
    return [
        (8, 1024, 12, 12, 128, True, 0, f16),
        (2, 1000, 32, 8, 128, True, 0, f16),
        (2, 200, 32, 8, 64, True, 130, f16),
        (2, 200, 32, 8, 128, False, 130, f16),
        (4, 129, 4, 4, 16, True, 0, f16),
        (2, 1000, 8, 2, 80, True, 77, f16),
        (2, 200, 4, 2, 256, False, 0, f16),
        (2, 129, 4, 2, 264, True, 0, f16),
        (2, 1000, 4, 2, 512, True, 77, f16),
    ]


def _p14_loop(mixed_precision: str, handlers=(), remat=False, steps: int = P14_TIMED,
              warmup: int = P14_WARMUP, profiled: bool = True, until_taken: int | None = None,
              island: bool = False) -> dict:
    """The flagship (8 × 1024 ids a step, f32 masters, AdamW at optax's
    adamw(1e-4)) through the loop as users write it under
    ``mixed_precision``: backward, a clip on unscaled gradients, the
    optimizer and the scheduler steps. ``warmup`` then ``steps`` timed
    steps (the flash counters and the fp8 GEMM counter set to 0 just before
    the timed ones, read just after), then one profiled step. With
    ``until_taken`` it runs (up to ``steps``) until that many steps were
    taken, untimed. ``island``: the logits of an ``autocast`` island on 2
    rows, with the f32 module's own logits on them."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator, AutocastKwargs, generate
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig.flagship_700m(max_position_embeddings=1024, remat=remat)
    accelerator = Accelerator(mixed_precision=mixed_precision, kwargs_handlers=list(handlers))
    module = LlamaForCausalLM.from_config(cfg, seed=0, device=accelerator.device)
    adamw = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    opt = torch.optim.AdamW(module.parameters(), **adamw)
    model, opt, sched = accelerator.prepare(module, opt,
                                            torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0))
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.as_tensor(ids, device=accelerator.device)
    rows = []

    def step():
        out = model(input_ids=ids, labels=ids)
        accelerator.backward(out.loss)
        accelerator.clip_grad_norm_(model, 1.0)
        opt.step()
        sched.step()
        opt.zero_grad()
        scale = accelerator.scaler.scale.clone() if accelerator.scaler is not None else None
        rows.append((out.loss.detach(), opt.step_was_skipped, scale))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if until_taken is not None:
        for _ in range(steps):
            step()
            if sum(not r[1] for r in rows) >= until_taken:
                break
        torch.cuda.synchronize()
        timed_ms, counts, gemms = None, None, None
    else:
        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        _zero_flash_counts()
        fp8.gemm_launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3 / steps
        counts, gemms = _flash_counts(), fp8.gemm_launches
    peak = torch.cuda.max_memory_allocated()
    out = {
        "mixed_precision": mixed_precision,
        "remat": remat,
        "losses": [float(r[0]) for r in rows],
        "skipped": [bool(r[1]) for r in rows],
        "scales": [float(r[2]) if r[2] is not None else None for r in rows],
        "max_memory_allocated_bytes": peak,
    }
    if timed_ms is not None:
        out.update({
            "step_ms": timed_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (timed_ms / 1e3),
            "flash_launches_per_step": {k: v / steps for k, v in counts.items()},
            "fp8_gemms_per_step": gemms / steps,
        })
    if profiled:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        kernels = _kernel_rows(prof)
        flash = {name: sum(e.count for e in kernels
                           if re.search(flash_kernel_pattern(name), e.key))
                 for name in FLASH_KERNELS}
        averages = prof.key_averages()
        flag = [e for e in averages if e.key == "step/finite_flag"]
        # device time by the aten op that launched it (cuBLASLt's kernel
        # names do not carry the fp8 types; the op does)
        ops = sorted((e for e in averages if e.device_type != torch.autograd.DeviceType.CUDA
                      and e.key.startswith("aten::") and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        out["profiled_step"] = {
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "kernels_launched": sum(e.count for e in kernels),
            "flash_launches": flash,
            "flash_kernel_names": sorted({e.key[:80] for e in kernels
                                          if re.search(r"flash_\w+kernel", e.key)}),
            "fp8_gemm_device_ms": sum(e.self_device_time_total for e in ops
                                      if e.key == "aten::_scaled_mm") / 1e3,
            "top_ops_device_ms": {e.key: e.self_device_time_total / 1e3 for e in ops[:12]},
            "top_ops_launches": {e.key: e.count for e in ops[:12]},
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total / 1e3 for e in top},
            # the fp16 step's one host read of the finite flag: the host
            # waits there for the queued backward
            "finite_flag_host_ms": (sum(e.cpu_time_total for e in flag) / 1e3) if flag else None,
        }
    if island:
        rows2 = ids[:2]
        with accelerator.autocast(autocast_handler=AutocastKwargs(enabled=False)):
            with torch.no_grad():
                inside = model(input_ids=rows2).logits
        with torch.no_grad():
            ref = module(input_ids=rows2).logits
            policy = model(input_ids=rows2).logits
        out["island_vs_f32_max_abs_diff"] = (inside - ref).abs().max().item()
        out["policy_vs_f32_max_abs_diff"] = (policy - ref).abs().max().item()
        del inside, ref, policy
        # generate() under the policy (its decode step captured with the
        # fp8 products in it) and inside an island (the f32 module's tokens)
        from accelerate_tpu_torch import generation

        prompts = ids[:2, :64]
        before = (generation.captures, fp8.gemm_launches)
        tokens = generate(model, prompts, max_new_tokens=8, use_cache=True)
        captured = (generation.captures - before[0], fp8.gemm_launches - before[1])
        with accelerator.autocast(autocast_handler=AutocastKwargs(enabled=False)):
            island_tokens = generate(model, prompts, max_new_tokens=8, use_cache=True)
        f32_tokens = generate(module, prompts, max_new_tokens=8, use_cache=True)
        out["generate"] = {
            "captures": captured[0], "fp8_gemms_in_the_call": captured[1],
            "tokens_shape": list(tokens.shape),
            "island_tokens_equal_f32": bool(torch.equal(island_tokens, f32_tokens)),
            "policy_tokens_equal_f32": bool(torch.equal(tokens, f32_tokens)),
        }
        generation.clear_generation_cache(model)
        generation.clear_generation_cache(module)
    del model, opt, module, sched
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _check_scale_schedule(run: dict, what: str) -> None:
    """Finite losses, a taken step, and ``step_was_skipped`` on exactly the
    steps whose scale backed off."""
    if not all(np.isfinite(run["losses"])):
        raise AssertionError(f"{what}: a loss is not finite: {run['losses']}")
    if all(run["skipped"]):
        raise AssertionError(f"{what}: no step was taken: {run['skipped']}")
    prev = None
    for i, (skipped, scale) in enumerate(zip(run["skipped"], run["scales"])):
        backed_off = prev is not None and scale < prev
        if i > 0 and skipped != backed_off:
            raise AssertionError(f"{what}: step {i} skipped={skipped} but the scale went "
                                 f"{prev} -> {scale}")
        prev = scale


def check_fp8_matmul(dev) -> dict:
    """Phase 14c: ``fp8_matmul`` on the fp8 tensor cores against its plain
    version (the same f8 values multiplied in f32 on the card) at the
    flagship's projection shapes, forward and both gradients under HYBRID,
    bf16 operands; and both timed, with ``torch.matmul``'s bf16 product and
    its two gradients beside them (events)."""
    from accelerate_tpu_torch.ops import fp8

    rng = np.random.default_rng(14)
    out = {}
    for m, k, n in ((TRAIN_BATCH * TRAIN_SEQ, 1536, 4096), (TRAIN_BATCH * TRAIN_SEQ, 1536, 32000)):
        x = torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32), device=dev).bfloat16()
        w = torch.as_tensor((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32),
                            device=dev).bfloat16()
        g = torch.as_tensor(rng.normal(size=(m, n)).astype(np.float32), device=dev).bfloat16()

        def run(impl):
            tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = fp8.fp8_matmul(tx, tw, fp8_format="HYBRID", impl=impl)
            y.backward(g)
            return y.detach(), tx.grad, tw.grad

        before = fp8.gemm_launches
        got = run("cuda")
        launches = fp8.gemm_launches - before
        ref = run("plain")
        torch.cuda.synchronize()
        errs = {name: ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                for name, a, r in zip(("out", "dx", "dw"), got, ref)}
        if launches != 3 or max(errs.values()) > FP8_GATE:
            raise AssertionError(f"fp8_matmul [{m}, {k}] x [{k}, {n}]: {launches} fp8 GEMMs, "
                                 f"errors {errs} (gate {FP8_GATE} of max |ref|)")
        xw = x.clone().requires_grad_()
        ww = w.clone().requires_grad_()

        def fp8_call(i):
            y = fp8.fp8_matmul(xw, ww, fp8_format="HYBRID")
            torch.autograd.grad(y, (xw, ww), g)

        def bf16_call(i):
            y = torch.matmul(xw, ww)
            torch.autograd.grad(y, (xw, ww), g)

        fp8_ms = _time_spread(fp8_call, 5, 5)
        bf16_ms = _time_spread(bf16_call, 5, 5)
        flops = 3 * 2 * m * k * n
        key = f"{m}x{k}x{n}"
        out[key] = {"max_rel_err": errs, "fp8_gemms": launches, "fp8_ms_fwd_bwd": fp8_ms[1],
                    "fp8_ms_spread": fp8_ms, "bf16_ms_fwd_bwd": bf16_ms[1],
                    "bf16_ms_spread": bf16_ms, "flops": flops,
                    "fp8_bound_ms": flops / FP8_FLOPS_PER_S * 1e3,
                    "bf16_bound_ms": flops / BF16_FLOPS_PER_S * 1e3}
        log(f"  fp8_matmul [{m}, {k}] x [{k}, {n}] (bf16, HYBRID): |out| {errs['out']:.2e} "
            f"|dx| {errs['dx']:.2e} |dw| {errs['dw']:.2e} of max |ref|, {launches} fp8 GEMMs; "
            f"forward + both grads {fp8_ms[1]:.3f} ms (quantize passes included) against bf16 "
            f"torch.matmul {bf16_ms[1]:.3f} ms; bounds {out[key]['fp8_bound_ms']:.3f} / "
            f"{out[key]['bf16_bound_ms']:.3f} ms")
        del x, w, g, got, ref, xw, ww
        torch.cuda.empty_cache()
    return out


def run_phase14(dev) -> dict:
    """Phase 14: the train step's precision and memory policies on the
    flagship (see the module docstring)."""
    log_phase("phase 14a: B1-B3 at f16 against their plain versions; timed at the flagship "
              "shape beside sdpa at f16")
    f16_errs = check_flash_vs_plain(dev, f16_flash_cases())
    f16_times = time_flash_at(dev, TRAIN_BATCH, TRAIN_SEQ, 12, (128,), dtype=torch.float16)

    log_phase("phase 14b: the fp16 loop (GradScalerKwargs(init_scale=2**16)) on the flagship; "
              "a second run from 2**40 backs off, then steps")
    from accelerate_tpu_torch import GradScalerKwargs

    # the same loop at bf16 first, the yardstick in this process
    bf16 = _p14_loop("bf16")
    log(f"  bf16 (the same loop): step {bf16['step_ms']:.2f} ms, {bf16['tokens_per_s']:.0f} "
        f"tokens/s; profiled step: device {bf16['profiled_step']['device_ms']:.2f} ms, "
        f"{bf16['profiled_step']['kernels_launched']} kernels")
    fp16 = _p14_loop("fp16", [GradScalerKwargs(init_scale=2.0 ** 16)])
    _check_scale_schedule(fp16, "the fp16 loop")
    flag = fp16["profiled_step"]["finite_flag_host_ms"]
    log(f"  fp16: step {fp16['step_ms']:.2f} ms, {fp16['tokens_per_s']:.0f} tokens/s, losses "
        f"{['%.4f' % x for x in fp16['losses']]}, skipped {fp16['skipped']}, scales "
        f"{fp16['scales']}; profiled step: device {fp16['profiled_step']['device_ms']:.2f} ms, "
        f"{fp16['profiled_step']['kernels_launched']} kernels, flash launches "
        f"{fp16['profiled_step']['flash_launches']}, the finite flag's host read {flag} ms; "
        f"peak memory {fp16['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    per_step = fp16["flash_launches_per_step"]
    if any(per_step[k] != 16 for k in FLASH_KERNELS) or any(
            v != 16 for v in fp16["profiled_step"]["flash_launches"].values()):
        raise AssertionError(f"each flash kernel must launch 16 times a fp16 step: {per_step}, "
                             f"{fp16['profiled_step']['flash_launches']}")
    if not any("__half" in n for n in fp16["profiled_step"]["flash_kernel_names"]):
        raise AssertionError(f"the fp16 step ran no f16 flash kernel: "
                             f"{fp16['profiled_step']['flash_kernel_names']}")
    if flag is None:
        raise AssertionError("the profiled fp16 step shows no step/finite_flag range")
    forced = _p14_loop("fp16", [GradScalerKwargs(init_scale=P14_FORCED_SCALE)],
                       steps=P14_FORCED_STEPS, until_taken=P14_TAKEN, profiled=False)
    _check_scale_schedule(forced, "the fp16 loop from 2**40")
    taken = sum(not s for s in forced["skipped"])
    log(f"  fp16 from 2**40: {len(forced['skipped'])} steps, "
        f"{sum(forced['skipped'])} skipped, {taken} taken; scale "
        f"{forced['scales'][0]} -> {forced['scales'][-1]}")
    if not forced["skipped"][0] or taken < P14_TAKEN:
        raise AssertionError(f"the run from 2**40 must back off, then take {P14_TAKEN} steps: "
                             f"{forced['skipped']}")

    log_phase("phase 14c: fp8 — fp8_matmul at the flagship's projection shapes; the flagship "
              "loop under fp8; an autocast island")
    fp8_mm = check_fp8_matmul(dev)
    fp8_loop = _p14_loop("fp8", island=True)
    log(f"  fp8: step {fp8_loop['step_ms']:.2f} ms, {fp8_loop['tokens_per_s']:.0f} tokens/s, "
        f"{fp8_loop['fp8_gemms_per_step']:.0f} fp8 GEMMs a step, losses "
        f"{['%.4f' % x for x in fp8_loop['losses']]}; profiled step: device "
        f"{fp8_loop['profiled_step']['device_ms']:.2f} ms, "
        f"{fp8_loop['profiled_step']['kernels_launched']} kernels, fp8 GEMMs "
        f"{fp8_loop['profiled_step']['fp8_gemm_device_ms']:.2f} ms; device ms by op "
        f"{ {k: round(v, 2) for k, v in fp8_loop['profiled_step']['top_ops_device_ms'].items()} }"
        f"; island logits vs the f32 "
        f"module {fp8_loop['island_vs_f32_max_abs_diff']:.3e} (policy "
        f"{fp8_loop['policy_vs_f32_max_abs_diff']:.3e})")
    if not all(np.isfinite(fp8_loop["losses"])) or not fp8_loop["losses"][-1] < fp8_loop["losses"][0]:
        raise AssertionError(f"the fp8 loop's loss is not finite and falling: {fp8_loop['losses']}")
    if not fp8_loop["fp8_gemms_per_step"] >= 16 * 7 * 3:
        raise AssertionError(f"the fp8 step ran {fp8_loop['fp8_gemms_per_step']} fp8 GEMMs, fewer "
                             "than 3 for each of the 16 × 7 projections")
    if fp8_loop["island_vs_f32_max_abs_diff"] > 1e-5:
        raise AssertionError("the autocast island's logits are not the f32 module's: "
                             f"{fp8_loop['island_vs_f32_max_abs_diff']}")
    gen = fp8_loop["generate"]
    log(f"  generate() under fp8: {gen}")
    if not (gen["captures"] == 1 and gen["fp8_gemms_in_the_call"] > 0
            and gen["tokens_shape"] == [2, 72] and gen["island_tokens_equal_f32"]):
        raise AssertionError(f"generate() under fp8 must capture one decode step with fp8 "
                             f"products, and the island must give the f32 module's tokens: {gen}")

    log_phase("phase 14d: remat on the flagship bf16 step: False, True, 'dots_saveable'")
    remat = {}
    for policy in (False, True, "dots_saveable"):
        run = _p14_loop("bf16", remat=policy, steps=4)
        remat[str(policy)] = run
        log(f"  remat={policy!r}: step {run['step_ms']:.2f} ms, peak memory "
            f"{run['max_memory_allocated_bytes'] / 2**30:.2f} GiB, first loss "
            f"{run['losses'][0]:.6f}, flash launches a step {run['flash_launches_per_step']}; "
            f"profiled step: device {run['profiled_step']['device_ms']:.2f} ms, "
            f"{run['profiled_step']['kernels_launched']} kernels")
    # every step's loss, not only the first forward's: steps 2 on are the
    # first numbers a wrong recompute in the backward moves. The policies run
    # the same kernels on the same inputs (bitwise equal losses measured);
    # the gate is 1e-3 relative, under one bf16 ulp (2^-8)
    ref = remat["False"]["losses"]
    for name, run in remat.items():
        if len(run["losses"]) != len(ref) or any(
                not math.isfinite(x) or abs(x - r) > 1e-3 * abs(r)
                for x, r in zip(run["losses"], ref)):
            raise AssertionError(f"remat={name}'s losses {run['losses']} disagree with "
                                 f"remat=False's {ref}")
    log(f"  every policy's {len(ref)} losses within 1e-3 of remat=False's: {ref}")
    return {"flash_f16_max_abs_err": f16_errs["by_dtype"], "flash_f16_times": f16_times,
            "bf16": bf16, "fp16": fp16, "fp16_forced_overflow": forced, "fp8_matmul": fp8_mm,
            "fp8": fp8_loop, "remat": remat}


# -- phase 15: the model zoo --------------------------------------------------

#: phase 15a and 15c: the training shape of the two wide paths, and the steps
P15_BATCH, P15_SEQ, P15_WARMUP, P15_TIMED = 4, 1024, 2, 5
#: phase 10's AdamW (optax.adamw(1e-4)), one tensor at a time: at Mixtral's
#: width the foreach path's temporaries hold a copy of every parameter in
#: f32 (12.7 GB), the per-tensor path one tensor's (at most 0.94 GB)
P15_ADAMW = dict(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4, foreach=False)
#: phase 15b: generate() at Mixtral's width, bf16 for time (8 × 128 random
#: ids, 8 and 72 new tokens differenced) and f32 for equality (phase 7c's
#: ragged prompts, 16 new tokens)
P15_GEN_SHORT, P15_GEN_LONG, P15_GEN_F32_NEW = 8, 72, 16
#: phase 15d: each attention family's training batch and the attention it
#: hands B1-B3 there: (b, s, heads, kv heads, head dim, causal, key mask as
#: ``_flash_inputs`` takes it). bert-base pads every other row's keys from
#: 96 on; vit-base's s is 196 patches and the class token
P15_FAMILY_FLASH = {
    "gpt2": (8, 512, 12, 12, 64, True, 0),
    "opt-125m": (8, 512, 12, 12, 64, True, 0),
    "pythia-1.4b": (8, 512, 16, 16, 128, True, 0),
    "bert-base": (16, 128, 12, 12, 64, False, (2, 96)),
    "vit-base-patch16-224": (16, 197, 12, 12, 64, False, 0),
}
#: phase 15d: the gate on the f32 logits through the kernels against the
#: plain attention path at each family's training batch, over max(|logit|,
#: 1): a few f32 roundings of the kernels' output (gate 2e-5) carried
#: through 12 to 24 layers stay far below it; a kernel that is wrong moves
#: the logits by their own size
P15_F32_LOGITS_GATE = 1e-3


def mixtral_width(**kw):
    """Mixtral-8x7B at its published width (hidden 4096, 32 query and 8 kv
    heads × 128, 8 experts top-2, ff 14336, vocab 32000, the preset's
    ``remat=True``), cut to 2 of its 32 layers."""
    import dataclasses

    from accelerate_tpu_torch.models.mixtral import MixtralConfig

    return dataclasses.replace(MixtralConfig(), num_hidden_layers=2, **kw)


def gptj_width():
    """GPT-J-6B at its published width (hidden 4096, 16 heads × 256, rotary
    64, ff 16384, vocab 50400), cut to 2 of its 28 layers."""
    import dataclasses

    from accelerate_tpu_torch.models.gpt_neox import GPTNeoXConfig

    return dataclasses.replace(GPTNeoXConfig.gptj_6b(), num_hidden_layers=2)


def mixtral_active_params(c) -> int:
    """The parameters a token runs through: attention, ``k`` of the ``E``
    experts, the router and the head (the embedding is a gather)."""
    q, kv = c.num_attention_heads * c.head_dim, c.num_key_value_heads * c.head_dim
    h = c.hidden_size
    layer = (2 * h * q + 2 * h * kv + c.num_experts_per_tok * 3 * h * c.intermediate_size
             + h * c.num_local_experts)
    return c.num_hidden_layers * layer + c.vocab_size * h


def _lm_batch(vocab: int, b: int, s: int, dev, seed: int = 0) -> dict:
    ids = torch.as_tensor(np.random.default_rng(seed).integers(0, vocab, size=(b, s)), device=dev)
    return {"input_ids": ids, "labels": ids}


def _reset_accelerator_state() -> None:
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _first_losses(model, batch) -> tuple:
    """The first forward's loss through the kernels and through the plain
    attention path (``flash_impl="plain"``), on the same weights."""
    from accelerate_tpu_torch.ops.attention import attention_context

    with torch.no_grad():
        kernel = model(**batch).loss.float().item()
        with attention_context(impl="flash", flash_impl="plain"):
            plain = model(**batch).loss.float().item()
    return kernel, plain


def einsum_ms_from_trace(prof, time_attr: str = "device_time_total") -> dict:
    """The ms of a profiled step's ``aten::einsum`` calls (the forward and,
    under remat, its recompute) and of the backward nodes autograd made for
    them, read from the trace: a backward node carries the sequence number
    and the forward thread of the op that made it, so each op inside an
    einsum names its backward node. ``time_attr`` is the events' time to
    sum (the device's on the card)."""
    events = prof.events()
    made = set()
    forward, calls = 0.0, 0

    def walk(e):
        if e.sequence_nr >= 0:
            made.add((e.thread, e.sequence_nr))
        for child in e.cpu_children:
            walk(child)

    for e in events:
        if e.name == "aten::einsum" and not _under(e, lambda p: p.name == "aten::einsum"):
            forward += getattr(e, time_attr)
            calls += 1
            walk(e)

    def is_node(e):
        return e.fwd_thread and (e.fwd_thread, e.sequence_nr) in made

    nodes = [e for e in events if is_node(e) and not _under(e, is_node)]
    names = [e.name.removeprefix("autograd::engine::evaluate_function: ") for e in nodes]
    return {"calls": calls, "forward_ms": forward / 1e3,
            "backward_ms": sum(getattr(e, time_attr) for e in nodes) / 1e3,
            "backward_nodes": {n: names.count(n) for n in sorted(set(names))}}


def _under(e, pred) -> bool:
    """Whether an ancestor of the event ``e`` satisfies ``pred``."""
    p = e.cpu_parent
    while p is not None:
        if pred(p):
            return True
        p = p.cpu_parent
    return False


def p15_train(module, batch, what: str, warmup: int, timed: int, launches_per_step: dict,
              items: int, profile_step: bool = True) -> dict:
    """``module`` through the 5-line loop (bf16 over f32 masters, AdamW at
    phase 10's settings): the first loss through the kernels against the
    plain attention path (2e-2 relative), then ``warmup`` and ``timed``
    steps with the flash counters set to 0 just before and read just after
    (each kernel ``launches_per_step`` a step), a falling finite loss, peak
    memory, and one profiled step: device ms, kernels, B1-B3's device ms
    and share, the einsums' device ms and share (forward, recompute and
    backward: :func:`einsum_ms_from_trace`). ``items``: the
    tokens (or images, or sequences) a step, for the rate."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator

    _reset_accelerator_state()
    accelerator = Accelerator(mixed_precision="bf16")
    model, opt = accelerator.prepare(module, torch.optim.AdamW(module.parameters(), **P15_ADAMW))
    kernel_loss, plain_loss = _first_losses(model, batch)
    first_rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    log(f"  {what}: first loss through the kernels {kernel_loss:.6f}, plain {plain_loss:.6f} "
        f"(rel {first_rel:.2e}, gate 2e-2)")
    if not (math.isfinite(kernel_loss) and first_rel <= 2e-2):
        raise AssertionError(f"{what}: the first loss through the kernels disagrees with plain")
    losses = []

    def step():
        out = model(**batch)
        accelerator.backward(out.loss)
        opt.step()
        opt.zero_grad()
        losses.append(out.loss.detach())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / timed
    counts = _flash_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = warmup + timed
    want = {k: launches_per_step.get(k, 0) * steps for k in FLASH_KERNELS}
    loss_vals = [x.item() for x in losses]
    out = {"losses": loss_vals, "step_ms": step_ms, "launches": counts,
           "launches_per_step": {k: counts[k] / steps for k in counts},
           "max_memory_allocated_bytes": peak, "first_loss_kernels": kernel_loss,
           "first_loss_plain": plain_loss, "first_loss_rel_err": first_rel,
           "items_per_step": items, "items_per_s": items / (step_ms / 1e3)}
    if counts != want:
        raise AssertionError(f"{what}: flash launches {counts} in {steps} steps, {want} expected")
    if not (all(math.isfinite(x) for x in loss_vals) and loss_vals[-1] < loss_vals[0]):
        raise AssertionError(f"{what}: the loss is not finite and falling: {loss_vals}")
    if profile_step:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        rows = _kernel_rows(prof)
        device_ms = sum(e.self_device_time_total for e in rows) / 1e3
        flash = {name: [e for e in rows if re.search(flash_kernel_pattern(name), e.key)]
                 for name in FLASH_KERNELS}
        flash_ms = {n: sum(e.self_device_time_total for e in r) / 1e3 for n, r in flash.items()}
        einsum = einsum_ms_from_trace(prof)
        top = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        out["profiled_step"] = {
            "device_ms": device_ms, "kernels_launched": sum(e.count for e in rows),
            "device_busy_share": device_ms / step_ms,
            "flash_ms": flash_ms,
            "flash_launches": {n: sum(e.count for e in r) for n, r in flash.items()},
            "flash_share_of_device": sum(flash_ms.values()) / device_ms,
            "einsum_device_ms": einsum,
            "einsum_share_of_device": (einsum["forward_ms"] + einsum["backward_ms"]) / device_ms,
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total / 1e3 for e in top},
        }
        if launches_per_step and not all(flash_ms[k] > 0 for k in launches_per_step):
            raise AssertionError(f"{what}: the profiled step shows no flash kernel: {flash_ms}")
    log(f"  {what}: step {step_ms:.2f} ms, {out['items_per_s']:.0f} items/s, peak memory "
        f"{peak / 2**30:.2f} GiB, losses {['%.4f' % x for x in loss_vals]}, flash launches a "
        f"step {out['launches_per_step']}"
        + (f"; profiled step: device {out['profiled_step']['device_ms']:.2f} ms, "
           f"{out['profiled_step']['kernels_launched']} kernels, B1-B3 "
           f"{ {k: round(v, 3) for k, v in out['profiled_step']['flash_ms'].items()} } ms = "
           f"{out['profiled_step']['flash_share_of_device']:.1%} of device time" if profile_step
           else ""))
    del model, opt, losses
    _reset_accelerator_state()
    return out


def p15_generate(dev) -> dict:
    """15b: ``generate()`` at Mixtral's width. bf16 for time: 8 × 128
    random ids, 8 and 72 new tokens (each called twice: the first captures
    the decode step), decode tok/s by difference. f32 for equality, with
    ``capacity_factor`` = the expert count, so no assignment is dropped: a
    full forward over the whole buffer routes other token counts than a
    decode step, and a capacity that binds would drop other tokens in each
    (as in JAX). The cached path with the kernels = the same path with
    ``flash_impl="plain"`` = the full-forward loop, on phase 7c's ragged
    prompts; the flash counters set to 0 just before the cached call and
    read just after: B1 once a layer (the prefill)."""
    from accelerate_tpu_torch import generation
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM
    from accelerate_tpu_torch.ops import flash_attention as fa
    from accelerate_tpu_torch.ops.attention import attention_context

    cfg = mixtral_width()
    model = MixtralForCausalLM.from_config(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(8, 128)).astype(np.int32)
    secs, caps = {}, {}
    for new in (P15_GEN_SHORT, P15_GEN_LONG):
        before = generation.captures
        generate(model, ids, max_new_tokens=new, use_cache=True)
        caps[new] = generation.captures - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, ids, max_new_tokens=new, use_cache=True)
        torch.cuda.synchronize()
        secs[new] = time.perf_counter() - t0
        if tuple(out.shape) != (8, 128 + new):
            raise AssertionError(f"generate() at Mixtral width: shape {tuple(out.shape)}")
    step_s = (secs[P15_GEN_LONG] - secs[P15_GEN_SHORT]) / (P15_GEN_LONG - P15_GEN_SHORT)
    timed = {"calls_s": {str(k): v for k, v in secs.items()}, "decode_step_ms": step_s * 1e3,
             "decode_tokens_per_s": 8 / step_s, "captures_first_call": caps}
    log(f"  bf16 generate() at Mixtral width (8 × 128, 2 layers): {secs[P15_GEN_SHORT]:.3f} s for "
        f"{P15_GEN_SHORT} new, {secs[P15_GEN_LONG]:.3f} s for {P15_GEN_LONG}; a decode step "
        f"{step_s * 1e3:.3f} ms, {8 / step_s:.1f} decode tok/s; captures {caps}")
    if any(v != 1 for v in caps.values()):
        raise AssertionError(f"each length's first call must capture its decode step once: {caps}")
    del model
    clear_memory()

    cfg32 = mixtral_width(capacity_factor=8.0)
    model = MixtralForCausalLM.from_config(cfg32, seed=0, dtype=torch.float32, device=dev)
    ids, mask = _ragged_prompts(cfg32.vocab_size, seed=3)
    kw = dict(max_new_tokens=P15_GEN_F32_NEW, attention_mask=mask)
    _zero_flash_counts()
    cached = generate(model, ids, use_cache=True, **kw)
    launches = fa.fwd_launches
    with attention_context(flash_impl="plain"):
        plain = generate(model, ids, use_cache=True, **kw)
    full = generate(model, ids, **kw)
    if launches != cfg32.num_hidden_layers:
        raise AssertionError(f"B1 launched {launches} times in a cached generate(): one a layer")
    for what, other in (("flash_impl='plain'", plain), ("the full-forward loop", full)):
        if not torch.equal(cached, other):
            rows = [int(r) for r in torch.nonzero((cached != other).any(dim=1)).flatten()]
            raise AssertionError(f"Mixtral f32: greedy tokens of the cached path differ from "
                                 f"{what} in rows {rows}")
    log(f"  f32 greedy generate() at Mixtral width (capacity_factor 8: no drops), 8 ragged "
        f"prompts, {P15_GEN_F32_NEW} new: cached with the kernels = flash_impl='plain' = the "
        f"full-forward loop; B1 {launches} launches a cached call")
    del model
    clear_memory()
    return {"bf16": timed, "f32_tokens_identical": True, "flash_fwd_launches_cached_call": launches}


def clear_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _image_batch(b: int, size: int, classes: int, dev, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"pixel_values": torch.as_tensor(rng.normal(size=(b, size, size, 3)).astype(np.float32),
                                            device=dev),
            "labels": torch.as_tensor(rng.integers(0, classes, size=(b,)), device=dev)}


def p15_family_flash_cases():
    """15d: B1-B3 at each attention family's training shape and key mask
    (``P15_FAMILY_FLASH``), f32 and bf16."""
    shapes = dict.fromkeys(P15_FAMILY_FLASH.values())
    return [(*shape, dtype) for shape in shapes for dtype in (torch.float32, torch.bfloat16)]


def _f32_logits_gap(module, batch) -> float:
    """max |logits through the kernels − through ``flash_impl="plain"``| /
    max(|plain|, 1), on the f32 module (no autocast) at ``batch`` without
    its labels."""
    from accelerate_tpu_torch.ops.attention import attention_context

    inputs = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        got = module(**inputs).logits
        with attention_context(impl="flash", flash_impl="plain"):
            ref = module(**inputs).logits
        return _scaled_err(got, ref)


def p15_families(dev) -> dict:
    """15d: the zoo's other families at their published sizes (random
    weights from seed 0, bf16 over f32 masters): for the attention families
    the f32 logits at the training batch through the kernels against the
    plain path (``P15_F32_LOGITS_GATE``); the first loss through the
    kernels against the plain path, 1 warm-up and 3 timed steps of the
    5-line loop with the flash counters set to 0 just before and read just
    after (one launch of each kernel a layer a step for the attention
    families; resnet and T5 run none), a falling loss; then greedy
    ``generate()`` at f32 for the LMs and T5, with the kernels and with
    ``flash_impl="plain"``, tokens equal."""
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.models import MODEL_ZOO
    from accelerate_tpu_torch.ops.attention import attention_context

    rng = np.random.default_rng(31)
    runs = {}
    for name in ("gpt2", "opt-125m", "pythia-1.4b", "bert-base", "vit-base-patch16-224",
                 "resnet50d", "t5-small"):
        cfg, factory = MODEL_ZOO[name]
        module = factory(cfg)
        layers = getattr(cfg, "num_hidden_layers", 0)
        if name in P15_FAMILY_FLASH:
            b, s, nh, _, hd, _, pad = P15_FAMILY_FLASH[name]
            if (cfg.num_attention_heads, cfg.head_dim) != (nh, hd):
                raise AssertionError(f"{name}: {cfg.num_attention_heads} heads × {cfg.head_dim}, "
                                     f"not the {nh} × {hd} its kernels were checked at")
        if name in ("gpt2", "opt-125m", "pythia-1.4b"):
            batch = _lm_batch(cfg.vocab_size, b, s, dev)
            items = b * s
        elif name == "bert-base":
            ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(b, s)), device=dev)
            mask = torch.ones_like(ids)
            step, start = pad
            mask[::step, start:] = 0  # every other row padded: a key mask on the kernels' path
            batch = {"input_ids": ids, "attention_mask": mask,
                     "labels": torch.as_tensor(rng.integers(0, 2, size=(b,)), device=dev)}
            items = b
        elif name == "t5-small":
            ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 128)), device=dev)
            batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids),
                     "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(8, 64)),
                                               device=dev)}
            layers, items = 0, 8 * 64
        else:
            batch = _image_batch(16, 224, cfg.num_classes, dev)
            layers, items = (0 if name == "resnet50d" else layers), 16
        per_step = {k: layers for k in FLASH_KERNELS} if layers else {}
        gap = None
        if name in P15_FAMILY_FLASH:
            gap = _f32_logits_gap(module, batch)
            log(f"  {name}: f32 logits through the kernels against plain {gap:.2e} of max(|logit|, "
                f"1) (gate {P15_F32_LOGITS_GATE:.0e})")
            if not gap <= P15_F32_LOGITS_GATE:
                raise AssertionError(f"{name}: f32 logits through the kernels disagree with plain")
        run = p15_train(module, batch, name, 1, 3, per_step, items, profile_step=False)
        run["f32_logits_rel_err"] = gap
        del module
        clear_memory()
        if name in ("gpt2", "opt-125m", "pythia-1.4b", "t5-small"):
            model = factory(cfg, dtype=torch.float32)
            prompts = rng.integers(1, cfg.vocab_size, size=(2, 32)).astype(np.int32)
            kw = dict(max_new_tokens=8, use_cache=True)
            got = generate(model, prompts, **kw)
            with attention_context(flash_impl="plain"):
                ref = generate(model, prompts, **kw)
            if not torch.equal(got, ref):
                raise AssertionError(f"{name}: f32 greedy tokens through the kernels differ "
                                     "from the plain path")
            run["f32_greedy_tokens_equal_plain"] = True
            run["f32_greedy_shape"] = list(got.shape)
            del model
            clear_memory()
        runs[name] = run
    log(f"  families: {json.dumps({k: {'step_ms': round(v['step_ms'], 2), 'items_per_s': round(v['items_per_s'], 1), 'launches_per_step': v['launches_per_step'], 'first_loss_rel_err': v['first_loss_rel_err'], 'f32_logits_rel_err': v['f32_logits_rel_err']} for k, v in runs.items()})}")
    return runs


def run_phase15(dev) -> dict:
    """Phase 15: the model zoo on the card (see the module docstring)."""
    from accelerate_tpu_torch.models.gpt_neox import GPTNeoXForCausalLM
    from accelerate_tpu_torch.models.mixtral import MixtralForCausalLM

    t0 = time.perf_counter()
    seconds = {}
    log_phase("phase 15a: Mixtral-8x7B's width (2 of 32 layers) — B1-B3 at 32/8 × 128 against "
              "plain; the 5-line loop at b 4 × 1024, bf16 over f32 masters, remat")
    cfg = mixtral_width()
    gqa_errs = check_flash_vs_plain(dev, [
        (P15_BATCH, P15_SEQ, 32, 8, 128, True, 0, torch.bfloat16),
        (P15_BATCH, P15_SEQ, 32, 8, 128, True, 0, torch.float32),
        (2, P15_SEQ, 32, 8, 128, True, 77, torch.bfloat16)])
    gqa_times = time_flash_at(dev, P15_BATCH, P15_SEQ, 32, (128,), n_kv=8)
    module = MixtralForCausalLM.from_config(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in module.parameters())
    batch = _lm_batch(cfg.vocab_size, P15_BATCH, P15_SEQ, dev)
    L = cfg.num_hidden_layers
    tokens = P15_BATCH * P15_SEQ
    mixtral = p15_train(module, batch, "Mixtral width", P15_WARMUP, P15_TIMED,
                        {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}, tokens)
    del module
    clear_memory()
    active = mixtral_active_params(cfg)
    flops = 6.0 * active * tokens + 6.0 * L * tokens * P15_SEQ * cfg.hidden_size
    mixtral.update({"n_params": n_params, "active_params": active, "train_flops_per_step": flops,
                    "tokens_per_s": tokens / (mixtral["step_ms"] / 1e3),
                    "mfu_active": flops / (mixtral["step_ms"] / 1e3) / BF16_FLOPS_PER_S})
    # every einsum of the step is moe_ffn's dispatch and combine
    einsum = mixtral["profiled_step"]["einsum_device_ms"]
    if not (einsum["forward_ms"] > 0 and einsum["backward_ms"] > 0):
        raise AssertionError(f"Mixtral width: the profiled step shows no einsum: {einsum}")
    log(f"  Mixtral width: {n_params / 1e9:.3f} B parameters ({active / 1e9:.3f} B active a "
        f"token); {mixtral['tokens_per_s']:.0f} tokens/s, MFU over active parameters "
        f"{mixtral['mfu_active']:.4f} of 989 TFLOP/s (6 × active × tokens + 6 × L × tokens × s × "
        f"h); the dispatch/combine einsums in the profiled step: {einsum['forward_ms']:.3f} ms "
        f"forward and recompute, {einsum['backward_ms']:.3f} ms in their backward nodes = "
        f"{mixtral['profiled_step']['einsum_share_of_device']:.1%} of the step's device time")
    seconds["15a"] = time.perf_counter() - t0

    log_phase("phase 15b: generate() at Mixtral's width — bf16 for time, f32 for equality")
    gen = p15_generate(dev)
    seconds["15b"] = time.perf_counter() - t0 - sum(seconds.values())

    log_phase("phase 15c: GPT-J-6B's width (2 of 28 layers) — B1-B3 at 16 × 256 and their "
              "256-wide wgmma instances (hd 136-256, bf16 and f16) against plain; the instances "
              "each width and dtype launches; B1-B3 timed; the 5-line loop at b 4 × 1024")
    hd256_errs = check_flash_vs_plain(dev, [
        (2, P15_SEQ, 16, 16, 256, True, 77, torch.float32)] + wide_tc_flash_cases())
    instances = check_flash_instances(dev)
    hd256_times = time_flash_at(dev, P15_BATCH, P15_SEQ, 16, (256,))
    gcfg = gptj_width()
    module = GPTNeoXForCausalLM.from_config(gcfg, seed=0, device=dev)
    gptj = p15_train(module, _lm_batch(gcfg.vocab_size, P15_BATCH, P15_SEQ, dev), "GPT-J width",
                     P15_WARMUP, P15_TIMED, {k: gcfg.num_hidden_layers for k in FLASH_KERNELS},
                     tokens)
    gptj["tokens_per_s"] = tokens / (gptj["step_ms"] / 1e3)
    del module
    clear_memory()
    seconds["15c"] = time.perf_counter() - t0 - sum(seconds.values())

    log_phase("phase 15d: gpt2, opt-125m, pythia-1.4b, bert-base, vit-base-patch16-224, "
              "resnet50d, t5-small at their published sizes — B1-B3 against plain at each "
              "family's training shape and mask, then the families")
    family_errs = check_flash_vs_plain(dev, p15_family_flash_cases())
    families = p15_families(dev)
    errs = {name: {} for name in FLASH_KERNELS}
    for src in (gqa_errs, hd256_errs, family_errs):
        for name, by_dtype in src["by_dtype"].items():
            for key, err in by_dtype.items():
                errs[name][key] = max(errs[name].get(key, 0.0), err)
    seconds["15d"] = time.perf_counter() - t0 - sum(seconds.values())
    seconds["total"] = time.perf_counter() - t0
    log(f"  phase 15: {seconds['total']:.1f} s (15a {seconds['15a']:.1f}, 15b "
        f"{seconds['15b']:.1f}, 15c {seconds['15c']:.1f}, 15d {seconds['15d']:.1f})")
    return {"mixtral": mixtral, "generate": gen, "gptj": gptj, "families": families,
            "flash_max_abs_err": errs, "seconds": seconds,
            "flash_at_mixtral_gqa": {k: v["head_dim_128"] for k, v in gqa_times.items()},
            "flash_at_gptj_hd256": {k: v["head_dim_256"] for k, v in hd256_times.items()},
            "flash_instances": instances}


# -- phase 16: big-model inference at OPT-30B's width -----------------------------

#: OPT-30B's width (hidden 7168, 56 × 128 heads, ff 28672, vocab 50272, the
#: head tied to ``wte``) cut to 8 of its 48 layers
P16_LAYERS = 8
#: the four prompts' lengths, right-padded to the longest
P16_LENGTHS = (64, 88, 111, 128)
P16_NEW = 8
P16_NEW_QUANT = 4
#: steady-state forwards timed with the offload files in the page cache
P16_WARM = 2
#: free bytes phase 16 needs for its checkpoint and three offload folders
P16_DISK_BYTES = 24 * 2**30


def p16_config():
    from accelerate_tpu_torch.models.opt import OPTConfig

    config = OPTConfig.opt_30b()
    config.num_hidden_layers = P16_LAYERS
    return config


def _p16_dir() -> str:
    """A scratch directory for the checkpoint and the offload folders: the
    temporary directory or the checkout's git-ignored ``build/``, whichever
    has more room; it must hold :data:`P16_DISK_BYTES`."""
    candidates = [tempfile.gettempdir(), os.path.join(REPO, "build")]
    os.makedirs(candidates[1], exist_ok=True)
    free = {c: shutil.disk_usage(c).free for c in candidates}
    log(f"  free bytes: {free}")
    base = max(free, key=free.get)
    if free[base] < P16_DISK_BYTES:
        raise AssertionError(f"phase 16 needs {P16_DISK_BYTES} free bytes for its checkpoint and "
                             f"offload folders; the most any candidate has is {free[base]}")
    return tempfile.mkdtemp(prefix="p16_", dir=base)


def write_p16_checkpoint(path: str, config, seed: int = 0) -> dict:
    """Random fp16 weights from ``seed`` (the family's initialiser, drawn
    leaf by leaf on the card, where 5 G normals take a fraction of a
    second, and moved to the host) as a sharded ``.safetensors``
    checkpoint: one shard a layer and one for the embeddings and the final
    norm, with ``model.safetensors.index.json``."""
    from accelerate_tpu_torch.models import _params
    from accelerate_tpu_torch.models.opt import opt_spec
    from accelerate_tpu_torch.utils.modeling import SAFE_WEIGHTS_INDEX_NAME, save_safetensors

    t0 = time.perf_counter()
    os.makedirs(path, exist_ok=True)
    shards: dict = {}
    for name, leaf in _params.flatten(opt_spec(config)):
        shard = "layer-" + name.split(".")[1] if name.startswith("layers.") else "other"
        shards.setdefault(shard, {})[name] = leaf
    generator = torch.Generator(device="cuda").manual_seed(seed)
    weight_map, nbytes = {}, 0
    for k, leaves in enumerate(shards.values()):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = {n: _params._draw(generator, leaf, torch.float16, "cuda").cpu()
                   for n, leaf in leaves.items()}
        save_safetensors(tensors, os.path.join(path, fname))
        nbytes += sum(t.numel() * t.element_size() for t in tensors.values())
        weight_map.update({n: fname for n in tensors})
    with open(os.path.join(path, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
        json.dump({"metadata": {"total_size": nbytes}, "weight_map": weight_map}, f)
    return {"bytes": nbytes, "shards": len(shards), "seconds": time.perf_counter() - t0}


def _p16_new_tokens(tokens, n: int) -> list:
    """Each row's ``n`` new tokens: they follow its own prompt in the
    right-padded buffer."""
    return [tokens[r, length:length + n].tolist() for r, length in enumerate(P16_LENGTHS)]


def _p16_prompts(vocab: int, dev):
    rng = np.random.default_rng(16)
    s = max(P16_LENGTHS)
    mask = (np.arange(s)[None, :] < np.asarray(P16_LENGTHS)[:, None]).astype(np.int32)
    ids = rng.integers(0, vocab, size=(len(P16_LENGTHS), s)).astype(np.int64) * mask
    return torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)


def _segment_bytes(model) -> dict:
    """Bytes a streamed segment moves: each layer's, and the embedding and
    head segments' (``wte``, ``wpe``; the final norm and ``wte``)."""
    sizes = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:2]) if name.startswith("layers.") else name
        sizes[key] = sizes.get(key, 0) + p.numel() * p.element_size()
    embed = sizes["wte"] + sizes["wpe"]
    head = sizes["ln_f_g"] + sizes["ln_f_b"] + sizes["wte"]
    layers = [v for k, v in sizes.items() if k.startswith("layers.")]
    return {"layer": max(layers), "embed": embed, "head": head,
            "largest": max(max(layers), embed, head), "model": sum(sizes.values())}


def _layer_tiers(device_map, layers: int) -> dict:
    from accelerate_tpu_torch.big_modeling import _entry_for

    return {i: str(_entry_for(f"layers.{i}.w_q", device_map)) for i in range(layers)}


def _drop_page_cache(folder: str) -> int:
    """``posix_fadvise(DONTNEED)`` on this process's own offload files (after
    an ``fsync``): the next read of them comes from the disk. Returns the
    bytes advised."""
    nbytes = 0
    for name in os.listdir(folder):
        if name.endswith(".dat"):
            fd = os.open(os.path.join(folder, name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
                nbytes += os.fstat(fd).st_size
            finally:
                os.close(fd)
    return nbytes


def _logits_recorder():
    """A hook that keeps a host copy of every forward's logits."""
    from accelerate_tpu_torch.hooks import ModelHook

    class Record(ModelHook):
        def __init__(self):
            self.logits = []

        def post_forward(self, module, output):
            self.logits.append(output["logits"].detach().cpu())
            return output

    return Record()


def p16_fp16(dev, cfg, ckpt: str, root: str) -> dict:
    """16a: ``init_empty_weights`` → ``load_checkpoint_and_dispatch(device_map=
    "auto")`` with a third of the layers in HBM, a third on the host and
    the rest on disk → ``generate()`` streamed; gated bit for bit against
    the same plan with every tier in HBM."""
    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.hooks import add_hook_to_module, remove_hook_from_module
    from accelerate_tpu_torch.models.opt import OPTForCausalLM

    ids, mask = _p16_prompts(cfg.vocab_size, dev)
    with bm.init_empty_weights():
        sizes = _segment_bytes(OPTForCausalLM(cfg, dtype=torch.float16))
    # the map walks JAX's pytree order (layers, ln_f_*, wpe, wte): three
    # layers fill the card, three the host, and the rest lands on disk
    third = round(P16_LAYERS / 3)
    max_memory = {0: third * sizes["layer"] + 2**20, "cpu": third * sizes["layer"] + 2**20,
                  "disk": float("inf")}
    offload = os.path.join(root, "offload_fp16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with bm.init_empty_weights():
        empty = OPTForCausalLM(cfg, dtype=torch.float16)
    assert all(p.is_meta for p in empty.parameters()), "init_empty_weights left real tensors"
    model = bm.load_checkpoint_and_dispatch(empty, ckpt, device_map="auto", max_memory=max_memory,
                                            no_split_module_classes=[r"layers\.\d+"],
                                            offload_folder=offload)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    tiers = _layer_tiers(model.hf_device_map, P16_LAYERS)
    log(f"  the inferred map: {model.hf_device_map}")
    log(f"  layers by tier: {tiers}; load {load_s:.2f} s")
    if not {"0", "cpu", "disk"} <= set(tiers.values()):
        raise AssertionError(f"the map must put layers on all three tiers: {tiers}")
    resident_bytes = model.tiered.resident_bytes
    record = _logits_recorder()
    add_hook_to_module(model, record)
    model.timing = True
    model.stream_report()
    _zero_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, ids, attention_mask=mask, max_new_tokens=P16_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = _flash_counts()["flash_fwd"]
    peak = torch.cuda.max_memory_allocated()
    first = model.stream_report()
    remove_hook_from_module(model)
    if launches != P16_NEW * P16_LAYERS:
        raise AssertionError(f"B1 launched {launches} times in the streamed generate(); "
                             f"{P16_NEW} forwards × {P16_LAYERS} layers expected")
    bound = resident_bytes + 3 * sizes["largest"] + 2**30
    log(f"  streamed generate(): {gen_s:.3f} s for {P16_NEW} tokens; peak {peak / 2**30:.3f} GiB "
        f"(bound {bound / 2**30:.3f}: resident {resident_bytes / 2**30:.3f} + 3 × "
        f"{sizes['largest'] / 2**30:.3f} + 1; the model {sizes['model'] / 2**30:.3f}); {first}")
    if not peak < min(bound, sizes["model"]):
        raise AssertionError(f"peak {peak} breaks the memory invariant ({bound}, model "
                             f"{sizes['model']})")
    # steady-state tokens: forwards of the last step's buffer, the offload
    # files in the page cache (warm), then out of it (cold)
    lengths = torch.as_tensor(P16_LENGTHS, device=dev)[:, None] + P16_NEW
    buf_mask = (torch.arange(out.shape[1], device=dev)[None, :] < lengths).to(torch.int32)

    def token() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model(input_ids=out, attention_mask=buf_mask)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    warm_s = [token() for _ in range(P16_WARM)]
    warm = model.stream_report()
    dropped = _drop_page_cache(offload)
    cold_s = token()
    cold = model.stream_report()
    streamed_logits = record.logits[:P16_NEW]
    retries = model.dequantize_retries
    model.close()
    del model, empty, record
    gc.collect()
    torch.cuda.empty_cache()

    # the same plan with every tier in HBM
    with bm.init_empty_weights():
        empty = OPTForCausalLM(cfg, dtype=torch.float16)
    resident = bm.load_checkpoint_and_dispatch(empty, ckpt, device_map={"": 0})
    record = _logits_recorder()
    add_hook_to_module(resident, record)
    ref = generate(resident, ids, attention_mask=mask, max_new_tokens=P16_NEW)
    if not torch.equal(out, ref):
        raise AssertionError(f"streamed greedy tokens differ from the all-HBM run's:\n{out}\n{ref}")
    if len(record.logits) != len(streamed_logits) or not all(
            torch.equal(a, b) for a, b in zip(streamed_logits, record.logits)):
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(streamed_logits, record.logits))
        raise AssertionError(f"streamed logits differ from the all-HBM run's (max |Δ| {diff})")
    if not all(torch.isfinite(t).all() for t in streamed_logits):
        raise AssertionError("streamed logits are not finite")
    resident.close()
    del resident, empty, record, streamed_logits
    gc.collect()
    torch.cuda.empty_cache()
    per_token = sum(warm_s) / P16_WARM
    result = {
        "cut": f"{P16_LAYERS} of OPT-30B's 48 layers, full width, fp16, random from seed 0",
        "tiers": tiers, "load_s": load_s, "generate_s": gen_s,
        "generate_s_per_token": gen_s / P16_NEW, "generate_stream": first,
        "s_per_token_warm": per_token, "s_per_token_warm_each": warm_s,
        "s_per_token_cold": cold_s,
        "bytes_streamed_per_token": warm["bytes_h2d"] / P16_WARM,
        "effective_GBps_warm": warm["bytes_h2d"] / P16_WARM / per_token / 1e9,
        "effective_GBps_cold": cold["bytes_h2d"] / cold_s / 1e9,
        "copy_ms_per_token": warm["copy_ms"] / P16_WARM,
        "compute_ms_per_token": warm["compute_ms"] / P16_WARM,
        "io_s_per_token_warm": warm["io_s"] / P16_WARM, "io_s_cold": cold["io_s"],
        "copy_ms_cold": cold["copy_ms"], "compute_ms_cold": cold["compute_ms"],
        "page_cache_dropped_bytes": dropped,
        "peak_GiB": peak / 2**30, "peak_bound_GiB": bound / 2**30,
        "resident_GiB": resident_bytes / 2**30, "model_GiB": sizes["model"] / 2**30,
        "largest_segment_GiB": sizes["largest"] / 2**30,
        "flash_fwd_launches_per_generate": launches, "dequantize_retries": retries,
        "bit_equal_to_all_hbm": True, "tokens_equal": True,
        "new_tokens": _p16_new_tokens(out, P16_NEW),
    }
    log(f"  16a: load {load_s:.2f} s; {per_token:.4f} s a token warm, {cold_s:.4f} s cold; "
        f"(generate() {gen_s / P16_NEW:.4f} s a token, its first call's staging ring "
        f"included); {result['bytes_streamed_per_token'] / 1e9:.3f} GB streamed a token, "
        f"{result['effective_GBps_warm']:.2f} GB/s warm, {result['effective_GBps_cold']:.2f} "
        f"cold; copy {result['copy_ms_per_token']:.1f} ms against compute "
        f"{result['compute_ms_per_token']:.1f} ms a token; logits bit-equal to the all-HBM run")
    return result


def _p16_quant_layer_bytes(cfg, mode: str) -> int:
    """One layer's bytes once quantized (``int8``: a byte a weight and an
    f32 scale a row; ``nf4``: half a byte a weight, an int8 scale a block
    of 64, two f32 a row and the codebook), its vectors in fp16."""
    h, ff = cfg.hidden_size, cfg.intermediate_size
    shapes = [(h, h)] * 4 + [(ff, h), (h, ff)]
    vectors = 2 * (9 * h + ff)
    if mode == "int8":
        return vectors + sum(o * i + 4 * o for o, i in shapes)
    return vectors + sum(o * i // 2 + o * (i // 64) + 8 * o + 64 for o, i in shapes)


def p16_quantized(dev, cfg, ckpt: str, root: str, fp16_tokens) -> dict:
    """16b: ``load_and_quantize_model`` on the same checkpoint, int8 and
    nf4, with one layer in HBM, one on the host and the rest, embeddings
    included, on disk; 4 new tokens each. The int8 GEMM and the native nibble
    decoder must have run."""
    from accelerate_tpu_torch import big_modeling as bm
    from accelerate_tpu_torch import native
    from accelerate_tpu_torch.generation import generate
    from accelerate_tpu_torch.models.opt import OPTForCausalLM
    from accelerate_tpu_torch.utils import quantization as q

    ids, mask = _p16_prompts(cfg.vocab_size, dev)
    out = {}
    for mode in ("int8", "nf4"):
        config = q.BnbQuantizationConfig(load_in_4bit=mode == "nf4")
        with bm.init_empty_weights():
            empty = OPTForCausalLM(cfg, dtype=torch.float16)
        layer = _p16_quant_layer_bytes(cfg, mode)
        max_memory = {0: layer + 2**20, "cpu": layer + 2**20, "disk": float("inf")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = q.load_and_quantize_model(empty, config, weights_location=ckpt,
                                          device_map="auto", max_memory=max_memory,
                                          no_split_module_classes=[r"layers\.\d+"],
                                          offload_folder=os.path.join(root, f"offload_{mode}"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tiers = _layer_tiers(model.hf_device_map, P16_LAYERS)
        gemms, decodes = q.int8_gemm_launches, native.decode_calls
        model.stream_report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = generate(model, ids, attention_mask=mask, max_new_tokens=P16_NEW_QUANT)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        report = model.stream_report()
        gemms, decodes = q.int8_gemm_launches - gemms, native.decode_calls - decodes
        new = torch.as_tensor(_p16_new_tokens(tokens, P16_NEW_QUANT))
        agree = float((new == torch.as_tensor(fp16_tokens)[:, :P16_NEW_QUANT]).float().mean())
        row = {"tiers": tiers, "load_s": load_s, "generate_s": gen_s,
               "s_per_token": gen_s / P16_NEW_QUANT,
               "bytes_streamed_per_token": report["bytes_h2d"] / P16_NEW_QUANT,
               "int8_gemm_launches": gemms, "native_decodes": decodes,
               "decode_s_per_token": report["decode_s"] / P16_NEW_QUANT,
               "dequantize_retries": model.dequantize_retries,
               "greedy_agreement_with_fp16": agree}
        log(f"  16b {mode}: layers {tiers}; load {load_s:.2f} s; {row['s_per_token']:.4f} s a "
            f"token, {row['bytes_streamed_per_token'] / 1e9:.3f} GB streamed a token; {gemms} int8 "
            f"GEMMs, {decodes} native decodes; greedy tokens agree with fp16 on {agree:.2f}")
        if not {"0", "cpu", "disk"} <= set(tiers.values()):
            raise AssertionError(f"{mode}: the map must put layers on all three tiers: {tiers}")
        if gemms == 0:
            raise AssertionError(f"{mode}: the int8 GEMM never ran")
        if mode == "nf4" and (native.load() is None or decodes == 0):
            raise AssertionError("nf4: the native nibble decoder did not build or did not run")
        if model.dequantize_retries:
            raise AssertionError(f"{mode}: a zoo segment took the dequantize retry")
        if tokens.shape != (ids.shape[0], ids.shape[1] + P16_NEW_QUANT):
            raise AssertionError(f"{mode}: tokens of shape {tuple(tokens.shape)}")
        model.close()
        del model, empty
        gc.collect()
        torch.cuda.empty_cache()
        out[mode] = row
    return out


def p16_flash(dev, launches: int) -> dict:
    """16c: B1 at the streamed forward's shape (b 4, s = 128 + 8, 56 × 128,
    f16, causal, the prompts' key mask) against its plain version at phase
    8's f16 gates, launched twice with equal bits; timed against sdpa."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    b, s, nh, hd = len(P16_LENGTHS), max(P16_LENGTHS) + P16_NEW, 56, 128
    rng = np.random.default_rng(17)
    q, k, v, _, _ = _flash_inputs(rng, b, s, nh, nh, hd, 0, torch.float16, dev)
    lengths = np.asarray(P16_LENGTHS)
    mask = torch.as_tensor(np.arange(s)[None, :] < lengths[:, None], device=dev)
    o, lse = fa.flash_fwd(q, k, v, mask, causal=True, impl="cuda")
    o2, lse2 = fa.flash_fwd(q, k, v, mask, causal=True, impl="cuda")
    ro, rlse = fa.flash_fwd(q, k, v, mask, causal=True, impl="plain")
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError("B1 at the streamed shape: two launches differ")
    o_err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    o_gate = FLASH_GATES["f16"][0]
    log(f"  B1 at the streamed shape: |o| {o_err:.2e} (gate {o_gate}), |lse| {lse_err:.2e}")
    if not (o_err <= o_gate and lse_err <= 1e-5 and torch.isfinite(o.float()).all()):
        raise AssertionError(f"B1 disagrees with its plain version at the streamed shape "
                             f"(|o| {o_err}, |lse| {lse_err})")
    timed = time_flash_masked(dev, b, s, nh, hd, P16_LENGTHS, torch.float16,
                              "the streamed OPT-30B shape")
    return {**timed, "max_abs_err": o_err, "lse_max_abs_err": lse_err,
            "launches_per_generate": launches}


def run_phase16(dev) -> dict:
    """Phase 16: big-model inference at OPT-30B's width (16a fp16 tiered,
    16b int8 and nf4, 16c B1 at the path's shape); logs its own seconds."""
    t0 = time.perf_counter()
    cfg = p16_config()
    root = _p16_dir()
    try:
        log_phase(f"phase 16a: OPT-30B's width ({P16_LAYERS} of 48 layers, fp16, random weights "
                  "from seed 0): a sharded safetensors checkpoint → init_empty_weights → "
                  "load_checkpoint_and_dispatch over HBM, host and disk → generate()")
        ckpt = os.path.join(root, "checkpoint")
        written = write_p16_checkpoint(ckpt, cfg)
        log(f"  checkpoint: {written}")
        fp16 = p16_fp16(dev, cfg, ckpt, root)
        t_a = time.perf_counter()
        log_phase("phase 16b: load_and_quantize_model, int8 and nf4, the disk-heavy map")
        quant = p16_quantized(dev, cfg, ckpt, root, fp16["new_tokens"])
        t_b = time.perf_counter()
        log_phase("phase 16c: B1 at the streamed shape (b 4, s 136, 56 × 128, f16, key mask)")
        flash = p16_flash(dev, fp16["flash_fwd_launches_per_generate"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"phase 16: {seconds:.1f} s (16a {t_a - t0:.1f}, 16b {t_b - t_a:.1f}, "
        f"16c {seconds - (t_b - t0):.1f})")
    return {"checkpoint": written, "fp16": fp16, "quantized": quant, "flash_fwd": flash,
            "seconds": seconds}


# -- phase 17 ---------------------------------------------------------------

#: phase 17a: 10 global batches of TRAIN_BATCH × TRAIN_SEQ ids; the preempted
#: run trains 0-5 (a sync save after 1, an async one after 3), is signalled
#: before 6, whose backward takes the emergency save; the resume trains 7-9
P17_BATCHES, P17_SIGNALLED, P17_RESUMED = 10, 6, 3
#: the steps the async write overlaps, and the steps before it it is held to
P17_DURING_WRITE, P17_BEFORE_WRITE = (4, 5), (2, 3)
#: 17c: find_executable_batch_size's first size (rows of TRAIN_SEQ ids)
P17_START_BATCH = 128
#: 17d: the watchdog's floor, and the longest the held step waits for it
P17_WATCHDOG_FLOOR_S, P17_HOLD_MAX_S = 2.0, 10.0


def _p17_model(dev, seed: int = 0):
    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.flagship_700m(max_position_embeddings=TRAIN_SEQ)
    return cfg, LlamaForCausalLM.from_config(cfg, seed=seed, device=dev)


def _p17_write(path: str, report: dict) -> None:
    with open(path + ".part", "w") as f:
        json.dump(report, f)
    os.replace(path + ".part", path)


def _p17_loop(mode: str, project_dir: str, out_path: str, report: dict) -> dict:
    """One run of phase 17a's loop on the flagship (bf16 over f32 masters,
    AdamW, a decaying LambdaLR, a ``DataLoader`` of P17_BATCHES batches).
    ``straight``: the batches the preempted run and its resume train,
    uninterrupted (P17_SIGNALLED is skipped: the preempted run fetches it
    and never trains it). ``train``: ``fault_tolerance=True``,
    ``log_with="jsonl"``, the watchdog, ``ProjectConfiguration(automatic_
    checkpoint_naming=True, total_limit=2)``: a sync ``save_state`` after
    batch 1, an async one after batch 3 overlapping batches 4 and 5, then
    ``P17_READY`` on stdout; the parent's SIGTERM makes batch 6's
    ``backward`` take the emergency save and exit 143. ``resume``: the same
    under ``ACCELERATE_AUTO_RESUME=true`` (``prepare`` loads the newest valid
    checkpoint), P17_RESUMED steps. Each step is timed between
    synchronisations and its flash launches counted; ``report`` is written
    to ``out_path`` after every step."""
    from accelerate_tpu_torch import Accelerator, DiagnosticsPlugin, ProjectConfiguration
    from accelerate_tpu_torch.checkpointing import wait_for_checkpoint

    managed = mode != "straight"
    acc = Accelerator(
        mixed_precision="bf16", log_with="jsonl" if managed else None,
        project_config=ProjectConfiguration(project_dir=project_dir if managed else None,
                                            automatic_checkpoint_naming=True, total_limit=2),
        fault_tolerance=managed,
        diagnostics=DiagnosticsPlugin(tracing=False) if managed else False)
    cfg, module = _p17_model(acc.device)
    opt = torch.optim.AdamW(module.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.95 ** step)
    ids = np.random.default_rng(17).integers(0, cfg.vocab_size,
                                             size=(P17_BATCHES * TRAIN_BATCH, TRAIN_SEQ))
    loader = torch.utils.data.DataLoader(_TokenRows(ids), batch_size=TRAIN_BATCH,
                                         pin_memory=True)
    t0 = time.perf_counter()
    model, opt, loader, sched = acc.prepare(module, opt, loader, sched)
    start = loader.position
    run = {"mode": mode, "resumed_at": start, "prepare_s": time.perf_counter() - t0,
           "losses": {}, "step_ms": {}, "launches": {}}
    report[mode] = run
    if managed:
        acc.init_trackers("p17", config={"batch": TRAIN_BATCH, "seq": TRAIN_SEQ})
    for j, batch in enumerate(loader):
        idx = start + j
        if mode == "straight" and idx == P17_SIGNALLED:
            continue
        if mode == "train" and idx == P17_SIGNALLED:
            _p17_write(out_path, report)
            print("P17_READY", flush=True)
            deadline = time.perf_counter() + 120
            while not acc.preemption_requested:
                if time.perf_counter() > deadline:
                    raise AssertionError("no SIGTERM came within 120 s")
                time.sleep(0.01)
        _zero_flash_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with acc.accumulate(model):
            out = model(**batch)
            acc.backward(out.loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        torch.cuda.synchronize()
        run["step_ms"][idx] = (time.perf_counter() - t) * 1e3
        run["launches"][idx] = _flash_counts()
        loss = out.loss.item()
        run["losses"][idx] = loss
        acc.log({"loss": loss, "lr": sched.get_last_lr()[0]}, step=idx)
        if mode == "train" and idx == 1:
            t = time.perf_counter()
            run["sync_save_dir"] = acc.save_state()
            run["sync_save_s"] = time.perf_counter() - t
        elif mode == "train" and idx == 3:
            t = time.perf_counter()
            run["async_save_dir"] = acc.save_state(async_save=True)
            run["async_block_s"] = time.perf_counter() - t
        elif mode == "train" and idx == P17_DURING_WRITE[-1]:
            t = time.perf_counter()
            wait_for_checkpoint()
            run["async_wait_after_steps_s"] = time.perf_counter() - t
        _p17_write(out_path, report)
        if mode == "resume" and j + 1 == P17_RESUMED:
            break
    acc.end_training()
    run["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    _p17_write(out_path, report)
    return run


def p17_loop_child(mode: str, project_dir: str, out_path: str) -> int:
    """Phase 17a's process: ``train`` runs the ``straight`` loop first (the
    uninterrupted reference, a fresh Accelerator and model), then the
    preempted loop, which exits 143; ``resume`` runs the resumed loop. The
    telemetry recorder writes the checkpoint and preemption rows under
    ``project_dir``."""
    from accelerate_tpu_torch.telemetry import TelemetryRecorder, set_active_recorder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"pid": os.getpid()}
    if mode == "train":
        _p17_loop("straight", project_dir, out_path, report)
        _reset_accelerator_state()
        clear_memory()
        torch.cuda.reset_peak_memory_stats()
    recorder = TelemetryRecorder(logging_dir=project_dir)
    set_active_recorder(recorder)
    _p17_loop(mode, project_dir, out_path, report)
    recorder.close()
    return 0


def _p17_child(mode: str, project_dir: str, out_path: str, env_extra=None) -> tuple:
    env = {k: v for k, v in os.environ.items() if k not in DDP_ENV + ("ACCELERATE_AUTO_RESUME",)}
    env.update(env_extra or {})
    cmd = [sys.executable, os.path.abspath(__file__), "--p17-loop", mode, project_dir, out_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
    return proc, time.perf_counter() - t0


def _p17_report(path: str, mode: str) -> dict:
    """One loop's report from a 17a child's JSON, batch indices as ints."""
    with open(path) as f:
        run = json.load(f)[mode]
    for key in ("losses", "step_ms", "launches"):
        run[key] = {int(k): v for k, v in run[key].items()}
    return run


def _p17_dir(state_bytes: int, model_bytes: int) -> str:
    """A scratch directory under the temporary directory or the checkout's
    git-ignored ``build/``, whichever has more room; it must hold three
    checkpoints of the training state and the model's weights."""
    need = 3 * state_bytes + model_bytes
    candidates = [tempfile.gettempdir(), os.path.join(REPO, "build")]
    os.makedirs(candidates[1], exist_ok=True)
    free = {c: shutil.disk_usage(c).free for c in candidates}
    log(f"  free bytes: {free}; phase 17 needs {need} (3 × the state {state_bytes} + the "
        f"model {model_bytes})")
    base = max(free, key=free.get)
    if free[base] < need:
        raise AssertionError(f"phase 17 needs {need} free bytes (3 × the training state + the "
                             f"model); the most any candidate has is {free[base]}")
    return tempfile.mkdtemp(prefix="p17_", dir=base)


def p17_resume(root: str) -> dict:
    """17a from the parent: the train child (the straight run, then the
    preempted run and its SIGTERM), the resume child; the checks and the
    numbers."""
    from accelerate_tpu_torch.diagnostics.monitor import collect_status
    from accelerate_tpu_torch.resilience.manifest import (
        SENTINEL_NAME,
        read_manifest,
        validate_checkpoint,
    )
    from accelerate_tpu_torch.telemetry import telemetry_segments

    project = os.path.join(root, "project")
    train_out, resume_out = (os.path.join(root, f"{m}.json") for m in ("train", "resume"))
    env = {k: v for k, v in os.environ.items() if k not in DDP_ENV + ("ACCELERATE_AUTO_RESUME",)}
    cmd = [sys.executable, os.path.abspath(__file__), "--p17-loop", "train", project, train_out]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    try:
        ready = False
        for line in child.stdout:
            if line.strip() == "P17_READY":
                ready = True
                break
        if not ready:
            raise AssertionError(f"17a's preempted run ended before it was ready: "
                                 f"{child.wait(60)}\n{child.stderr.read()[-6000:]}")
        t_term = time.perf_counter()
        child.send_signal(__import__("signal").SIGTERM)
        rc = child.wait(timeout=600)
        term_to_exit_s = time.perf_counter() - t_term
        stderr = child.stderr.read()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(60)
    train_wall_s = time.perf_counter() - t0
    if rc != 143:
        log(stderr[-6000:])
        raise AssertionError(f"the preempted run exited {rc}, not 143")
    straight, trained = (_p17_report(train_out, m) for m in ("straight", "train"))
    ckdir = os.path.join(project, "checkpoints")
    names = sorted(os.listdir(ckdir))
    if names != [SENTINEL_NAME, "checkpoint_1", "checkpoint_2"]:
        raise AssertionError(f"after the emergency save (total_limit 2) the checkpoints are {names}")
    with open(os.path.join(ckdir, SENTINEL_NAME)) as f:
        sentinel = json.load(f)
    if sentinel["reason"] != "SIGTERM" or not sentinel["checkpoint"].endswith("checkpoint_2"):
        raise AssertionError(f"the sentinel says {sentinel}")
    manifests = {}
    for name in ("checkpoint_1", "checkpoint_2"):
        ok, reason = validate_checkpoint(os.path.join(ckdir, name))
        if not ok:
            raise AssertionError(f"{name}'s manifest does not validate: {reason}")
        manifests[name] = read_manifest(os.path.join(ckdir, name))

    proc, resume_s = _p17_child("resume", project, resume_out,
                                {"ACCELERATE_AUTO_RESUME": "true"})
    if proc.returncode != 0:
        log(proc.stderr[-6000:])
        raise AssertionError(f"17a's resumed run exited {proc.returncode}")
    resumed = _p17_report(resume_out, "resume")
    if os.path.exists(os.path.join(ckdir, SENTINEL_NAME)):
        raise AssertionError("the resume left the sentinel in place")
    if resumed["resumed_at"] != P17_SIGNALLED + 1:
        raise AssertionError(f"the resume started at batch {resumed['resumed_at']}, not "
                             f"{P17_SIGNALLED + 1}")
    # the losses: the preempted run's equal the straight run's, and so do
    # the resumed ones (bitwise expected; 1e-5 relative, as phase 13)
    rel, bitwise = 0.0, True
    for run in (trained, resumed):
        for idx, loss in run["losses"].items():
            ref = straight["losses"][idx]
            if not math.isfinite(loss):
                raise AssertionError(f"a non-finite loss at batch {idx}: {run['losses']}")
            rel = max(rel, abs(loss - ref) / abs(ref))
            bitwise = bitwise and loss == ref
    if not rel <= 1e-5:
        raise AssertionError(f"the resumed losses {resumed['losses']} (preempted run "
                             f"{trained['losses']}) differ from the uninterrupted "
                             f"{straight['losses']} (max rel {rel:.2e})")
    if sorted(resumed["losses"]) != list(range(P17_SIGNALLED + 1,
                                               P17_SIGNALLED + 1 + P17_RESUMED)):
        raise AssertionError(f"the resume trained batches {sorted(resumed['losses'])}")
    layers = 16
    for run in (straight, trained, resumed):
        for idx, counts in run["launches"].items():
            if any(counts[k] != layers for k in FLASH_KERNELS):
                raise AssertionError(f"each flash kernel must launch {layers} times a step "
                                     f"(batch {idx} of the {run['mode']} run: {counts})")
    # the tracker's rows: every logged step of both processes
    with open(os.path.join(project, "p17", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    logged = sorted(r["step"] for r in rows if "loss" in r)
    expected = sorted(list(trained["losses"]) + list(resumed["losses"]))
    if logged != expected or sum(1 for r in rows if r.get("event") == "init") != 2:
        raise AssertionError(f"the JSONL tracker logged steps {logged}, not {expected}")
    # the telemetry rows: the sync, async and emergency saves, the restore
    tel = []
    for seg in telemetry_segments(os.path.join(project, "telemetry", "telemetry.jsonl")):
        with open(seg) as f:
            tel += [json.loads(line) for line in f]
    ckpt_rows = [r for r in tel if r["type"] == "checkpoint"]
    kinds = [(r["kind"], r["async"]) for r in ckpt_rows]
    if kinds != [("save", False), ("save", True), ("save", False), ("restore", False)]:
        raise AssertionError(f"the checkpoint rows are {kinds}")
    sync_row, async_row, emergency_row, restore_row = ckpt_rows
    events = [r for r in tel if r["type"] == "event" and r["kind"] == "preemption"]
    if len(events) != 1 or events[0]["reason"] != "SIGTERM":
        raise AssertionError(f"the preemption rows are {events}")
    heartbeat = collect_status(project)["hosts"]
    state_bytes = sync_row["bytes"]
    during = [trained["step_ms"][i] for i in P17_DURING_WRITE]
    before = [trained["step_ms"][i] for i in P17_BEFORE_WRITE]
    out = {
        "state_gb": state_bytes / 1e9,
        "n_params": sum(math.prod(e["global_shape"])
                        for e in manifests["checkpoint_2"]["arrays"]["model_0"].values()),
        "sync_save_s": trained["sync_save_s"],
        "sync_save_gb_per_s": state_bytes / 1e9 / trained["sync_save_s"],
        "sync_save_row_s": sync_row["seconds"],
        "async_block_s": trained["async_block_s"],
        "async_write_s": async_row["seconds"],
        "async_wait_after_steps_s": trained["async_wait_after_steps_s"],
        "step_ms_during_write": during,
        "step_ms_before_write": before,
        "step_ms_straight": [straight["step_ms"][i] for i in P17_DURING_WRITE],
        "emergency_save_s": emergency_row["seconds"],
        "sigterm_to_exit_s": term_to_exit_s,
        "load_s": restore_row["seconds"],
        "resume_prepare_s": resumed["prepare_s"],
        "checkpoint_bytes": {k: sum(f["bytes"] for f in m["files"].values())
                             for k, m in manifests.items()},
        "checkpoint_kind": manifests["checkpoint_2"]["kind"],
        "losses_straight": straight["losses"],
        "losses_preempted": trained["losses"],
        "losses_resumed": resumed["losses"],
        "max_rel_loss_diff": rel,
        "bitwise_equal_losses": bitwise,
        "launches_per_step_after_resume": resumed["launches"][P17_SIGNALLED + 1],
        "tracker_steps": logged,
        "heartbeat_hosts": heartbeat,
        "wall_s": {"straight_then_preempted": train_wall_s, "resume": resume_s},
        "peak_allocated_bytes": resumed["peak_allocated_bytes"],
    }
    log(f"  state {out['state_gb']:.3f} GB ({out['checkpoint_kind']}); sync save "
        f"{out['sync_save_s']:.2f} s ({out['sync_save_gb_per_s']:.3f} GB/s); async save blocked "
        f"{out['async_block_s']:.2f} s, its write took {out['async_write_s']:.2f} s, steps during "
        f"it {['%.1f' % x for x in during]} ms against {['%.1f' % x for x in before]} before "
        f"(the straight run's {['%.1f' % x for x in out['step_ms_straight']]}); emergency save "
        f"{out['emergency_save_s']:.2f} s (SIGTERM to exit 143 {term_to_exit_s:.2f} s); load "
        f"{out['load_s']:.2f} s; resumed losses {['%.6f' % resumed['losses'][i] for i in sorted(resumed['losses'])]} "
        f"(bitwise {bitwise}, max rel {rel:.2e}); B1-B3 a step after the resume "
        f"{out['launches_per_step_after_resume']}; tracker steps {logged}")
    return out


def p17_save_model(dev, root: str) -> dict:
    """17b: ``save_model`` of a trained flagship into several shards, then
    ``load_checkpoint_and_dispatch`` with the whole model on the card: its
    f32 logits bit-equal to the trained module's."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.big_modeling import init_empty_weights, load_checkpoint_and_dispatch
    from accelerate_tpu_torch.models import LlamaForCausalLM

    _reset_accelerator_state()
    acc = Accelerator(mixed_precision="bf16")
    cfg, module = _p17_model(dev)
    model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-4))
    gen = torch.Generator(device=dev).manual_seed(171)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), device=dev, generator=gen)
    for _ in range(2):
        acc.backward(model(input_ids=ids, labels=ids).loss)
        opt.step()
        opt.zero_grad()
    out_dir = os.path.join(root, "weights")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc.save_model(model, out_dir, max_shard_size="1GB")
    save_s = time.perf_counter() - t0
    files = sorted(os.listdir(out_dir))
    shards = [f for f in files if f.endswith(".safetensors")]
    if len(shards) < 2 or "model.safetensors.index.json" not in files:
        raise AssertionError(f"save_model(max_shard_size='1GB') wrote {files}")
    nbytes = sum(os.path.getsize(os.path.join(out_dir, f)) for f in shards)
    probe = ids[:2]
    with torch.no_grad():
        ref = module(input_ids=probe).logits
    del model, opt
    acc.free_memory()
    clear_memory()
    with init_empty_weights():
        empty = LlamaForCausalLM(cfg, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = load_checkpoint_and_dispatch(empty, out_dir, device_map={"": 0})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        got = loaded(input_ids=probe).logits
    if got.shape != ref.shape or not torch.equal(got, ref):
        raise AssertionError(f"the reloaded model's logits differ from the trained model's: "
                             f"max |Δ| {(got - ref).abs().max().item()}")
    out = {"shards": len(shards), "bytes": nbytes, "save_s": save_s,
           "save_gb_per_s": nbytes / 1e9 / save_s, "load_s": load_s,
           "load_gb_per_s": nbytes / 1e9 / load_s, "logits_bit_equal": True,
           "logits_shape": list(ref.shape)}
    log(f"  save_model: {len(shards)} shards, {nbytes / 1e9:.3f} GB in {save_s:.2f} s "
        f"({out['save_gb_per_s']:.3f} GB/s); load_checkpoint_and_dispatch {load_s:.2f} s; "
        f"logits {list(ref.shape)} bit-equal")
    del loaded, empty, module, ref, got
    clear_memory()
    return out


def p17_find_batch_size(dev) -> tuple:
    """17c: ``find_executable_batch_size`` from P17_START_BATCH × TRAIN_SEQ ids
    a step on the flagship (bf16 over f32 masters, AdamW): the sizes tried,
    the real ``torch.OutOfMemoryError``s caught, and the allocated bytes at
    the start of every try, which must equal their level before the first."""
    from accelerate_tpu_torch import Accelerator, find_executable_batch_size

    _reset_accelerator_state()
    acc = Accelerator(mixed_precision="bf16")
    cfg, module = _p17_model(dev)
    model, opt = acc.prepare(module, torch.optim.AdamW(module.parameters(), lr=1e-4))
    clear_memory()
    baseline = torch.cuda.memory_allocated()
    ooms_before = torch.cuda.memory_stats().get("num_ooms", 0)
    tried, entry_bytes, caught = [], [], []

    @find_executable_batch_size(starting_batch_size=P17_START_BATCH)
    def train_step(batch_size):
        opt.zero_grad()
        entry_bytes.append(torch.cuda.memory_allocated())
        tried.append(batch_size)
        ids = torch.randint(0, cfg.vocab_size, (batch_size, TRAIN_SEQ), device=dev)
        try:
            loss = model(input_ids=ids, labels=ids).loss
            acc.backward(loss)
            opt.step()
        except torch.OutOfMemoryError:
            caught.append(batch_size)
            raise
        torch.cuda.synchronize()
        return batch_size, loss.item()

    t0 = time.perf_counter()
    settled, loss = train_step()
    seconds = time.perf_counter() - t0
    ooms = torch.cuda.memory_stats().get("num_ooms", 0) - ooms_before
    if not caught or ooms < 1:
        raise AssertionError(f"no real torch.OutOfMemoryError was caught (tried {tried}, "
                             f"allocator OOMs {ooms})")
    if any(b != baseline for b in entry_bytes):
        raise AssertionError(f"memory_allocated at the start of each try {entry_bytes} did not "
                             f"return to {baseline}")
    if not math.isfinite(loss) or settled != tried[-1]:
        raise AssertionError(f"find_executable_batch_size settled on {settled} (loss {loss})")
    out = {"tried": tried, "settled": settled, "oom_caught": caught, "allocator_ooms": ooms,
           "allocated_at_each_try": entry_bytes, "allocated_before": baseline,
           "loss": loss, "seconds": seconds,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(f"  find_executable_batch_size: tried {tried}, caught OOM at {caught} (allocator OOMs "
        f"{ooms}), settled on {settled} × {TRAIN_SEQ} (loss {loss:.4f}) in {seconds:.1f} s; "
        f"allocated at each try {entry_bytes} (before {baseline})")
    return out, (acc, model, opt, cfg)


def p17_watchdog(dev, root: str, live) -> dict:
    """17d: the hang watchdog on the flagship loop: a step held by
    ``time.sleep`` past a P17_WATCHDOG_FLOOR_S floor fires a hang report
    that carries the card's memory, and the port's monitor reads the
    heartbeat (fired, the step count) and names the host wedged."""
    from accelerate_tpu_torch import Accelerator, DiagnosticsPlugin
    from accelerate_tpu_torch.diagnostics.monitor import collect_status

    _, model, opt, cfg = live
    _reset_accelerator_state()
    logging_dir = os.path.join(root, "watchdog")
    acc = Accelerator(mixed_precision="bf16", project_dir=logging_dir,
                      diagnostics=DiagnosticsPlugin(
                          tracing=False, watchdog_floor_seconds=P17_WATCHDOG_FLOOR_S,
                          watchdog_check_seconds=0.1, heartbeat_interval_seconds=0.5))
    model, opt = acc.prepare(model.module, opt.optimizer)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), device=dev)
    wd = acc.watchdog
    for _ in range(3):
        acc.backward(model(input_ids=ids, labels=ids).loss)
        opt.step()
        opt.zero_grad()
        torch.cuda.synchronize()
    t_hold = time.perf_counter()
    acc.backward(model(input_ids=ids, labels=ids).loss)
    torch.cuda.synchronize()
    while not os.path.exists(wd.report_path) and time.perf_counter() - t_hold < P17_HOLD_MAX_S:
        time.sleep(0.05)  # the held step: no progress reaches the watchdog
    fired_after_s = time.perf_counter() - t_hold
    status = collect_status(logging_dir)
    opt.step()
    opt.zero_grad()
    if not os.path.exists(wd.report_path):
        raise AssertionError(f"the watchdog did not fire within {fired_after_s:.1f} s")
    with open(wd.report_path) as f:
        report = json.load(f)
    memory = report["device_memory"] or {}
    if not memory.get("bytes_in_use") or not memory.get("bytes_limit"):
        raise AssertionError(f"the hang report carries no card memory: {memory}")
    hosts = status["hosts"]
    if status["wedged"] != [0] or not hosts or hosts[0]["step"] != 3 or not hosts[0]["fired"]:
        raise AssertionError(f"the monitor read {status['wedged']} wedged and hosts {hosts}")
    acc.end_training()
    out = {"fired_after_s": fired_after_s, "deadline_s": report["deadline_s"],
           "ema_step_s": report["ema_step_s"], "stalled_phase": report["stalled_phase"],
           "device_memory": memory, "monitor_hosts": hosts, "monitor_wedged": status["wedged"]}
    log(f"  watchdog: fired {fired_after_s:.2f} s into the held step (deadline "
        f"{report['deadline_s']:.2f} s, EMA step {report['ema_step_s']:.3f} s); report memory "
        f"{memory}; monitor: wedged {status['wedged']}, heartbeat step {hosts[0]['step']}")
    return out


def run_phase17(dev) -> dict:
    """Phase 17: the training loop's state on the flagship (17a save, async
    save, SIGTERM and auto-resume in processes of their own; 17b save_model
    and load_checkpoint_and_dispatch; 17c find_executable_batch_size over a
    real OOM; 17d the hang watchdog); logs its own seconds."""
    t0 = time.perf_counter()
    n_params = 702_000_000
    # f32 masters, AdamW's two moments; the model's weights alone in f32
    root = _p17_dir(state_bytes=3 * 4 * n_params, model_bytes=4 * n_params)
    try:
        log_phase("phase 17a: save_state (sync, then async under the next steps), SIGTERM → the "
                  "emergency save → exit 143, ACCELERATE_AUTO_RESUME=true → the same losses")
        resume = p17_resume(root)
        t_a = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        log_phase("phase 17b: save_model into shards → load_checkpoint_and_dispatch on the card")
        saved = p17_save_model(dev, root)
        t_b = time.perf_counter()
        log_phase(f"phase 17c: find_executable_batch_size from {P17_START_BATCH} × {TRAIN_SEQ} "
                  "on the flagship")
        batch, live = p17_find_batch_size(dev)
        t_c = time.perf_counter()
        log_phase("phase 17d: the hang watchdog on a held step; the monitor reads its heartbeat")
        watchdog = p17_watchdog(dev, root, live)
        del live
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _reset_accelerator_state()
        clear_memory()
    seconds = time.perf_counter() - t0
    log(f"phase 17: {seconds:.1f} s (17a {t_a - t0:.1f}, 17b {t_b - t_a:.1f}, 17c "
        f"{t_c - t_b:.1f}, 17d {seconds - (t_c - t0):.1f})")
    return {"resume": resume, "save_model": saved, "find_executable_batch_size": batch,
            "watchdog": watchdog, "seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--ddp-loop"]:
        return ddp_loop_child(sys.argv[2])
    if sys.argv[1:2] == ["--p17-loop"]:
        return p17_loop_child(*sys.argv[2:5])
    # --phase N: phases 1, 2 and N alone, for work on that phase; no verdict
    alone = None
    if sys.argv[1:2] == ["--phase"]:
        alone = {"14": run_phase14, "15": run_phase15, "16": run_phase16,
                 "17": run_phase17}.get(sys.argv[2] if sys.argv[2:] else "")
        if alone is None:
            print("chip_smoke: --phase takes 14, 15, 16 or 17", file=sys.stderr)
            return 2
    from accelerate_tpu_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = _T0[0] = time.perf_counter()

    log_phase("phase 1: device")
    smi = nvidia_smi()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    log_phase("phase 2: build")
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
    for key, nbytes in paged_smem.items():
        ptxas["paged_attention.cu"][key]["dynamic_smem"] = nbytes
    for kname, rep in sorted(kv for report in ptxas.values() for kv in report.items()):
        log(f"  {kname}: {rep.get('registers')} registers, spill stores {rep['spill_stores']} B, "
            f"spill loads {rep['spill_loads']} B, static smem {rep.get('static_smem')} B"
            + (f", dynamic smem {rep['dynamic_smem']} B" if "dynamic_smem" in rep else "")
            + (f", blocks a SM {rep['blocks_per_sm']}" if "blocks_per_sm" in rep else ""))
    flash_ptxas = ptxas["flash_attention.cu"]
    wgmma = {k: v for k, v in flash_ptxas.items() if "_wgmma_kernel<" in k}
    # bf16 and f16 (fp16 training) instances of each up to hd 128 and at 256
    if len(wgmma) != 3 * 2 * len(FLASH_BUILT_HDS) + 3 * 2 or any(
            v["spill_stores"] or v["spill_loads"] for v in wgmma.values()):
        raise AssertionError(f"the wgmma flash kernels (B1-B3 at each of {FLASH_BUILT_HDS} and "
                             "at 256, bf16 and f16) must "
                             f"build without spills: {wgmma}")
    b4 = ptxas["paged_attention.cu"][PAGED_TIMED[0]]
    if b4["spill_stores"] or b4["spill_loads"]:
        raise AssertionError(f"B4's bf16 hd-128 instance must build without spills: {b4}")
    if alone is not None:
        log(json.dumps({f"phase{sys.argv[2]}": alone(dev), "card": smi}))
        log(f"phase {sys.argv[2]} alone: {time.perf_counter() - t_start:.1f} s; no verdict")
        return 0

    log_phase("phase 3: paged_attention kernel against its plain version")
    errs = check_kernel_vs_plain(dev)
    log_phase("phase 3d: C4c — the paged kernel at head dims 264, 300 and 512 (column blocks of 256)")
    errs_c4c = check_kernel_vs_plain(dev, c4c_kernel_cases())
    for key, err in errs_c4c.items():
        errs[key] = max(errs.get(key, 0.0), err)

    log_phase("phase 4: flagship paged step, kernel against plain")
    logits_diff = check_flagship_forward(dev)
    torch.cuda.empty_cache()

    log_phase("phase 5: serve through the entry point")
    serve_run = run_serve_subprocess()
    launches = serve_run["launches"]
    launches_int8 = run_serve_int8_inprocess()
    launches_tiny = run_serve_tiny_defaults()

    from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    flagship = LlamaForCausalLM.from_config(LlamaConfig.flagship_700m(), seed=0,
                                            dtype=torch.bfloat16, device=dev)
    log_phase("phase 5b: the graph engine, async and sync, against an eager reference")
    parity, greedy = check_graph_engine_parity(flagship)
    log_phase("phase 5: the mixed batch through the lane burst (sampling, grammars, stop, "
        "min_tokens, logprobs)")
    lane_batch, (eos, lane_sampled) = check_lane_batch(flagship, greedy)
    log_phase("phase 5b: greedy through the lane burst; sampled requests in reverse order; the "
        "prefix cache on a shared-prefix batch")
    lane_parity = check_lane_parity(flagship, greedy, eos, lane_sampled)
    prefix = check_prefix_cache(flagship)
    log_phase("phase 5c: sampled graph engines with one seed, in two admission orders")
    sampled = check_sampled_pair(flagship)
    log_phase("phase 5d: speculative decoding, swap preemption, a deadline and the usage ledger")
    spec_swap = check_spec_swap_deadline(flagship, greedy)
    log_phase("phase 5e: the front door — serve --http on the flagship (lifecycle, OpenAI and "
        "/generate answers, SSE, /profile, /metrics, a SIGTERM drain)")
    front_door = run_front_door(serve_run)
    log_phase("phase 5f: workload replay — serve --trace on the flagship")
    workload = run_workload_replay()
    log_phase("phase 5g: the fleet — route --replicas 2 over serve --http replicas of the flagship "
        "(r0:kill@7, a SIGTERM drain)")
    fleet = run_fleet(flagship, serve_run, front_door)
    log_phase("phase 5h: the HBM pre-flight — serve --auto-blocks and --hbm-gb 1 on the flagship")
    preflight = run_preflight(dev)
    log_phase("phase 5i: the fleet with an armed SLO objective — route --respawn --logging-dir, "
              "a scale_decision row with a dominant phase, slo report and monitor --once")
    fleet_slo = run_fleet_slo()

    log_phase("phase 6: times at the flagship decode shape and the prefill chunk")
    times = time_paged_shape(dev, ctx=512)
    times_1024 = time_paged_shape(dev, ctx=1024)
    prefill = {f"context_{ctx}": time_paged_shape(dev, b=1, s=32, ctx=ctx) for ctx in (512, 896)}
    verify = time_paged_shape(dev, b=8, s=SPEC["spec_k"] + 1, ctx=512)
    paged_hd = {f"head_dim_{hd}": time_paged_shape(dev, ctx=512, hd=hd) for hd in (80, 24)}
    # C4b: 8 heads × 256 (hidden 2048, Gemma-style widths) at the decode shape
    paged_hd["head_dim_256"] = time_paged_shape(dev, ctx=512, hd=256, nh=8)
    # C4c: 4 heads × 512 (hidden 2048) in column blocks of 256
    paged_hd["head_dim_512"] = time_paged_shape(dev, ctx=512, hd=512, nh=4)

    log_phase("phase 7: where a decode step's time goes on the graph engine")
    breakdown = serve_breakdown(flagship)
    log_phase("phase 7b: generate() on the flagship at bf16 for time (bench.py's decode shape), "
              "sampling with one seed twice, a speculative round")
    gen_time = time_generate(flagship)
    del flagship
    gc.collect()
    torch.cuda.empty_cache()
    log_phase("phase 7c: generate() on the flagship at f32 for equality (cached with the "
              "kernels = plain = full-forward = speculative; eos; the prefill's logits)")
    _zero_flash_counts()
    gen_f32 = check_generate_f32(dev)
    log_phase("phase 7d: B1 against its plain version at generate()'s shapes; B1 timed at the "
              "prefill shape")
    gen_flash_errs = check_flash_generate_shapes(dev)
    flash_prefill = time_flash_prefill(dev)
    log(json.dumps({"generate": gen_time, "generate_f32": gen_f32,
                    "flash_fwd_generate_shapes_max_abs_err": gen_flash_errs,
                    "flash_fwd_at_generate_prefill": flash_prefill, "fleet_slo": fleet_slo,
                    "card": smi}))
    log(json.dumps({"front_door": front_door, "workload": workload, "fleet": fleet,
                    "preflight": preflight}))
    serve_run = {k: v for k, v in serve_run.items() if k != "rows"}
    log(json.dumps({"serve_breakdown": breakdown, "serve": serve_run, "parity": parity,
                    "lane_batch": lane_batch, "lane_parity": lane_parity,
                    "prefix_cache": prefix, "sampled_pair": sampled,
                    "spec_swap_deadline": spec_swap, "card": smi}))

    log_phase("phase 8: flash-attention kernels against their plain versions")
    flash_errs = check_flash_vs_plain(dev)

    log_phase("phase 8b: the tiny llama (head dim 16) trained on the card; B1-B3 timed at hd 16, "
        "32, 24 and 80")
    tiny_train = run_tiny_train()
    flash_narrow = time_flash_at(dev, 8, 128, 4, (16, 32, 24, 80))
    log_phase("phase 8c: C4b — a tiny llama with 256-wide heads trained on the card; B1-B3 timed "
        "at hd 256 (b 8, s 1024, 8 heads, bf16, causal)")
    tiny_train_256 = run_tiny_train(hidden_size=1024)
    flash_wide = time_flash_at(dev, 8, 1024, 8, (256,))
    log_phase("phase 8d: C4c — B1-B3 at head dims 264, 300 and 512; a tiny llama with two 512-wide "
        "heads trained and its paged step kernel against plain; B1-B3 timed at hd 512")
    flash_errs_c4c = check_flash_vs_plain(dev, c4c_flash_cases())
    for name, by_dtype in flash_errs_c4c["by_dtype"].items():
        for key, err in by_dtype.items():
            flash_errs["by_dtype"][name][key] = max(flash_errs["by_dtype"][name][key], err)
    tiny_train_512 = run_tiny_train(hidden_size=1024, heads=2)
    from accelerate_tpu_torch.models import LlamaConfig as _Config
    paged_512_diff = check_flagship_forward(dev, _Config.tiny(hidden_size=1024, heads=2))
    flash_512 = time_flash_at(dev, 8, 1024, 8, (512,))

    log_phase("phase 9: a flagship-width train step, kernels against plain")
    step_check = check_train_step_kernel_vs_plain(dev)

    log_phase("phase 10: the flagship train step through the 5-line Accelerator loop")
    train, (step, *live) = run_train_loop()

    log_phase("phase 11: where a train step's time goes")
    train_bd = train_breakdown(step, train["step_ms"])
    log(json.dumps({"train_breakdown": train_bd}))
    del step, live
    gc.collect()
    torch.cuda.empty_cache()

    log_phase("phase 12: flash kernels timed at the flagship shape")
    flash_times = time_flash_kernels(dev, train_bd["flash_ms_per_launch"])
    log_phase("phase 13: the data-parallel loop as users write it — prepare(model, opt, "
              "train_dl, eval_dl, sched) under the launch environment, NCCL at world size 1")
    gc.collect()
    torch.cuda.empty_cache()
    ddp = run_ddp_loop()
    log(json.dumps({"ddp_loop": ddp, "card": smi}))
    p14 = run_phase14(dev)
    log(json.dumps({"phase14": p14, "card": smi}))
    gc.collect()
    torch.cuda.empty_cache()
    p15 = run_phase15(dev)
    log(json.dumps({"phase15": p15, "card": smi}))
    gc.collect()
    torch.cuda.empty_cache()
    p16 = run_phase16(dev)
    log(json.dumps({"phase16": p16, "card": smi}))
    gc.collect()
    torch.cuda.empty_cache()
    p17 = run_phase17(dev)
    log(json.dumps({"phase17": p17, "card": smi}))
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "losses"},
                    "train_step_check": step_check, "tiny_train": tiny_train,
                    "tiny_train_head_dim_256": tiny_train_256,
                    "tiny_train_head_dim_512": tiny_train_512,
                    "paged_step_head_dim_512_logits_diff": paged_512_diff}))

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
        "at_spec_verify": {k: verify[k] for k in PAGED_TIMED_KEYS + ("bound_by", "shape")},
        "at_head_dims": {h: {k: t[k] for k in PAGED_TIMED_KEYS + ("bound_by", "shape")}
                         for h, t in paged_hd.items()},
        "launches_spec_greedy_in_process": spec_swap["greedy"]["launches"],
        "launches_front_door": front_door["launches_after_drain"],
        "launches_fleet": fleet["launches"],
        "launches_workload_replay": workload["launches"],
        "ptxas": {k: ptxas["paged_attention.cu"][k] for k in PAGED_TIMED},
        "ptxas_head_dim_256": {k: ptxas["paged_attention.cu"][k] for k in PAGED_WIDE},
        "ptxas_head_dim_512": {k: ptxas["paged_attention.cu"][k] for k in PAGED_COLS},
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
            "launches_ddp_loop": ddp["launches"][name],
            "max_abs_err": max(by_dtype.values()),
            "max_abs_err_by_dtype": by_dtype,
            "ms": t["kernel_ms"],
            "kernel_ms": t["kernel_ms"],
            "profiler_ms": t["profiler_ms"],
            "tflops": t["tflops"],
            "tflops_profiler": t["tflops_profiler"],
            "ptxas": {k: v for k, v in flash_ptxas.items() if k.startswith(f"{name}_")},
            # the instance the timed shape (hd 128, bf16) launches, and those
            # phase 15c saw at each width and dtype
            "instance": flash_instances(128, "bf16")[name],
            "instances": {case: by_name[name] for case, by_name in p15["flash_instances"].items()},
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
            **({"launches_generate": {
                "cached_call_f32": gen_f32["flash_fwd_launches_cached_call"],
                "full_forward_call_f32": gen_f32["flash_fwd_launches_full_forward"],
                "cached_call_bf16": gen_time[f"new_{DECODE_LONG}"]["calls"][0][
                    "flash_fwd_launches"]},
                "max_abs_err_generate_shapes": gen_flash_errs,
                "at_generate_prefill": flash_prefill} if name == "flash_fwd" else {}),
            "max_abs_err_fp16": p14["flash_f16_max_abs_err"][name]["f16"],
            "ms_fp16": p14["flash_f16_times"][name]["head_dim_128"]["ms"],
            "profiler_ms_fp16": p14["flash_f16_times"][name]["head_dim_128"]["profiler_ms"],
            "library_ms_fp16": p14["flash_f16_times"][name]["head_dim_128"]["library_ms"],
            "launches_fp16_loop_per_step": p14["fp16"]["flash_launches_per_step"][name],
            "at_narrow_heads": flash_narrow[name],
            "at_head_dim_256": {**flash_wide[name], "instance": FLASH_WIDE[FLASH_KERNELS.index(name)],
                                "ptxas": flash_ptxas[FLASH_WIDE[FLASH_KERNELS.index(name)]]},
            "at_head_dim_512": flash_512[name],
            # phase 15: the zoo's paths, each driven with the counters at 0
            "launches_phase15": {"mixtral_width": p15["mixtral"]["launches"][name],
                                 "gptj_width": p15["gptj"]["launches"][name],
                                 **{f: r["launches"][name] for f, r in p15["families"].items()}},
            "max_abs_err_phase15": p15["flash_max_abs_err"][name],
            "at_mixtral_gqa": p15["flash_at_mixtral_gqa"][name],
            "at_gptj_head_dim_256": {**p15["flash_at_gptj_hd256"][name],
                                     "instance": FLASH_WIDE[FLASH_KERNELS.index(name)],
                                     "ptxas": flash_ptxas[FLASH_WIDE[FLASH_KERNELS.index(name)]]},
            # phase 16: big-model inference, the counters at 0 around the
            # streamed generate() (B1 only: inference)
            **({"launches_big_model_generate": p16["fp16"]["flash_fwd_launches_per_generate"],
                "at_opt30b_streamed": p16["flash_fwd"]} if name == "flash_fwd" else {}),
            # phase 17: the resumed loop, the counters at 0 around each step
            "launches_phase17_per_step_after_resume":
                p17["resume"]["launches_per_step_after_resume"][name],
        })
    log(json.dumps({"kernels": kernels, "build_s": build_s, "serve_wall_s": serve_run["wall_s"],
                    "total_s": time.perf_counter() - t_start, "card": smi}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
