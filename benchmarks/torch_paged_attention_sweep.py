#!/usr/bin/env python3
"""Sweep the paged-attention kernel's split plan on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 benchmarks/torch_paged_attention_sweep.py [--targets 2,4,6]

For each target of blocks an SM (``ops.paged_attention._BLOCKS_PER_SM_TARGET``,
which sets how many key splits a launch gets), it times the kernel at the
shapes ``chip_smoke.py`` phase 6 times: decode (8 slots, 12 × 128, bf16) at
contexts 512 and 1024, and the 32-query prefill chunk at contexts 512 and
896, with ``chip_smoke.time_paged_shape`` (events around the wrapper, the
profiler's device time a launch of each kernel, sdpa on the pre-gathered
span, the bound). Prints the card's name and power limit, then one JSON line
``{"sweep": {target: {shape: {...}}}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 1, 512), (8, 1, 1024), (1, 32, 512), (1, 32, 896))  # (b, s, context)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--targets", default="2,4,6",
                        help="comma-separated blocks-an-SM targets, in the order run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("paged_attention_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from accelerate_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(cs.nvidia_smi())
    dev = torch.device("cuda")
    sweep = {}
    for target in (int(t) for t in args.targets.split(",")):
        pa._BLOCKS_PER_SM_TARGET = target
        cs.log(f"target {target} blocks an SM")
        sweep[target] = {
            f"b{b}_s{s}_ctx{ctx}": {
                **cs.time_paged_shape(dev, b=b, s=s, ctx=ctx),
                "splits": pa._split_plan(b, s, 12, 12, 128, 1024,
                                         pa._sm_count(dev.index or 0)).splits,
            }
            for b, s, ctx in SHAPES
        }
    cs.log(json.dumps({"sweep": sweep}))
    cs.log(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
