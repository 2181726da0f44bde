"""B1-B3 and B4 timed at head dims 128 and 256 (B1-B3 at 256 at two
shapes: b 8 × 8 heads and GPT-J-6B's b 4 × 16 heads, s 1024) with the
``chip_smoke.py`` and the kernels of the tree it runs in (its working
directory): one line, ``AB {...}``. ``scripts/kernel_ab.sh`` runs it in a
parent tree and in this one, in turns, on one card."""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from accelerate_tpu_torch import _build  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
_build.build_all()
out = {"tree": os.getcwd()}
out["flash_128"] = cs.time_flash_at(dev, 8, 1024, 12, (128,))
out["flash_256"] = cs.time_flash_at(dev, 8, 1024, 8, (256,))
out["flash_256_gptj"] = cs.time_flash_at(dev, 4, 1024, 16, (256,))
keys = cs.PAGED_TIMED_KEYS
out["paged_128"] = {k: cs.time_paged_shape(dev, ctx=512)[k] for k in keys}
out["paged_256"] = {k: cs.time_paged_shape(dev, ctx=512, hd=256, nh=8)[k] for k in keys}
print("AB " + json.dumps(out), flush=True)
