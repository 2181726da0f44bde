"""What each gloo rank runs in ``tests/test_torch_checkpointing.py``'s
sharded tests, and the dataset both packages' loops read there. A module
that imports torch and the port only: ``debug_launcher`` spawns the ranks,
which import their function by name."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset

#: optimizer steps before the save, and after it
STEPS = 3


class Rows(Dataset):
    """``{"input_ids", "labels"}`` rows of a numpy id matrix."""

    def __init__(self, ids: np.ndarray):
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        row = torch.from_numpy(self.ids[i])
        return {"input_ids": row, "labels": row.clone()}


def sharded_train(init: dict, cfg_kwargs: dict, ids: np.ndarray, ckpt: str, sharded: bool,
                  mode: str) -> dict:
    """The tiny llama at f32 over 8 global rows a step, split across the
    ranks. ``mode="save"``: train STEPS steps, ``save_state(ckpt,
    sharded=sharded)``, train STEPS more; ``"resume"``: ``load_state(ckpt)``
    and train STEPS. Returns the global (rank-averaged) losses, the loader's
    position after the load, the device of AdamW's ``step`` and the final
    weights."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.models import llama as tllama

    acc = Accelerator(cpu=True)
    cfg = tllama.LlamaConfig(**cfg_kwargs)
    module = tllama.LlamaForCausalLM(cfg, device="cpu")
    module.load_state_dict(tllama.params_from_jax(init, cfg))
    opt = torch.optim.AdamW(module.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    # a constant schedule: the scheduler steps num_processes times an
    # optimizer step, so a decaying one would differ between 1 and 2 ranks
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 1.0)
    loader = DataLoader(Rows(ids), batch_size=8 // acc.num_processes)
    model, opt, loader, sched = acc.prepare(module, opt, loader, sched)
    position = 0
    if mode == "resume":
        acc.load_state(ckpt)
        position = loader.position
    losses = []
    for batch in loader:
        with acc.accumulate(model):
            out = model(**batch)
            acc.backward(out.loss)
            opt.step()
            sched.step()
            opt.zero_grad()
        losses.append(float(acc.reduce(out.loss.detach(), reduction="mean")))
        if mode == "save" and len(losses) == STEPS:
            acc.save_state(ckpt, sharded=sharded)
        if mode == "resume" and len(losses) == STEPS:
            break
    acc.end_training()
    first = next(iter(module.parameters()))
    return {
        "losses": losses,
        "position": position,
        "step_device": opt.state[first]["step"].device.type,
        "weights": np.concatenate([p.detach().reshape(-1).numpy() for p in module.parameters()]),
    }
