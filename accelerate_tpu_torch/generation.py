"""Token picking (port of ``pick_next_token`` and ``scale_logits`` from
``accelerate_tpu/generation.py``). The rest of ``generation.py`` —
``generate()`` and speculative decoding — is not ported yet."""

from __future__ import annotations

import torch

#: the temperature floor every sampling path divides by
TEMPERATURE_FLOOR = 1e-6


def scale_logits(logits: torch.Tensor, temperature) -> torch.Tensor:
    """Temperature scaling with the shared floor; ``temperature`` may be a
    float or a tensor broadcast against ``logits``."""
    if isinstance(temperature, torch.Tensor):
        return logits / torch.clamp(temperature, min=TEMPERATURE_FLOOR)
    return logits / max(float(temperature), TEMPERATURE_FLOOR)


def pick_next_token(logits, generator, finished, eos_id, temperature, do_sample, has_eos):
    """THE token pick: greedy ``argmax`` (the first maximal index, as
    ``jnp.argmax``), or a temperature-scaled categorical draw (Gumbel-max
    over uniforms from ``generator``, which advances in place — the port's
    stand-in for JAX's key split; it cannot reproduce JAX's bits). With
    ``has_eos``, finished rows keep emitting ``eos_id``. Returns
    ``(int32 tokens, finished)``."""
    if do_sample:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        tok = torch.argmax(scale_logits(logits.float(), temperature) + gumbel, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    tok = tok.to(torch.int32)
    if has_eos:
        tok = torch.where(finished, torch.full_like(tok, eos_id), tok)
        finished = finished | (tok == eos_id)
    return tok, finished
