"""Token picking and greedy speculative acceptance (port of
``pick_next_token``, ``scale_logits`` and ``spec_accept_tokens`` from
``accelerate_tpu/generation.py``). The rest of ``generation.py`` —
``generate()`` and its speculative loop — is not ported yet."""

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


def spec_accept_tokens(d: torch.Tensor, preds: torch.Tensor):
    """Greedy speculative acceptance — the single source of the accept/emit
    token math for the serving engine's spec programs (port of JAX
    ``spec_accept_tokens``).

    ``d`` ``[b, k]`` are the draft's proposed tokens; ``preds`` ``[b, k+1]``
    the target's greedy picks at each position of the verify chunk
    ``[pending, d_1 .. d_k]``. Returns ``(accept, tok_seq)``:

    * ``accept`` ``[b]`` int32 in ``0..k`` — the longest prefix of ``d``
      agreeing with the target's own greedy choices;
    * ``tok_seq`` ``[b, k+1]`` int32 — the accepted draft prefix, then the
      target's correction at index ``accept``, zeros after (callers emit
      ``tok_seq[:, : accept + 1]``).

    Greedy acceptance is exact for any draft: every emitted token equals
    what plain greedy decoding of the target would have produced. Fixed
    shapes, no host sync: it runs inside a captured graph."""
    b, k = d.shape
    match = preds[:, :k] == d
    accept = torch.where(match.all(dim=1), torch.full_like(d[:, 0], k),
                         torch.argmin(match.to(torch.int32), dim=1).to(d.dtype))
    accept = accept.to(torch.int32)
    j = torch.arange(k + 1, dtype=torch.int32, device=d.device)[None, :]
    corr = torch.gather(preds, 1, accept.long()[:, None])  # [b, 1]
    d_ext = torch.cat([d, torch.zeros((b, 1), dtype=d.dtype, device=d.device)], dim=1)
    a = accept[:, None]
    tok_seq = torch.where(j < a, d_ext, torch.where(j == a, corr, torch.zeros_like(d_ext)))
    return accept, tok_seq.to(torch.int32)
