"""Per-slot sampling for the serving engine (port of
``accelerate_tpu/serving/sampling.py``).

The engine captures ONE decode burst into a CUDA graph and replays it for
the life of the process, so everything a request can vary rides in as
fixed-shape *lane* operands: ``[num_slots]`` tensors (plus one ``[num_slots,
rep_window]`` ring for the repetition penalty) whose shapes never change,
whichever requests occupy the slots. The lanes are views of the lane
program's one int32 operand buffer; the float lanes are bit-cast views.

Randomness is derived, never threaded: the uniform of a slot's draw at
output position ``pos`` is a counter-based integer hash of ``(engine seed,
tag, request seed, pos)`` (:func:`slot_uniforms`), and the pick inverts the
CDF of the filtered distribution in token order. The uniform depends only
on (seed, position, draw kind) — not on the slot index, the batch
composition, or how many bursts it took to get there — so identical
``(seed, prompt)`` pairs reproduce the same completion across admission
orders. The hash is integer arithmetic in int64 masked to 32 bits, so the
CPU and the card give the same bits; it needs no ``torch.Generator`` and no
RNG state registered with a graph. It cannot reproduce the JAX package's
threefry bits: sampled slots match JAX in distribution, greedy slots
token for token. ``TAG_*`` separates the independent draws a speculative
round makes at one position (:func:`rejection_accept`).

The JAX module's ``lax.cond`` greedy fast path becomes a host choice in
the engine: CUDA graphs cannot branch on data, so the plain burst graph
replays when every live request is inert for the whole burst and the lane
graph otherwise. :func:`pick_tokens` always runs the filtered path, whose
argmax equals the plain argmax on an inert slot.

Host-side bookkeeping (stop sequences, min/max tokens, the authoritative
DFA state) lives on the request object; this module supplies the pure
helpers (:func:`match_stop`, :class:`SamplingParams`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..generation import scale_logits

__all__ = [
    "NEG",
    "SamplingParams",
    "resolve_sampling",
    "LANE_SPECS",
    "blank_lanes",
    "set_slot_lane",
    "clear_slot_lane",
    "match_stop",
    "slot_uniforms",
    "apply_filters",
    "dist_logprobs",
    "inverse_cdf_pick",
    "pick_tokens",
    "TAG_SAMPLE",
    "TAG_DRAFT",
    "TAG_ACCEPT",
    "TAG_RESAMPLE",
    "rejection_accept",
]

#: large-but-finite mask fill. Not -inf: a fully-masked row (a grammar's
#: terminal state, sampled only on discarded burst tails) must softmax to
#: uniform garbage, not NaN.
NEG = -1e30

# Draw kinds hashed into the per-slot uniform so a speculative round's
# independent draws at the same output position don't collide.
TAG_SAMPLE = 0  # plain decode / prefill token pick
TAG_DRAFT = 1  # speculative draft proposal
TAG_ACCEPT = 2  # accept/reject uniform in the verify round
TAG_RESAMPLE = 3  # residual resample / bonus token


# --------------------------------------------------------------------------
# host-side request params
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs, validated once at admission.

    ``stop`` is a tuple of token-id tuples (the engine works in token ids).
    ``logprobs`` asks for the top-N per-step logprobs and must be ≤ the
    engine's static ``logprobs_topn`` cap (the cap shapes the lane graph's
    outputs, the request only opts in).
    """

    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    seed: int = 0
    min_tokens: int = 0
    stop: tuple = ()
    logprobs: int = 0

    def validate(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {self.repetition_penalty}"
            )
        if self.min_tokens < 0:
            raise ValueError(f"min_tokens must be >= 0, got {self.min_tokens}")
        if self.logprobs < 0:
            raise ValueError(f"logprobs must be >= 0, got {self.logprobs}")
        for seq in self.stop:
            if not seq:
                raise ValueError("stop sequences must be non-empty")
        return self

    @property
    def inert(self):
        """True when this request is indistinguishable from bare greedy."""
        return (
            not self.do_sample
            and self.repetition_penalty == 1.0
            and self.min_tokens == 0
            and self.logprobs == 0
        )


def resolve_sampling(obj, default=None):
    """Coerce ``None`` / dict / :class:`SamplingParams` into validated
    params. ``None`` inherits the engine default (itself derived from the
    engine-wide ``do_sample``/``temperature`` config)."""
    if obj is None:
        return default if default is not None else SamplingParams()
    if isinstance(obj, SamplingParams):
        return obj.validate()
    if isinstance(obj, dict):
        allowed = {f.name for f in dataclasses.fields(SamplingParams)}
        unknown = set(obj) - allowed
        if unknown:
            raise ValueError(
                f"unknown sampling params {sorted(unknown)} (allowed: {sorted(allowed)})"
            )
        kw = dict(obj)
        if "stop" in kw:
            stops = kw["stop"]
            if isinstance(stops, (list, tuple)) and stops and isinstance(
                stops[0], (int, np.integer)
            ):
                stops = [stops]  # one bare token-id sequence
            kw["stop"] = tuple(tuple(int(t) for t in s) for s in (stops or ()))
        return SamplingParams(**kw).validate()
    raise ValueError(f"sampling must be a dict or SamplingParams, got {type(obj)!r}")


# --------------------------------------------------------------------------
# lanes: the fixed-shape operands
# --------------------------------------------------------------------------

#: name, dtype, inert default. ``sample`` is an int32 flag (the lanes share
#: one int32 buffer); float lanes are bit-cast views of it on the device.
LANE_SPECS = (
    ("sample", np.int32, 0),
    ("temp", np.float32, 1.0),
    ("top_k", np.int32, 0),
    ("top_p", np.float32, 1.0),
    ("rep", np.float32, 1.0),
    ("seed", np.int32, 0),
    ("pos", np.int32, 0),
    ("min_tokens", np.int32, 0),
    ("grammar_row", np.int32, 0),
    ("dfa_state", np.int32, 0),
)


def blank_lanes(num_slots, rep_window):
    """All-inert host lanes (numpy): every slot behaves exactly like the
    plain greedy burst until :func:`set_slot_lane` arms it."""
    lanes = {
        name: np.full((num_slots,), default, dtype=dtype)
        for name, dtype, default in LANE_SPECS
    }
    lanes["rep_ring"] = np.full((num_slots, rep_window), -1, dtype=np.int32)
    return lanes


def set_slot_lane(lanes, slot, params, pos, grammar_row=0, dfa_state=0, recent=()):
    """Arm one slot from its request state. ``pos`` is the number of
    output tokens already emitted — the hash position of the NEXT token,
    recomputed from the request on every dispatch. ``recent`` is the tail of
    the tokens feeding the repetition-penalty ring."""
    lanes["sample"][slot] = int(bool(params.do_sample))
    lanes["temp"][slot] = float(params.temperature)
    lanes["top_k"][slot] = int(params.top_k)
    lanes["top_p"][slot] = float(params.top_p)
    lanes["rep"][slot] = float(params.repetition_penalty)
    lanes["seed"][slot] = np.int32(np.uint32(int(params.seed) & 0xFFFFFFFF))
    lanes["pos"][slot] = int(pos)
    lanes["min_tokens"][slot] = int(params.min_tokens)
    lanes["grammar_row"][slot] = int(grammar_row)
    lanes["dfa_state"][slot] = int(dfa_state)
    ring = lanes["rep_ring"]
    ring[slot, :] = -1
    if recent is not None and params.repetition_penalty != 1.0:
        tail = list(recent)[-ring.shape[1]:]
        if tail:
            ring[slot, : len(tail)] = tail


def clear_slot_lane(lanes, slot):
    for name, dtype, default in LANE_SPECS:
        lanes[name][slot] = dtype(default)
    lanes["rep_ring"][slot, :] = -1


def match_stop(tokens, stop_seqs):
    """Return the length of the stop sequence matched at the tail of
    ``tokens`` (so the caller can trim it), or 0."""
    for seq in stop_seqs:
        n = len(seq)
        if n and len(tokens) >= n and tuple(tokens[-n:]) == tuple(seq):
            return n
    return 0


# --------------------------------------------------------------------------
# device helpers (torch ops on the lanes; captured inside the lane graph)
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in ``[0, 2^32)``, in 16-bit halves
    of ``c`` so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply rounds): every input bit
    reaches every output bit."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def slot_uniforms(engine_seed: int, tag: int, seed_lane: torch.Tensor,
                  pos_lane: torch.Tensor) -> torch.Tensor:
    """One uniform in ``[0, 1)`` per slot, f32, a pure function of
    ``(engine_seed, tag, request seed, output position)``: the counter-based
    stand-in for the JAX package's ``fold_in`` keys. 24 bits of the hash,
    so the float is exact on every device."""
    h = torch.full_like(seed_lane, 0, dtype=torch.int64)
    for v in (int(engine_seed) & _M32, int(tag) & _M32):
        h = _mix32((h + v + _GOLDEN) & _M32)
    for lane in (seed_lane, pos_lane):
        h = _mix32((h + (lane.to(torch.int64) & _M32) + _GOLDEN) & _M32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def apply_filters(logits, lanes, dfa_state, pos, gmask, eos_id):
    """Everything that reshapes the distribution *before* temperature:
    repetition penalty, grammar allow-mask, min-token eos suppression.
    Greedy slots argmax the result, sampled slots feed it to
    :func:`dist_logprobs`, and the reported logprobs are its plain
    log-softmax.

    ``dfa_state`` is passed apart from ``lanes['dfa_state']`` because
    mid-burst steps advance it on the device; ``pos`` is likewise the
    per-step effective position (``lanes['pos'] + step``)."""
    num_slots, vocab = logits.shape
    ring = lanes["rep_ring"]
    # scatter-add of the ring's live entries: -1 pads clamp onto token 0
    # with weight 0, so a pad never marks token 0 present
    present = torch.zeros((num_slots, vocab), dtype=torch.int32, device=logits.device)
    present.scatter_add_(1, ring.clamp(0, vocab - 1).long(), (ring >= 0).to(torch.int32))
    rep = lanes["rep"][:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where((present > 0) & (rep != 1.0), penalized, logits)

    mask = gmask[lanes["grammar_row"].long(), dfa_state.long()]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG))

    if eos_id is not None:
        suppress = pos < lanes["min_tokens"]
        eos_col = torch.arange(vocab, device=logits.device) == int(eos_id)
        logits = logits + torch.where(suppress[:, None] & eos_col[None, :], NEG, 0.0)
    return logits


def dist_logprobs(filtered, lanes):
    """Per-slot temperature + top-k + top-p over already-filtered logits,
    returned as log-probs in original token order (``NEG`` where cut). The
    sort is stable, so equal logits keep token order (JAX's ``top_k``)."""
    num_slots, vocab = filtered.shape
    scaled = scale_logits(filtered, lanes["temp"][:, None])
    vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    k_eff = torch.where(lanes["top_k"] <= 0, torch.full_like(lanes["top_k"], vocab),
                        lanes["top_k"])
    keep_k = torch.arange(vocab, device=filtered.device)[None, :] < k_eff[:, None]
    probs_sorted = torch.softmax(vals, dim=-1)
    csum = torch.cumsum(probs_sorted, dim=-1)
    # keep every token whose preceding cumulative mass is < top_p — the
    # highest-prob token always survives (its preceding mass is 0)
    keep_p = (csum - probs_sorted) < lanes["top_p"][:, None]
    keep = keep_k & keep_p
    neg = torch.full_like(vals, NEG)
    kept = torch.where(keep, vals, neg)
    logp_sorted = torch.log_softmax(kept, dim=-1)
    return torch.full_like(filtered, NEG).scatter(1, idx, torch.where(keep, logp_sorted, neg))


def inverse_cdf_pick(logp: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The token whose CDF interval (token order) holds ``u`` of each row's
    total mass: the first index whose running sum of ``exp(logp)`` exceeds
    ``u * total``. A token of zero mass is never picked."""
    cdf = torch.cumsum(torch.exp(logp), dim=-1)
    target = (u * cdf[:, -1])[:, None].contiguous()
    tok = torch.searchsorted(cdf, target, right=True)[:, 0]
    return tok.clamp_max(logp.shape[-1] - 1).to(torch.int32)


def pick_tokens(logits, lanes, dfa_state, step, gmask, engine_seed, *, eos_id,
                logprobs_topn):
    """The per-slot decode-step pick over f32 logits ``[S, vocab]``. Returns
    ``(tok [S] int32, logp_tok [S], top_vals [S, N], top_ids [S, N] int32)``
    with ``N = max(logprobs_topn, 1)``; reported logprobs are the filtered
    distribution at temperature 1 (the model's distribution, not the
    sampler's). On an inert slot the token is the plain argmax."""
    n = max(int(logprobs_topn), 1)
    pos = lanes["pos"] + step
    filtered = apply_filters(logits.float(), lanes, dfa_state, pos, gmask, eos_id)
    greedy = torch.argmax(filtered, dim=-1).to(torch.int32)
    logp_dist = dist_logprobs(filtered, lanes)
    u = slot_uniforms(engine_seed, TAG_SAMPLE, lanes["seed"], pos)
    sampled = inverse_cdf_pick(logp_dist, u)
    tok = torch.where(lanes["sample"] != 0, sampled, greedy)
    lp = torch.log_softmax(filtered, dim=-1)
    logp_tok = torch.gather(lp, 1, tok.long()[:, None])[:, 0]
    top_vals, top_ids = torch.topk(lp, n, dim=-1)
    return tok, logp_tok, top_vals, top_ids.to(torch.int32)


# --------------------------------------------------------------------------
# speculative rejection sampling
# --------------------------------------------------------------------------


def rejection_accept(d, p, q, u, engine_seed, seed_lane, pos_lane):
    """Standard speculative-sampling acceptance for the sampled slots of a
    verify round (port of JAX ``rejection_accept``).

    ``d [S, k]`` are the draft tokens, ``p [k+1, S, V]`` the target
    probabilities at each draft position (plus the bonus position), ``q [k,
    S, V]`` the draft probabilities the tokens were drawn from, ``u [S, k]``
    the per-position accept uniforms. Draft token ``j`` is accepted while
    ``u_j < min(1, p_j(d_j) / q_j(d_j))``; the first rejection resamples from
    the clamped residual ``max(p - q, 0)``, and a fully-accepted row draws
    its bonus token from ``p_k``. The resample is an inverse-CDF pick whose
    uniform hashes (engine seed, ``TAG_RESAMPLE``, request seed, the output
    position it lands on: ``pos_lane + accept``), so it is as admission-order
    independent as every other draw. Returns ``(accept [S] int32, tok_seq
    [S, k+1] int32)`` shaped like :func:`~..generation.spec_accept_tokens`.

    Grammar masks are already inside ``p`` and ``q`` (both come out of
    :func:`dist_logprobs` over filtered logits): an out-of-language draft has
    target probability 0 and is rejected with certainty, and the residual is
    in-language. Fixed shapes, no host sync."""
    num_slots, k = d.shape
    rows = torch.arange(num_slots, device=d.device)
    dl = d.long()
    p_d = torch.stack([p[j, rows, dl[:, j]] for j in range(k)], dim=1)
    q_d = torch.stack([q[j, rows, dl[:, j]] for j in range(k)], dim=1)
    ok = u < torch.clamp(p_d / torch.clamp(q_d, min=1e-20), max=1.0)
    accept = torch.where(ok.all(dim=1), torch.full_like(dl[:, 0], k),
                         torch.argmin(ok.to(torch.int32), dim=1))
    p_a = p[accept, rows]  # [S, V] target dist at the first-reject position
    q_a = q[torch.clamp(accept, max=k - 1), rows]
    resid = torch.clamp(p_a - q_a, min=0.0)
    bonus = (accept == k)[:, None]
    dist = torch.where(bonus, p_a, resid)
    degenerate = dist.sum(dim=-1, keepdim=True) <= 0.0
    dist = torch.where(degenerate, p_a, dist)
    u_res = slot_uniforms(engine_seed, TAG_RESAMPLE, seed_lane,
                          pos_lane + accept.to(pos_lane.dtype))
    corr = inverse_cdf_pick(torch.log(dist), u_res)
    accept = accept.to(torch.int32)
    d_ext = torch.cat([d, torch.zeros((num_slots, 1), dtype=d.dtype, device=d.device)], dim=1)
    j = torch.arange(k + 1, device=d.device)[None, :]
    a = accept[:, None]
    tok_seq = torch.where(j < a, d_ext,
                          torch.where(j == a, corr[:, None].to(d.dtype), torch.zeros_like(d_ext)))
    return accept, tok_seq.to(torch.int32)
