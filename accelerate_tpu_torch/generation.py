"""Autoregressive generation (port of ``accelerate_tpu/generation.py``):
:func:`generate` over the llama's dense KV cache, its full-forward loop for
models without one, greedy speculative decoding with a separate draft
model, and the token pick and acceptance rules the serving engine shares.

The token buffer has a static shape ``[b, prompt + max_new]`` (right-padded,
mask-tracked), as in JAX. Where JAX compiles a decode chunk as one
``lax.scan`` and the speculative loop as one ``lax.while_loop``, the port
captures one decode step (forward, pick, eos mask, KV append), or one
speculative round, into a CUDA graph over static buffers and replays it: an
eager Python loop would pay its launch latency on every token. The graph is
captured once per key (batch, cache length, sampling, eos, dtype; the
speculative round adds k and the draft) and kept on the model, and captured
anew when the weights it reads have moved to other storage (a dtype round
trip, ``load_state_dict(assign=True)``, a move between devices): the
:data:`_KEPT_PROGRAMS` most recently used keys of a model keep their graphs
and buffers (caches included), an older key's are released, and
:func:`clear_generation_cache` releases them all. On the CPU the same
functions run eagerly over the same static buffers.

Dispatch differs from JAX's in one place: the speculative loop reads its
done flag on the host once a round (JAX runs the whole loop on the device).
The tokens do not differ: greedy speculative output equals plain greedy
output for any draft.

Sampling draws one uniform a row a token from a counter-based hash of
(seed, row, output position) (:func:`~.serving.sampling.slot_uniforms`), so
a graph replay needs no generator state, the same seed gives the same tokens
on every call, and the cached and full-forward paths draw alike. The port
cannot reproduce JAX's sampled bits; greedy decoding equals JAX's token for
token.

A prepared model runs under the precision policy in force when
:func:`generate` is called: its compute dtype and its fp8 recipe, both of
which an ``Accelerator.autocast`` island suspends. Each policy keys its
own programs (the key carries the dtype and the recipe's format), so an
island neither replays a bf16 graph nor captures anew on every call.

An encoder-decoder model (``is_encoder_decoder``: t5) decodes through the
seq2seq loop (:func:`_generate_seq2seq`): the prompt is encoded once and
one decoder forward a token reads the fixed-size decoder buffer, eagerly.

Not ported yet: the streaming ``DispatchedModel`` path (ROADMAP item 19).
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict

import numpy as np
import torch

#: the temperature floor every sampling path divides by
TEMPERATURE_FLOOR = 1e-6

#: decode steps between two reads of the finished flags when an eos can end
#: generation early: wasted steps after every row finished are bounded by one
#: chunk
_EOS_CHUNK = 64

#: graph keys a model keeps (least recently used released first)
_KEPT_PROGRAMS = 2

#: CUDA-graph captures and replays of the generation programs since import
#: (0 on the CPU, where the programs run eagerly)
captures = 0
replays = 0


def scale_logits(logits: torch.Tensor, temperature) -> torch.Tensor:
    """Temperature scaling with the shared floor; ``temperature`` may be a
    float or a tensor broadcast against ``logits``."""
    if isinstance(temperature, torch.Tensor):
        return logits / torch.clamp(temperature, min=TEMPERATURE_FLOOR)
    return logits / max(float(temperature), TEMPERATURE_FLOOR)


def pick_next_token(logits, u, finished, eos_id, temperature, do_sample, has_eos):
    """THE token pick: greedy ``argmax`` (the first maximal index, as
    ``jnp.argmax``), or a temperature-scaled categorical draw that inverts
    the CDF at ``u`` (``[b]`` uniforms, :func:`_uniforms`; unused when
    greedy). With ``has_eos``, finished rows keep emitting ``eos_id`` (an
    int or a 0-dim tensor). Returns ``(int32 tokens, finished)``. Fixed
    shapes, no host sync: a CUDA graph captures it."""
    if do_sample:
        from .serving.sampling import inverse_cdf_pick

        logp = torch.log_softmax(scale_logits(logits.float(), temperature), dim=-1)
        tok = inverse_cdf_pick(logp, u)
    else:
        tok = torch.argmax(logits, dim=-1)
    tok = tok.to(torch.int32)
    if has_eos:
        tok = torch.where(finished, eos_id, tok).to(torch.int32)
        finished = finished | (tok == eos_id)
    return tok, finished


def spec_accept_tokens(d: torch.Tensor, preds: torch.Tensor):
    """Greedy speculative acceptance — the single source of the accept/emit
    token math for :func:`generate`'s speculative round and the serving
    engine's spec programs (port of JAX ``spec_accept_tokens``).

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


def _row_seeds(seed: int, b: int) -> np.ndarray:
    """One 32-bit lane a row from ``(seed, row)``: the request-seed lane of
    :func:`_uniforms`."""
    return np.asarray([(int(seed) * 0x9E3779B1 + row * 0x85EBCA77) & 0xFFFFFFFF
                       for row in range(b)], np.int64)


def _uniforms(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """``[b]`` uniforms for the tokens landing at ``positions`` (each row's
    output position), from the rows' seed lanes."""
    from .serving.sampling import TAG_SAMPLE, slot_uniforms

    return slot_uniforms(0, TAG_SAMPLE, seeds, positions)


def _logits_of(out):
    return out["logits"] if isinstance(out, dict) else out.logits


class _Backend:
    """A model's dense-cache forward: ``self(input_ids=..., attention_mask=...,
    use_cache=True, max_cache_len=...)`` is the prefill and ``self(input_ids=...,
    kv_cache=..., cache_index=...)`` a decode step. ``owner`` keeps the
    captured programs; ``weights`` (a prepared model's compute-dtype copies,
    refreshed once a :func:`generate` call) replace the module's parameters,
    or ``None`` runs the module's own; ``fp8`` is the fp8 recipe's format
    (``"HYBRID"`` or ``"E4M3"``) the projections run under, or ``None``."""

    def __init__(self, owner, module, weights, dtype, fp8=None):
        self.owner = owner
        self.module = module
        self.weights = weights
        self.dtype = dtype
        self.fp8 = fp8
        self.device = module.device
        self.config = module.config

    @property
    def policy(self) -> tuple:
        """What a kept program is keyed by besides its shapes."""
        return self.dtype, self.fp8

    def __call__(self, **kw):
        from .ops.fp8 import fp8_autocast

        with fp8_autocast(fp8_format=self.fp8) if self.fp8 else contextlib.nullcontext():
            if self.weights is None:
                return self.module(**kw)
            return torch.func.functional_call(self.module, self.weights, (), kw)

    def storage(self) -> tuple:
        """Where the tensors a captured graph reads in place lie: the
        weight copies or the module's parameters, and its buffers."""
        tensors = dict(self.module.named_parameters())
        tensors.update(self.weights or {})
        return tuple(t.data_ptr() for t in (*tensors.values(), *self.module.buffers()))


def _cache_backend(model):
    """The :class:`_Backend` of a model that supports the dense KV-cache
    decode path (``supports_kv_cache``), else ``None``.

    A :class:`~.modules.PreparedModel` runs at its current
    ``compute_dtype`` and ``fp8_recipe``, read here, once a call: its
    floating parameters are cast into one persistent copy a dtype (the
    weights cannot change inside a call, and a cast a token would cost more
    than the step), and a captured graph reads that copy in place."""
    from .modules import PreparedModel

    if isinstance(model, PreparedModel):
        inner = model.module
        if not getattr(inner, "supports_kv_cache", False):
            return None
        dtype = model.compute_dtype
        fp8 = model.fp8_recipe.fp8_format.upper() if model.fp8_recipe is not None else None
        if dtype is None:
            return _Backend(model, inner, None, inner.dtype, fp8)
        store = model.__dict__.setdefault("_generation_weights", {})
        params = [(n, p) for n, p in inner.named_parameters() if p.is_floating_point()]
        weights = store.get(dtype)
        if weights is None:
            weights = store[dtype] = {n: torch.empty_like(p, dtype=dtype) for n, p in params}
        with torch.no_grad():
            for n, p in params:
                weights[n].copy_(p)
        return _Backend(model, inner, weights, dtype, fp8)
    if isinstance(model, torch.nn.Module) and getattr(model, "supports_kv_cache", False):
        return _Backend(model, model, None, model.dtype)
    return None


def clear_generation_cache(model) -> None:
    """Release the captured programs and static buffers (KV caches
    included) that :func:`generate` keeps on ``model``, and a prepared
    model's compute-dtype weight copies."""
    for name in ("_generation_programs", "_generation_weights"):
        model.__dict__.pop(name, None)


def _program_for(owner, key, build, storage: tuple):
    """The program kept on ``owner`` under ``key``, built on a miss or when
    the weights it reads lie elsewhere than at its capture (``storage``,
    :meth:`_Backend.storage`): a graph replayed over freed weights would
    read garbage. The :data:`_KEPT_PROGRAMS` most recently used stay."""
    store = owner.__dict__.get("_generation_programs")
    if store is None:
        store = owner.__dict__["_generation_programs"] = OrderedDict()
    program = store.get(key)
    if program is None or program.storage != storage:
        program = store[key] = build()
        program.storage = storage
        while len(store) > _KEPT_PROGRAMS:
            store.popitem(last=False)
    store.move_to_end(key)
    return program


class _StaticProgram:
    """A fixed-shape function over static buffers, run through the serving
    engine's ``_Program``: captured into a CUDA graph at its first run on
    the card and replayed after; eager on the CPU."""

    def __init__(self, name: str, fn, device: torch.device):
        from .serving.engine import _Program

        self.program = _Program(name, fn, device, None)

    def run(self, upload=None) -> None:
        global captures, replays
        p = self.program
        before = (p.captures, p.replays)
        p.run(upload or (lambda: None))
        captures += p.captures - before[0]
        replays += p.replays - before[1]


class _DecodeProgram(_StaticProgram):
    """One cached decode step (port of ``_scan_decode_for``'s scan body):
    the forward of ``tok`` at ``pos``, the pick, the eos mask and the KV
    append, over static buffers. Step ``i``'s token lands in ``toks[i]``.
    The caches carry a spare slot past their ``total`` positions
    (:func:`~.ops.layers.write_kv_cache`), so the append needs no
    read-back."""

    def __init__(self, backend, b: int, total: int, do_sample: bool, has_eos: bool):
        dev = backend.device
        shape = backend.module.kv_cache_shape(b, total + 1)
        self.kv = {n: torch.zeros(shape, dtype=backend.dtype, device=dev) for n in "kv"}
        self.tok = torch.zeros(b, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
        self.toks = torch.zeros((total, b), dtype=torch.int32, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.seeds = torch.zeros(b, dtype=torch.int64, device=dev)
        self.temperature = torch.ones((), dtype=torch.float32, device=dev)
        self.eos = torch.zeros((), dtype=torch.int64, device=dev)

        def step():
            out = backend(input_ids=self.tok[:, None], kv_cache=self.kv, cache_index=self.pos,
                          spare_slot=True)
            u = _uniforms(self.seeds, self.pos + 1) if do_sample else None
            nxt, fin = pick_next_token(_logits_of(out)[:, 0, :], u, self.finished, self.eos,
                                       self.temperature, do_sample, has_eos)
            self.toks.index_copy_(0, self.step, nxt[None])
            self.tok.copy_(nxt)
            self.finished.copy_(fin)
            self.pos.add_(1)
            self.step.add_(1)

        super().__init__("generate_decode", step, dev)


def _scan_decode_for(backend, b, total, do_sample, has_eos) -> _DecodeProgram:
    key = ("decode", b, total, bool(do_sample), bool(has_eos), backend.policy)
    return _program_for(backend.owner, key,
                        lambda: _DecodeProgram(backend, b, total, do_sample, has_eos),
                        backend.storage())


def _as_ids(input_ids) -> np.ndarray:
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.detach().cpu().numpy()
    ids = np.asarray(input_ids, dtype=np.int32)
    return ids[None, :] if ids.ndim == 1 else ids


def _mask_of(attention_mask, b: int, prompt_len: int) -> np.ndarray:
    if attention_mask is None:
        return np.ones((b, prompt_len), np.int32)
    if isinstance(attention_mask, torch.Tensor):
        attention_mask = attention_mask.detach().cpu().numpy()
    mask = np.atleast_2d(np.asarray(attention_mask, np.int32))
    if mask.shape != (b, prompt_len):
        raise ValueError(
            f"attention_mask shape {mask.shape} does not match input_ids {(b, prompt_len)}"
        )
    return mask


def _device_of(model, input_ids) -> torch.device:
    device = getattr(model, "device", None)
    if device is not None:
        return torch.device(device)
    if isinstance(input_ids, torch.Tensor):
        return input_ids.device
    from .utils.device import resolve_device

    return resolve_device(None)


def _result(buf: np.ndarray, input_ids) -> torch.Tensor:
    out = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.int32))
    return out.to(input_ids.device) if isinstance(input_ids, torch.Tensor) else out


def generate(
    model,
    input_ids,
    max_new_tokens: int = 20,
    do_sample: bool = False,
    temperature: float = 1.0,
    eos_token_id: int | None = None,
    seed: int = 0,
    attention_mask=None,
    use_cache: bool = False,
    draft_model=None,
    num_draft_tokens: int = 5,
):
    """Greedy / temperature-sampled decoding. Returns ``[b, prompt+new]``
    int32 token ids (right-padded with ``eos`` after a sequence finishes),
    on ``input_ids``' device when it is a tensor, else on the CPU.

    ``model`` runs on its own device (the card unless it was built on the
    CPU). ``use_cache=True`` runs prefill-then-decode over a dense KV cache
    when the model declares ``supports_kv_cache`` (a
    :class:`~.models.llama.LlamaForCausalLM`, or a prepared one); other
    models silently use the full-forward path, which is equally correct.
    An encoder-decoder model (t5) returns ``[b, 1 + new]`` decoder tokens
    from its start token (:func:`_generate_seq2seq`). ``draft_model`` runs greedy speculative decoding: the draft proposes
    ``num_draft_tokens`` tokens a round and the target verifies them in
    one forward."""
    from .telemetry import get_active_recorder

    tel = get_active_recorder()
    t0 = time.perf_counter()
    with torch.no_grad():
        if _is_encoder_decoder(model):
            out = _generate_seq2seq(model, input_ids, max_new_tokens, do_sample, temperature,
                                    eos_token_id, seed, attention_mask)
            if tel:
                tel.record_generation(mode="seq2seq", new_tokens=int(out.shape[0]) * (
                    int(out.shape[1]) - 1), seconds=time.perf_counter() - t0)
            return _result(out, input_ids)
        if draft_model is not None:
            if do_sample:
                raise NotImplementedError(
                    "speculative decoding is greedy-only: rejection sampling for "
                    "do_sample=True is not implemented (pass do_sample=False)"
                )
            if int(num_draft_tokens) < 1:
                raise ValueError(
                    f"num_draft_tokens must be >= 1, got {num_draft_tokens}: the "
                    "speculative loop drafts k tokens per verify round — k < 1 "
                    "would verify nothing and never advance"
                )
            target = _cache_backend(model)
            draft = _cache_backend(draft_model)
            if target is None or draft is None:
                raise ValueError(
                    "draft_model decoding needs KV-cache support on both models "
                    "(supports_kv_cache on a module or a prepared model); got "
                    f"target={'ok' if target else 'unsupported'}, "
                    f"draft={'ok' if draft else 'unsupported'}"
                )
            config = getattr(model, "config", None)
            out = _generate_speculative(
                target, draft, input_ids, max_new_tokens, int(num_draft_tokens),
                eos_token_id, attention_mask,
                max_positions=getattr(config, "max_position_embeddings", None),
            )
            return _result(out, input_ids)
        if use_cache:
            backend = _cache_backend(model)
            if backend is not None:
                out = _generate_cached(
                    backend, input_ids, max_new_tokens, do_sample, temperature,
                    eos_token_id, seed, attention_mask,
                )
                if tel:
                    prompt_len = _as_ids(input_ids).shape[1]
                    tel.record_generation(
                        mode="kv_cache",
                        new_tokens=int(out.shape[0]) * max(int(out.shape[1]) - prompt_len, 0),
                        seconds=time.perf_counter() - t0,
                    )
                return _result(out, input_ids)
        out = _generate_full_forward(model, input_ids, max_new_tokens, do_sample, temperature,
                                     eos_token_id, seed, attention_mask)
    if tel:
        tel.record_generation(
            mode="full_forward",
            new_tokens=int(out.shape[0]) * max(int(out.shape[1]) - _as_ids(input_ids).shape[1], 0),
            seconds=time.perf_counter() - t0,
        )
    return _result(out, input_ids)


def _pick_next(logits, do_sample, temperature, u, finished, eos_token_id):
    """Host-side shim over :func:`pick_next_token` for the full-forward
    loop: same rule, numpy finished flags in and out."""
    has_eos = eos_token_id is not None
    fin = torch.as_tensor(finished, device=logits.device)
    tok, fin = pick_next_token(logits, u, fin, eos_token_id if has_eos else 0, temperature,
                               do_sample, has_eos)
    return tok.cpu().numpy(), fin.cpu().numpy()


def _generate_full_forward(model, input_ids, max_new_tokens, do_sample, temperature,
                           eos_token_id, seed, attention_mask):
    """One full forward a token over the whole static buffer (JAX's
    full-forward loop): exact for a causal model, since the logits at a
    row's last real position do not see the padded tail."""
    ids = _as_ids(input_ids)
    b, prompt_len = ids.shape
    total = prompt_len + max_new_tokens
    buf = np.zeros((b, total), np.int32)
    buf[:, :prompt_len] = ids
    mask = np.zeros((b, total), np.int32)
    if attention_mask is not None:
        if isinstance(attention_mask, torch.Tensor):
            attention_mask = attention_mask.detach().cpu().numpy()
        mask[:, :prompt_len] = np.asarray(attention_mask)
    else:
        mask[:, :prompt_len] = 1
    # per-row decode position: right-padded shorter prompts continue from
    # THEIR last real token, not the batch-uniform column
    lengths = mask.sum(axis=1).astype(np.int64)

    dev = _device_of(model, input_ids)
    seeds = torch.as_tensor(_row_seeds(seed, b), device=dev)
    finished = np.zeros((b,), bool)
    rows = np.arange(b)
    for _ in range(max_new_tokens):
        out = model(input_ids=torch.as_tensor(buf, device=dev),
                    attention_mask=torch.as_tensor(mask, device=dev))
        lengths_t = torch.as_tensor(lengths, device=dev)
        logits = _logits_of(out)[torch.as_tensor(rows, device=dev), lengths_t - 1, :]
        u = _uniforms(seeds, lengths_t) if do_sample else None
        next_tok, finished = _pick_next(logits, do_sample, temperature, u, finished,
                                        eos_token_id)
        buf[rows, lengths] = next_tok
        mask[rows, lengths] = 1
        lengths += 1
        if eos_token_id is not None and finished.all():
            break
    return buf[:, : int(lengths.max())]


def _is_encoder_decoder(model) -> bool:
    """The flag of the model, or of the module under a prepared model."""
    return bool(getattr(model, "is_encoder_decoder", False)
                or getattr(getattr(model, "module", None), "is_encoder_decoder", False))


def _generate_seq2seq(model, input_ids, max_new_tokens, do_sample, temperature,
                      eos_token_id, seed, attention_mask):
    """Greedy / sampled seq2seq decoding (port of JAX ``_generate_seq2seq``):
    the encoder's prompt is fixed and tokens fill a ``[b, 1 + max_new]``
    decoder buffer from the config's ``decoder_start_token_id``. Decoder
    self-attention is causal and cross-attention per position, so the
    buffer's unwritten tail cannot reach the position read: one shape
    serves every step. The encoder runs once (its output is fed back as
    ``encoder_outputs``), then one decoder forward a token, through the
    model's own call (a prepared model's precision policy included)."""
    config = getattr(model, "config", None)
    start_id = int(getattr(config, "decoder_start_token_id", 0) or 0)
    ids = _as_ids(input_ids)
    b, prompt_len = ids.shape
    dev = _device_of(model, input_ids)
    ids_t = torch.as_tensor(ids, device=dev)
    mask_t = torch.as_tensor(_mask_of(attention_mask, b, prompt_len), device=dev)
    total = 1 + max_new_tokens
    dec = torch.full((b, total), start_id, dtype=torch.int64, device=dev)
    enc = model(input_ids=ids_t, attention_mask=mask_t,
                decoder_input_ids=dec[:, :1])["encoder_last_hidden_state"]
    seeds = torch.as_tensor(_row_seeds(seed, b), device=dev)
    finished = np.zeros((b,), bool)
    n_written = 0
    for t in range(max_new_tokens):
        logits = _logits_of(model(input_ids=ids_t, attention_mask=mask_t, encoder_outputs=enc,
                                  decoder_input_ids=dec))[:, t, :]
        u = _uniforms(seeds, torch.full((b,), t + 1, device=dev)) if do_sample else None
        next_tok, finished = _pick_next(logits, do_sample, temperature, u, finished,
                                        eos_token_id)
        dec[:, t + 1] = torch.as_tensor(next_tok, device=dev)
        n_written = t + 1
        if eos_token_id is not None and finished.all():
            break
    return dec[:, : 1 + n_written].cpu().numpy()


def _generate_cached(backend, input_ids, max_new_tokens, do_sample, temperature,
                     eos_token_id, seed, attention_mask):
    """Prefill + per-token cached decode (the llama's ``use_cache`` and
    ``kv_cache=`` modes). Each decode step appends K/V at every row's own
    position, so ragged right-padded prompts behave exactly like the
    full-forward path."""
    ids = _as_ids(input_ids)
    b, prompt_len = ids.shape
    total = prompt_len + max_new_tokens
    mask = _mask_of(attention_mask, b, prompt_len)
    lengths = mask.sum(axis=1).astype(np.int64)
    buf = np.zeros((b, total), np.int32)
    buf[:, :prompt_len] = ids
    if max_new_tokens <= 0:
        return buf[:, : int(lengths.max())] if lengths.size else buf

    dev = backend.device
    has_eos = eos_token_id is not None
    out = backend(input_ids=torch.as_tensor(ids, device=dev),
                  attention_mask=torch.as_tensor(mask, device=dev),
                  use_cache=True, max_cache_len=total)
    lengths_t = torch.as_tensor(lengths, device=dev)
    logits0 = _logits_of(out)[torch.arange(b, device=dev), lengths_t - 1, :]
    seeds = torch.as_tensor(_row_seeds(seed, b), device=dev)
    u0 = _uniforms(seeds, lengths_t) if do_sample else None
    tok0, fin0 = pick_next_token(logits0, u0, torch.zeros(b, dtype=torch.bool, device=dev),
                                 eos_token_id if has_eos else 0, temperature, do_sample,
                                 has_eos)

    prog = _scan_decode_for(backend, b, total, do_sample, has_eos)

    def upload():
        for n in "kv":
            prog.kv[n][:, :, :total].copy_(out["kv_cache"][n])
        prog.tok.copy_(tok0)
        prog.pos.copy_(lengths_t)
        prog.finished.copy_(fin0)
        prog.step.zero_()
        prog.seeds.copy_(seeds)
        prog.temperature.fill_(float(temperature))
        prog.eos.fill_(int(eos_token_id) if has_eos else 0)

    steps_left = max_new_tokens - 1
    steps = 0
    while steps_left > 0:
        # no eos → nothing can stop early: one chunk for the whole decode
        chunk = min(_EOS_CHUNK, steps_left) if has_eos else steps_left
        for _ in range(chunk):
            prog.run(upload if steps == 0 else None)
            steps += 1
        steps_left -= chunk
        if has_eos and steps_left > 0 and bool(prog.finished.all()):
            break
    del out
    toks = torch.cat([tok0[None, :], prog.toks[:steps]], dim=0).cpu().numpy()  # [n, b]

    # trim to the step where every row had finished — the same stopping
    # point a per-step loop with an all-finished break produces
    if has_eos:
        finished_by = np.cumsum(toks == eos_token_id, axis=0) > 0
        all_fin = finished_by.all(axis=1)
        n_emit = int(np.argmax(all_fin)) + 1 if all_fin.any() else toks.shape[0]
    else:
        n_emit = toks.shape[0]
    rows = np.arange(b)
    for s in range(n_emit):
        buf[rows, lengths] = toks[s]
        lengths += 1
    return buf[:, : int(lengths.max())]


class _SpecProgram(_StaticProgram):
    """One speculative round (port of ``_spec_loop_for``'s loop body) over
    static buffers: ``k`` greedy draft steps from the pending token, the
    feed-only push of the last draft token (so the draft cache never has a
    hole), one target forward over ``[pending, d_1 .. d_k]``,
    :func:`spec_accept_tokens`, and the emit into ``buf``. ``done`` says
    whether every row has finished or spent its budget. The caches carry a
    spare slot past their ``cache_len`` positions that takes the writes
    dropped near an exact-fit budget (:func:`~.ops.layers.write_kv_cache`)."""

    def __init__(self, target, draft, b, total, cache_len, k, has_eos):
        dev = target.device
        self.kv_t = {n: torch.zeros(target.module.kv_cache_shape(b, cache_len + 1),
                                    dtype=target.dtype, device=dev) for n in "kv"}
        self.kv_d = {n: torch.zeros(draft.module.kv_cache_shape(b, cache_len + 1),
                                    dtype=draft.dtype, device=dev) for n in "kv"}
        # column ``total`` takes the dropped writes (JAX's mode="drop")
        self.buf = torch.zeros((b, total + 1), dtype=torch.int32, device=dev)
        self.lengths = torch.zeros(b, dtype=torch.int64, device=dev)
        self.emitted = torch.zeros(b, dtype=torch.int64, device=dev)
        self.pending = torch.zeros(b, dtype=torch.int64, device=dev)
        self.pos = torch.zeros(b, dtype=torch.int64, device=dev)
        self.finished = torch.zeros(b, dtype=torch.bool, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.eos = torch.zeros((), dtype=torch.int64, device=dev)
        self.max_new = torch.zeros((), dtype=torch.int64, device=dev)
        self.draft_owner = draft.owner  # the graph reads the draft's weights
        cache_limit = cache_len - k - 2
        j = torch.arange(k + 1, device=dev)[None, :]

        def round_body():
            tok, p, ds = self.pending, self.pos, []
            for _ in range(k):
                out = draft(input_ids=tok[:, None], kv_cache=self.kv_d, cache_index=p,
                            spare_slot=True)
                tok = torch.argmax(_logits_of(out)[:, 0, :], dim=-1)
                ds.append(tok)
                p = p + 1
            draft(input_ids=tok[:, None], kv_cache=self.kv_d, cache_index=p, spare_slot=True)
            d = torch.stack(ds, dim=1).to(torch.int32)  # [b, k]
            chunk = torch.cat([self.pending[:, None], d.long()], dim=1)
            out_t = target(input_ids=chunk, kv_cache=self.kv_t, cache_index=self.pos,
                           spare_slot=True)
            preds = torch.argmax(_logits_of(out_t), dim=-1).to(torch.int32)  # [b, k+1]
            accept, tok_seq = spec_accept_tokens(d, preds)
            corr = torch.gather(tok_seq, 1, accept.long()[:, None])  # [b, 1]

            # emit as the sequential rule does: skip finished rows, cut a run
            # at its first eos, cap at the token budget
            base = j <= accept[:, None]
            if has_eos:
                is_eos = (tok_seq == self.eos).to(torch.int64)
                prior_eos = torch.cumsum(is_eos, dim=1) - is_eos
                base = base & (prior_eos == 0) & (~self.finished)[:, None]
            base_i = base.to(torch.int64)
            cnt_before = torch.cumsum(base_i, dim=1) - base_i
            valid = base & (self.emitted[:, None] + cnt_before < self.max_new)
            write_pos = torch.where(valid, self.lengths[:, None] + cnt_before,
                                    torch.full_like(cnt_before, total))
            self.buf.scatter_(1, write_pos, tok_seq)
            n_row = valid.to(torch.int64).sum(dim=1)
            self.emitted.add_(n_row)
            self.lengths.add_(n_row)
            if has_eos:
                self.finished.logical_or_((valid & (tok_seq == self.eos)).any(dim=1))
            self.pending.copy_(corr[:, 0])
            pos = self.pos + accept + 1
            # done rows keep riding the batch; pin their write position
            # inside the cache margin so their (ignored) chunks never clip
            done = self.finished | (self.emitted >= self.max_new)
            self.pos.copy_(torch.where(done, pos.clamp(max=cache_limit), pos))
            self.done.copy_(done.all())

        super().__init__("generate_spec", round_body, dev)


def _spec_loop_for(target, draft, b, total, cache_len, k, has_eos) -> _SpecProgram:
    key = ("spec", b, total, cache_len, k, bool(has_eos), target.policy, id(draft.owner),
           draft.policy)
    return _program_for(target.owner, key,
                        lambda: _SpecProgram(target, draft, b, total, cache_len, k, has_eos),
                        target.storage() + draft.storage())


def _generate_speculative(target, draft, input_ids, max_new_tokens, k, eos_token_id,
                          attention_mask, max_positions: int | None = None):
    """Greedy speculative decoding (the reference has no analog): a cheap
    draft model proposes ``k`` tokens autoregressively, the target scores
    all of them in ONE chunked decode forward (s = k+1), and the longest
    matching prefix plus the target's own next token are accepted. The
    emitted sequence equals plain greedy decoding of the target for ANY
    draft. Cache rollback is free: :func:`~.ops.layers.cached_attention`
    masks every position past each row's own index, so rejected draft
    entries are never attended and are overwritten by later appends."""
    t_start = time.perf_counter()
    ids = _as_ids(input_ids)
    b, prompt_len = ids.shape
    mask = _mask_of(attention_mask, b, prompt_len)
    lengths = mask.sum(axis=1).astype(np.int64)
    total = prompt_len + max_new_tokens
    # verify chunks may overshoot a row's budget by up to k; both caches
    # carry the margin so the write never drops a live row's token. Near an
    # exact-fit budget (total == max_position_embeddings) the margin is
    # clamped: overshoot writes past the cache end are DROPPED
    # (ops.layers.write_kv_cache) and belong to tokens past the budget,
    # which are never emitted.
    cache_len = total + k + 1
    if max_positions is not None:
        if total > int(max_positions):
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds max_position_embeddings {max_positions}: "
                "emitted tokens would fall past the position table"
            )
        cache_len = min(cache_len, int(max_positions))
    buf = np.zeros((b, total), np.int32)
    buf[:, :prompt_len] = ids
    if max_new_tokens <= 0:
        return buf[:, : int(lengths.max())] if lengths.size else buf

    has_eos = eos_token_id is not None
    dev = target.device
    ids_t = torch.as_tensor(ids, device=dev)
    mask_t = torch.as_tensor(mask, device=dev)
    out_t = target(input_ids=ids_t, attention_mask=mask_t, use_cache=True,
                   max_cache_len=cache_len)
    out_d = draft(input_ids=ids_t, attention_mask=mask_t, use_cache=True,
                  max_cache_len=cache_len)
    rows = np.arange(b)
    logits0 = _logits_of(out_t)[torch.arange(b, device=dev),
                                torch.as_tensor(lengths - 1, device=dev), :]
    pending = torch.argmax(logits0, dim=-1).cpu().numpy().astype(np.int64)

    # next cache slot == count of CACHED tokens: the prompt only — the
    # pending pick is not yet fed, its K/V lands in the first draft step
    pos = lengths.copy()
    # the prefill pick is the first emitted token (each round emits its
    # accepted drafts plus the correction, which becomes the next round's
    # pending — so only this one is host-emitted)
    emitted = np.zeros((b,), np.int64)
    finished = np.zeros((b,), bool)
    for row in rows:
        buf[row, lengths[row]] = pending[row]
        lengths[row] += 1
        emitted[row] += 1
        if has_eos and pending[row] == eos_token_id:
            finished[row] = True

    prog = _spec_loop_for(target, draft, b, total, cache_len, k, has_eos)

    def upload():
        for n in "kv":
            prog.kv_t[n][:, :, :cache_len].copy_(out_t["kv_cache"][n])
            prog.kv_d[n][:, :, :cache_len].copy_(out_d["kv_cache"][n])
        prog.buf[:, :total].copy_(torch.as_tensor(buf))
        prog.lengths.copy_(torch.as_tensor(lengths))
        prog.emitted.copy_(torch.as_tensor(emitted))
        prog.pending.copy_(torch.as_tensor(pending))
        prog.pos.copy_(torch.as_tensor(pos))
        prog.finished.copy_(torch.as_tensor(finished))
        prog.eos.fill_(int(eos_token_id) if has_eos else 0)
        prog.max_new.fill_(int(max_new_tokens))

    rounds = 0
    done = bool((finished | (emitted >= max_new_tokens)).all())
    while not done:
        prog.run(upload if rounds == 0 else None)
        rounds += 1
        done = bool(prog.done)
    if rounds:
        buf = prog.buf[:, :total].cpu().numpy().copy()
        lengths = prog.lengths.cpu().numpy().astype(np.int64)
        emitted = prog.emitted.cpu().numpy()
    del out_t, out_d

    from .telemetry import get_active_recorder

    tel = get_active_recorder()
    if tel:
        loop_tokens = int(emitted.sum()) - b  # first token was host-emitted
        tel.record_generation(
            mode="speculative",
            new_tokens=int(emitted.sum()),
            seconds=time.perf_counter() - t_start,
            # aggregate acceptance: fraction of the k+1 tokens each verify
            # round could emit that were actually emitted
            accept_rate=(loop_tokens / (rounds * b * (k + 1))) if rounds else None,
            verify_rounds=rounds,
        )

    # eos-finished rows pad with eos to the step the LAST row stopped at —
    # the same column the all-finished break of the plain loops produces
    if has_eos:
        n_emit = int(emitted.max())
        for row in rows:
            while emitted[row] < n_emit and lengths[row] < total:
                buf[row, lengths[row]] = eos_token_id
                lengths[row] += 1
                emitted[row] += 1
    return buf[:, : int(lengths.max())]
