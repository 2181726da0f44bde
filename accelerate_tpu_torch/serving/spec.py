"""Speculative-decoding draft specs for the serving engine (a copy of
``accelerate_tpu/serving/spec.py``: pure Python, the same messages).

One tiny parser shared by ``EngineConfig(draft=...)`` and ``serve --draft``
so every surface agrees on what a draft string means and rejects the same
garbage with the same message.

The shipped draft family is ``"early_exit:N"`` — the target's own first
``N`` layers plus its embeddings/final norm/head. It is the one draft whose KV state is a
strict subset of the target's paged pool (identical weights ⇒ identical
K/V for the shared layers), which is what lets the engine run speculation
without a second cache and without teaching prefix sharing, copy-on-write,
or swap preemption anything new. A path to a companion draft checkpoint is
reserved syntax: a companion model needs its own paged pool with full
CoW/swap/radix maintenance, which this engine does not grow until a
trained companion exists to justify it — the refusal says so instead of
silently serving wrong tokens.
"""

from __future__ import annotations

from dataclasses import dataclass

#: the draft family the engine implements
EARLY_EXIT_PREFIX = "early_exit:"


@dataclass(frozen=True)
class DraftSpec:
    """Parsed ``EngineConfig.draft``. ``kind`` is ``"early_exit"``;
    ``layers`` the draft's depth (< the target's)."""

    kind: str
    layers: int

    def __str__(self) -> str:  # the normalized form stats()/telemetry report
        return f"{self.kind}:{self.layers}"


def parse_draft_spec(draft: str, num_layers: int | None = None) -> DraftSpec:
    """``"early_exit:2"`` → :class:`DraftSpec`. ``num_layers`` (the target's
    depth, when known) bounds the early-exit depth: a draft as deep as the
    target verifies nothing it didn't already compute. Raises ValueError
    with guidance on any other string — including a companion-checkpoint
    path, which is recognised and refused explicitly."""
    if not isinstance(draft, str) or not draft.strip():
        raise ValueError(
            f"malformed draft spec {draft!r}: want 'early_exit:N' "
            "(the target's first N layers as the draft)"
        )
    draft = draft.strip()
    if draft.startswith(EARLY_EXIT_PREFIX):
        raw = draft[len(EARLY_EXIT_PREFIX):]
        try:
            layers = int(raw)
        except ValueError:
            raise ValueError(
                f"malformed draft spec {draft!r}: the early-exit depth "
                f"{raw!r} is not an integer"
            ) from None
        if layers < 1:
            raise ValueError(
                f"early-exit draft depth must be >= 1, got {layers}"
            )
        if num_layers is not None and layers >= num_layers:
            raise ValueError(
                f"early-exit draft depth {layers} must be < the target's "
                f"{num_layers} layers: a full-depth draft IS the target and "
                "speculation would verify its own output"
            )
        return DraftSpec(kind="early_exit", layers=layers)
    if "/" in draft or draft.endswith((".ckpt", ".safetensors", ".msgpack")):
        raise ValueError(
            f"companion draft checkpoints ({draft!r}) are not supported yet: "
            "a separate draft model needs its own paged KV pool with "
            "CoW/swap/radix maintenance. Use draft='early_exit:N' — the "
            "target's first N layers share the target's pool for free"
        )
    raise ValueError(
        f"unknown draft spec {draft!r}: want 'early_exit:N'"
    )
