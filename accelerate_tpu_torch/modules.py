"""Model output container (port of ``ModelOutput`` from
``accelerate_tpu/modules.py``; ``Model``/``PreparedModel`` are training-side
and not ported yet)."""

from __future__ import annotations


class ModelOutput(dict):
    """Dict with attribute access (``out.logits`` / ``out.loss``), the
    transformers-style output object."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value
