"""Environment-variable parsing helpers (a copy of
``accelerate_tpu/utils/environment.py``, which the port may not import):
the same string→bool/int coercion, keyed on ``ACCELERATE_*`` variables, so
a launcher's environment reads the same in both packages."""

from __future__ import annotations

import contextlib
import os
from typing import Any

_TRUE = {"1", "true", "yes", "on", "y", "t"}
_FALSE = {"0", "false", "no", "off", "n", "f", ""}


def str_to_bool(value: str) -> int:
    """Coerce an env-var string to 0/1; raises ``ValueError`` on anything else."""
    value = value.lower().strip()
    if value in _TRUE:
        return 1
    if value in _FALSE:
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def get_int_from_env(env_keys: list[str], default: int) -> int:
    """First present env var from ``env_keys`` parsed as int, else ``default``."""
    for key in env_keys:
        val = int(os.environ.get(key, -1))
        if val >= 0:
            return val
    return default


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key, str(default))
    try:
        return bool(str_to_bool(value))
    except ValueError:
        return default


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


@contextlib.contextmanager
def patch_environment(**kwargs: Any):
    """Temporarily set (upper-cased) env vars; the old values come back on exit."""
    existing = {}
    for key, value in kwargs.items():
        key = key.upper()
        existing[key] = os.environ.get(key)
        os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, old in existing.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old
