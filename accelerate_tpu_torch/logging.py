"""Multi-process-aware logging (port of ``accelerate_tpu/logging.py``):
``main_process_only=True`` by default, ``in_order=True`` logs rank by rank
with a barrier between ranks."""

from __future__ import annotations

import functools
import logging
import os


class MultiProcessAdapter(logging.LoggerAdapter):
    """Logs only on the main process unless a call passes
    ``main_process_only=False``; ``in_order=True`` serialises the output
    rank by rank (every rank must make the call)."""

    def log(self, level, msg, *args, **kwargs):
        if not self.isEnabledFor(level):
            return
        main_process_only = kwargs.pop("main_process_only", True)
        in_order = kwargs.pop("in_order", False)
        kwargs.setdefault("stacklevel", 2)

        from .state import PartialState

        state = PartialState()
        if not in_order:
            if not main_process_only or state.is_main_process:
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, msg, *args, **kwargs)
            return
        for i in range(state.num_processes):
            if i == state.process_index:
                msg, kwargs = self.process(msg, kwargs)
                self.logger.log(level, f"[rank {i}] {msg}", *args, **kwargs)
            state.wait_for_everyone()

    @functools.lru_cache(None)
    def warning_once(self, *args, **kwargs):
        self.warning(*args, **kwargs)


def get_logger(name: str, log_level: str | None = None) -> MultiProcessAdapter:
    """A :class:`MultiProcessAdapter` over ``logging.getLogger(name)``;
    honours ``ACCELERATE_LOG_LEVEL``."""
    if log_level is None:
        log_level = os.environ.get("ACCELERATE_LOG_LEVEL", None)
    logger = logging.getLogger(name)
    if log_level is not None:
        logger.setLevel(log_level.upper())
        logger.root.setLevel(log_level.upper())
    return MultiProcessAdapter(logger, {})
