"""Preemption signals (:mod:`.preemption`): the flag ``serve`` drains on."""

from .preemption import SENTINEL_NAME, PreemptionHandler, get_active_handler

__all__ = ["SENTINEL_NAME", "PreemptionHandler", "get_active_handler"]
