"""User-facing model hooks: behaviour attached around a model's forward
(port of ``accelerate_tpu/hooks.py``).

As in the reference's torch design, :func:`add_hook_to_module` replaces
the object's ``forward`` with a wrapper that runs the hook's
``pre_forward`` on the arguments and its ``post_forward`` on the output,
and :func:`remove_hook_from_module` puts the original back. Anything whose
call goes through its ``forward`` takes a hook: an ``nn.Module``, a
:class:`~.modules.PreparedModel`, a :class:`~.big_modeling.DispatchedModel`.
Offloading is the streaming executor's (``big_modeling.py``), so hooks are
the extension point only.
"""

from __future__ import annotations

import functools


class ModelHook:
    """Subclass and override any of the four callbacks; attach with
    :func:`add_hook_to_module`. ``no_grad`` runs the wrapped forward under
    ``torch.no_grad()``."""

    no_grad = False

    def init_hook(self, module):
        return module

    def pre_forward(self, module, *args, **kwargs):
        return args, kwargs

    def post_forward(self, module, output):
        return output

    def detach_hook(self, module):
        return module


class SequentialHook(ModelHook):
    """Several hooks run in order."""

    def __init__(self, *hooks):
        self.hooks = list(hooks)

    def init_hook(self, module):
        for hook in self.hooks:
            module = hook.init_hook(module)
        return module

    def pre_forward(self, module, *args, **kwargs):
        for hook in self.hooks:
            args, kwargs = hook.pre_forward(module, *args, **kwargs)
        return args, kwargs

    def post_forward(self, module, output):
        for hook in self.hooks:
            output = hook.post_forward(module, output)
        return output

    def detach_hook(self, module):
        for hook in self.hooks:
            module = hook.detach_hook(module)
        return module


def _own(module, name):
    """``module``'s own attribute ``name`` (not one a wrapper's
    ``__getattr__`` forwards from what it wraps), or None."""
    return vars(module).get(name)


def add_hook_to_module(module, hook: ModelHook, append: bool = False):
    """Run ``hook`` around ``module``'s forward. ``append`` chains it after
    a hook already attached (a :class:`SequentialHook`); otherwise it
    replaces that hook."""
    if not callable(getattr(module, "forward", None)):
        raise TypeError(f"{type(module).__name__} is not callable through a forward — hooks "
                        "wrap a model's forward")
    if append and _own(module, "_hf_hook") is not None:
        old = module._hf_hook
        remove_hook_from_module(module)
        hook = SequentialHook(old, hook)
    old_forward = _own(module, "_old_forward") or module.forward
    module = hook.init_hook(module)
    module._hf_hook = hook
    module._old_forward = old_forward

    def new_forward(*args, **kwargs):
        import torch

        args, kwargs = module._hf_hook.pre_forward(module, *args, **kwargs)
        if module._hf_hook.no_grad:
            with torch.no_grad():
                output = module._old_forward(*args, **kwargs)
        else:
            output = module._old_forward(*args, **kwargs)
        return module._hf_hook.post_forward(module, output)

    module.forward = functools.update_wrapper(new_forward, old_forward)
    return module


def remove_hook_from_module(module, recurse: bool = False):
    """Detach the hook and restore the original forward; ``recurse`` does
    the same for an ``nn.Module``'s children."""
    hook = _own(module, "_hf_hook")
    if hook is not None:
        hook.detach_hook(module)
        del module._hf_hook
    if _own(module, "_old_forward") is not None:
        del module._old_forward
        del module.forward  # the class's forward shows through again
    if recurse and hasattr(module, "children"):
        for child in module.children():
            remove_hook_from_module(child, recurse)
    return module


class UserCpuOffloadHook:
    """Handle that lets a user re-run or detach an offload hook."""

    def __init__(self, model, hook: ModelHook):
        self.model = model
        self.hook = hook

    def offload(self):
        self.hook.init_hook(self.model)

    def remove(self):
        remove_hook_from_module(self.model)
