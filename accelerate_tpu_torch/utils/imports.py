"""Feature-availability probes (port of the tracker half of
``accelerate_tpu/utils/imports.py``). Each looks the package up without
importing it, so importing this module, or the trackers that consult it,
loads none of the packages it asks about."""

from __future__ import annotations

import functools
import importlib.metadata
import importlib.util


def _is_package_available(pkg_name: str) -> bool:
    if importlib.util.find_spec(pkg_name) is None:
        return False
    try:
        importlib.metadata.version(pkg_name)
    except importlib.metadata.PackageNotFoundError:
        # namespace packages have no top-level dist metadata
        pass
    return True


@functools.cache
def is_tensorboard_available() -> bool:
    return _is_package_available("tensorboard") or _is_package_available("tensorboardX")


@functools.cache
def is_wandb_available() -> bool:
    return _is_package_available("wandb")


@functools.cache
def is_comet_ml_available() -> bool:
    return _is_package_available("comet_ml")


@functools.cache
def is_mlflow_available() -> bool:
    return _is_package_available("mlflow")


@functools.cache
def is_aim_available() -> bool:
    return _is_package_available("aim")


@functools.cache
def is_clearml_available() -> bool:
    return _is_package_available("clearml")


@functools.cache
def is_dvclive_available() -> bool:
    return _is_package_available("dvclive")
