"""Experiment trackers (port of ``accelerate_tpu/tracking.py``): a
``GeneralTracker`` base with eight built-ins and main-process gating.
Trackers are host-side observers. Every tracker package is imported
lazily, when its tracker is made: importing this module loads none of
tensorboard, wandb, mlflow, comet_ml, aim, clearml or dvclive, and
:func:`filter_trackers` asks for them through availability probes that do
not import them. ``log_with="jsonl"`` needs nothing but the standard
library.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import time

import numpy as np

from .metrics.registry import _is_main_process
from .utils import imports as _imports

logger = logging.getLogger(__name__)

LOGGER_TYPE_TO_CLASS = {}


def on_main_process(function):
    """Run only on the main process (the state is read, never created)."""

    @functools.wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if getattr(self, "main_process_only", True):
            if _is_main_process():
                return function(self, *args, **kwargs)
            return None
        return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """Tracker base. Subclasses set ``name``,
    ``requires_logging_directory``, implement ``store_init_configuration``
    and ``log``, and may expose the raw client via ``tracker``."""

    main_process_only = True
    name = "generic"
    requires_logging_directory = False

    def __init__(self, _blank: bool = False, **kwargs):
        self._blank = _blank

    @property
    def tracker(self):
        return None

    def store_init_configuration(self, values: dict):
        pass

    def log(self, values: dict, step: int | None = None, **kwargs):
        pass

    def log_images(self, values: dict, step: int | None = None, **kwargs):
        pass

    def log_table(
        self,
        table_name: str,
        columns: list[str] | None = None,
        data: list[list] | None = None,
        dataframe=None,
        step: int | None = None,
        **kwargs,
    ):
        """Log a table either as ``columns`` + ``data`` rows or a dataframe.
        Base implementation is a no-op; WandB/ClearML override."""

    def finish(self):
        pass


class JSONLTracker(GeneralTracker):
    """Dependency-free built-in (``log_with="jsonl"``): one JSON object per
    ``log()`` call appended to ``{logging_dir}/{run_name}/metrics.jsonl``,
    flushed per record so a crash loses at most the in-flight line. The
    same file format the telemetry subsystem writes — a run with both
    enabled yields a complete, greppable trail with zero extra services."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        os.makedirs(self.logging_dir, exist_ok=True)
        self._file = open(os.path.join(self.logging_dir, "metrics.jsonl"), "a")

    @property
    def tracker(self):
        return getattr(self, "_file", None)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self._file.write(json.dumps({"event": "init", "config": _jsonable(values)}) + "\n")
        self._file.flush()

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        self._file.write(
            json.dumps({"step": step, "ts": time.time(), **_jsonable(_flatten_scalars(values))})
            + "\n"
        )
        self._file.flush()

    @on_main_process
    def finish(self):
        self._file.close()


class TensorBoardTracker(GeneralTracker):
    """``torch.utils.tensorboard``'s ``SummaryWriter`` (tensorboardX's if
    that fails) writing event files; without either, JSONL scalars that
    TensorBoard's scalars plugin can be re-fed from."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str, **kwargs):
        super().__init__()
        self.run_name = run_name
        self.logging_dir = os.path.join(logging_dir, run_name)
        os.makedirs(self.logging_dir, exist_ok=True)
        self.writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415

            self.writer = SummaryWriter(self.logging_dir, **kwargs)
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # noqa: PLC0415

                self.writer = SummaryWriter(self.logging_dir, **kwargs)
            except Exception:
                self._jsonl = open(os.path.join(self.logging_dir, "scalars.jsonl"), "a")

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        if self.writer is not None:
            self.writer.add_hparams(_flatten_scalars(values), metric_dict={})
            self.writer.flush()
        else:
            with open(os.path.join(self.logging_dir, "hparams.json"), "w") as f:
                json.dump(_jsonable(values), f, indent=2)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        values = _flatten_scalars(values)
        if self.writer is not None:
            for k, v in values.items():
                if isinstance(v, str):
                    self.writer.add_text(k, v, global_step=step)
                else:
                    self.writer.add_scalar(k, v, global_step=step)
            self.writer.flush()
        else:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **_jsonable(values)}) + "\n")
            self._jsonl.flush()

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, **kwargs):
        """``{name: batch of HWC/NCHW arrays}`` → ``add_images``; the JSONL
        fallback stores ``.npy`` files next to the scalars so the data
        survives without a SummaryWriter."""
        if self.writer is not None:
            for k, v in values.items():
                self.writer.add_images(k, v, global_step=step, **kwargs)
            self.writer.flush()
        else:
            img_dir = os.path.join(self.logging_dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            for k, v in values.items():
                safe = k.replace("/", "_")
                np.save(os.path.join(img_dir, f"{safe}_step{step or 0}.npy"), np.asarray(v))

    @on_main_process
    def finish(self):
        if self.writer is not None:
            self.writer.close()
        elif hasattr(self, "_jsonl"):
            self._jsonl.close()


class WandBTracker(GeneralTracker):

    name = "wandb"
    requires_logging_directory = False
    main_process_only = True

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        import wandb  # noqa: PLC0415

        self.run = wandb.init(project=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb  # noqa: PLC0415

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, **kwargs):
        """``{name: list of images}`` → ``wandb.Image`` wraps."""
        import wandb  # noqa: PLC0415

        for k, v in values.items():
            self.log({k: [wandb.Image(image) for image in v]}, step=step, **kwargs)

    @on_main_process
    def log_table(
        self,
        table_name: str,
        columns: list[str] | None = None,
        data: list[list] | None = None,
        dataframe=None,
        step: int | None = None,
        **kwargs,
    ):
        import wandb  # noqa: PLC0415

        table = wandb.Table(columns=columns, data=data, dataframe=dataframe)
        self.log({table_name: table}, step=step, **kwargs)

    @on_main_process
    def finish(self):
        self.run.finish()


class MLflowTracker(GeneralTracker):

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str | None = None, **kwargs):
        super().__init__()
        import mlflow  # noqa: PLC0415

        self._mlflow = mlflow
        experiment = mlflow.set_experiment(run_name)
        self.active_run = mlflow.start_run(**kwargs)

    @property
    def tracker(self):
        return self.active_run

    @on_main_process
    def store_init_configuration(self, values: dict):
        for k, v in _flatten_scalars(values).items():
            self._mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        metrics = {k: v for k, v in _flatten_scalars(values).items() if not isinstance(v, str)}
        self._mlflow.log_metrics(metrics, step=step)

    @on_main_process
    def finish(self):
        self._mlflow.end_run()


class CometMLTracker(GeneralTracker):

    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from comet_ml import Experiment  # noqa: PLC0415

        self.run = Experiment(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.run.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        if step is not None:
            self.run.set_step(step)
        self.run.log_metrics(_flatten_scalars(values), step=step)

    @on_main_process
    def finish(self):
        self.run.end()


class AimTracker(GeneralTracker):

    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__()
        from aim import Run  # noqa: PLC0415

        self.writer = Run(repo=logging_dir, **kwargs)
        self.writer.name = run_name

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        for k, v in values.items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, kwargs: dict | None = None):
        """``{name: image | (image, caption)}`` → ``aim.Image`` tracks;
        ``kwargs`` splits into the ``aim_image`` and ``track`` call
        kwargs."""
        import aim  # noqa: PLC0415

        kwargs = kwargs or {}
        image_kw = kwargs.get("aim_image", {})
        track_kw = kwargs.get("track", {})
        for k, v in values.items():
            caption = None
            if isinstance(v, tuple):
                v, caption = v
            image = aim.Image(v, caption=caption, **image_kw) if caption is not None else aim.Image(v, **image_kw)
            self.writer.track(image, name=k, step=step, **track_kw)

    @on_main_process
    def finish(self):
        self.writer.close()


class ClearMLTracker(GeneralTracker):

    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__()
        from clearml import Task  # noqa: PLC0415

        self.task = Task.init(project_name=run_name, **kwargs)

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in _flatten_scalars(values).items():
            if isinstance(v, str):
                continue
            title, _, series = k.partition("/")
            clearml_logger.report_scalar(title=title, series=series or title, value=v, iteration=step or 0)

    @on_main_process
    def log_images(self, values: dict, step: int | None = None, **kwargs):
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            title, _, series = k.partition("/")
            clearml_logger.report_image(
                title=title, series=series or title, iteration=step, image=v, **kwargs
            )

    @on_main_process
    def log_table(
        self,
        table_name: str,
        columns: list[str] | None = None,
        data: list[list] | None = None,
        dataframe=None,
        step: int | None = None,
        **kwargs,
    ):
        """``columns`` + ``data`` rows, or a dataframe."""
        to_report = dataframe
        if dataframe is None:
            if data is None:
                raise ValueError("log_table needs `data` when `dataframe` is None")
            to_report = [columns] + data if columns else data
        title, _, series = table_name.partition("/")
        self.task.get_logger().report_table(
            title=title, series=series or title, table_plot=to_report, iteration=step, **kwargs
        )

    @on_main_process
    def finish(self):
        self.task.close()


class DVCLiveTracker(GeneralTracker):

    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str | None = None, live=None, **kwargs):
        super().__init__()
        from dvclive import Live  # noqa: PLC0415

        self.live = live if live is not None else Live(**kwargs)

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: int | None = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in _flatten_scalars(values).items():
            self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def finish(self):
        self.live.end()


LOGGER_TYPE_TO_CLASS.update(
    {
        "aim": AimTracker,
        "comet_ml": CometMLTracker,
        "mlflow": MLflowTracker,
        "tensorboard": TensorBoardTracker,
        "wandb": WandBTracker,
        "clearml": ClearMLTracker,
        "dvclive": DVCLiveTracker,
        "jsonl": JSONLTracker,
    }
)

_AVAILABILITY = {
    "tensorboard": lambda: True,  # JSONL fallback always works
    "wandb": _imports.is_wandb_available,
    "comet_ml": _imports.is_comet_ml_available,
    "mlflow": _imports.is_mlflow_available,
    "aim": _imports.is_aim_available,
    "clearml": _imports.is_clearml_available,
    "dvclive": _imports.is_dvclive_available,
    "jsonl": lambda: True,  # stdlib-only
}


def filter_trackers(log_with, logging_dir: str | None = None):
    """Resolve user input ("all", name, class instance, list) into tracker
    specs, as the JAX package does."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    loggers = []
    if "all" in log_with:
        log_with = [name for name in LOGGER_TYPE_TO_CLASS if _AVAILABILITY[name]()] + [
            t for t in log_with if isinstance(t, GeneralTracker)
        ]
    for tracker in log_with:
        if isinstance(tracker, GeneralTracker):
            loggers.append(tracker)
            continue
        name = str(tracker)
        if name not in LOGGER_TYPE_TO_CLASS:
            raise ValueError(
                f"unknown tracker {name!r}; choose from {sorted(LOGGER_TYPE_TO_CLASS)}"
            )
        if not _AVAILABILITY[name]():
            logger.warning(f"tracker {name} is not available in this environment; skipping")
            continue
        if LOGGER_TYPE_TO_CLASS[name].requires_logging_directory and logging_dir is None:
            raise ValueError(f"tracker {name} requires a logging_dir / project_dir")
        loggers.append(name)
    return loggers


def init_trackers(log_with, project_name, logging_dir, config, init_kwargs):
    trackers = []
    for spec in log_with:
        if isinstance(spec, GeneralTracker):
            tracker = spec
        else:
            cls = LOGGER_TYPE_TO_CLASS[spec]
            kwargs = init_kwargs.get(spec, {})
            if cls.requires_logging_directory:
                tracker = cls(project_name, logging_dir, **kwargs)
            else:
                tracker = cls(project_name, **kwargs)
        if config is not None:
            tracker.store_init_configuration(config)
        trackers.append(tracker)
    return trackers


def _flatten_scalars(values: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in values.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_scalars(v, prefix=f"{key}/"))
        elif isinstance(v, (int, float, str, bool, np.number)):
            out[key] = v
        elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[key] = v.item()
    return out


def _jsonable(values):
    return json.loads(json.dumps(values, default=lambda o: getattr(o, "item", lambda: str(o))()))
