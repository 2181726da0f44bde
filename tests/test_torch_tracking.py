"""The port's trackers held against the JAX package's: the same
``init_trackers`` / ``log`` calls write the same JSONL rows (time fields
aside), ``filter_trackers`` resolves every input as JAX's does, the
tensorboard tracker writes event files (skipped where tensorboard is
missing), and the ``Accelerator`` facade (``log_with``, ``init_trackers``,
``log``, ``get_tracker``, ``end_training``) round-trips."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from accelerate_tpu import Accelerator as JAccelerator  # noqa: E402
from accelerate_tpu import tracking as jtracking  # noqa: E402
from accelerate_tpu.state import AcceleratorState as JAccState  # noqa: E402
from accelerate_tpu_torch import Accelerator, AcceleratorState, GradientState  # noqa: E402
from accelerate_tpu_torch import tracking as ttracking  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    JAccState._reset_state(reset_partial_state=True)
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    JAccState._reset_state(reset_partial_state=True)


def _rows(path) -> list[dict]:
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in path.read_text().splitlines()]


def test_jsonl_rows_equal_jax(tmp_path):
    config = {"lr": 0.1, "model": {"layers": 2, "name": "tiny"}, "tags": ["a", "b"]}
    logs = [({"loss": 1.5, "nested": {"acc": 0.5, "deep": {"x": 3}}, "note": "warm"}, 0),
            ({"loss": 0.25, "flag": True, "count": 7}, 1),
            ({"loss": 0.125}, None)]
    out = {}
    for name, acc_cls, scalar in (("port", lambda **kw: Accelerator(cpu=True, **kw),
                                   lambda v: torch.tensor(v)),
                                  ("jax", JAccelerator, lambda v: jnp.asarray(v))):
        root = tmp_path / name
        acc = acc_cls(log_with="jsonl", project_dir=str(root))
        acc.init_trackers("run1", config=config)
        for values, step in logs:
            acc.log(values, step=step)
        acc.log({"loss": scalar(0.5), "lr": np.float32(0.001)}, step=3)
        assert acc.get_tracker("jsonl").name == "jsonl"
        acc.end_training()
        out[name] = _rows(root / "run1" / "metrics.jsonl")
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"event": "init", "config": config}
    assert out["port"][1]["nested/deep/x"] == 3


class _Custom(ttracking.GeneralTracker):
    name = "custom"

    def __init__(self):
        super().__init__()
        self.rows = []
        self.config = None

    @property
    def tracker(self):
        return self.rows

    def store_init_configuration(self, values):
        self.config = dict(values)

    def log(self, values, step=None, **kwargs):
        self.rows.append((step, dict(values)))


class _JCustom(jtracking.GeneralTracker):
    name = "custom"


@pytest.mark.parametrize("log_with", [None, "jsonl", ["jsonl"], "tensorboard", "all",
                                      ["all", "custom"], ["tensorboard", "jsonl"],
                                      "not_a_tracker", "wandb"])
@pytest.mark.parametrize("logging_dir", [None, "/tmp/x"])
def test_filter_trackers_resolves_as_jax_does(log_with, logging_dir):
    def resolve(module, custom_cls):
        spec = log_with
        if isinstance(spec, list):
            spec = [custom_cls() if s == "custom" else s for s in spec]
        try:
            got = module.filter_trackers(spec, logging_dir)
        except ValueError as e:
            return ("raised", str(e))
        return [t if isinstance(t, str) else t.name for t in got]

    assert resolve(ttracking, _Custom) == resolve(jtracking, _JCustom)


def test_the_zoo_and_its_directory_needs_are_jax_s():
    assert set(ttracking.LOGGER_TYPE_TO_CLASS) == set(jtracking.LOGGER_TYPE_TO_CLASS)
    for name, cls in ttracking.LOGGER_TYPE_TO_CLASS.items():
        ref = jtracking.LOGGER_TYPE_TO_CLASS[name]
        assert cls.name == ref.name
        assert cls.requires_logging_directory == ref.requires_logging_directory
        assert ttracking._AVAILABILITY[name]() == jtracking._AVAILABILITY[name]()


def test_accelerator_facade_with_a_custom_tracker():
    tracker = _Custom()
    acc = Accelerator(cpu=True, log_with=tracker)
    acc.init_trackers("proj", config={"lr": 0.1})
    assert tracker.config == {"lr": 0.1}
    acc.log({"loss": 1.5}, step=0)
    acc.log({"loss": 0.5}, step=1, log_kwargs={"custom": {"commit": True}})
    acc.end_training()
    assert tracker.rows == [(0, {"loss": 1.5}), (1, {"loss": 0.5})]
    assert acc.get_tracker("custom") is tracker
    assert acc.get_tracker("custom", unwrap=True) is tracker.rows
    blank = acc.get_tracker("absent")
    assert isinstance(blank, ttracking.GeneralTracker) and blank.log({"x": 1}) is None


def test_jsonl_tracker_writes_on_the_main_process_only(tmp_path, monkeypatch):
    from accelerate_tpu_torch.state import PartialState

    Accelerator(cpu=True)
    monkeypatch.setitem(PartialState._shared_state, "process_index", 1)
    tracker = ttracking.JSONLTracker("run", str(tmp_path))
    tracker.log({"loss": 1.0}, step=0)
    assert not (tmp_path / "run").exists()


def test_tensorboard_tracker_writes_event_files(tmp_path):
    pytest.importorskip("tensorboard")
    acc = Accelerator(cpu=True, log_with="tensorboard", project_dir=str(tmp_path))
    acc.init_trackers("run1", config={"lr": 0.1, "layers": 2})
    acc.log({"loss": 1.0, "note": "text"}, step=0)
    acc.log({"loss": torch.tensor(0.5)}, step=1)
    writer = acc.get_tracker("tensorboard", unwrap=True)
    assert writer is not None
    acc.end_training()
    written = [f for _, _, files in os.walk(tmp_path) for f in files]
    assert any(f.startswith("events.out.tfevents") for f in written), written


def test_tensorboard_images_fall_back_to_npy_files(tmp_path):
    tracker = ttracking.TensorBoardTracker.__new__(ttracking.TensorBoardTracker)
    ttracking.GeneralTracker.__init__(tracker)
    tracker.writer = None
    tracker.logging_dir = str(tmp_path)
    tracker.log_images({"val/sample": np.zeros((2, 4, 4, 3))}, step=2)
    assert os.listdir(tmp_path / "images") == ["val_sample_step2.npy"]
