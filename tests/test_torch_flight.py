"""The port's flight recorder (``accelerate_tpu_torch/serving/flight.py``, a
copy of the JAX package's) and its wiring into the engine's ``step()``.

* The recorder's unit behaviour, on both packages: ``record`` asserts that
  the phases sum to the wall time, the ring caps while the totals stay
  cumulative, and ``host_fraction`` follows its formula.
* On the port's engine: every iteration's phases sum to its wall time,
  ``reset_stats`` clears the ring, the synchronous loop hides no overlap,
  and ``flight_history=0`` leaves the recorder off.
* The module imports nothing but the standard library at its top (its
  profiler window imports torch inside the window).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accelerate_tpu.serving import flight as jflight  # noqa: E402
from accelerate_tpu_torch.models import LlamaConfig, LlamaForCausalLM  # noqa: E402
from accelerate_tpu_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from accelerate_tpu_torch.serving import flight as tflight  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = pytest.mark.parametrize("fl", [jflight, tflight], ids=["jax", "port"])


def _entry_phases(i):
    """Deterministic synthetic phase durations for iteration ``i``."""
    phases = {
        "schedule": 0.001, "prefill": 0.002 * (i % 3), "dispatch": 0.003,
        "device_wait": 0.010 + 0.001 * i, "harvest": 0.0005,
    }
    return phases, sum(phases.values())


@PACKAGES
def test_record_asserts_phase_sum_equals_wall(fl):
    rec = fl.FlightRecorder(history=8)
    phases, wall = _entry_phases(1)
    entry = rec.record(1, t_start=100.0, wall_s=wall, **phases)
    assert entry["wall_s"] == pytest.approx(wall)
    with pytest.raises(AssertionError):  # a dropped stamp
        rec.record(2, t_start=101.0, wall_s=wall + 0.5, **phases)
    with pytest.raises(AssertionError):  # a wrong phase vocabulary
        rec.record(3, t_start=102.0, wall_s=0.001, schedule=0.001)
    with pytest.raises(AssertionError):  # hidden overlap beyond wall - device_wait
        rec.record(4, t_start=103.0, wall_s=wall, overlap_hidden_s=wall, **phases)


@PACKAGES
def test_ring_caps_and_totals_stay_cumulative(fl):
    rec = fl.FlightRecorder(history=4)
    total_wall = 0.0
    for i in range(10):
        phases, wall = _entry_phases(i)
        rec.record(i, t_start=float(i), wall_s=wall, overlap_hidden_s=0.001, **phases)
        total_wall += wall
    assert len(rec) == 4 and rec.iterations == 10
    assert rec.wall_total_s == pytest.approx(total_wall)
    dev = sum(_entry_phases(i)[0]["device_wait"] for i in range(10))
    assert rec.host_fraction() == pytest.approx(1.0 - (dev + 0.010) / total_wall)
    assert [e["iteration"] for e in rec.tail(2)] == [8, 9]
    assert [e["iteration"] for e in rec.window(8.0)] == [8, 9]
    summary = rec.summary()
    assert summary["flight_window"] == 4
    assert set(summary["iteration_phases_s"]) == set(fl.ITERATION_PHASES)
    rec.reset()
    assert len(rec) == 0 and rec.iterations == 0 and rec.summary() == {}
    assert rec.current_phase == "idle"


def test_the_copy_keeps_the_reference_vocabulary():
    assert tflight.ITERATION_PHASES == jflight.ITERATION_PHASES


def test_flight_module_is_stdlib_only():
    probe = ("import json, sys; import accelerate_tpu_torch.serving.flight; "
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
             "{'jax', 'jaxlib', 'accelerate_tpu', 'numpy'})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    leaked = json.loads(proc.stdout.splitlines()[-1])
    # the package's __init__ imports torch (and with it numpy), never JAX
    assert not [m for m in leaked if m.split(".")[0] in ("jax", "jaxlib", "accelerate_tpu")]
    src = open(os.path.join(REPO, "accelerate_tpu_torch", "serving", "flight.py")).read()
    imports = [ln for ln in src.splitlines() if ln.startswith(("import ", "from "))]
    assert imports == ["from __future__ import annotations", "import json", "import math",
                       "import os", "import threading", "import time",
                       "from collections import deque"]


# ---------------------------------------------------------------------------
# the engine's wiring
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_model():
    config = LlamaConfig.tiny(vocab_size=64, hidden_size=32, layers=2, heads=4, seq=96)
    return LlamaForCausalLM.from_config(config, seed=0, device="cpu")


def _engine(model, **kw):
    base = dict(num_slots=2, block_size=8, max_seq_len=96, prefill_chunk=8, decode_burst=2)
    base.update(kw)
    return InferenceEngine(model, EngineConfig(**base), device="cpu")


@pytest.mark.parametrize("async_dispatch", [True, False], ids=["async", "sync"])
def test_engine_phases_sum_to_wall_and_reset_clears_ring(tiny_model, async_dispatch):
    engine = _engine(tiny_model, flight_history=16, async_dispatch=async_dispatch)
    assert tflight.get_active_flight_recorder() is engine._flight
    engine.add_request([1, 2, 3], max_new_tokens=8)
    engine.run_until_idle(max_iterations=100)
    warm = engine.stats()["iterations"]
    assert warm > 0 and len(engine._flight) == min(warm, 16)
    for e in engine._flight.tail(16):
        assert sum(e[f"{p}_s"] for p in tflight.ITERATION_PHASES) == pytest.approx(
            e["wall_s"], abs=1e-6)
        assert -1e-6 <= e["overlap_hidden_s"] <= e["wall_s"] - e["device_wait_s"] + 1e-6
    engine.reset_stats()
    assert len(engine._flight) == 0 and engine._flight.iterations == 0
    assert "host_fraction" not in engine.stats()
    rng = np.random.default_rng(0)
    for n in (5, 19, 2):
        engine.add_request(rng.integers(0, 64, size=n), max_new_tokens=6)
    engine.run_until_idle(max_iterations=200)
    stats = engine.stats()
    assert stats["iterations"] == engine._flight.iterations == len(engine._flight)
    assert 0.0 < stats["host_fraction"] <= 1.0
    assert stats["flight_window"] == stats["iterations"]
    assert set(stats["iteration_phases_s"]) == set(tflight.ITERATION_PHASES)
    fl = engine._flight
    assert fl.host_fraction() == pytest.approx(max(0.0, 1.0 - (
        fl.phase_totals_s["device_wait"] + fl.overlap_hidden_total_s) / fl.wall_total_s),
        abs=1e-12)
    if async_dispatch:
        assert fl.overlap_hidden_total_s > 0.0  # host work ran under in-flight rounds
    else:
        assert stats["overlap_hidden_s"] == 0.0


def test_flight_disabled_path(tiny_model):
    tflight.set_active_flight_recorder(None)
    engine = _engine(tiny_model, flight_history=0)
    assert engine._flight is None
    assert tflight.get_active_flight_recorder() is None
    engine.add_request([1, 2, 3], max_new_tokens=4)
    engine.run_until_idle(max_iterations=100)
    stats = engine.stats()
    for key in ("host_fraction", "iteration_p50_s", "flight_window"):
        assert key not in stats
    assert stats["completed"] == 1
