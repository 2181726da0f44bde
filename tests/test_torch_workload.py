"""The port's workload suite (``accelerate_tpu_torch/serving/workload.py``, a
copy of the JAX package's) and ``serve --trace`` in stdin mode.

* For every generator (and a ``replay:`` of a recorded schedule) the same
  spec gives the same schedule bytes, so the same ``schedule_digest``, in
  both packages; malformed specs are refused by both.
* ``serve --device cpu --trace SPEC`` answers every scheduled request and
  writes ``WORKLOAD.json`` whose digest equals a recomputation; a malformed
  spec is a startup refusal: an error row and exit 2.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from accelerate_tpu.serving import workload as jwl
from accelerate_tpu_torch.serving import workload as twl

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240

SPECS = ["bursty-diurnal:7:6:5", "longctx-flood:3:4:3", "agentic:11:5:2",
         "overbudget-storm:5:4:6", "bursty-diurnal:7:6:5:tenants=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_schedules_and_digests_equal_jax(spec):
    got = twl.generate_schedule(twl.parse_trace_spec(spec))
    ref = jwl.generate_schedule(jwl.parse_trace_spec(spec))
    assert got and twl.schedule_bytes(got) == jwl.schedule_bytes(ref)
    assert twl.schedule_digest(got) == jwl.schedule_digest(ref)
    assert twl.parse_trace_spec(spec).as_text() == jwl.parse_trace_spec(spec).as_text()


def test_replay_of_a_recorded_schedule_equals_jax(tmp_path):
    path = tmp_path / "recorded.jsonl"
    schedule = jwl.generate_schedule(jwl.parse_trace_spec("agentic:4:3:2"))
    path.write_bytes(jwl.schedule_bytes(schedule))
    got = twl.generate_schedule(twl.parse_trace_spec(f"replay:{path}"))
    ref = jwl.generate_schedule(jwl.parse_trace_spec(f"replay:{path}"))
    assert twl.schedule_digest(got) == jwl.schedule_digest(ref) == jwl.schedule_digest(schedule)


@pytest.mark.parametrize("bad", ["", "bursty-diurnal", "nope:1:2:3", "agentic:x:2:3",
                                 "bursty-diurnal:1:-2:3", "replay:/no/such/file"])
def test_malformed_specs_are_refused_by_both(bad):
    for module in (twl, jwl):
        with pytest.raises(module.TraceSpecError):
            module.generate_schedule(module.parse_trace_spec(bad))


def _serve(args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "accelerate_tpu_torch", "serve", *args],
                          input="", capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=TIMEOUT_S)


def test_serve_trace_answers_every_scheduled_request(tmp_path):
    spec = "bursty-diurnal:7:2:4"
    schedule = twl.generate_schedule(twl.parse_trace_spec(spec))
    proc = _serve(["--device", "cpu", "--preset", "tiny", "--max-seq-len", "128",
                   "--trace", spec, "--logging-dir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    assert sorted(r["id"] for r in rows) == sorted(e["payload"]["id"] for e in schedule)
    budgets = {e["payload"]["id"]: e["payload"]["max_new_tokens"] for e in schedule}
    assert all(len(r["tokens"]) == budgets[r["id"]] for r in rows)
    manifest = json.loads((tmp_path / twl.WORKLOAD_FILENAME).read_text())
    assert manifest["requests"] == len(schedule)
    assert manifest["schedule_sha256"] == twl.schedule_digest(schedule)
    assert manifest["spec"] == spec and f"served {len(schedule)} requests" in proc.stderr


def test_serve_refuses_a_malformed_trace_spec():
    proc = _serve(["--device", "cpu", "--preset", "tiny", "--trace", "nope:1:2:3"])
    assert proc.returncode == 2
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.strip()]
    assert len(rows) == 1 and "nope" in rows[0]["error"]
    assert "refusing to start" in proc.stderr
