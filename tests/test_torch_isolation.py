"""The port stands alone: ``accelerate_tpu_torch``, ``chip_smoke.py`` and
``benchmarks/torch_paged_attention_sweep.py`` import neither ``jax`` nor
anything of the JAX package ``accelerate_tpu`` (whose ``__init__`` pulls in
jax), and the package imports on a box with no GPU, no ``nvcc`` and no
``triton``.

Checked twice: at run time, by importing every module of the package in a
fresh interpreter and reading ``sys.modules``; and statically, by walking
the AST of every source file for an import of either.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "accelerate_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "accelerate_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
import accelerate_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {"jax", "jaxlib", "optax", "accelerate_tpu", "triton"})
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_every_module_imports_without_jax_or_triton():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.splitlines()[-1])
    assert "accelerate_tpu_torch.serving.engine" in result["modules"]
    assert "accelerate_tpu_torch.ops.paged_attention" in result["modules"]
    for name in ("accelerator", "state", "optimizer", "scheduler", "ops.attention",
                 "ops.flash_attention", "utils.dataclasses", "utils.random",
                 # the front door's modules: copies, never imports, of the JAX ones
                 "commands.serve", "serving.openai_api", "serving.workload",
                 "metrics.registry", "metrics.openmetrics", "metrics.ingest",
                 "diagnostics.tracing", "telemetry", "resilience.preemption",
                 "analysis.lockwatch",
                 # the fleet and the pre-flight: copies, never imports, too
                 "commands.route", "serving.router", "serving.replica",
                 "serving.supervisor", "serving.chaos", "analysis.shardplan",
                 "utils.device",
                 # generate() and the SLO, goodput, alerts and monitor copies
                 "generation", "metrics.alerts", "metrics.goodput", "metrics.slo",
                 "metrics.exporter", "diagnostics.reqtrace", "diagnostics.monitor",
                 "commands.slo", "commands.metrics", "commands.monitor", "commands.usage",
                 # process groups, collectives and the prepared loader
                 "operations", "data_loader", "mesh", "launchers", "logging",
                 "utils.environment",
                 # the precision and memory policies: the loss scaler, fp8
                 # projections, autocast islands, named remat, the HF loader
                 "modules", "ops.fp8", "ops.layers", "models.llama", "parallel",
                 "parallel.pipeline"):
        assert f"accelerate_tpu_torch.{name}" in result["modules"]
    assert result["leaked"] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py",
                                     REPO / "benchmarks" / "torch_paged_attention_sweep.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert bad == [], f"{path.relative_to(REPO)} imports {bad}"


def test_the_kernel_sources_ship_inside_the_package():
    from accelerate_tpu_torch import _build

    for source in _build.SOURCES:
        assert (_build.CSRC_DIR / source).is_file()
        assert _build.library_path(source).parent == _build.BUILD_DIR
    assert "code=sm_90a" in " ".join(_build.NVCC_FLAGS)
