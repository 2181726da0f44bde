"""The kernel build (``accelerate_tpu_torch/_build.py``) on a box without a
CUDA toolkit: a stand-in ``nvcc`` script on ``PATH`` shows that a library
is built once per source hash and flag set, that a failed build raises
with the compiler's stderr, and that a missing compiler raises instead of
falling back. The real compile runs on the card, in ``chip_smoke.py``.
"""

import os
import stat
import sys

import pytest

pytest.importorskip("torch")

from accelerate_tpu_torch import _build  # noqa: E402

_FAKE_NVCC = """#!{python}
import os, sys
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\\n")
if os.environ.get("FAKE_NVCC_FAIL"):
    print("paged_attention.cu(1): error: boom", file=sys.stderr)
    sys.exit(2)
with open(sys.argv[sys.argv.index("-o") + 1], "wb") as f:
    f.write(b"not a real library")
print("ptxas info    : Used 42 registers")
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build" / "torch_kernels")
    return log


def test_sources_name_every_kernel_file():
    assert _build.SOURCES == ("paged_attention.cu", "flash_attention.cu")
    on_disk = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert sorted(_build.SOURCES) == on_disk


def test_builds_once_per_source_hash_and_flags(fake_toolchain, monkeypatch):
    built = _build.build_all()
    assert set(built) == set(_build.SOURCES)
    for src, path in built.items():
        stem = src.removesuffix(".cu")
        assert path.parent == _build.BUILD_DIR and path.is_file()
        assert path.name.startswith(f"{stem}-") and path.suffix == ".so"
        assert "Used 42 registers" in _build.build_log(src)
    path = built["paged_attention.cu"]
    calls = fake_toolchain.read_text().splitlines()
    assert len(calls) == len(_build.SOURCES)  # one nvcc per source, started together
    assert all("arch=compute_90a,code=sm_90a" in call for call in calls)
    assert sorted(call.split()[-1].rsplit("/", 1)[-1] for call in calls) == sorted(_build.SOURCES)
    assert _build.build_all() == built  # unchanged source: nothing rebuilt
    assert len(fake_toolchain.read_text().splitlines()) == len(_build.SOURCES)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("paged_attention.cu") != path  # new flags, new build
    assert not list(_build.BUILD_DIR.glob("*.tmp.so"))


def test_failed_build_raises_with_the_compiler_stderr(fake_toolchain, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed to build paged_attention.cu.*boom"):
        _build.build_all()
    assert not list(_build.BUILD_DIR.glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at the default path")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()
