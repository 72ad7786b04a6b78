"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, every port module
imports with JAX blocked, importing the kernel modules builds and
loads nothing, and ``chip_smoke.py`` prints no result without CUDA."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))",
    re.MULTILINE)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_pattern_allows_the_port_and_refuses_the_reference():
    assert FORBIDDEN.search("import repro.retrieval\n")
    assert FORBIDDEN.search("from repro.kernels import ops\n")
    assert FORBIDDEN.search("    import jax.numpy as jnp\n")
    assert not FORBIDDEN.search("import repro_torch.kernels\n")
    assert not FORBIDDEN.search("from repro_torch.core import head_api\n")


_BLOCK_AND_IMPORT = """
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")

sys.meta_path.insert(0, Block())
from repro_torch.kernels import _build

def built():
    root = _build.build_root()
    return sorted(root.rglob("*")) if root.exists() else []

before = built()
for name in sys.argv[1:]:
    importlib.import_module(name)
assert not _build._FUNCS, "a kernel library was loaded at import"
assert built() == before, "importing the port built something"
print("ok", len(sys.argv) - 1)
"""


def test_every_module_imports_with_jax_blocked_and_builds_nothing(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK_AND_IMPORT, *MODULES],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(MODULES))]


def test_chip_smoke_without_cuda_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_build_without_nvcc_fails_naming_nvcc(tmp_path, monkeypatch):
    """On a machine without the CUDA toolkit the first launch raises a
    clear error, and the build goes only under the build root."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "build_root", lambda: tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.build_dir().parent == tmp_path / "build"
    assert _build.build_dir().name.startswith("kernels-")
