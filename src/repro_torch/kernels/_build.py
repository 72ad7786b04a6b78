"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface
(``build/kernels-<hash>/lib<name>.so`` at the root of the checkout), and
loaded with ``ctypes``. The sources may include the headers beside them
(``csrc/*.cuh``). The directory is keyed by a hash of the sources, the
headers and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. The kernels link only the CUDA runtime: a
driver-API function (TMA's ``cuTensorMapEncodeTiled``) is looked up at
run time through the runtime's driver entry point
(``csrc/hopper.cuh``). Importing this module compiles and loads nothing:
the CPU tests import every kernel module on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("sparton_fwd", "sparton_bwd", "impact_topk", "topk_score")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def build_root() -> Path:
    """``build/`` at the root of the checkout (``src/repro_torch/..``)."""
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built on the machine with the "
            "card")
    return found


def headers() -> List[Path]:
    """The headers the sources may include, in a fixed order."""
    return sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu" for name in SOURCES] + headers():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return build_root() / f"kernels-{digest.hexdigest()[:16]}"


def build_all() -> Path:
    """Compile every source that is not built yet, in parallel.

    Returns the build directory; ``<name>.log`` there holds nvcc's and
    ptxas's report (registers, shared memory, spills) for each source.
    Raises with the compiler's output if any source fails.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = []
    for name in SOURCES:
        if (out / f"lib{name}.so").exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        with open(out / f"{name}.log", "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp))
    failed = []
    for name, proc, tmp in jobs:
        if proc.wait() != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n"
                          + (out / f"{name}.log").read_text())
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failed))
    return out


def function(lib: str, name: str, argtypes: Sequence,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``name`` of ``lib<lib>.so``, built on first use,
    with its argument types declared and, by default, an ``int`` return
    (the CUDA error code of the launch)."""
    key = f"{lib}.{name}"
    with _LOCK:
        if key not in _FUNCS:
            handle = ctypes.CDLL(str(build_all() / f"lib{lib}.so"))
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _FUNCS[key] = fn
        return _FUNCS[key]


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch's C function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc}")
