"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each kernel source in ``stmgcn_tpu_torch/csrc/`` is a plain C interface
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, at first use. The library name
carries a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads in milliseconds. Nothing here runs at import time:
the CPU tests import every module on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "BuildInfo", "load_library"]

_REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "kernels"

#: true fp32 (no --use_fast_math); -Xptxas -v reports registers/spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict = {}


class BuildInfo:
    """What one build did: the library path, seconds spent in ``nvcc``
    (0.0 when an up-to-date library was reused) and the compiler's log."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path = path
        self.seconds = seconds
        self.log = log


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "compiled at first use on the machine with the GPU"
    )


def _build(sources, name: str) -> BuildInfo:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(Path(src).read_bytes())
    path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    return BuildInfo(path, seconds, proc.stdout + proc.stderr)


def load_library(sources, name: str) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load one kernel library; cached per process.

    Raises when ``nvcc`` is missing or the build fails — there is no
    fallback: a caller holding CUDA tensors gets the kernel or an error.
    """
    with _LOCK:
        if name not in _LOADED:
            info = _build(sources, name)
            _LOADED[name] = (ctypes.CDLL(str(info.path)), info)
        return _LOADED[name]
