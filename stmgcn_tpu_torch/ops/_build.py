"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each kernel source in ``stmgcn_tpu_torch/csrc/`` is a plain C interface
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root, at first use. The library name
carries a hash of the sources, the ``*.cuh`` headers beside them and the
flags, so an edited source or header rebuilds and an unchanged one loads
in milliseconds. Nothing here runs at import time:
the CPU tests import every module on a host with no ``nvcc``.
:func:`on_cuda` is the wrappers' choice between a kernel and its plain
version (B1's operator leaves that choice to PyTorch's dispatcher, and
its CUDA implementation checks its operands with :func:`on_cuda`).
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

import torch

__all__ = ["BUILD_DIR", "BuildInfo", "KERNEL_DTYPES", "PREBUILT_ENV", "load_library", "on_cuda"]

_REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "kernels"

#: true fp32 (no --use_fast_math); -Xptxas -v reports registers/spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the storage dtypes the kernels take (one per launch)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: set (to anything) in a process that must only load libraries already
#: built, never build one: the ranks of a job whose launcher built them
PREBUILT_ENV = "STMGCN_KERNELS_PREBUILT"

_LOCKS: dict = {}  # one lock per library, so different kernels build in parallel
_LOCKS_GUARD = threading.Lock()
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


def _build(sources, name: str, defines=()) -> BuildInfo:
    flags = (*NVCC_FLAGS, *defines)
    digest = hashlib.sha256(" ".join(flags).encode())
    # the sources and every header beside them, which they may include
    headers = sorted({h for src in sources for h in Path(src).parent.glob("*.cuh")})
    for path in [*sources, *headers]:
        digest.update(Path(path).read_bytes())
    path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    if os.environ.get(PREBUILT_ENV):
        raise RuntimeError(
            f"{path.name} is not built and {PREBUILT_ENV} is set: this process loads the "
            "kernels its launcher built and never runs nvcc (a rank of a multi-process "
            "job on one card)")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
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


def on_cuda(name, operands, int_operands=()) -> bool:
    """Where a kernel wrapper's operands send it: False when every operand
    lies on the CPU (the plain version runs); True when all are contiguous
    and on one CUDA device, ``operands`` all float32 or all bfloat16 and
    ``int_operands`` int32 (the kernel of that storage type runs); raises on
    anything else — no fallback, and a bfloat16 operand never goes to the
    float32 kernel."""
    every = tuple(operands) + tuple(int_operands)
    if all(t.device.type == "cpu" for t in every):
        return False
    device = every[0].device
    if device.type != "cuda" or any(t.device != device for t in every):
        raise ValueError(
            f"{name}: operands must all be on one CUDA device (or all on "
            f"the CPU), got {[str(t.device) for t in every]}"
        )
    dtypes = {t.dtype for t in operands}
    if len(dtypes) != 1 or dtypes.pop() not in KERNEL_DTYPES:
        raise TypeError(
            f"{name}: the CUDA kernel takes float32 or bfloat16 storage, every "
            f"operand of one dtype, got {[str(t.dtype) for t in operands]}"
        )
    if any(t.dtype != torch.int32 for t in int_operands):
        raise TypeError(
            f"{name}: the CUDA kernel takes int32 block indices, got "
            f"{[str(t.dtype) for t in int_operands]}"
        )
    if not all(t.is_contiguous() for t in every):
        raise ValueError(f"{name}: the CUDA kernel needs contiguous operands")
    return True


def load_library(sources, name: str, defines=()) -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (if needed) and load one kernel library; cached per process.
    ``defines`` are ``-D`` flags of this library (one source may build
    several libraries under several names).

    Raises when ``nvcc`` is missing or the build fails — there is no
    fallback: a caller holding CUDA tensors gets the kernel or an error.
    Different libraries may be built from several threads at once (one
    ``nvcc`` each); one library is built once.
    """
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LOADED:
            info = _build(sources, name, defines)
            _LOADED[name] = (ctypes.CDLL(str(info.path)), info)
        return _LOADED[name]
