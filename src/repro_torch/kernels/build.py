"""Build and load the port's CUDA kernels.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles ``csrc/paged_attention.cu`` (a plain C interface, no PyTorch
headers, so the build takes seconds) into ``build/torch_kernels/`` at the
root of the checkout, at first use, and ``ctypes`` loads it.  The library
is rebuilt whenever the source is newer than it.  Nothing here runs at
import time: the CPU tests import this module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
_REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
_LIB_PATH = BUILD_DIR / "libpaged_attention.so"

_lib: ctypes.CDLL | None = None
build_log = ""           # nvcc's -Xptxas -v report of the last build
build_seconds = 0.0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH): the port's "
                           "CUDA kernels cannot be built on this machine")
    return found


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernel library if it is missing or stale; returns its
    path.  Raises with nvcc's output if the compile fails."""
    global build_log, build_seconds
    if (not force and _LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime):
        return _LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    tmp.replace(_LIB_PATH)
    return _LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_sweep.argtypes = (
            [p] * 10 + [i] * 12 + [f, f, i, p])
        lib.paged_attention_sweep.restype = i
        lib.lse_merge.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.lse_merge.restype = i
        _lib = lib
    return _lib
