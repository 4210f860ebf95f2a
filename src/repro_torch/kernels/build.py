"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file (a plain C interface, no PyTorch headers, so each
compiles in seconds) goes through its own ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -c`` process, all started together, and
one more ``nvcc -shared`` links the objects into
``build/torch_kernels/libtorch_kernels.so`` at the root of the checkout, at
first use; ``ctypes`` loads it.  The library is rebuilt whenever any source
or header under ``csrc/`` is newer than it.  Nothing here runs at import
time: the CPU tests import this module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "torch_kernels"
_LIB_PATH = BUILD_DIR / "libtorch_kernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

_lib: ctypes.CDLL | None = None
build_log = ""           # nvcc's -Xptxas -v report of the last build
build_seconds = 0.0


def sources() -> list[pathlib.Path]:
    """The kernel sources compiled into the library."""
    return sorted(_CSRC.glob("*.cu"))


def cuda_tool(name: str = "nvcc") -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``):
    ``$CUDA_HOME/bin``, the toolkit's default install where ``CUDA_HOME``
    is unset, else ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (CUDA_HOME or PATH): the "
                           "port's CUDA kernels cannot be built or read on "
                           "this machine")
    return found


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    built = _LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built for p in _CSRC.iterdir()
               if p.suffix in (".cu", ".cuh"))


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernel library if it is missing or stale; returns its
    path.  Raises with nvcc's output if a compile or the link fails."""
    global build_log, build_seconds
    if not force and not _stale():
        return _LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool()
    tag = os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *_ARCH, "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
               "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out = proc.communicate()[0]
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    objs = [obj for _, obj, _ in jobs]
    tmp = _LIB_PATH.with_suffix(f".{tag}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{build_log}")
    tmp.replace(_LIB_PATH)
    return _LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_sweep.argtypes = (
            [p] * 13 + [i] * 12 + [f, f, i, p])
        lib.paged_attention_sweep.restype = i
        lib.paged_attention_occupancy.argtypes = [i, i, i, p]
        lib.paged_attention_occupancy.restype = i
        lib.ring_attention_sweep.argtypes = (
            [p] * 12 + [i] * 13 + [f, f, i, p])
        lib.ring_attention_sweep.restype = i
        lib.ring_attention_occupancy.argtypes = [i, i, i, p]
        lib.ring_attention_occupancy.restype = i
        lib.lse_merge.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.lse_merge.restype = i
        lib.mla_latent_sweep.argtypes = [p] * 9 + [i] * 11 + [f, f, i, p]
        lib.mla_latent_sweep.restype = i
        lib.mla_latent_occupancy.argtypes = [i, i, p]
        lib.mla_latent_occupancy.restype = i
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 11 + [f, f, i, p]
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 11 + [f, f, i, p]
        lib.flash_attention_bwd.restype = i
        lib.flash_attention_bwd_occupancy.argtypes = [i, i, i, i, p]
        lib.flash_attention_bwd_occupancy.restype = i
        lib.flash_attention_occupancy.argtypes = [i, i, i, p]
        lib.flash_attention_occupancy.restype = i
        lib.rmsnorm_fwd.argtypes = [p] * 4 + [ctypes.c_long, i, f] + [
            i] * 6 + [p]
        lib.rmsnorm_fwd.restype = i
        lib.rmsnorm_bwd.argtypes = [p] * 7 + [ctypes.c_long] + [i] * 8 + [p]
        lib.rmsnorm_bwd.restype = i
        lg = ctypes.c_long
        lib.ssd_scan_fwd.argtypes = ([p] * 10 + [i] * 8 + [lg] * 4
                                     + [i, p])
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_bwd.argtypes = ([p] * 17 + [i] * 7 + [lg] * 4
                                     + [i, p])
        lib.ssd_scan_bwd.restype = i
        lib.ssd_bwd_occupancy.argtypes = [i, p]
        lib.ssd_bwd_occupancy.restype = i
        _lib = lib
    return _lib
