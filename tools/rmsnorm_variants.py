"""Where K9, the fused RMSNorm, spends its time: copies of
``src/repro_torch/kernels/csrc/rmsnorm.cu`` with other cache hints, and
other launch shapes, each timed on one card at ``chip_smoke.RMS_TIMED``
(bf16, the kernel alone; ``F.rms_norm`` once beside them), beside the
kernel as it is.

    python3 tools/rmsnorm_variants.py

The copies differ from the source by text edits, each one anchored to a
line of the kernel (the run stops, naming the anchor, if the source no
longer has it), or by the launch shape the wrapper hands the kernel:

  kernel          the source and ``rmsnorm.launch_shape`` as they are;
  cached loads    x read by plain loads through L1 and L2 (``__ldg``)
                  instead of streaming (evict-first) loads;
  cached stores   out written by plain stores instead of streaming ones;
  cached both     both;
  one vector      every width's shape with the fewest vectors of 8
                  values a thread at every row count (the kernel's for
                  fewer than ``rmsnorm.FEW_ROWS`` rows), the source as it
                  is;
  one, cached     both of the last two.

Every copy computes RMSNorm; each is held against the plain version at
every timed row (its largest |kernel - plain| is printed).  One line per
row lists every copy's time in microseconds, then F.rms_norm's, with the
card's name and power limit.  It needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import importlib.util
import pathlib
import shutil
import subprocess
import sys
import types

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"
KERNEL = "rmsnorm.cu"
LOAD = ("__ldcs(reinterpret_cast<const uint4*>(p))",
        "__ldcs(reinterpret_cast<const float4*>(p))",
        "__ldcs(reinterpret_cast<const float4*>(p) + 1)")
STORE = ("__stcs(reinterpret_cast<uint4*>(p), o);",
         "__stcs(reinterpret_cast<float4*>(p), make_float4(",
         "__stcs(reinterpret_cast<float4*>(p) + 1,")


def variants(src: dict[str, str]) -> dict[str, tuple[dict[str, str], bool]]:
    """Each copy of the sources ``src`` (file name -> text), by name, with
    whether it takes the one-vector launch shape."""
    def edit(*pairs):
        text = src[KERNEL]
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"rmsnorm_variants: {KERNEL} no longer "
                                   f"has the anchor {old[:60]!r}")
            text = text.replace(old, new)
        return dict(src, **{KERNEL: text})

    loads = [(a, a.replace("__ldcs", "__ldg")) for a in LOAD]
    stores = [(STORE[0], "*reinterpret_cast<uint4*>(p) = o;"),
              (STORE[1], "*reinterpret_cast<float4*>(p) = (make_float4("),
              (STORE[2], "*(reinterpret_cast<float4*>(p) + 1) = (")]
    return {"kernel": (src, False),
            "cached loads": (edit(*loads), False),
            "cached stores": (edit(*stores), False),
            "cached both": (edit(*loads, *stores), False),
            "one vector": (src, True),
            "one, cached": (edit(*loads, *stores), True)}


def one_vector(rms, d: int, rows: int) -> tuple[int, int, int]:
    """``rms.launch_shape`` taking the fewest vectors a thread at any row
    count."""
    return rms.launch_shape(d, 1)


def build(name: str, src: dict[str, str], out: pathlib.Path, nvcc: str):
    """Start nvcc on one copy; the library lands in ``out / name``."""
    d = out / name.replace(" ", "_").replace(",", "")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for fname, text in src.items():
        (d / fname).write_text(text)
    return d / "lib.so", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared", "-o",
         str(d / "lib.so"), str(d / KERNEL)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv: list[str]) -> int:
    if argv:
        print(__doc__)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models import common
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K9 can only be timed on the card")
    spec = importlib.util.spec_from_file_location("rms_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / "rmsnorm_variants"
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cuh")}
    sources[KERNEL] = (CSRC / KERNEL).read_text()
    copies = variants(sources)
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, (src, _) in copies.items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"rmsnorm_variants: {name} did not build:\n"
                               f"{log}")
        spills = [x.strip() for x in log.splitlines()
                  if "spill" in x and " 0 bytes spill stores" not in x]
        if spills:
            print(f"[rmsnorm_variants] {name} spills: {spills}")
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rmsnorm_fwd.argtypes = [p, p, p, ctypes.c_long, i, f] + [i] * 6 + [
            p]
        lib.rmsnorm_fwd.restype = i
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    default = rms.launch_shape
    default_rms = types.SimpleNamespace(launch_shape=default)
    rows, library = {}, {}
    for n, (name, lib) in enumerate(libs.items()):
        kbuild._lib = lib        # the wrapper launches this copy's kernel
        rms.launch_shape = (functools.partial(one_vector, default_rms)
                            if copies[name][1] else default)
        for row, t in smoke.rms_rows(torch, np, dev, rms, common,
                                     plain=False, library=n == 0).items():
            rows.setdefault(row, []).append(t["ms"])
            if n == 0:
                library[row] = t["library_ms"]
        rng = np.random.default_rng(1)
        worst = 0.0
        for _, n_rows, d, gemma in smoke.RMS_TIMED:
            x = torch.tensor(rng.standard_normal((n_rows, d)),
                             dtype=torch.float32, device=dev).to(
                                 torch.bfloat16)
            w = torch.tensor(rng.standard_normal(d), dtype=torch.float32,
                             device=dev)
            got = rms.rmsnorm(x, w, gemma_style=gemma)
            want = common.rmsnorm(x, w, 1e-6, gemma_style=gemma)
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max()))
        print(f"[rmsnorm_variants] {name}: largest |kernel - plain| over the "
              f"timed rows {worst:.3e}")
    rms.launch_shape = default
    print(f"[rmsnorm_variants] {card}; kernel us per copy: "
          f"{', '.join(libs)}; then F.rms_norm")
    for row, times in rows.items():
        lib = library[row]
        print(f"[rmsnorm_variants] K9 {row}: "
              + " / ".join(f"{t * 1e3:.2f}" for t in times)
              + ("; n/a" if lib is None else f"; {lib * 1e3:.2f}"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
