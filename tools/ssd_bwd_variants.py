"""Where K8's backward spends its time: ablated copies of the chunk kernel
in ``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``, each compiled on its
own (with ``ssd_scan.cu``, whose stage kernels the backward calls) and
timed on one card at phase 7 (d)'s shape (mamba2-370m's heads, 8 x 512,
bf16, D), beside the kernels as they are.

    python3 tools/ssd_bwd_variants.py

The copies differ from the source by text edits, each one anchored to a
line of the chunk kernel (the run stops, naming the anchor, if the source
no longer has it):

  kernel          the source as it is;
  no band         the band's tiles left out (dM, M^T dy, the rows' Z);
  no dm loop      the band's products dy_t . x_s left out;
  no dx band      the band's M^T dy left out;
  no u            the state term B g_out^T left out;
  no dB           the dB partial's product x g_out left out;
  no dC           the dC partial's product dy h_in left out;
  no state fills  B, g_out, h_in and C never loaded into shared memory;
  no x/dy fills   x and dy never loaded into shared memory.

Only ``kernel`` computes gradients; the others are timed for where the
time goes.  Each copy runs in a process of its own, its call timed whole
(CUDA events over CUDA-graph replays) and by launch
(``chip_smoke.launch_split``), in microseconds, with the card's name and
power limit.  It needs the card and nvcc.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"
SRC = "ssd_scan_bwd.cu"


def variants(src: str) -> dict[str, str]:
    """Each ablated copy of ``src``, by name."""
    def edit(*pairs):
        out = src
        for old, new in pairs:
            if out.count(old) != 1:
                raise RuntimeError(f"ssd_bwd_variants: the kernels do not "
                                   f"have the anchor {old[:60]!r} once")
            out = out.replace(old, new)
        return out

    def never(line):
        return line, line.replace("fill_rows(", "if (0) fill_rows(", 1)

    return {
        "kernel": src,
        "no band": edit(("for (int t0 = 0; t0 < rows; t0 += TR) {",
                         "for (int t0 = 0; t0 < 0; t0 += TR) {")),
        "no dm loop": edit((
            "for (int p = 0; p < PP; p += 4) {\n        const float4 xv",
            "for (int p = 0; p < 0; p += 4) {\n        const float4 xv")),
        "no dx band": edit(("for (int i = max(0, so - t0); i < tr; ++i) {",
                            "for (int i = max(0, so - t0); i < 0; ++i) {")),
        "no u": edit((
            "for (int n = 0; n < NN; n += 4) {\n      const float4 bv",
            "for (int n = 0; n < 0; n += 4) {\n      const float4 bv")),
        "no dB": edit((
            "for (int p = 0; p < P; ++p) {\n      const float xv = xr[p];",
            "for (int p = 0; p < 0; ++p) {\n      const float xv = xr[p];")),
        "no dC": edit((
            "for (int p = 0; p < P; ++p) {\n        const float gv = dr[p];",
            "for (int p = 0; p < 0; ++p) {\n        const float gv = dr[p];")),
        "no state fills": edit(
            never("  fill_rows(bsm, LDN, Q, LDN, Bm"),
            never("  fill_rows(gs, LDN"), never("  fill_rows(hs, LDN"),
            never("  fill_rows(bsm, LDN, Q, LDN, Cm")),
        "no x/dy fills": edit(never("  fill_rows(xs, LDX"),
                              never("  fill_rows(dys, LDX, Q")),
    }


def build(name: str, src: str, out: pathlib.Path, nvcc: str):
    """Start nvcc on one copy (with ``ssd_scan.cu``); the library lands in
    ``out / name``."""
    d = out / name.replace(" ", "_").replace("/", "_")
    d.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "ssd_scan.cu").write_text((CSRC / "ssd_scan.cu").read_text())
    (d / SRC).write_text(src)
    return d / "lib.so", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
         str(d / "ssd_scan.cu"), str(d / SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def time_copy(lib_path: str, name: str) -> None:
    """One copy's times, in this process: its library stands in for the
    port's kernel library."""
    import ctypes
    import importlib.util
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ssd_scan as ss
    spec = importlib.util.spec_from_file_location("ssd_bwd_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    lib = ctypes.CDLL(lib_path)
    p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.ssd_scan_fwd.argtypes = [p] * 10 + [i] * 8 + [lg] * 4 + [i, p]
    lib.ssd_scan_fwd.restype = i
    lib.ssd_scan_bwd.argtypes = [p] * 17 + [i] * 7 + [lg] * 4 + [i, p]
    lib.ssd_scan_bwd.restype = i
    kbuild._lib = lib
    dev = torch.device("cuda", 0)
    inp, _ = smoke.ssd_case(torch, np, dev, B=smoke.BATCH, S=smoke.PLEN,
                            dtype="bfloat16", seed=1300)
    dy, _ = smoke.ssd_bwd_inputs(torch, dev, inp, 1310, False)

    def call():
        return ss.ssd_scan_bwd(**inp, dy=dy)
    ms = smoke.time_ms(torch, call, iters=5, reps=10)
    split = smoke.launch_split(torch, call, smoke.SSD_BWD_LAUNCHES, iters=10)
    print(f"[ssd_bwd_variants] {name}: {ms * 1e3:.1f}; "
          + ", ".join(f"{k} {t:.1f}" for k, t in split.items()), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        time_copy(sys.argv[2], sys.argv[3])
        return 0
    sys.path.insert(0, str(HERE / "src"))
    import torch
    from repro_torch.kernels import build as kbuild
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K8's backward can only be timed on the "
                           "card")
    out = kbuild.BUILD_DIR.parent / "ssd_bwd_variants"
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, src in variants((CSRC / SRC).read_text()).items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[ssd_bwd_variants] {card}; mamba2 8 x 512 bf16, us a call")
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"ssd_bwd_variants: {name} did not build:\n"
                               f"{log}")
        subprocess.run([sys.executable, __file__, "--time", str(path), name],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
