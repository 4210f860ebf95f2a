"""Where K8, the SSD scan, spends its time: ablated copies of
``src/repro_torch/kernels/csrc/ssd_scan.cu``, each compiled on its own
with the headers it includes and timed on one card at
``chip_smoke.SSD_TIMED`` (bf16, the kernel alone), beside the kernel as
it is.

    python3 tools/ssd_variants.py

The copies differ from the source by text edits, each one anchored to a
line of the kernel (the run stops, naming the anchor, if the source no
longer has it):

  kernel        the source as it is;
  single bf16   the three fp32 operands (decayed scores, w x, the
                incoming state) enter their products as one bf16 term
                instead of two (hi + lo);
  loads only    no product: the tiles loaded into shared memory, each
                chunk's scan of dt A, the state pass and the stores;
  scores only   only the launch of C B^T per (batch, group, chunk);
  no scores     every launch but that one;
  no state pass the state pass not launched;
  out only      only the output launch;
  p tile 16, p tile 32
                every launch at P tiles of 16 or 32 columns, whatever
                ``ssd_p_tile`` would pick;
  out 4 warps   the output kernel's blocks 4 warps wide, each warp over
                all of its P tile (no two warps build the same decayed
                scores);
  fast exp      the decay exponentials of the output kernel by __expf.

Then, for the source as it is, each of its kernels' mean device time a
call at every timed row, from ``torch.profiler`` over five calls (the
launches of one call run in order on one stream).

Only ``kernel``, ``single bf16``, the ``p tile`` copies, ``out 4 warps``
and ``fast exp`` compute the scan: each is held against the plain
version at every timed row (its largest |kernel - plain| over y and the
final state is printed); the others give wrong outputs and are timed for
where the time goes.  One line per row lists every copy's time in
microseconds, with the card's name and power limit; a copy whose
registers spill says so.  It needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib.util
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"
KERNEL = "ssd_scan.cu"
EXACT = ("kernel", "single bf16", "p tile 16", "p tile 32", "out 4 warps",
         "fast exp")

# the launches of the tensor-core kernels, as they start in launch_tc
SCORES = ("    ssd_scores_kernel<<<",)
STATES = ("      ssd_states_kernel<PT><<<dim3(ptiles",
          "    ssd_states_kernel<PT><<<dim3(ng * ptiles")
PASS = ("    ssd_pass_kernel<<<dim3((int)",)
OUT = ("    ssd_out_kernel<PT><<<",)


def variants(src: dict[str, str]) -> dict[str, dict[str, str]]:
    """Each ablated copy of the sources ``src`` (file name -> text), by
    name."""
    def edit(*pairs):
        text = src[KERNEL]
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"ssd_variants: {KERNEL} no longer has "
                                   f"the anchor {old[:60]!r}")
            text = text.replace(old, new)
        return dict(src, **{KERNEL: text})

    rule = "int ssd_p_tile(int B, int H, int P, int nc) {\n"

    def skip(*launches):     # each launch statement under a false guard
        return [(a, a.replace("ssd_", "if (Q < 0) ssd_", 1))
                for group in launches for a in group]

    return {
        "kernel": src,
        "single bf16": edit(*[(f"mma_bf16_16816({acc}, {a}, {b});\n", "")
                              for acc, a, b in (
                                  ("acc[2 * jp]", "al", "bb[0], bb[1]"),
                                  ("acc[2 * jp + 1]", "al", "bb[2], bb[3]"),
                                  ("acc[jj]", "a", "bl0, bl1"),
                                  ("acc[2 * jp]", "al", "bx[0], bx[1]"),
                                  ("acc[2 * jp + 1]", "al", "bx[2], bx[3]"))]),
        "loads only": edit(
            ("        if (16 * kk < Np) {\n          uint32_t bb[4];",
             "        if (16 * kk < Np && Q < 0) {\n"
             "          uint32_t bb[4];"),
            ("  for (int kk = 0; kk < KT; ++kk) {",
             "  for (int kk = 0; kk < KT * (Q < 0); ++kk) {"),
            ("      for (int kk = 0; kk < Np / 16; ++kk) {",
             "      for (int kk = 0; kk < Np / 16 * (Q < 0); ++kk) {"),
            ("    for (int kk = 0; kk <= i; ++kk) {",
             "    for (int kk = 0; kk <= i && Q < 0; ++kk) {")),
        "scores only": edit(*skip(STATES, PASS, OUT)),
        "no scores": edit(*skip(SCORES)),
        "no state pass": edit(*skip(PASS)),
        "out only": edit(*skip(SCORES, STATES, PASS)),
        **{f"p tile {pt}": edit((rule, rule + f"  return {pt};\n"))
           for pt in (16, 32)},
        "out 4 warps": edit(("static constexpr int NW = PT == 64 ? 4 : 2;",
                             "static constexpr int NW = PT / 8;")),
        "fast exp": edit(("gv[f].x * expf(fminf(", "gv[f].x * __expf(fminf("),
                         ("gv[f].y * expf(fminf(", "gv[f].y * __expf(fminf("),
                         ("const float e0 = expf(cum[t0]), "
                          "e1 = expf(cum[t1]);",
                          "const float e0 = __expf(cum[t0]), "
                          "e1 = __expf(cum[t1]);")),
    }


def build(name: str, src: dict[str, str], out: pathlib.Path, nvcc: str):
    """Start nvcc on one copy; the library lands in ``out / name``."""
    d = out / name.replace(" ", "_")
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
    from repro_torch.kernels import ssd_scan as ss
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K8 can only be timed on the card")
    spec = importlib.util.spec_from_file_location("ssd_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / "ssd_variants"
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cuh")}
    sources[KERNEL] = (CSRC / KERNEL).read_text()
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, src in variants(sources).items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"ssd_variants: {name} did not build:\n{log}")
        spills = [x.strip() for x in log.splitlines()
                  if "spill" in x and " 0 bytes spill stores" not in x]
        if spills:
            print(f"[ssd_variants] {name} spills: {spills}")
        lib = ctypes.CDLL(str(path))
        p, i, lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.ssd_scan_fwd.argtypes = [p] * 10 + [i] * 8 + [lg] * 4 + [i, p]
        lib.ssd_scan_fwd.restype = i
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rows = {}
    for name, lib in libs.items():
        kbuild._lib = lib        # the wrapper launches this copy's kernel
        for row, t in smoke.ssd_rows(torch, np, dev, ss, plain=False).items():
            rows.setdefault(row, []).append(t["ms"])
        if name in EXACT:
            worst = 0.0
            for i, (label, B, S) in enumerate(smoke.SSD_TIMED):
                inp, _ = smoke.ssd_case(torch, np, dev, B=B, S=S,
                                        dtype="bfloat16", seed=900 + i)
                y, h = ss.ssd_scan(**inp, return_state=True)
                wy, wh = ss.ssd_scan_torch(**inp, return_state=True)
                worst = max(worst, float((y.float() - wy.float()).abs().max()),
                            float((h - wh).abs().max()))
            print(f"[ssd_variants] {name}: largest |kernel - plain| over the "
                  f"timed rows (y and final state) {worst:.3e}")
    print(f"[ssd_variants] {card}; kernel us per copy: {', '.join(libs)}")
    for row, times in rows.items():
        print(f"[ssd_variants] K8 {row}: "
              + " / ".join(f"{t * 1e3:.1f}" for t in times))
    kbuild._lib = libs["kernel"]
    for row, per_kernel in kernel_times(torch, np, dev, ss, smoke).items():
        print(f"[ssd_variants] K8 {row}, device us a call by kernel: "
              + (", ".join(f"{k} {v:.1f}" for k, v in per_kernel.items())
                 or "no device time in the profile"))
    return 0


def kernel_times(torch, np, dev, ss, smoke, calls=5):
    """Mean device time a call of each of K8's kernels at every timed row
    (``torch.profiler``), by row and kernel name."""
    import re
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for i, (label, B, S) in enumerate(smoke.SSD_TIMED):
        inp, _ = smoke.ssd_case(torch, np, dev, B=B, S=S, dtype="bfloat16",
                                seed=900 + i)
        for _ in range(2):
            ss.ssd_scan(**inp, return_state=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ss.ssd_scan(**inp, return_state=True)
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            m = re.search(r"(ssd_\w+_kernel)(<\d+>)?", ev.key)
            us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
            if m and us:
                name = m.group(1) + (m.group(2) or "")
                per[name] = per.get(name, 0.0) + us / calls
        out[label] = per
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
