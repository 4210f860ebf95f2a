"""Where the latent sweep spends its time: ablated copies of
``src/repro_torch/kernels/csrc/mla_attention.cu`` (and of the headers it
includes), each compiled on its own and timed on one card at
``chip_smoke.MLA_TIMED`` (q bf16, the kernel alone), beside the kernel as
it is.

    python3 tools/mla_variants.py

The copies differ from the sources by text edits, each one anchored to a
line of the kernel (the run stops, naming the anchor, if the source no
longer has it):

  kernel       the sources as they are;
  rows 16, rows 32
               every bf16 block 16 or 32 (query, head) rows wide, whatever
               ``mla_row_tiles`` would pick;
  4 stages     the latent ring four tiles deep (copies issued three
               tiles ahead; 32-row blocks then fit one an SM);
  regs 128     two blocks an SM asked of the compiler: at 32 rows a
               block at most 128 registers a thread;
  whole q.k    every warp of a 16-row tile computes the whole 16 x 16
               score tile itself (36 k16 steps), no partial scores shared;
  single p     p enters p.v as one bf16 term instead of two (hi + lo);
  no softmax   the online-softmax update left out (p = the masked s);
  no q.k       the score products left out;
  no p.v       the value products left out;
  loads only   no math on a tile: the q tile, the latent ring and its
               barriers, the partial scores' exchange and the stores;
  q and out    no tile: the q tile and the stores.

``kernel``, the ``rows`` copies, ``4 stages``, ``regs 128``, ``whole
q.k`` and ``single p`` compute attention, and each is held against the
plain version at every timed row (its largest |kernel - plain| is
printed); the others give wrong outputs and are timed for where the time
goes.  One line per row lists every copy's time in microseconds, with the
card's name and power limit; a copy whose registers spill says so.  It
needs the card and nvcc.
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
KERNEL = "mla_attention.cu"
EXACT = ("kernel", "rows 16", "rows 32", "4 stages", "regs 128",
         "whole q.k", "single p")


def variants(src: dict[str, str]) -> dict[str, dict[str, str]]:
    """Each ablated copy of the sources ``src`` (file name -> text), by
    name."""
    def edit(name, *pairs):
        out = dict(src)
        for old, new in pairs:
            if old not in out[name]:
                raise RuntimeError(f"mla_variants: {name} no longer has the "
                                   f"anchor {old[:60]!r}")
            out[name] = out[name].replace(old, new)
        return out

    rule = "int mla_row_tiles(int B, int Q, int Hq, int n_splits) {\n"
    qk = ("    for (int kk = 0; kk < KS; ++kk) {",
          "    for (int kk = 0; kk < KS * (Q < 0); ++kk) {")
    pv = ("    for (int nn = 0; nn < MCOLS / 16; ++nn) {",
          "    for (int nn = 0; nn < MCOLS / 16 * (Q < 0); ++nn) {")
    softmax = ("    st.update(s_);\n", "")
    return {
        "kernel": src,
        **{f"rows {16 * mt}": edit(KERNEL, (rule, rule + f"  return {mt};\n"))
           for mt in (1, 2)},
        "4 stages": edit(KERNEL, ("constexpr int MSTAGES = 3;",
                                  "constexpr int MSTAGES = 4;")),
        "regs 128": edit(KERNEL, ("__launch_bounds__(MlaForm<MT>::NT)",
                                  "__launch_bounds__(MlaForm<MT>::NT, 2)")),
        "whole q.k": edit(KERNEL, ("constexpr int ML_KSPLIT = 4;",
                                   "constexpr int ML_KSPLIT = 1;")),
        "single p": edit(KERNEL, ("      for (int x = 0; x < 2; ++x) {\n"
                                  "        mma_bf16_16816(st.o[2 * nn]",
                                  "      for (int x = 0; x < 1; ++x) {\n"
                                  "        mma_bf16_16816(st.o[2 * nn]")),
        "no softmax": edit(KERNEL, softmax),
        "no q.k": edit(KERNEL, qk),
        "no p.v": edit(KERNEL, pv),
        "loads only": edit(KERNEL, qk, pv, softmax),
        "q and out": edit(KERNEL, ("  const int n_items = n_pool + n_cand;",
                                   "  const int n_items = 0 * (n_pool + "
                                   "n_cand);")),
    }


def build(name: str, src: dict[str, str], out: pathlib.Path, nvcc: str):
    """Start nvcc on one copy; the library lands in ``out / name``."""
    d = out / name.replace(" ", "_").replace(".", "")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for fname, text in src.items():
        (d / fname).write_text(text)
    return d / "lib.so", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared", "-o",
         str(d / "lib.so"), str(d / KERNEL)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the latent sweep can only be timed on "
                           "the card")
    spec = importlib.util.spec_from_file_location("mla_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / "mla_variants"
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cuh")}
    sources[KERNEL] = (CSRC / KERNEL).read_text()
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, src in variants(sources).items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"mla_variants: {name} did not build:\n{log}")
        spills = [x.strip() for x in log.splitlines()
                  if "spill" in x and " 0 bytes spill stores" not in x]
        if spills:
            print(f"[mla_variants] {name} spills: {spills}")
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mla_latent_sweep.argtypes = [p] * 9 + [i] * 11 + [f, f, i, p]
        lib.mla_latent_sweep.restype = i
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rows = {}
    for name, lib in libs.items():
        kbuild._lib = lib        # the wrapper launches this copy's kernel
        if name in EXACT:
            err = 0.0
            for verify, pos, Q in smoke.MLA_TIMED:
                c = smoke.mla_case(torch, np, dev, B=4, nb=5, pos=pos, Q=Q,
                                   dtype="bfloat16", seed=1400 + Q)
                args, kw = smoke.mla_args(c)
                for n in (1, 5):
                    got = da.mla_latent_sweep(*args, **kw, n_splits=n)
                    want = da.mla_latent_sweep_torch(*args, **kw,
                                                     n_splits=n)
                    for g, w in zip(*((got, want) if n > 1
                                      else ((got,), (want,)))):
                        err = max(err, float((g.float() - w.float())
                                             .abs().max()))
            print(f"[mla_variants] {name}: max |kernel - plain| {err:.3e}")
        for row, t in smoke.mla_timings(torch, np, dev, da, ops,
                                        plain=False).items():
            rows.setdefault(row, []).append(t["ms"])
    print(f"[mla_variants] {card}; kernel us per copy: {', '.join(libs)}")
    for row, times in rows.items():
        print(f"[mla_variants] {row}: "
              + " / ".join(f"{t * 1e3:.1f}" for t in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
