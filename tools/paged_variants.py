"""Where the paged or the ring sweep spends its time: ablated copies of
their kernel template, ``gqa_sweep_kernel`` in
``src/repro_torch/kernels/csrc/sweep_fragments.cuh``, each compiled on
its own with ``paged_attention.cu`` (or ``ring_attention.cu``) and timed on
one card at ``chip_smoke.PAGED_FORMS`` (or every ring row of
``chip_smoke.ring_rows``; q bf16, the kernel alone), beside the kernel as
it is.

    python3 tools/paged_variants.py [ring]

The copies differ from the sources by text edits, each one anchored to a
line of the kernel template (the run stops, naming the anchor, if the
source no longer has it):

  kernel       the sources as they are;
  single p     p enters p.v as one bf16 term instead of two (hi + lo);
  no softmax   the online-softmax update left out (p = the masked s);
  loads only   no math on a tile: the q tile, each warp's cp.async ring
               and its waits, the merge and the stores;
  q and out    no tile: the q tile and the stores;
  4 warps      the bf16 forms' blocks at most 4 warps wide, as the fp32
               forms' (a split's key tiles spread over fewer warps);
  regs 128     two blocks an SM asked of the compiler: the bf16 forms at
               most 128 registers a thread (some spill);
  no widen     int8 pools or rings: the int8 rows copied, never
               widened.

Only ``kernel``, ``single p``, ``4 warps`` and ``regs 128`` compute
attention; the others give wrong outputs and are timed for where the
time goes.  One line per row lists every copy's time in microseconds,
with the card's name and power limit; a copy whose registers spill says
so.  It needs the card and nvcc.
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
BODY = "sweep_fragments.cuh"


def variants(src: dict[str, str]) -> dict[str, dict[str, str]]:
    """Each ablated copy of the sources ``src`` (file name -> text), by
    name."""
    def edit(old, new):
        if old not in src[BODY]:
            raise RuntimeError(f"paged_variants: {BODY} no longer has the "
                               f"anchor {old[:60]!r}")
        return dict(src, **{BODY: src[BODY].replace(old, new)})

    return {
        "kernel": src,
        "single p": edit("        for (int x = 0; x < 2; ++x) {\n"
                         "          mma_bf16_16816(st.o[2 * nn]",
                         "        for (int x = 0; x < 1; ++x) {\n"
                         "          mma_bf16_16816(st.o[2 * nn]"),
        "no softmax": edit("    st.update(s_);\n", ""),
        "loads only": edit("    compute(t, sg);\n",
                           "    if (Q < 0) compute(t, sg);\n"),
        "q and out": edit("  const int n_items = n_pool + n_cand;",
                          "  const int n_items = 0 * (n_pool + n_cand);"),
        "4 warps": edit("MAXW = TC ? 8 : 4;", "MAXW = 4;"),
        "regs 128": edit("__launch_bounds__(SweepForm<T, TKV, HD>::MAXW * 32)",
                         "__launch_bounds__(SweepForm<T, TKV, HD>::MAXW * 32,"
                         " 2)"),
        "no widen": edit("          if (N8 % 32 == 0 || c < N8) {",
                         "          if (Q < 0 && (N8 % 32 == 0 || c < N8)) {"),
    }


def build(name: str, src: dict[str, str], kernel: str, out: pathlib.Path,
          nvcc: str):
    """Start nvcc on one copy; the library lands in ``out / name``."""
    d = out / name.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    for fname, text in src.items():
        (d / fname).write_text(text)
    return d / "lib.so", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xptxas", "-v", "-Xcompiler", "-fPIC", "-shared", "-o",
         str(d / "lib.so"), str(d / kernel)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv: list[str]) -> int:
    sweep = argv[0] if argv else "paged"
    if sweep not in ("paged", "ring"):
        print(__doc__)
        return 2
    kernel = f"{sweep}_attention.cu"
    entry = f"{sweep}_attention_sweep"
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch
    from repro_torch import quant
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        raise RuntimeError(f"no card: the {sweep} sweep can only be timed "
                           "on the card")
    spec = importlib.util.spec_from_file_location("paged_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / f"{sweep}_variants"
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cuh")}
    sources[kernel] = (CSRC / kernel).read_text()
    jobs = {name: build(name, src, kernel, out, kbuild.cuda_tool())
            for name, src in variants(sources).items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"paged_variants: {name} did not build:\n{log}")
        spills = [x.strip() for x in log.splitlines()
                  if "spill" in x and " 0 bytes spill stores" not in x]
        if spills:
            print(f"[{sweep}_variants] {name} spills: {spills}")
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = getattr(lib, entry)
        fn.argtypes = ([p] * 13 + [i] * 12 if sweep == "paged"
                       else [p] * 12 + [i] * 13) + [f, f, i, p]
        fn.restype = i
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rows = {}
    for name, lib in libs.items():
        kbuild._lib = lib        # the wrapper launches this copy's kernel
        timer = smoke.paged_timings if sweep == "paged" else smoke.ring_rows
        for row, t in timer(torch, np, dev, da, ops, quant,
                            plain=False).items():
            rows.setdefault(row, []).append(t["ms"])
    print(f"[{sweep}_variants] {card}; kernel us per copy: {', '.join(libs)}")
    for row, times in rows.items():
        print(f"[{sweep}_variants] {row}: "
              + " / ".join(f"{t * 1e3:.1f}" for t in times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
