"""Where K4's tensor-core kernel spends its time: ablated copies of
``src/repro_torch/kernels/csrc/flash_attention.cu``, each compiled on its
own and timed on one card at ``chip_smoke.K4_SHAPES`` (bf16), beside the
kernel as it is.

    python3 tools/k4_variants.py

The copies differ from the source by text edits, each one anchored to a
line of the kernel (the run stops, naming the anchor, if the source no
longer has it):

  kernel       the source as it is;
  single p     p enters p.v as one bf16 term instead of two (hi + lo);
  no softmax   scale, cap, mask and online softmax left out (p = s);
  loads only   no math in the tile loop: q, the k/v ring, its barriers,
               the output stores;
  q and out    no tile visited: the q tile and the output stores only.

Only ``kernel`` and ``single p`` compute attention; the others give wrong
outputs and are timed for where the time goes.  One line per shape lists
every copy's time in microseconds, with the card's name and power limit.
It needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib.util
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"


def variants(src: str) -> dict[str, str]:
    """Each ablated copy of ``src``, by name."""
    def edit(*pairs):
        out = src
        for old, new in pairs:
            if old not in out:
                raise RuntimeError(f"k4_variants: the kernel no longer has "
                                   f"the anchor {old[:60]!r}")
            out = out.replace(old, new)
        return out

    soft0 = src.index("      // scale and soft-cap, each loop branch-free")
    soft1 = src.index("      // o += p . v, p in bf16 A fragments")
    split = ("              mma_bf16_16816(o[mt][2 * nn], a[mt][x], bv[0], "
             "bv[1]);")
    return {
        "kernel": src,
        "single p": edit(
            ("            for (int x = 0; x < 2; ++x) {\n" + split,
             "            for (int x = 0; x < 1; ++x) {\n" + split),
            ("            for (int x = 0; x < 2; ++x)\n"
             "              mma_bf16_16816(o[mt][NO - 1]",
             "            for (int x = 0; x < 1; ++x)\n"
             "              mma_bf16_16816(o[mt][NO - 1]")),
        "no softmax": edit((src[soft0:soft1], "")),
        "loads only": edit(("    if (warp_live) {\n      const int k0 = t * BK;",
                            "    if (warp_live && Sk < 0) {\n"
                            "      const int k0 = t * BK;")),
        "q and out": edit(("  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1)"
                           " / BK;",
                           "  const int t_lo = k_lo / BK, t_hi = t_lo;")),
    }


def build(name: str, src: str, out: pathlib.Path, nvcc: str):
    """Start nvcc on one copy; the library lands in ``out / name``."""
    d = out / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "flash_attention.cu").write_text(src)
    return d / "lib.so", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
         str(d / "flash_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build as kbuild
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K4 can only be timed on the card")
    spec = importlib.util.spec_from_file_location("k4_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / "k4_variants"
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, src in variants(
                (CSRC / "flash_attention.cu").read_text()).items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"k4_variants: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 11 + [f, f, i, p]
        lib.flash_attention_fwd.restype = i
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[k4_variants] {card}; kernel us per copy: {', '.join(libs)}")
    for i, (row, label, shp, kw, _) in enumerate(smoke.K4_SHAPES):
        q, k, v = smoke.fa_case(torch, np, dev, dtype="bfloat16",
                                seed=600 + i, **shp)
        B, Sq, Hq, D = q.shape
        Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
        o = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, B,
                Sq, Sk, Hq, Hkv, D, Dv, 128 // (Hq // Hkv), 1,
                int(kw.get("window", 0)), 0, float(kw.get("logit_cap", 0.0)),
                float(kw.get("scale", D ** -0.5)), 1)
        times = []
        for name, lib in libs.items():
            def run(lib=lib):
                err = lib.flash_attention_fwd(
                    *args, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            times.append(smoke.time_ms(torch, run, iters=5,
                                       reps=5 if Sq > 1024 else 20))
        print(f"[k4_variants] {row} ({label}): "
              + " / ".join(f"{t * 1e3:.1f}" for t in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
