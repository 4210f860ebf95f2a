"""Where K4's Hopper backward kernels spend their time: ablated copies of
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, each compiled on
its own and timed on one card at phase 7 (d)'s shape (smollm's 8 x 512,
Hq 9, Hkv 3, D 64, bf16, causal), beside the kernels as they are.

    python3 tools/bwd_variants.py [--sass]

The copies differ from the source by text edits, each one anchored to a
line of the kernels (the run stops, naming the anchor, if the source no
longer has it):

  kernel       the source as it is;
  no softmax   p = s and ds = dp: no scale, exponential, mask or delta;
  no ss        the score products (s, dp) left out;
  no rs        the gradient products (dv, dk, dq) left out;
  loads only   every tile classified SKIP: the rings, their barriers and
               the stores, no math;
  k v in smem  the dk / dv kernel's score products read k and v from
               shared memory (ss) instead of register fragments;
  2 blocks     k v in smem, and the dk / dv kernel held to 168 registers,
               so that two of its blocks fit an SM;
  dq beside    the dq kernel launched on a second stream (forked from the
               caller's after the pack and joined back after), so that it
               runs beside the dk / dv kernel.

Only ``kernel`` computes gradients; the others are timed for where the
time goes.  Each copy's call is timed whole (CUDA events over CUDA-graph
replays) and by launch (``chip_smoke.launch_split``: delta, dk / dv, dq),
in microseconds, with the card's name and power limit; ``--sass`` also
leaves each copy's ``cuobjdump -sass`` beside its library under
``build/bwd_variants/``.  It needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import importlib.util
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"
SRC = "flash_attention_bwd.cu"


def variants(src: str) -> dict[str, str]:
    """Each ablated copy of ``src``, by name."""
    def edit(*pairs):
        out = src
        for old, new in pairs:
            if old not in out:
                raise RuntimeError(f"bwd_variants: the kernels no longer "
                                   f"have the anchor {old[:60]!r}")
            out = out.replace(old, new)
        return out

    dkdv_pds = ("        wg_p_ds<CAP>(s[4 * j + e], dp[4 * j + e], (e & 1) "
                "? l.y : l.x,\n                     (e & 1) ? dl.y : dl.x, "
                "keep, a.m, p, ds);")
    dq_pds = ("      wg_p_ds<CAP>(s[4 * j + e], dp[4 * j + e], lr[h], dr[h], "
              "keep, a.m, p,\n                   ds);")
    ss = [("    wg_rs(s, kf, st + c * CH * 128);\n"
           "    wg_rs(dp, vf, st + PK * F::QPANEL + c * CH * 128);\n", ""),
          ("    wg_ss<CH>(s, ks, F::KPANEL, st + c * CH * 128, F::QPANEL, "
           "4 * PK);\n", ""),
          ("    wg_ss<CH>(dp, vs, F::KPANEL, st + PK * F::QPANEL + c * CH * "
           "128,\n              F::QPANEL, 4 * PV);\n", ""),
          ("  wg_ss<64>(s, qs + r0 * 128, F::QPANEL, st, F::KPANEL, 4 * PK);\n",
           ""),
          ("  wg_ss<64>(dp, qs + PK * F::QPANEL + r0 * 128, F::QPANEL,\n"
           "            st + PK * F::KPANEL, F::KPANEL, 4 * PV);\n", "")]
    rs = [("        wgmma_rs_n64<1>(adv[p], pa[kk], sw128_desc(",
           "        if (a.Sq < 0) wgmma_rs_n64<1>(adv[p], pa[kk], sw128_desc("),
          ("        wgmma_rs_n64<1>(adk[p], da[kk], sw128_desc(",
           "        if (a.Sq < 0) wgmma_rs_n64<1>(adk[p], da[kk], sw128_desc("),
          ("      wgmma_rs_n64<1>(adq[p], da[kk], sw128_desc(",
           "      if (a.Sq < 0) wgmma_rs_n64<1>(adq[p], da[kk], sw128_desc(")]
    areg = "  static constexpr bool AREG = PK == 1 && PV == 1;"
    areg_off = "  static constexpr bool AREG = false;"
    launch_dkdv = ("  kdkdv<<<(unsigned)(nkt * a.Hkv * a.B), WG_THREADS, "
                   "F::dkdv_smem,\n"
                   "          a.stream>>>(mq, mk, mv, mdo, w);\n")
    return {
        "kernel": src,
        "no softmax": edit(
            (dkdv_pds, "        p = s[4 * j + e] + (keep ? 0.f : 1.f) "
                       "* l.x;\n        ds = dp[4 * j + e] + dl.x;"),
            (dq_pds, "      p = s[4 * j + e] + (keep ? 0.f : 1.f) * lr[h];"
                     "\n      ds = dp[4 * j + e] + dr[h];")),
        "no ss": edit(*ss),
        "no rs": edit(*rs),
        "loads only": edit(("    const int cls = tile_class(",
                            "    const int cls = TILE_SKIP * tile_class(")),
        "k v in smem": edit((areg, areg_off)),
        "2 blocks": edit((areg, areg_off),
                         ("__global__ void __launch_bounds__(WG_THREADS, 1)\n"
                          "    fa_bwd_dkdv_wgmma_kernel(",
                          "__global__ void __launch_bounds__(WG_THREADS, 2)\n"
                          "    fa_bwd_dkdv_wgmma_kernel(")),
        "dq beside": edit((
            launch_dkdv +
            "  e = cudaGetLastError();\n"
            "  if (e != cudaSuccess) return (int)e;\n"
            "  kdq<<<(unsigned)(ntq * F::NH * a.Hkv * a.B), WG_THREADS, "
            "F::dq_smem,\n        a.stream>>>(mq, mk, mv, mdo, w);\n"
            "  return (int)cudaGetLastError();\n",
            "  static cudaStream_t side = nullptr;\n"
            "  static cudaEvent_t fork, join;\n"
            "  if (side == nullptr) {\n"
            "    cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking);\n"
            "    cudaEventCreateWithFlags(&fork, cudaEventDisableTiming);\n"
            "    cudaEventCreateWithFlags(&join, cudaEventDisableTiming);\n"
            "  }\n"
            "  cudaEventRecord(fork, a.stream);\n"
            "  cudaStreamWaitEvent(side, fork, 0);\n"
            "  kdq<<<(unsigned)(ntq * F::NH * a.Hkv * a.B), WG_THREADS, "
            "F::dq_smem,\n        side>>>(mq, mk, mv, mdo, w);\n"
            "  cudaEventRecord(join, side);\n" + launch_dkdv +
            "  cudaStreamWaitEvent(a.stream, join, 0);\n"
            "  return (int)cudaGetLastError();\n")),
    }


def build(name: str, src: str, out: pathlib.Path, nvcc: str):
    """Start nvcc on one copy; the library lands in ``out / name``."""
    d = out / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / SRC).write_text(src)
    return d / "lib.so", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(d / "lib.so"),
         str(d / SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    sys.path.insert(0, str(HERE / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K4's backward can only be timed on the "
                           "card")
    spec = importlib.util.spec_from_file_location("bwd_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / "bwd_variants"
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, src in variants((CSRC / SRC).read_text()).items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if "--sass" in sys.argv:
            sass = subprocess.run([kbuild.cuda_tool("cuobjdump"), "-sass",
                                   str(path)], capture_output=True,
                                  text=True).stdout
            (path.parent / "lib.sass").write_text(sass)
        if proc.returncode != 0:
            raise RuntimeError(f"bwd_variants: {name} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd.argtypes = [p] * 10 + [i] * 11 + [f, f, i, p]
        lib.flash_attention_bwd.restype = i
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    shp = dict(B=smoke.BATCH, Sq=smoke.PLEN, Sk=smoke.PLEN, Hq=9, Hkv=3, D=64)
    q, k, v = smoke.fa_case(torch, np, dev, dtype="bfloat16", seed=990,
                            **shp)
    o, lse = fa._forward(q, k, v, causal=True, window=0, logit_cap=0.0,
                         scale=None, q_offset=0, with_lse=True)
    do = torch.randn_like(o)
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    bq, n_ws = fa.bwd_plan(D, Dv, q.dtype, B, Sq, Hq, Hkv)
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    print(f"[bwd_variants] {card}; smollm 8 x 512 (64, 64) G 3, us a call")
    for name, lib in libs.items():
        def run(lib=lib):
            err = lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), ws.data_ptr(),
                *(g.data_ptr() for g in grads), B, Sq, Sk, Hq, Hkv, D, Dv,
                bq, 1, 0, 0, 0.0, D ** -0.5, 1,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err}")
        ms = smoke.time_ms(torch, run, iters=5, reps=10)
        split = smoke.launch_split(
            torch, run, smoke.BWD_LAUNCHES["flash_attention_bwd"])
        print(f"[bwd_variants] {name}: {ms * 1e3:.1f}; "
              + ", ".join(f"{k} {t:.1f}" for k, t in split.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
