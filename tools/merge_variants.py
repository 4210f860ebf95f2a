"""Where the merge K2b spends its time, standalone and folded into the
split sweeps: copies of ``csrc/lse_merge.cuh`` (``merge_rows``,
``arrive_last``), of the fused tail in ``csrc/sweep_fragments.cuh`` and
of the latent sweep's call of it in ``csrc/mla_attention.cu``, each
compiled with ``paged_attention.cu`` and ``mla_attention.cu`` into a
library of its own and timed on one card, beside the sources as they are.

    python3 tools/merge_variants.py

Timed, q bf16, CUDA events around CUDA-graph replays: the standalone
``lse_merge`` on fp32 partials of the paged decode (4 x 9 rows), the
paged verify Q 16 (4 x 9 x 16 rows) and the latent decode (4 x 128 rows of
512), S 5, an empty split among them; the paged sweep at smollm's engine
shapes (decode, verify Q 16; S 5) and at h2o's heads (verify Q 16, D
120, S 3) and the latent decode (S 5 at 5 pages, S 16 at 16), each split
alone (``merge=False``) and fused (``merge=True``).

The copies differ from the sources by text edits, each anchored to a line
(the run stops, naming the anchor, if the source no longer has it):

  kernel        the sources as they are;
  EPT 1         one float4 column a thread at a time (MERGE_EPT 1, not
                2; the latent tail keeps its 4);
  latent EPT 2  the bf16 latent sweep's 16-row blocks' tail at two float4
                columns a thread at a time, as the others, not four;
  SPC 4         four splits' loads together in every form (MERGE_SPC 4:
                S 5 takes two round trips; head dim 120 takes 4 already);
  fence sc      the arrival's fences sequentially consistent
                (fence.sc.gpu, as __threadfence) rather than acq_rel;
  noinline      the fused tail a call (__noinline__), so that the
                sweep's own code is compiled without it;
  merge twice   the fused tail merges its rows twice, so that the
                second pass reads partials this SM has read already
                (is the first read of another block's fresh partials
                what costs?);
  weak loads    the merge's loads plain (weak) loads rather than __ldcg
                (ld.global.cg, which sm_90 compiles to strong gpu-scope
                loads, LDG.E.STRONG.GPU); the acquire fence before them
                invalidates the SM's L1 (CCTL.IVALL), so they read L2;
  arrive only   the fused tail counts its blocks in, and no block merges;
  no arrive     every block of a split merges at once, without the
                counter (a race: wrong results, timed for the merge's own
                cost).

``arrive only`` and ``no arrive`` give wrong fused outputs.  One line per
row lists every copy's time in microseconds, with the card's name and
power limit; a copy whose registers spill says so.  It needs the card and
nvcc; ``variants()`` checks the anchors without them.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
CSRC = HERE / "src" / "repro_torch" / "kernels" / "csrc"
MERGE, TAIL = "lse_merge.cuh", "sweep_fragments.cuh"
UNITS = ("paged_attention.cu", "mla_attention.cu")


def variants(src: dict[str, str]) -> dict[str, dict[str, str]]:
    """Each copy of the sources ``src`` (file name -> text), by name."""
    def edit(fname, old, new, base=None):
        base = src if base is None else base
        if old not in base[fname]:
            raise RuntimeError(f"merge_variants: {fname} no longer has the "
                               f"anchor {old[:60]!r}")
        return dict(base, **{fname: base[fname].replace(old, new)})

    def loads(helpers):
        """The merge's L2 loads (__ldcg) replaced by ``ldw`` overloads."""
        return edit(MERGE, "__ldcg(", "ldw(", edit(
            MERGE, "constexpr int MERGE_EPT = 2;",
            helpers + "constexpr int MERGE_EPT = 2;"))

    return {
        "kernel": src,
        "EPT 1": edit(MERGE, "constexpr int MERGE_EPT = 2;",
                      "constexpr int MERGE_EPT = 1;"),
        "latent EPT 2": edit(UNITS[1], "merge_tail<T, MDV, MT == 1 ? 4 : "
                             "MERGE_EPT>(", "merge_tail<T, MDV>("),
        "SPC 4": edit(MERGE, "constexpr int MERGE_SPC = 8;",
                      "constexpr int MERGE_SPC = 4;"),
        "fence sc": edit(MERGE, '"fence.acq_rel.gpu;"', '"fence.sc.gpu;"'),
        "noinline": edit(TAIL, "__device__ __forceinline__ void "
                         "merge_tail(",
                         "__device__ __noinline__ void merge_tail("),
        "merge twice": edit(TAIL, "  merge_rows<DV == 120",
                            "  merge_rows<DV == 120 ? 4 : MERGE_SPC, EPT>(lse,"
                            " partial, out, live, Q, S, DV, TailRows{row0, G,"
                            " hk, b, Q, Hq, S});\n  merge_rows<DV == 120"),
        "weak loads": loads("template <typename T>\n__device__ "
                            "__forceinline__ T ldw(const T* p) { return *p; "
                            "}\n"),
        "arrive only": edit(TAIL, "  if (!arrive_last(counter, S)) return;",
                            "  if (!arrive_last(counter, S) || S > 0) "
                            "return;"),
        "no arrive": edit(TAIL, "  if (!arrive_last(counter, S)) return;",
                          "  __syncthreads();"),
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
         str(d / "lib.so"), *(str(d / u) for u in UNITS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(lib) -> None:
    """The argument types of the entries the wrappers call."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_sweep.argtypes = [p] * 13 + [i] * 12 + [f, f, i, p]
    lib.lse_merge.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.mla_latent_sweep.argtypes = [p] * 9 + [i] * 11 + [f, f, i, p]
    for fn in (lib.paged_attention_sweep, lib.lse_merge,
               lib.mla_latent_sweep):
        fn.restype = i


def rows(torch, np, dev, da, smoke):
    """{row: call} of every timed row (q bf16, S 5)."""
    out = {}
    rng = np.random.default_rng(7)
    for label, shape in (("paged decode", (4, 9, 5, 1, 64)),
                         ("paged verify Q 16", (4, 9, 5, 16, 64)),
                         ("latent decode", (4, 128, 5, 1, 512))):
        part = torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)
        lse = torch.tensor(rng.standard_normal(shape[:-1]),
                           dtype=torch.float32, device=dev)
        lse[:, :, 3] = da.NEG_INF
        part[:, :, 3] = 0.0
        out[f"lse_merge, {label}"] = (
            lambda p=part, l=lse: da.lse_merge(p, l, torch.bfloat16))
    for verify, pos, Q, heads, S in (
            (False, [64, 71, 75, 79], 1, dict(Hq=9, Hkv=3, D=64), 5),
            (True, [32, 48, 16, 32], 16, dict(Hq=9, Hkv=3, D=64), 5),
            (True, [32, 48, 16, 32], 16, smoke.H2O_HEADS, 3)):
        c = smoke.make_case(torch, np, dev, B=4, ps=16, nb=5, pos=pos, Q=Q,
                            dtype="bfloat16", seed=100 + Q, **heads)
        args, kw = smoke.sweep_args(c, verify)
        name = ("paged verify Q 16" if verify else "paged decode") + (
            f" D {heads['D']}" if heads["D"] != 64 else "")
        for merge in (False, True):
            out[f"{name} {'fused' if merge else 'split'}"] = (
                lambda a=args, k=kw, m=merge, n=S: da.paged_attention_sweep(
                    *a, **k, n_splits=n, merge=m))
    for nb, pos, S in ((5, [64, 71, 75, 79], 5),
                       (16, [17, 100, 200, 255], 16)):
        c = smoke.mla_case(torch, np, dev, B=4, nb=nb, pos=pos, Q=1,
                           dtype="bfloat16", seed=1401)
        args, kw = smoke.mla_args(c)
        for merge in (False, True):
            out[f"latent decode S {S} {'fused' if merge else 'split'}"] = (
                lambda a=args, k=kw, m=merge, n=S: da.mla_latent_sweep(
                    *a, **k, n_splits=n, merge=m))
    return out


def main(argv: list[str]) -> int:
    if argv:
        print(__doc__)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import importlib.util

    import numpy as np
    import torch
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import decode_attention as da
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the merge can only be timed on the card")
    spec = importlib.util.spec_from_file_location("merge_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = kbuild.BUILD_DIR.parent / "merge_variants"
    sources = {p.name: p.read_text() for p in CSRC.glob("*.cuh")}
    sources.update({u: (CSRC / u).read_text() for u in UNITS})
    jobs = {name: build(name, src, out, kbuild.cuda_tool())
            for name, src in variants(sources).items()}
    libs = {}
    for name, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"merge_variants: {name} did not build:\n"
                               f"{log}")
        spills = smoke.sweep_spills(log, ("gqa_sweep_kernel", "mla_latent",
                                          "lse_merge"))
        if spills:
            print(f"[merge_variants] {name} spills: {spills}")
        lib = ctypes.CDLL(str(path))
        bind(lib)
        libs[name] = lib
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    times = {}
    for name, lib in libs.items():
        kbuild._lib = lib        # the wrappers launch this copy's kernels
        for row, call in rows(torch, np, dev, da, smoke).items():
            times.setdefault(row, []).append(smoke.time_ms(torch, call))
    print(f"[merge_variants] {card}; us per copy: {', '.join(libs)}")
    for row, ts in times.items():
        print(f"[merge_variants] {row}: "
              + " / ".join(f"{t * 1e3:.2f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
