"""Time the split sweeps with their merge (K2b) in several checkouts on one
card, back to back.

Each checkout runs in a process of its own (each has its own
``repro_torch``), in the order given, so that two commits are compared
within one call on one card: ``OLD NEW NEW OLD``.  Every run builds the
kernel library from its checkout's sources and times, at every split
form of the main paths' shapes (this checkout's
``chip_smoke.merge_forms``: the paged sweep's forms, the ring sweep's
batch forms and the latent decode, q bf16, each at the engine's split
count), with this checkout's ``chip_smoke.merge_pairs``: the sweep alone
(stage 1) and the attention function a model calls followed by
``_out_proj``'s reshape (before the fold: the sweep, ``lse_merge`` and,
for Q > 1, the reshape's copy; after it: one fused launch), CUDA events
around CUDA-graph replays.  Each run also reads the sweeps' occupancy
(blocks per SM and registers a thread) of every form.

    python3 tools/merge_ab.py OLD NEW NEW OLD

prints one line per form with every run's times in microseconds, the
occupancy of each run, and the card's name and power limit.  It needs the
card and nvcc, and fails without them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
TAG = "MERGEAB "


def child(tree: pathlib.Path) -> None:
    """One run: ``tree``'s kernels timed with this checkout's helpers."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    if not pathlib.Path(da.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {da.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the sweeps can only be timed on the "
                           "card")
    spec = importlib.util.spec_from_file_location("merge_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build(force=True)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    occ = {}
    for sweep in ("paged", "ring"):
        for D in da.SWEEP_HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                for int8 in (False, True):
                    o = da.sweep_occupancy(D, dtype, int8, sweep)
                    occ[f"{sweep} D {D} {str(dtype)[6:]}"
                        f"{' int8' if int8 else ''}"] = (
                        o["blocks_per_sm"], o["registers"])
    for dtype, widths in da.MLA_ROWS.items():
        for rows in widths:
            o = da.mla_occupancy(dtype, rows)
            occ[f"latent {str(dtype)[6:]} {rows} rows"] = (
                o["blocks_per_sm"], o["registers"])
    rows = smoke.merge_pairs(torch, np, torch.device("cuda", 0), da, ops,
                             quant, pair=False)
    print(TAG + json.dumps({"tree": str(tree), "card": card, "rows": rows,
                            "occupancy": occ}), flush=True)


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        child(pathlib.Path(argv[1]).resolve())
        return 0
    if not argv:
        print(__doc__)
        return 2
    runs = []
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            print(f"[merge_ab] {tree}: exit {proc.returncode}")
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        runs.append((tree, json.loads(line[-1][len(TAG):])))
    print(f"[merge_ab] {runs[0][1]['card']}; us per run, in order: "
          + ", ".join(tree for tree, _ in runs))
    for name, row in runs[0][1]["rows"].items():
        call = " / ".join(f"{run['rows'][name]['call_ms'] * 1e3:.2f}"
                          for _, run in runs)
        stage1 = " / ".join(f"{run['rows'][name]['stage1_ms'] * 1e3:.2f}"
                            for _, run in runs)
        print(f"[merge_ab] {name} (n_splits {row['n_splits']}): attention "
              f"call {call}; stage 1 alone {stage1}")
    for form in runs[0][1]["occupancy"]:
        cells = " / ".join("{} blocks an SM, {} registers".format(
            *run["occupancy"][form]) for _, run in runs)
        print(f"[merge_ab] occupancy {form}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
