"""Time K8, the SSD scan, and its backward in several checkouts on one
card, back to back.

Each checkout runs in a process of its own (each has its own
``repro_torch``), in the order given, so that two commits are compared
within one call on one card: ``OLD NEW NEW OLD``.  Every run builds the
kernel library from its checkout's sources and times its ``ssd_scan`` at
every row of phase 5 (``chip_smoke.SSD_TIMED``: bf16 at mamba2-370m's
heads, chunk 128, the final state returned; the batch path's 8 x 512,
the long batch's 2 x 4000 and one engine prompt of 1 x 32) with this
checkout's ``chip_smoke.ssd_rows``, and its backward ``ssd_scan_bwd`` at
phase 7 (d)'s ``chip_smoke.SSD_BWD_TIMED`` (bf16, 8 x 512 and 2 x 4000):
each call alone, CUDA events around CUDA-graph replays, beside the
bound.

    python3 tools/ssd_ab.py OLD NEW NEW OLD

prints one line per row with every run's kernel time in microseconds,
and the card's name and power limit.  It needs the card and nvcc, and
fails without them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
TAG = "SSDAB "


def child(tree: pathlib.Path) -> None:
    """One run: ``tree``'s kernels timed with this checkout's helpers."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ss
    if not pathlib.Path(ss.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {ss.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K8 can only be timed on the card")
    spec = importlib.util.spec_from_file_location("ssd_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build(force=True)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rows = smoke.ssd_rows(torch, np, dev, ss, plain=False)
    for i, (label, B, S) in enumerate(smoke.SSD_BWD_TIMED):
        inp, _ = smoke.ssd_case(torch, np, dev, B=B, S=S, dtype="bfloat16",
                                seed=1300 + i)
        dy, _ = smoke.ssd_bwd_inputs(torch, dev, inp, 1310 + i, False)
        ms = smoke.time_ms(torch, lambda: ss.ssd_scan_bwd(**inp, dy=dy),
                           iters=5, reps=10 if S <= 1024 else 3)
        rows[f"ssd_scan_bwd {label}"] = {
            "ms": ms, "bound_ms": smoke.ssd_bwd_bound(B, S)[0]}
        del inp, dy
        torch.cuda.empty_cache()
    print(TAG + json.dumps({
        "tree": str(tree), "card": card,
        "rows": {name: {k: row[k] for k in ("ms", "bound_ms")}
                 for name, row in rows.items()}}), flush=True)


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
            print(f"[ssd_ab] {tree}: exit {proc.returncode}")
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        runs.append((tree, json.loads(line[-1][len(TAG):])))
    print(f"[ssd_ab] {runs[0][1]['card']}; kernel us per run, in order: "
          + ", ".join(tree for tree, _ in runs))
    for name, row in runs[0][1]["rows"].items():
        times = " / ".join(f"{run['rows'][name]['ms'] * 1e3:.1f}"
                           for _, run in runs)
        print(f"[ssd_ab] K8 {name}: {times}; bound "
              f"{row['bound_ms'] * 1e3:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
