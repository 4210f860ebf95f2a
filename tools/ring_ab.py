"""Time the ring sweep (K5a, K5b, K6a, K6b) in several checkouts on one
card, back to back.

Each checkout runs in a process of its own (each has its own
``repro_torch``), in the order given, so that two commits are compared
within one call on one card: ``OLD NEW NEW OLD``.  Every run builds the
kernel library from its checkout's sources and times its
``ring_attention_sweep`` at every ring row of phase 5 (q bf16, rings of
545 slots at pos 528, decode and verify Q 4, at the engine's split count
and at one split: D 64 in bf16 and int8 rings, D 120 in bf16 and int8,
and the engine's private rings of 48 slots at D 120) with this checkout's
``chip_smoke.ring_rows``: the kernel alone, CUDA events around CUDA-graph
replays, beside the bound.
A row at several splits times the launch the main paths make, which
merges its own splits (``merge=True``), so every checkout given must
take ``merge=``.

    python3 tools/ring_ab.py OLD NEW NEW OLD

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
TAG = "RINGAB "


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
        raise RuntimeError("no card: the ring sweep can only be timed on "
                           "the card")
    spec = importlib.util.spec_from_file_location("ring_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build(force=True)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = smoke.ring_rows(torch, np, torch.device("cuda", 0), da, ops,
                           quant, plain=False)
    print(TAG + json.dumps({
        "tree": str(tree), "card": card,
        "rows": {name: {k: row[k] for k in ("ms", "bound_ms", "n_splits")}
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
            print(f"[ring_ab] {tree}: exit {proc.returncode}")
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        runs.append((tree, json.loads(line[-1][len(TAG):])))
    print(f"[ring_ab] {runs[0][1]['card']}; kernel us per run, in order: "
          + ", ".join(tree for tree, _ in runs))
    for name, row in runs[0][1]["rows"].items():
        times = " / ".join(f"{run['rows'][name]['ms'] * 1e3:.1f}"
                           for _, run in runs)
        print(f"[ring_ab] {name} (n_splits {row['n_splits']}): {times}; "
              f"bound {row['bound_ms'] * 1e3:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
