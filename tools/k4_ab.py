"""Time K4, the port's prefill flash attention, in several checkouts on one
card, back to back.

Each checkout runs in a process of its own (each has its own
``repro_torch``), in the order given, so that two commits are compared
within one call on one card: ``OLD NEW NEW OLD``.  Every run builds the
kernel library from its checkout's sources and times its
``flash_attention`` at ``chip_smoke.K4_SHAPES`` (bf16) with this
checkout's ``chip_smoke.k4_timings``: the kernel, the plain version and
SDPA, CUDA events around CUDA-graph replays, beside the bound.

    python3 tools/k4_ab.py OLD NEW NEW OLD

prints each run's rows as they come, then one line per shape with every
run's kernel time in microseconds, and the card's name and power limit.
It needs the card and nvcc, and fails without them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
TAG = "K4AB "


def child(tree: pathlib.Path) -> None:
    """One run: ``tree``'s kernels timed with this checkout's helpers."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    if not pathlib.Path(fa.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {fa.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K4 can only be timed on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location("k4_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build(force=True)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = smoke.k4_timings(torch, np, torch.device("cuda", 0), fa, ops)
    keep = ("ms", "plain_ms", "library_ms", "bound_ms", "shape")
    print(TAG + json.dumps({
        "tree": str(tree), "card": card,
        "rows": {name: {k: row[k] for k in keep}
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
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            print(f"[k4_ab] {tree}: exit {proc.returncode}")
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        runs.append((tree, json.loads(line[-1][len(TAG):])))
    print(f"[k4_ab] {runs[0][1]['card']}; kernel us per run, in order: "
          + ", ".join(tree for tree, _ in runs))
    for name, row in runs[0][1]["rows"].items():
        times = " / ".join(f"{run['rows'][name]['ms'] * 1e3:.1f}"
                           for _, run in runs)
        print(f"[k4_ab] {name} ({row['shape']}): {times}; sdpa "
              f"{row['library_ms'] * 1e3:.1f}, bound "
              f"{row['bound_ms'] * 1e3:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
