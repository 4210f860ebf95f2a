"""Time K4's and K9's backward kernels in several checkouts on one card,
back to back.

Each checkout runs in a process of its own (each has its own
``repro_torch``), in the order given, so that two commits are compared
within one call on one card: ``OLD NEW NEW OLD``.  Every run builds the
kernel library from its checkout's sources and times its
``flash_attention_bwd`` (smollm's 8 x 512, Hq 9, Hkv 3, D 64, bf16,
causal) and ``rmsnorm_bwd`` (smollm's 4096 x 576, bf16 x, fp32 scale)
with this checkout's ``chip_smoke.backward_timings``: the whole call
(CUDA events around CUDA-graph replays), each of its launches
(``chip_smoke.launch_split``: K4's delta, dk / dv and dq, K9's rows and
reduce) and, in the same run, SDPA's and ``F.rms_norm``'s backward
through autograd (the port never calls them), beside the bound.

    python3 tools/bwd_ab.py OLD NEW NEW OLD

prints one line per kernel with every run's time in microseconds, its
launches, the library's time, and the card's name and power limit.  It
needs the card and nvcc, and fails without them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
TAG = "BWDAB "


def child(tree: pathlib.Path) -> None:
    """One run: ``tree``'s kernels timed with this checkout's helpers."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    if not pathlib.Path(fa.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {fa.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the backward kernels can only be "
                           "timed on the card")
    spec = importlib.util.spec_from_file_location("bwd_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build(force=True)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = smoke.backward_timings(torch, np, torch.device("cuda", 0), fa,
                                  rms, plain=False)
    print(TAG + json.dumps({
        "tree": str(tree), "card": card,
        "rows": {name: {k: row[k] for k in ("ms", "library_ms", "bound_ms",
                                            "split")}
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
            print(f"[bwd_ab] {tree}: exit {proc.returncode}")
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        runs.append((tree, json.loads(line[-1][len(TAG):])))
    print(f"[bwd_ab] {runs[0][1]['card']}; us per run, in order: "
          + ", ".join(tree for tree, _ in runs))
    for name, row in runs[0][1]["rows"].items():
        times = " / ".join(f"{run['rows'][name]['ms'] * 1e3:.1f}"
                           for _, run in runs)
        lib = " / ".join(f"{run['rows'][name]['library_ms'] * 1e3:.1f}"
                         for _, run in runs)
        print(f"[bwd_ab] {name}: {times}; library {lib}; bound "
              f"{row['bound_ms'] * 1e3:.2f}")
        for label in row["split"]:
            part = " / ".join(f"{run['rows'][name]['split'][label]:.1f}"
                              for _, run in runs)
            print(f"[bwd_ab]   {label}: {part}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
