"""Time K9, the fused RMSNorm, in several checkouts on one card, back to
back.

Each checkout runs in a process of its own (each has its own
``repro_torch``), in the order given, so that two commits are compared
within one call on one card: ``OLD NEW NEW OLD``.  Every run builds the
kernel library from its checkout's sources and times its ``rmsnorm`` at
every row of phase 5 (``chip_smoke.RMS_TIMED``: bf16 rows of the zoo's
widths, 2048 to 4096 prefill rows and decode steps of 4 and 8 rows) with
this checkout's ``chip_smoke.rms_rows``, beside ``F.rms_norm`` (timed in
the same run; the port never calls it) and the bound: CUDA events around
CUDA-graph replays.

    python3 tools/rmsnorm_ab.py OLD NEW NEW OLD

prints one line per row with every run's kernel time in microseconds,
then every run's F.rms_norm time, and the card's name and power limit.
It needs the card and nvcc, and fails without them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
TAG = "RMSAB "


def child(tree: pathlib.Path) -> None:
    """One run: ``tree``'s kernels timed with this checkout's helpers."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.models import common
    if not pathlib.Path(rms.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {rms.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise RuntimeError("no card: K9 can only be timed on the card")
    spec = importlib.util.spec_from_file_location("rms_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build(force=True)
    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = smoke.rms_rows(torch, np, torch.device("cuda", 0), rms, common,
                          plain=False, library=True)
    print(TAG + json.dumps({
        "tree": str(tree), "card": card,
        "rows": {name: {k: row[k] for k in ("ms", "library_ms", "bound_ms")}
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
            print(f"[rmsnorm_ab] {tree}: exit {proc.returncode}")
            return 1
        line = [x for x in proc.stdout.splitlines() if x.startswith(TAG)]
        runs.append((tree, json.loads(line[-1][len(TAG):])))
    print(f"[rmsnorm_ab] {runs[0][1]['card']}; kernel us per run, in order: "
          + ", ".join(tree for tree, _ in runs))
    for name, row in runs[0][1]["rows"].items():
        times = " / ".join(f"{run['rows'][name]['ms'] * 1e3:.2f}"
                           for _, run in runs)
        lib = " / ".join(
            "n/a" if run["rows"][name]["library_ms"] is None
            else f"{run['rows'][name]['library_ms'] * 1e3:.2f}"
            for _, run in runs)
        print(f"[rmsnorm_ab] K9 {name}: {times}; F.rms_norm {lib}; bound "
              f"{row['bound_ms'] * 1e3:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
