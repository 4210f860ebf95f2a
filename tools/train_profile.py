"""Where the port's train step spends its time on the card: smollm-135m at
full width and depth (the launcher's main path: batch 8 x 512, bf16
activations, fp32 masters, AdamW), a few steps under ``torch.profiler``.

    python3 tools/train_profile.py [--steps 4] [--arch smollm-135m]
    python3 tools/train_profile.py --launcher [--steps 24]

Prints the card's name and power limit, the step's host wall (median,
synchronised), the device's busy time in the profiled window (the union
of its kernels' intervals) and so its idle share, and the device time by
kernel name (the top rows, with each row's share of the busy time and
its calls a step), then the SSD scan's kernel families (``GROUPS``)
summed.  With ``--launcher`` it runs the training launcher's main path
instead (``repro_torch.launch.train``, ``--frost``, the same batch)
under ``cProfile`` and prints the host functions with the most
cumulative time, each a step, beside the run's steps/s: where the loop's
wall goes beyond the bare step (cProfile slows Python code, not the
card's, so the shares lean towards the host).  It needs the card and
nvcc.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


# kernel families summed apart (substrings of the kernel names): K8's
# backward kernels, and the SSD stage kernels that the forward launches and
# the backward launches again (the incoming states, their pass, the scores:
# one call of each a layer in each direction, of the same shapes)
GROUPS = (("K8 backward kernels (ssd_bwd_*)", ("ssd_bwd_",)),
          ("K8 stage kernels (states, pass, scores; forward and backward)",
           ("ssd_states_kernel", "ssd_pass_kernel", "ssd_scores_kernel")),
          ("K8 forward outputs (ssd_out_kernel)", ("ssd_out_kernel",)))


def busy_us(events) -> float:
    """The union of the device kernels' [start, end) intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def launcher_profile(args, card: str) -> int:
    """``repro_torch.launch.train`` at ``args``' arch, batch and sequence
    with ``--frost`` under cProfile: the top host functions by cumulative
    time, in ms a step."""
    import cProfile
    import contextlib
    import io
    import pstats
    import tempfile

    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", args.arch, "--steps", str(args.steps), "--frost",
                "--batch", str(args.batch), "--seq", str(args.seq),
                "--ckpt-dir", ckpt]
        prof = cProfile.Profile()
        with contextlib.redirect_stdout(io.StringIO()):
            rep = prof.runcall(train.train,
                               train.build_parser().parse_args(argv))
    n = rep["steps"]
    print(f"[train_profile] {card}; launcher {args.arch} {args.batch} x "
          f"{args.seq}, {n} steps under cProfile: {rep['steps_per_s']:.2f} "
          f"steps/s ({1e3 / rep['steps_per_s']:.1f} ms a step)")
    stats = pstats.Stats(prof)
    rows = sorted(((v[3], f"{k[0].rsplit('/', 1)[-1]}:{k[1]} {k[2]}")
                   for k, v in stats.stats.items()), reverse=True)
    for cum, name in rows[:args.top]:
        print(f"[train_profile]   {cum / n * 1e3:9.2f} ms a step  {name}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--top", type=int, default=18)
    ap.add_argument("--launcher", action="store_true",
                    help="profile the launcher's loop on the host")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the train step can only be profiled on "
                           "the card")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, TokenBatches
    from repro_torch.kernels import build
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import steps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.library()
    if args.launcher:
        return launcher_profile(args, card)
    dev = torch.device("cuda", 0)
    cfg = get_arch(args.arch).config
    sc = steps.StepConfig(remat="none", optimizer=OptimizerConfig(
        warmup_steps=2, total_steps=100))
    state = steps.init_train_state(
        cfg, sc, torch.Generator(device=dev).manual_seed(0), dev)
    step = steps.make_train_step(cfg, sc)
    data = TokenBatches(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch))
    for i in range(3):                                   # warm up
        state, m = step(state, data.batch(i))
    float(m["loss"])
    walls = []
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, data.batch(3 + i))
        float(m["loss"])
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.steps):
            state, m = step(state, data.batch(3 + args.steps + i))
            float(m["loss"])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    busy = busy_us(kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end
                                              - e.time_range.start)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    n = args.steps
    print(f"[train_profile] {card}; {args.arch} {args.batch} x {args.seq}, "
          f"{n} steps: host wall median {statistics.median(walls) * 1e3:.1f}"
          f" ms a step (min {min(walls) * 1e3:.1f}); profiled window "
          f"{window_us / n / 1e3:.1f} ms a step, device busy "
          f"{busy / n / 1e3:.1f} ms a step, idle share "
          f"{1 - busy / window_us:.1%}; {len(kernels) // n} kernels a step")
    for name, ts in rows[:args.top]:
        print(f"[train_profile]   {sum(ts) / n / 1e3:8.3f} ms "
              f"{sum(ts) / busy:6.1%}  x{len(ts) // n:<5d} {name[:90]}")
    for group, keys in GROUPS:
        ts = [t for name, v in by_name.items()
              if any(k in name for k in keys) for t in v]
        if ts:
            print(f"[train_profile] {group}: {sum(ts) / n / 1e3:.3f} ms a "
                  f"step, {sum(ts) / busy:.1%} of the busy time, "
                  f"{len(ts) // n} launches a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
