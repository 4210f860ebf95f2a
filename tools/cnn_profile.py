"""Where the CNN zoo's train step spends its time on the card: the step
that ``chip_smoke.py`` phase 8 (b) times (``models.cnn.loss_and_grads``,
then ``optim.adamw_update`` with the paper benchmark's optimizer), at
batch 128 of 32x32x3 ``CifarBatches`` images in fp32, cuDNN's TF32 on
(the library's default).

    python3 tools/cnn_profile.py [--models ResNet18,VGG16,DenseNet121,DPN92]

For each model it prints the card's name and power limit; the median
synchronised wall of ``STEPS`` steps with the least and the most; the
step's device busy time under ``torch.profiler`` (the union of the
kernels' intervals over ``STEPS`` profiled steps) and the idle share it
leaves of that median step and of the profiled window (the profiler
slows the host), with its kernels a step, by family (``FAMILIES``) and
the ``TOP`` kernels; and
the step's median wall with the images and the conv weights in
``torch.channels_last``, which the port does not use.  Where the host
spends the step (issuing forward and backward, issuing AdamW, waiting
for the card) is in ``chip_smoke.py`` phase 8's ``[cnn]`` lines.  It
needs the card, not nvcc (no hand-written kernel is on this path).
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
# phase 8 (b)'s batch; the steps timed and profiled; the kernels listed
BATCH, STEPS, TOP = 128, 6, 6

# kernel families by substrings of their lower-cased names, the first
# match counting (cuDNN's batch-norm and layout kernels before its convs)
FAMILIES = (("batch norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm")),
            ("layout transforms (NCHW <-> NHWC)", ("nchwtonhwc",
                                                  "nhwctonchw",
                                                  "region_transform")),
            ("convolution (cuDNN, CUTLASS)", ("conv", "cudnn", "xmma",
                                             "implicit", "wgrad", "dgrad",
                                             "fprop", "winograd", "gemm",
                                             "cutlass")),
            ("pooling", ("pool",)),
            ("reductions", ("reduce",)),
            ("copies and concatenation", ("copy", "memcpy", "cat", "pad")),
            ("elementwise (AdamW, ReLU, adds)", ("elementwise",)))


def walls_ms(torch, fn):
    """The median, least and most synchronised wall of ``STEPS`` calls, in
    ms."""
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), min(walls), max(walls)


def shown(walls):
    return f"{walls[0]:.2f} ms (least {walls[1]:.2f}, most {walls[2]:.2f})"


def profile_model(torch, name, card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import bridge, data, optim
    from repro_torch.models import cnn, common
    from train_profile import busy_us

    dev = torch.device("cuda", 0)
    apply = cnn.CNN_ZOO[name][1]
    cfg = optim.OptimizerConfig(**cnn.OPTIMIZER)
    x, y = data.CifarBatches(seed=0, batch=BATCH).batch_at(0)
    x = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev)
    y = torch.from_numpy(y).to(dev)

    def state(fmt):
        params = bridge.init_cnn(
            name, torch.Generator(device=dev).manual_seed(0), dev)
        if fmt is torch.channels_last:
            for t in common.tree_leaves(params):
                if t.ndim == 4:
                    t.data = t.data.contiguous(memory_format=fmt)
        return params, optim.adamw_init(params, cfg)

    def step(params, opt, xx):
        (loss, _), grads = cnn.loss_and_grads(apply, params, xx, y)
        optim.adamw_update(grads, opt, params, cfg)
        return loss

    params, opt = state(torch.contiguous_format)
    for _ in range(3):                                   # warm up
        step(params, opt, x)
    step_ms = walls_ms(torch, lambda: step(params, opt, x))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step(params, opt, x)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    n = STEPS
    busy = busy_us(kernels)
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.end
                                              - e.time_range.start)
    del params, opt
    params, opt = state(torch.channels_last)
    xl = x.contiguous(memory_format=torch.channels_last)
    for _ in range(3):
        step(params, opt, xl)
    cl_ms = walls_ms(torch, lambda: step(params, opt, xl))
    print(f"[cnn_profile] {name} b{BATCH} fp32 on {card}: step "
          f"{shown(step_ms)}; device busy {busy / n / 1e3:.2f} ms a step, "
          f"idle share {1 - busy / n / 1e3 / step_ms[0]:.1%} of the median "
          f"step ({1 - busy / window_us:.1%} of the profiled window, "
          f"{window_us / n / 1e3:.2f} ms a step), {len(kernels) // n} "
          f"kernels a step; channels_last step {shown(cl_ms)}")
    left = dict(by_name)
    for family, keys in FAMILIES:
        hit = {k: v for k, v in left.items()
               if any(s in k.lower() for s in keys)}
        for k in hit:
            del left[k]
        ts = [t for v in hit.values() for t in v]
        print(f"[cnn_profile]   {family}: {sum(ts) / n / 1e3:.3f} ms a "
              f"step, {sum(ts) / busy:.1%} of busy, {len(ts) // n} "
              "launches a step")
    ts = [t for v in left.values() for t in v]
    print(f"[cnn_profile]   other: {sum(ts) / n / 1e3:.3f} ms a step, "
          f"{sum(ts) / busy:.1%} of busy, {len(ts) // n} launches a step")
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for kname, ts in rows[:TOP]:
        print(f"[cnn_profile]     {sum(ts) / n / 1e3:8.3f} ms "
              f"{sum(ts) / busy:6.1%}  x{len(ts) // n:<5d} {kname[:90]}")
    del params, opt
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="ResNet18,VGG16,DenseNet121,DPN92")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    sys.path.insert(0, str(HERE / "tools"))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no card: the CNN step can only be profiled on "
                           "the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for name in args.models.split(","):
        profile_model(torch, name, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
