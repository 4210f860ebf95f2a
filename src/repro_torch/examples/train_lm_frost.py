"""End-to-end run: train smollm-135m with the full stack — the train
step with two micro-batches, FROST cap tuning from the step's roofline,
checkpoint/restart under the fault-tolerance supervisor, a telemetry
ledger.

    # smollm-135m at its published width and depth on the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm_frost --full \
        --steps 40 --inject-failure 20
    # the smoke config on the CPU
    PYTHONPATH=src python -m repro_torch.examples.train_lm_frost \
        --device cpu --steps 6 --inject-failure 3

The step's roofline terms come from ``launch.stepcost`` (the JAX example
parses its compiled step's HLO; the FLOPs are equal).
``--inject-failure STEP`` silences the node at that step: the supervisor
notices and restores the last checkpoint.  Without ``--ckpt`` the
checkpoints go to a new temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core import (BALANCED, H100_SXM, CapProfiler,
                              PowerCappedDevice, WorkloadProfile)
from repro_torch.data import DataConfig, TokenBatches
from repro_torch.launch import stepcost
from repro_torch.models import common
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime.fault import Supervisor, SupervisorConfig
from repro_torch.runtime.steps import (StepConfig, init_train_state,
                                       make_train_step)
from repro_torch.telemetry.meters import CpuProcessMeter, DramMeter
from repro_torch.telemetry.sampler import PowerSampler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="real smollm-135m (the card's); default reduced")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="kill a worker at this step (recovery drill)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "directory)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None, device_spec=H100_SXM) -> dict:
    """Train; returns ``losses``, ``restarts``, ``final_step``,
    ``seconds``, ``steps_per_s``, ``peak_gib`` (None on the CPU) and the
    step's ``flops``."""
    args = build_parser().parse_args(argv)
    dev = _device.resolve(args.device)
    spec = get_arch("smollm-135m")
    cfg = spec.config if args.full else spec.smoke
    print(f"[cfg] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    step_cfg = StepConfig(
        n_micro=2, remat="none",
        optimizer=OptimizerConfig(learning_rate=6e-4, warmup_steps=20,
                                  total_steps=args.steps))
    state = init_train_state(cfg, step_cfg,
                             torch.Generator(device=dev).manual_seed(0), dev)
    train_step = make_train_step(cfg, step_cfg)

    data = TokenBatches(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                   seq_len=args.seq,
                                   global_batch=args.batch))

    # ---- FROST: tune the cap from the step's roofline (paper Sec III-C) --
    h = stepcost.analyze(cfg, "train", batch=args.batch, seq=args.seq,
                         n_micro=step_cfg.n_micro)
    wl = WorkloadProfile(name=cfg.name, flops_per_step=h["dot_flops"],
                         hbm_bytes_per_step=h["hbm_bytes"],
                         collective_bytes_per_step=h["collective_bytes"],
                         samples_per_step=args.batch)
    model = PowerCappedDevice(device_spec)

    class Probe:
        def probe(self, cap, duration_s):
            return model.probe(wl, cap, duration_s)

    decision = CapProfiler(Probe(), policy=BALANCED).run()
    print(f"[frost] step profile: {h['dot_flops']/1e9:.1f} GFLOP, "
          f"{h['hbm_bytes']/1e9:.2f} GB HBM (estimate) -> cap "
          f"{decision.cap:.0%} (energy {decision.predicted_energy_saving:+.1%}"
          f", delay {decision.predicted_delay_increase:+.1%})")

    # ---- supervised training with telemetry ------------------------------
    own_dir = None if args.ckpt else tempfile.mkdtemp(prefix="frost_lm_")
    ckpt = CheckpointManager(args.ckpt or own_dir, keep=2, save_async=True)
    ckpt.save(state, 0)                    # recovery floor before step 1

    def restore():
        restored = ckpt.restore(state)
        for p in common.tree_leaves(restored["params"]):
            p.requires_grad_(True)
        return restored, ckpt.latest_step() or 0

    sup = Supervisor(SupervisorConfig(checkpoint_every=50),
                     save_fn=lambda s, i: ckpt.save(s, i),
                     restore_fn=restore)
    sup.register("node-0")
    inject = {args.inject_failure: "node-0"} if args.inject_failure else {}

    sampler = PowerSampler({"cpu": CpuProcessMeter(),
                            "dram": DramMeter(4, 16)}, rate_hz=0.5)
    batches = (data.batch(i) for i in range(args.steps))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with sampler:
        state, report = sup.run(train_step, state, batches,
                                inject_failure_at=inject)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ckpt.wait()
    if own_dir is not None:
        shutil.rmtree(own_dir)

    losses = [float(x["loss"]) for x in report["history"]]
    energy = sampler.ledger.report()
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    print(f"[done] {report['final_step']} steps in {dt:.1f}s | "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-20:]):.3f} | "
          f"restarts={report['restarts']}")
    print(f"[energy] gross {energy.gross_j:.1f} J over "
          f"{energy.duration_s:.1f}s (mean {energy.mean_power_w:.1f} W, "
          f"host meters)")
    assert losses[-1] < losses[0], "loss should decrease"
    return {"losses": losses, "restarts": report["restarts"],
            "final_step": report["final_step"], "seconds": dt,
            "steps_per_s": len(losses) / dt, "peak_gib": peak,
            "flops": h["dot_flops"]}


if __name__ == "__main__":
    main()
