"""Quickstart: FROST in ~60 lines, batch and closed-loop.

Part 1 profiles a workload's power-cap response the paper's way (8 x 30 s
probe windows), fits the F(x) cost curve, and picks the ED^2P-optimal cap —
showing the A1-policy knob moving the decision.

Part 2 runs the same decision *online*: step telemetry streams over the
control-plane event bus, the ``OnlineCapProfiler`` amortises its probes
across live traffic, and cap commands land mid-run — no dedicated probe
windows.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The device is the analytic ``H100_SXM`` model (``main(device_spec=...)``
takes another, such as the JAX example's ``TPU_V5E``).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.control import CapApplied, EventBus, StepDone
from repro_torch.control.online import OnlineCapProfiler
from repro_torch.core import (BALANCED, ENERGY_LEAN, H100_SXM, LATENCY_LEAN,
                              CapProfiler, PowerCappedDevice,
                              WorkloadProfile)
from repro_torch.core.profiler import RecordingBackend


def main(argv=None, device_spec=H100_SXM) -> int:
    argparse.ArgumentParser().parse_args(argv)

    # 1. Describe a workload by its roofline character (FLOPs + bytes per
    #    step).  In production these numbers come from the step's cost
    #    (repro_torch.launch.stepcost, as the dry-run counts them); here: a
    #    training-like, compute-leaning step.
    workload = WorkloadProfile(
        name="demo-train",
        flops_per_step=1.2e12,         # 1.2 TFLOP per step
        hbm_bytes_per_step=6e9,        # 6 GB HBM traffic per step
        samples_per_step=256,
    )

    # 2. A power-cappable device (RTX_3080/3090 = the paper's rigs).
    device = PowerCappedDevice(device_spec)

    class Probe:
        """FROST probes the workload under each cap for ~30 s (paper Sec
        III-C)."""

        def probe(self, cap: float, duration_s: float):
            return device.probe(workload, cap, duration_s)

    # 3. Batch flow: profile -> fit F(x) -> downhill simplex, per A1 policy.
    batch_decisions = {}
    for policy in (ENERGY_LEAN, BALANCED, LATENCY_LEAN):
        decision = batch_decisions[policy.policy_id] = \
            CapProfiler(Probe(), policy=policy).run()
        print(f"{policy.policy_id:18s} -> cap {decision.cap:5.0%}  "
              f"energy {decision.predicted_energy_saving:+6.1%}  "
              f"delay {decision.predicted_delay_increase:+6.1%}  "
              f"(fit rmse {decision.fit.rel_rmse:.2%}, "
              f"{'accepted' if decision.fit_accepted else 'FALLBACK'})")

    # 4. Closed-loop flow: the SAME decision from streamed events — the
    #    online profiler probes across live steps instead of freezing the
    #    pipeline.
    bus = EventBus()
    backend = RecordingBackend()
    profiler = OnlineCapProfiler(bus, backend, policy=BALANCED,
                                 steps_per_probe=2, hold_steps=16,
                                 min_refresh_interval_s=0.0)
    for step in range(40):                       # live traffic
        cap = backend.current_cap()              # honour the latest command
        est = device.estimate(workload, cap)
        bus.publish(StepDone(node_id="node-0", step=step,
                             duration_s=est.step_time_s,
                             samples=workload.samples_per_step,
                             energy_j=est.energy_j))

    caps = bus.events_of(CapApplied)
    probes = sum(1 for c in caps if c.reason == "probe")
    print(f"\nonline: {len(caps)} cap commands over 40 live steps "
          f"({probes} amortised probes) -> cap {profiler.decision.cap:.0%} "
          f"(batch said {batch_decisions[BALANCED.policy_id].cap:.0%})")

    # 5. The raw probe curve, to plot Fig 4 from:
    probes_m = CapProfiler(Probe(), policy=BALANCED).measure()
    caps_g = [m.cap for m in probes_m]
    energy = [m.energy_per_sample for m in probes_m]
    print("\ncap grid   :", [f"{c:.0%}" for c in caps_g])
    print("J / sample :", [f"{e:.3f}" for e in energy])
    best = caps_g[int(np.argmin(energy))]
    print(f"energy-optimal probe: {best:.0%} of TDP")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
