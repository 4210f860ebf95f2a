"""Cluster power shifting — the Sec II-C capability the paper motivates but
never builds, closed-loop: a ``ClusterCoordinator`` subscribes to per-node
``StepDone`` telemetry, *re-estimates* each node's thermal derate from
observed step times, and re-splits the global power budget through the
water-filling allocator — emitting per-node cap commands.

Scenario: a 16-node pod with a 90% global power budget; two nodes are
thermally derated (the canonical stragglers).  Nobody tells the
coordinator which nodes are sick — it finds out from the event stream.
Compare:

  A. uniform capping  — every node gets the same cap,
  B. FROST power shift — slow nodes get more watts, fast nodes get capped
     harder (straggler mitigation at equal budget).

    PYTHONPATH=src python -m repro_torch.examples.cluster_powershift

The nodes are analytic ``H100_SXM`` models (``main(device_spec=...)``
takes another, such as the JAX example's ``TPU_V5E``).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.control import CapApplied, EventBus, PowerSampled, StepDone
from repro_torch.control.coordinator import ClusterCoordinator
from repro_torch.core import (H100_SXM, ClusterNode, PowerCappedDevice,
                              WorkloadProfile)

# one pod-slice: 16 nodes, same training step everywhere (DP)
WL = WorkloadProfile(name="train-step", flops_per_step=4e12,
                     hbm_bytes_per_step=3e9, collective_bytes_per_step=5e8,
                     samples_per_step=16)

TRUE_DERATE = {3: 0.78, 11: 0.78}    # ground truth the coordinator must infer


def main(argv=None, device_spec=H100_SXM) -> int:
    argparse.ArgumentParser().parse_args(argv)
    # the devices the pod *actually* runs on (two thermally throttled)...
    actual = [PowerCappedDevice(device_spec, derate=TRUE_DERATE.get(i, 1.0))
              for i in range(16)]

    budget = 0.90 * 16 * device_spec.tdp_w
    print(f"global budget: {budget:.0f} W over 16 nodes "
          f"(2 derated to 0.78 — unknown to the coordinator)\n")

    # --- A: uniform cap meeting the budget ---------------------------------
    uniform_cap = 0.90
    times_uniform = [d.estimate(WL, uniform_cap).step_time_s for d in actual]
    power_uniform = [d.estimate(WL, uniform_cap).power_w for d in actual]
    t_uniform = max(times_uniform)
    e_uniform = sum(power_uniform) * t_uniform
    print(f"A. uniform {uniform_cap:.0%} cap : step {t_uniform*1e3:7.1f} ms   "
          f"energy/step {e_uniform:7.1f} J   "
          f"(straggler drag "
          f"{max(times_uniform)/np.median(times_uniform):.2f}x)")

    # --- B: the closed loop -------------------------------------------------
    # ...but the coordinator is registered with HEALTHY node models: the
    # derates must be inferred from streamed step telemetry before
    # rebalancing.
    bus = EventBus()
    coord = ClusterCoordinator(bus, global_budget_w=budget,
                               rebalance_every=3 * 16)
    backends = {}
    for i in range(16):
        node = ClusterNode(f"node-{i:02d}", PowerCappedDevice(device_spec),
                           WL)
        backends[node.node_id] = coord.register_node(node)

    # three synchronous DP steps: every rank reports its *measured* step
    # time under its currently-enforced cap; the third round of reports
    # trips the coordinator's rebalance.
    for step in range(3):
        for i, dev in enumerate(actual):
            nid = f"node-{i:02d}"
            cap = backends[nid].current_cap()
            est = dev.estimate(WL, cap)
            bus.publish(PowerSampled(node_id=nid, t=float(step),
                                     gpu_w=est.power_w))
            bus.publish(StepDone(node_id=nid, step=step,
                                 duration_s=est.step_time_s,
                                 samples=WL.samples_per_step,
                                 energy_j=est.energy_j))

    plan = coord.plans[-1]
    print(f"B. FROST shift       : step {plan.step_time_s*1e3:7.1f} ms   "
          f"energy/step {plan.energy_per_step_j:7.1f} J   "
          f"(feasible={plan.feasible})")

    derates = coord.derates()
    healthy = np.median([v for k, v in derates.items()
                         if k not in ('node-03', 'node-11')])
    print(f"   inferred derates  : node-03={derates['node-03']:.2f} "
          f"node-11={derates['node-11']:.2f} (healthy ~{healthy:.2f})")
    caps = coord.current_caps()
    slow = [f"{k}={v:.0%}" for k, v in caps.items()
            if k in ("node-03", "node-11")]
    fast = [f"{v:.0%}" for v in sorted(v for k, v in caps.items()
                                       if k not in ("node-03", "node-11"))]
    n_cmds = len(bus.events_of(CapApplied))
    print(f"   derated nodes got: {', '.join(slow)}; "
          f"healthy nodes capped to {fast[0]}..{fast[-1]} "
          f"({n_cmds} cap commands on the bus)")
    audit = coord.audit[-1]
    # one more telemetry round under the NEW caps so the measured EWMA
    # reflects the post-rebalance draw (at rebalance time it still
    # remembers uncapped steps)
    for i, dev in enumerate(actual):
        nid = f"node-{i:02d}"
        est = dev.estimate(WL, backends[nid].current_cap())
        bus.publish(PowerSampled(node_id=nid, t=3.0, gpu_w=est.power_w))
    measured_now = coord.measured_total_w()
    print(f"   budget audit      : allocated {audit['allocated_w']:.0f} W, "
          f"measured {measured_now:.0f} W of {audit['budget_w']:.0f} W "
          f"({'within' if measured_now <= audit['budget_w'] else 'OVER'} "
          f"budget)")

    speedup = t_uniform / plan.step_time_s - 1.0
    saving = 1 - plan.energy_per_step_j / e_uniform
    print(f"\n=> step time {speedup:+.1%}, energy/step saved {saving:.1%} "
          f"at the SAME global budget — power capping as straggler "
          f"mitigation, driven entirely by streamed telemetry.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
