"""Cluster-level power shifting — paper Sec II-C, built out (beyond paper).

The paper motivates power *shifting* ("dynamic setting of power budgets for
individual system components to maintain a global power level") but only
evaluates single nodes.  At pod scale this becomes the straggler problem:
in synchronous data parallelism the step time is the max over ranks, so a
naive uniform cap wastes the budget on fast nodes while a derated node
drags the pod.  The allocator below:

  1. models every node as a PowerCappedDevice (possibly heterogeneous or
     thermally derated),
  2. finds, by bisection on the target step time T, the per-node caps that
     just achieve T, subject to  sum_i cap_i * TDP_i <= global_budget,
  3. returns per-node caps: slow nodes get more power, fast nodes are
     capped harder — equalising step time (straggler mitigation) at
     minimum energy.

This is the FROST-native alternative to dropping stragglers from the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.powermodel import PowerCappedDevice, WorkloadProfile


@dataclasses.dataclass(frozen=True)
class NodeAllocation:
    node_id: str
    cap: float
    power_w: float
    step_time_s: float
    energy_per_step_j: float


@dataclasses.dataclass(frozen=True)
class ShiftPlan:
    allocations: tuple[NodeAllocation, ...]
    step_time_s: float            # synchronous step time = max over ranks
    total_power_w: float
    global_budget_w: float
    feasible: bool

    @property
    def energy_per_step_j(self) -> float:
        # Synchronous DP: every rank is powered for the full step (idle
        # ranks still draw; we charge the allocated power for max-T).
        return sum(a.power_w for a in self.allocations) * self.step_time_s


@dataclasses.dataclass
class ClusterNode:
    node_id: str
    device: PowerCappedDevice
    workload: WorkloadProfile

    def step_time(self, cap: float) -> float:
        return self.device.estimate(self.workload, cap).step_time_s

    def min_cap_for_step_time(self, target_s: float) -> float:
        """Smallest cap achieving step_time <= target (monotone -> bisect)."""
        spec = self.device.spec
        lo, hi = spec.min_cap, 1.0
        if self.step_time(hi) > target_s:
            return float("inf")          # infeasible even uncapped
        if self.step_time(lo) <= target_s:
            return lo
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            if self.step_time(mid) <= target_s:
                hi = mid
            else:
                lo = mid
        return hi


def allocate_power(
    nodes: Sequence[ClusterNode],
    global_budget_w: float,
    *,
    tol: float = 1e-3,
) -> ShiftPlan:
    """Minimise synchronous step time subject to the global power budget.

    Outer bisection on the step-time target T; inner per-node bisection for
    the cheapest cap achieving T.  Both are monotone, so this converges to
    the water-filling optimum.
    """
    if not nodes:
        raise ValueError("no nodes")

    def budget_for(target_s: float) -> tuple[float, list[float]]:
        caps = [n.min_cap_for_step_time(target_s) for n in nodes]
        if any(np.isinf(c) for c in caps):
            return float("inf"), caps
        watts = sum(c * n.device.spec.tdp_w for c, n in zip(caps, nodes))
        return watts, caps

    # Fastest possible step time: all nodes uncapped.
    t_min = max(n.step_time(1.0) for n in nodes)
    w_at_tmin, _ = budget_for(t_min)
    feasible = True
    if w_at_tmin <= global_budget_w:
        t_star = t_min
    else:
        # Slowest sensible target: everyone at min cap.
        t_max = max(n.step_time(n.device.spec.min_cap) for n in nodes)
        w_at_tmax, _ = budget_for(t_max)
        if w_at_tmax > global_budget_w:
            feasible = False              # budget below floor: best effort
            t_star = t_max
        else:
            lo, hi = t_min, t_max
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                w, _ = budget_for(mid)
                if w <= global_budget_w:
                    hi = mid
                else:
                    lo = mid
                if hi - lo < tol * t_min:
                    break
            t_star = hi

    _, caps = budget_for(t_star)
    caps = [min(max(c, n.device.spec.min_cap), 1.0) for c, n in zip(caps, nodes)]
    allocs = []
    for n, c in zip(nodes, caps):
        est = n.device.estimate(n.workload, c)
        allocs.append(NodeAllocation(node_id=n.node_id, cap=c, power_w=est.power_w,
                                     step_time_s=est.step_time_s,
                                     energy_per_step_j=est.energy_j))
    step_time = max(a.step_time_s for a in allocs)
    return ShiftPlan(
        allocations=tuple(allocs),
        step_time_s=step_time,
        total_power_w=sum(a.power_w for a in allocs),
        global_budget_w=float(global_budget_w),
        feasible=feasible,
    )


def detect_stragglers(
    step_times_s: Sequence[float],
    *,
    threshold: float = 1.3,
) -> list[int]:
    """Indices of ranks slower than ``threshold`` x median — the supervisor
    feeds these into allocate_power (shift watts toward them) before ever
    considering evicting the node."""
    t = np.asarray(step_times_s, dtype=np.float64)
    med = float(np.median(t))
    if med <= 0:
        return []
    return [i for i, v in enumerate(t) if v > threshold * med]
