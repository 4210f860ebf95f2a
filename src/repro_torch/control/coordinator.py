"""Cluster coordinator — live-telemetry-driven power shifting (Sec II-C).

The seed's ``powershift.allocate_power`` was only ever called from examples
with hand-written derates.  Here it becomes the policy engine of a closed
loop: per-node ``StepDone``/``PowerSampled`` events stream into the
coordinator, which maintains an EWMA health picture of every node,
*re-estimates* each node's thermal derate from observed vs. predicted step
time, and periodically re-runs the allocator to split the global power
budget — emitting per-node cap commands through each node's existing
``CapBackend`` and publishing ``CapApplied(reason="rebalance")`` events.

The derate estimate is what closes the loop: a node that throttles mid-run
shows up as observed_step_time > model prediction at its current cap; the
next rebalance hands it a larger share of the budget (or caps its healthy
neighbours harder), exactly the straggler-mitigation story of
``runtime.fault.Supervisor`` but driven by streamed telemetry instead of a
one-shot report.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.control.bus import EventBus
from repro_torch.control.events import (CapApplied, NodeDerated, PowerSampled,
                                  StepDone)
from repro_torch.core.powermodel import PowerCappedDevice, WorkloadProfile
from repro_torch.core.powershift import ClusterNode, ShiftPlan, allocate_power
from repro_torch.core.profiler import CapBackend, RecordingBackend


@dataclasses.dataclass
class _NodeState:
    node: ClusterNode
    backend: CapBackend
    healthy_device: PowerCappedDevice    # derate=1 reference for inference
    step_time_ewma: float | None = None
    watts_ewma: float | None = None
    n_steps: int = 0
    derate_est: float = 1.0


class ClusterCoordinator:
    """Subscribes to per-node telemetry; rebalances the global budget."""

    def __init__(
        self,
        bus: EventBus,
        *,
        global_budget_w: float,
        rebalance_every: int = 16,
        ewma: float = 0.5,
        min_derate: float = 0.2,
        on_plan: Callable[[ShiftPlan], None] | None = None,
    ) -> None:
        self.bus = bus
        self.global_budget_w = float(global_budget_w)
        self.rebalance_every = int(rebalance_every)
        self.ewma = float(ewma)
        self.min_derate = float(min_derate)
        self.on_plan = on_plan
        self._nodes: dict[str, _NodeState] = {}
        self._steps_since_rebalance = 0
        self.plans: list[ShiftPlan] = []
        self.audit: list[dict] = []      # allocated vs measured watts per plan
        self._unsubs = [
            bus.subscribe(StepDone, self._on_step),
            bus.subscribe(PowerSampled, self._on_power),
            bus.subscribe(NodeDerated, self._on_derated),
        ]

    def close(self) -> None:
        for u in self._unsubs:
            u()

    # -- membership -----------------------------------------------------------
    def register_node(self, node: ClusterNode,
                      backend: CapBackend | None = None) -> CapBackend:
        backend = backend or RecordingBackend()
        self._nodes[node.node_id] = _NodeState(
            node=node, backend=backend,
            healthy_device=PowerCappedDevice(node.device.spec),
            derate_est=node.device.derate)
        return backend

    def deregister_node(self, node_id: str) -> None:
        self._nodes.pop(node_id, None)

    @property
    def node_ids(self) -> list[str]:
        return list(self._nodes)

    # -- telemetry ingestion --------------------------------------------------
    def _on_power(self, ev: PowerSampled) -> None:
        st = self._nodes.get(ev.node_id)
        if st is None:
            return
        w = ev.total_w
        st.watts_ewma = w if st.watts_ewma is None \
            else self.ewma * st.watts_ewma + (1 - self.ewma) * w

    def _on_step(self, ev: StepDone) -> None:
        st = self._nodes.get(ev.node_id)
        if st is None:
            return
        st.n_steps += 1
        t = ev.duration_s
        st.step_time_ewma = t if st.step_time_ewma is None \
            else self.ewma * st.step_time_ewma + (1 - self.ewma) * t
        self._steps_since_rebalance += 1
        if self._steps_since_rebalance >= self.rebalance_every:
            self.rebalance()

    def _on_derated(self, ev: NodeDerated) -> None:
        """A supervisor inferred a derate out-of-band (heartbeat latencies,
        not step telemetry).  Adopt it directly — it is fresher than the
        rebalance-window estimate and the next `_update_derate` will refine
        it once step telemetry under the new caps accumulates."""
        st = self._nodes.get(ev.node_id)
        if st is None:
            return
        st.derate_est = float(min(1.0, max(self.min_derate, ev.derate)))

    def _update_derate(self, st: _NodeState) -> None:
        """Observed/predicted step time at the node's current cap -> an
        effective derate (clock multiplier) for the next allocation.  Runs
        once per rebalance window, not per step: the fixed-point power-model
        solve is too heavy for the synchronous step path."""
        if st.step_time_ewma is None or st.step_time_ewma <= 0:
            return
        cap = st.backend.current_cap()
        predicted = st.healthy_device.estimate(st.node.workload,
                                               cap).step_time_s
        if predicted <= 0:
            return
        ratio = predicted / st.step_time_ewma              # <1 => slower than model
        st.derate_est = float(min(1.0, max(self.min_derate, ratio)))

    def update_workload(self, node_id: str, workload: WorkloadProfile) -> None:
        """Telemetry-independent workload refresh (e.g. recompiled step)."""
        st = self._nodes[node_id]
        st.node = dataclasses.replace(st.node, workload=workload)

    # -- the control action ---------------------------------------------------
    def rebalance(self) -> ShiftPlan:
        """Re-run the water-filling allocator over the live health picture and
        push per-node cap commands through each node's backend."""
        if not self._nodes:
            raise RuntimeError("no nodes registered")
        self._steps_since_rebalance = 0
        live_nodes = []
        for st in self._nodes.values():
            self._update_derate(st)
            device = PowerCappedDevice(st.node.device.spec,
                                       derate=st.derate_est)
            live_nodes.append(dataclasses.replace(st.node, device=device))
        plan = allocate_power(live_nodes, self.global_budget_w)
        for alloc in plan.allocations:
            st = self._nodes[alloc.node_id]
            if abs(st.backend.current_cap() - alloc.cap) > 1e-6:
                st.backend.apply_cap(alloc.cap)
                self.bus.publish(CapApplied(node_id=alloc.node_id,
                                            cap=alloc.cap,
                                            reason="rebalance",
                                            source="cluster-coordinator"))
        self.plans.append(plan)
        # Budget audit: allocation is model-based; the measured draw (EWMA of
        # PowerSampled telemetry) is the ground truth the budget is actually
        # enforced against.  The EWMA was accumulated under the caps of the
        # window that just ENDED, so `window_over_budget` audits the previous
        # plan's enforcement, not the plan being installed now.  A large gap
        # between allocated and measured flags a mis-calibrated power model.
        measured = self.measured_total_w()
        self.audit.append({"allocated_w": plan.total_power_w,
                           "window_measured_w": measured,
                           "budget_w": self.global_budget_w,
                           "window_over_budget": (measured is not None
                                                  and measured > self.global_budget_w)})
        # The caps just changed: step-time/watts EWMAs accumulated under the
        # OLD caps would be compared against new-cap predictions at the next
        # rebalance, pushing derate estimates into oscillation.  Start the
        # next health window clean (derate_est itself persists).
        for st in self._nodes.values():
            st.step_time_ewma = None
            st.watts_ewma = None
        if self.on_plan is not None:
            self.on_plan(plan)
        return plan

    def measured_total_w(self) -> float | None:
        """Sum of per-node measured power EWMAs; None until every registered
        node has reported at least one PowerSampled."""
        watts = [st.watts_ewma for st in self._nodes.values()]
        if any(w is None for w in watts):
            return None
        return float(sum(watts))

    def current_caps(self) -> dict[str, float]:
        return {nid: st.backend.current_cap()
                for nid, st in self._nodes.items()}

    def derates(self) -> dict[str, float]:
        return {nid: st.derate_est for nid, st in self._nodes.items()}
