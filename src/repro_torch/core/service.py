"""FROST as an O-RAN microservice — paper Fig 1 / Sec II-B.

Pragmatic, in-process realisation of the O-RAN AI/ML lifecycle pieces FROST
touches.  Each ML-enabled node runs a ``FrostService``; the SMO pushes A1
policies; new models trigger a profiling pass; the selected cap is applied
through the node's enforcement backend; continuous monitoring re-profiles
on drift (a changed workload invalidates the cached decision).

Since the control-plane refactor the service is a thin adapter over the
event bus: ``attach(bus)`` subscribes it to ``StepDone`` (drift monitoring
— no more manual ``on_step_report`` plumbing) and ``PolicyUpdated`` (A1
ingestion), and every lifecycle action is published as a typed event.  The
direct-call API (``on_policy`` / ``on_new_model`` / ``on_step_report``)
keeps working unchanged for batch scripts and existing tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Callable, Mapping

from repro_torch.control.events import DriftDetected, PolicyUpdated, StepDone
from repro_torch.core.profiler import (CapBackend, CapDecision, CapProfiler,
                                 RecordingBackend, Workload,
                                 interp_measurements)
from repro_torch.core.policy import QoSPolicy

if TYPE_CHECKING:
    from repro_torch.control.bus import EventBus


@dataclasses.dataclass
class CatalogueEntry:
    """AI/ML catalogue record (validated model ready for deployment)."""
    model_id: str
    metadata: Mapping[str, Any]
    cap_decision: CapDecision | None = None


class ModelCatalogue:
    """The non-RT-RIC AI/ML catalogue (validated + published models)."""

    def __init__(self) -> None:
        self._entries: dict[str, CatalogueEntry] = {}

    def publish(self, model_id: str, metadata: Mapping[str, Any] | None = None) -> CatalogueEntry:
        entry = CatalogueEntry(model_id=model_id, metadata=dict(metadata or {}))
        self._entries[model_id] = entry
        return entry

    def get(self, model_id: str) -> CatalogueEntry:
        return self._entries[model_id]

    def __contains__(self, model_id: str) -> bool:
        return model_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass(frozen=True)
class MonitorEvent:
    ts: float
    kind: str           # "profiled" | "policy" | "drift" | "applied"
    detail: Mapping[str, Any]


class FrostService:
    """One per ML-enabled O-RAN node (inference host or training host)."""

    def __init__(
        self,
        node_id: str,
        *,
        backend: CapBackend | None = None,
        policy: QoSPolicy | None = None,
        probe_seconds: float = 30.0,
        drift_threshold: float = 0.15,
        clock: Callable[[], float] = time.monotonic,
        bus: "EventBus | None" = None,
        reprofile_on_drift: bool = True,
    ) -> None:
        self.node_id = node_id
        self.backend = backend or RecordingBackend()
        self.policy = policy or QoSPolicy()
        self.probe_seconds = probe_seconds
        self.drift_threshold = drift_threshold
        self.reprofile_on_drift = reprofile_on_drift
        self._clock = clock
        self._decisions: dict[str, CapDecision] = {}
        self._workloads: dict[str, Workload] = {}
        self._baseline_step_time: dict[str, float] = {}
        self.events: list[MonitorEvent] = []
        self.bus: "EventBus | None" = None
        self._unsubs: list[Callable[[], None]] = []
        if bus is not None:
            self.attach(bus)

    # -- control-plane wiring -------------------------------------------------
    def attach(self, bus: "EventBus") -> "FrostService":
        """Subscribe to the control plane: ``StepDone`` events feed the drift
        monitor; ``PolicyUpdated`` events (from the SMO / coordinator) replace
        direct ``on_policy`` calls.

        NOTE: drift handling runs a full *batch* re-profile (8 dedicated
        probe windows of ``probe_seconds`` each) synchronously inside the
        publishing step's ``bus.publish`` — the seed's ``on_step_report``
        semantics, now automated.  On live traffic that stall is usually
        unacceptable: either pass ``reprofile_on_drift=False`` (the service
        then only publishes ``DriftDetected`` and leaves retuning to an
        ``OnlineCapProfiler``, which amortises probes across steps), or keep
        ``probe_seconds`` short."""
        self.detach()
        self.bus = bus
        self._unsubs = [
            bus.subscribe(StepDone, self._on_step_event),
            bus.subscribe(PolicyUpdated, self._on_policy_event),
        ]
        return self

    def detach(self) -> None:
        for u in self._unsubs:
            u()
        self._unsubs = []
        self.bus = None

    def _on_step_event(self, ev: StepDone) -> None:
        if ev.node_id != self.node_id or not ev.model_id:
            return
        self.on_step_report(ev.model_id, ev.duration_s / max(ev.samples, 1))

    def _on_policy_event(self, ev: PolicyUpdated) -> None:
        if ev.node_id != self.node_id:
            return
        if ev.policy is not self.policy:      # ignore our own publication
            # Adopt without re-publishing: echoing a second PolicyUpdated
            # would make every co-subscribed controller (e.g. an
            # OnlineCapProfiler) process each policy change twice.
            self._adopt_policy(QoSPolicy.from_a1(ev.policy.to_a1()),
                               publish=False)

    def _publish(self, event) -> None:
        if self.bus is not None:
            self.bus.publish(event)

    # -- A1 policy ingestion (SMO -> non-RT-RIC -> node) ---------------------
    def on_policy(self, a1_doc: Mapping[str, Any]) -> QoSPolicy:
        return self._adopt_policy(QoSPolicy.from_a1(a1_doc), publish=True)

    def _adopt_policy(self, policy: QoSPolicy, *, publish: bool) -> QoSPolicy:
        self.policy = policy
        self._decisions.clear()       # policy change invalidates cached caps
        self._log("policy", {"policy_id": self.policy.policy_id})
        if publish:
            self._publish(PolicyUpdated(node_id=self.node_id,
                                        policy=self.policy))
        return self.policy

    # -- model arrival (deployment from the catalogue) ------------------------
    def on_new_model(self, model_id: str, workload: Workload) -> CapDecision:
        # Route the profiler through the bus too: every probe/decision cap it
        # enforces on the backend shows up as a CapApplied event, so lossless
        # observers (bus.tap) see the real mid-run enforcement actions.
        profiler = CapProfiler(
            workload, policy=self.policy, backend=self.backend,
            probe_seconds=self.probe_seconds,
            bus=self.bus, node_id=self.node_id,
        )
        decision = profiler.run()
        self._decisions[model_id] = decision
        self._workloads[model_id] = workload
        ref = max(decision.measurements, key=lambda r: r.cap)
        self._baseline_step_time[model_id] = ref.time_per_sample
        self._log("profiled", {
            "model": model_id, "cap": decision.cap,
            "saving": decision.predicted_energy_saving,
            "delay": decision.predicted_delay_increase,
            "fit_accepted": decision.fit_accepted,
        })
        # CapApplied events (probes + decision) were published by the
        # profiler itself — publishing another here would double-count.
        return decision

    # -- continuous operation (O-RAN step vi) ---------------------------------
    def on_step_report(self, model_id: str, time_per_sample: float,
                       workload: Workload | None = None) -> CapDecision | None:
        """Monitoring hook: if observed throughput drifts >threshold from the
        profiled expectation, re-profile (workload changed under us).  The
        workload argument is optional when the model arrived via
        ``on_new_model`` (the service remembers how to probe it)."""
        decision = self._decisions.get(model_id)
        if decision is None:
            return None
        expected = self._interp_time(decision, decision.cap)
        if expected <= 0:
            return None
        drift = abs(time_per_sample - expected) / expected
        workload = workload if workload is not None \
            else self._workloads.get(model_id)
        if drift > self.drift_threshold:
            self._log("drift", {"model": model_id, "drift": drift})
            self._publish(DriftDetected(
                node_id=self.node_id, model_id=model_id, drift=float(drift),
                expected_s=float(expected), observed_s=float(time_per_sample)))
            if self.reprofile_on_drift and workload is not None:
                return self.on_new_model(model_id, workload)
        return None

    def decision_for(self, model_id: str) -> CapDecision | None:
        return self._decisions.get(model_id)

    @staticmethod
    def _interp_time(decision: CapDecision, cap: float) -> float:
        return interp_measurements(decision.measurements, cap)[1]

    def _log(self, kind: str, detail: Mapping[str, Any]) -> None:
        self.events.append(MonitorEvent(ts=self._clock(), kind=kind, detail=dict(detail)))
