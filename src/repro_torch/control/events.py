"""Typed control-plane events — the vocabulary of the FROST loop.

The paper's Fig 1 runs FROST *in parallel to* the ML pipeline: telemetry
streams out of the running job, decisions stream back in as cap commands.
These dataclasses are the wire format of that loop.  They are deliberately
plain (frozen dataclasses; no runtime imports from the rest of the repo,
so ``repro_torch.core`` modules can publish them without import cycles) and can
later cross a real message bus (O-RAN A1/E2 realisation) without changing
any producer or consumer.

Producers / consumers at a glance::

    StepDone       launch loops, Supervisor        -> OnlineCapProfiler,
                                                      FrostService, Coordinator
    PowerSampled   telemetry.PowerSampler          -> OnlineCapProfiler, Coordinator
    CapApplied     profilers, coordinator          -> observers / ledgers
    DriftDetected  OnlineCapProfiler, FrostService -> re-profiling triggers
    PolicyUpdated  SMO / FrostService.on_policy    -> profilers (reset + retune)
    FitUpdated     OnlineCapProfiler               -> observers / warm-start caches
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Mapping

if TYPE_CHECKING:                                  # no runtime dependency
    from repro_torch.core.fitting import FitResult
    from repro_torch.core.policy import QoSPolicy


@dataclasses.dataclass(frozen=True)
class Event:
    """Base class — every event names the node it concerns."""
    node_id: str


@dataclasses.dataclass(frozen=True)
class StepDone(Event):
    """One pipeline step (train step / decode token batch) finished."""
    step: int
    duration_s: float
    samples: int = 1
    energy_j: float = 0.0        # 0 => unknown; consumers may estimate from
                                 # the latest PowerSampled watts
    model_id: str = ""


@dataclasses.dataclass(frozen=True)
class PowerSampled(Event):
    """One telemetry sample (paper Eq 3 components), watts."""
    t: float
    cpu_w: float = 0.0
    gpu_w: float = 0.0
    dram_w: float = 0.0

    @property
    def total_w(self) -> float:
        return self.cpu_w + self.gpu_w + self.dram_w


@dataclasses.dataclass(frozen=True)
class CapApplied(Event):
    """A power cap was enforced through a CapBackend."""
    cap: float
    reason: str = "decision"     # "probe" | "decision" | "rebalance" | "policy"
    source: str = ""             # who applied it (profiler / coordinator / ...)
    model_id: str = ""


@dataclasses.dataclass(frozen=True)
class DriftDetected(Event):
    """Observed throughput departed from the profiled expectation."""
    model_id: str
    drift: float                 # |observed - expected| / expected
    expected_s: float
    observed_s: float


@dataclasses.dataclass(frozen=True)
class PolicyUpdated(Event):
    """A new A1 QoS policy is in force for the node."""
    policy: "QoSPolicy"

    @property
    def policy_id(self) -> str:
        return self.policy.policy_id


@dataclasses.dataclass(frozen=True)
class FitUpdated(Event):
    """The online profiler refreshed its F(x) fit (paper Eqs 6-7)."""
    model_id: str
    fit: "FitResult"
    cap: float                   # minimiser under the active policy
    n_probes: int


@dataclasses.dataclass(frozen=True)
class NodeDerated(Event):
    """A supervisor inferred a thermal/silicon derate from heartbeat
    latencies (1.0 = healthy).  The cluster coordinator folds this into
    its next power rebalance — the serving half of the FROST
    straggler-mitigation loop (see docs/fault_tolerance.md)."""
    derate: float
    source: str = ""             # who inferred it (supervisor / coordinator)


@dataclasses.dataclass(frozen=True)
class EmergencyPower(Event):
    """A power emergency (site cap slash / thermal trip) started or
    cleared.  Serving reacts by *degrading* — pause admission, shrink the
    decode chunk, drop speculative K — instead of violating the cap."""
    cap: float                   # cap fraction in force for the window
    active: bool                 # True = window opened, False = cleared
    reason: str = "emergency"


def as_dict(event: Event) -> Mapping[str, Any]:
    """Loggable view (FitResult/QoSPolicy collapsed to identifiers)."""
    out: dict[str, Any] = dataclasses.asdict(event)
    if isinstance(event, FitUpdated):
        out["fit"] = {"rel_rmse": event.fit.rel_rmse,
                      "accepted": event.fit.accepted}
    if isinstance(event, PolicyUpdated):
        out["policy"] = event.policy.policy_id
    out["type"] = type(event).__name__
    return out
