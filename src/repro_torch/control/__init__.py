"""Event-driven FROST control plane.

The paper's Fig 1 loop — telemetry out of the running pipeline, cap
decisions back in — realised as an in-process typed event bus plus two
controllers:

  * ``EventBus`` + event types (``bus``/``events``): the spine; producers
    (step loops, ``PowerSampler``) and consumers (profilers, coordinator,
    ``FrostService``) meet here instead of calling each other directly.
  * ``OnlineCapProfiler`` (``online``): amortises the paper's 8-point probe
    across live traffic and retunes the cap as events stream in.
  * ``ClusterCoordinator`` (``coordinator``): re-runs the power-shift
    allocator over live per-node telemetry and emits cap commands.

``online``/``coordinator`` are exported lazily (PEP 562) because they pull
in ``repro_torch.core``, which itself publishes events from this package.
"""
from repro_torch.control.bus import DeadLetter, EventBus, pipe
from repro_torch.control.events import (CapApplied, DriftDetected, EmergencyPower,
                                  Event, FitUpdated, NodeDerated,
                                  PolicyUpdated, PowerSampled, StepDone,
                                  as_dict)

__all__ = [
    "EventBus", "DeadLetter", "pipe",
    "Event", "StepDone", "PowerSampled", "CapApplied", "DriftDetected",
    "PolicyUpdated", "FitUpdated", "NodeDerated", "EmergencyPower", "as_dict",
    "OnlineCapProfiler", "ClusterCoordinator",
]


def __getattr__(name: str):
    if name == "OnlineCapProfiler":
        from repro_torch.control.online import OnlineCapProfiler
        return OnlineCapProfiler
    if name == "ClusterCoordinator":
        from repro_torch.control.coordinator import ClusterCoordinator
        return ClusterCoordinator
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
