"""The FROST cap profiler — paper Sec III-C.

When a new (model, dataset, hardware) triple appears, FROST:

  1. probes the 8 power limits {30..100}% of TDP for ~30 s each,
  2. computes the ED^mP cost of each probe (m from the A1 QoS policy),
  3. fits F(x) = a e^(bx-c) + d sigma(ex-f) + g by MSE (Eqs 6-7),
  4. minimises F with the downhill simplex -> optimal cap,
  5. applies the cap through a pluggable enforcement backend.

The workload is abstracted behind ``Workload.probe`` so the same profiler
drives: the analytic device model (this container), a real-step-timed CPU
workload (CNN zoo benchmarks), or `nvidia-smi`-backed hardware (deployment).

Steps 2-4 are pure and shared with the event-driven online profiler
(``repro_torch.control.online``) through :func:`decide_cap`; ``CapProfiler`` is
the batch front-end (dedicated probe windows) and publishes ``CapApplied``
events when attached to a control-plane bus.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Protocol, Sequence

import numpy as np

from repro_torch.control.events import CapApplied
from repro_torch.core.edp import CapMeasurement, normalized_costs
from repro_torch.core.energy import EnergyLedger
from repro_torch.core.fitting import FitResult, fit_cost_curve, minimize_fit
from repro_torch.core.policy import QoSPolicy

if TYPE_CHECKING:
    from repro_torch.control.bus import EventBus

DEFAULT_CAP_GRID: tuple[float, ...] = tuple(np.round(np.arange(0.30, 1.001, 0.10), 2))
DEFAULT_PROBE_SECONDS = 30.0   # paper: ~30 s covers several batches for all models


class Workload(Protocol):
    """Anything FROST can profile."""

    def probe(self, cap: float, duration_s: float) -> tuple[int, float, float]:
        """Run under ``cap`` for ~``duration_s``; return
        (samples_processed, energy_joules, elapsed_seconds)."""
        ...


class CapBackend(Protocol):
    """Cap enforcement (``nvidia-smi -pl`` equivalent)."""

    def apply_cap(self, cap: float) -> None: ...
    def current_cap(self) -> float: ...


class RecordingBackend:
    """Default in-memory backend (simulation / dry deployments)."""

    def __init__(self) -> None:
        self._cap = 1.0
        self.history: list[float] = []

    def apply_cap(self, cap: float) -> None:
        self._cap = float(cap)
        self.history.append(self._cap)

    def current_cap(self) -> float:
        return self._cap


@dataclasses.dataclass(frozen=True)
class CapDecision:
    """Outcome of one profiling pass."""
    cap: float                         # selected power limit (fraction of TDP)
    policy_id: str
    edp_exponent: float
    fit: FitResult
    measurements: tuple[CapMeasurement, ...]
    profile_energy_j: float            # Eq 4/5 leading term: 8 * int P_pr dt
    predicted_energy_saving: float     # vs the 100% cap probe
    predicted_delay_increase: float    # vs the 100% cap probe

    @property
    def fit_accepted(self) -> bool:
        return self.fit.accepted


def interp_measurements(meas: Sequence[CapMeasurement],
                         cap: float) -> tuple[float, float]:
    """Linear interpolation of (energy/sample, time/sample) between probes."""
    caps = np.array([r.cap for r in meas])
    e = np.array([r.energy_per_sample for r in meas])
    t = np.array([r.time_per_sample for r in meas])
    return (float(np.interp(cap, caps, e)), float(np.interp(cap, caps, t)))


def decide_cap(measurements: Sequence[CapMeasurement],
               policy: QoSPolicy,
               *,
               fit_x0: Sequence[float] | None = None,
               fit_multi_start: bool = True) -> CapDecision:
    """Steps 3-4 of the FROST flow as a pure function: fit F(x) to the probe
    costs, minimise over the policy's legal cap window, and enforce the hard
    QoS delay bound.  Shared by the batch ``CapProfiler`` and the streaming
    ``repro_torch.control.online.OnlineCapProfiler`` (which warm-starts the fit
    from its previous coefficients via ``fit_x0``)."""
    if len(measurements) < 3:
        raise ValueError("need >=3 probes to decide a cap")
    m = policy.edp_exponent
    meas = sorted(measurements, key=lambda r: r.cap)
    caps = np.array([r.cap for r in meas])
    costs = normalized_costs(list(meas), m)
    fit = fit_cost_curve(caps, costs, x0=fit_x0, multi_start=fit_multi_start)
    best_cap, _ = minimize_fit(fit, lo=max(policy.min_cap, caps.min()),
                               hi=min(policy.max_cap, caps.max()))

    ref = meas[-1]  # 100% (or highest legal) cap
    pred = interp_measurements(meas, best_cap)
    delay_increase = pred[1] / ref.time_per_sample - 1.0

    # Hard QoS constraint: walk the cap up until the delay bound holds.
    if (policy.max_delay_increase is not None
            and delay_increase > policy.max_delay_increase):
        for cap in [c for c in caps if c >= best_cap]:
            e, t = interp_measurements(meas, cap)
            if t / ref.time_per_sample - 1.0 <= policy.max_delay_increase:
                best_cap, pred = cap, (e, t)
                delay_increase = t / ref.time_per_sample - 1.0
                break
        else:
            best_cap, pred, delay_increase = ref.cap, (ref.energy_per_sample,
                                                       ref.time_per_sample), 0.0

    return CapDecision(
        cap=float(best_cap),
        policy_id=policy.policy_id,
        edp_exponent=m,
        fit=fit,
        measurements=tuple(meas),
        profile_energy_j=float(sum(r.energy_j for r in meas)),
        predicted_energy_saving=1.0 - pred[0] / ref.energy_per_sample,
        predicted_delay_increase=float(delay_increase),
    )


class CapProfiler:
    def __init__(
        self,
        workload: Workload,
        *,
        policy: QoSPolicy | None = None,
        backend: CapBackend | None = None,
        cap_grid: Sequence[float] = DEFAULT_CAP_GRID,
        probe_seconds: float = DEFAULT_PROBE_SECONDS,
        ledger: EnergyLedger | None = None,
        bus: "EventBus | None" = None,
        node_id: str = "node-0",
    ) -> None:
        self.workload = workload
        self.policy = policy or QoSPolicy()
        self.backend = backend or RecordingBackend()
        self.cap_grid = tuple(sorted(float(c) for c in cap_grid))
        self.probe_seconds = float(probe_seconds)
        self.ledger = ledger
        self.bus = bus
        self.node_id = node_id

    def _apply(self, cap: float, reason: str) -> None:
        self.backend.apply_cap(cap)
        if self.bus is not None:
            self.bus.publish(CapApplied(node_id=self.node_id, cap=float(cap),
                                        reason=reason, source="cap-profiler"))

    # -- step 1-2: probe the grid -------------------------------------------
    def measure(self) -> list[CapMeasurement]:
        out: list[CapMeasurement] = []
        for cap in self.cap_grid:
            if not (self.policy.min_cap <= cap <= self.policy.max_cap):
                continue
            self._apply(cap, "probe")
            samples, energy_j, elapsed_s = self.workload.probe(cap, self.probe_seconds)
            out.append(CapMeasurement(cap=cap, energy_j=energy_j,
                                      delay_s=elapsed_s, samples=samples))
            if self.ledger is not None:
                self.ledger.add_profile_energy(energy_j)
        if len(out) < 3:
            raise RuntimeError("policy cap window leaves <3 probes; cannot profile")
        return out

    # -- step 3-5: fit, minimise, decide --------------------------------------
    def decide(self, measurements: Sequence[CapMeasurement]) -> CapDecision:
        decision = decide_cap(measurements, self.policy)
        self._apply(decision.cap, "decision")
        return decision

    def run(self) -> CapDecision:
        return self.decide(self.measure())

    @staticmethod
    def _interp(meas: Sequence[CapMeasurement], cap: float) -> tuple[float, float]:
        return interp_measurements(meas, cap)
