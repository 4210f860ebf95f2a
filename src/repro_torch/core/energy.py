"""Energy accounting — paper Sec III-A/B, Eqs (1)-(5).

The paper measures phase energy as the integral of sampled power minus the
integral of idle power over a fixed idle-measurement window ``T_m``, and adds
the cost of the 8 profiling probes when the profiler ran (Eqs 4-5):

    E_tr = 8 * int_0^{T_pr} P_pr dt  +  int_0^{T_tr} P_tr dt  -  int_0^{T_m} P_idle dt

Power at any instant is the component sum P_CPU + P_GPU + P_DRAM (Eq 3).
DRAM power uses the paper's rule of thumb  P_DRAM = N_DIMM * 3/8 * S_DIMM
(watts, S_DIMM in GB) since consumer CPUs expose no DRAM MSRs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PowerSample:
    """One telemetry sample (paper Eq 3 components), watts."""
    t: float          # seconds, monotonic
    cpu_w: float = 0.0
    gpu_w: float = 0.0
    dram_w: float = 0.0

    @property
    def total_w(self) -> float:
        return self.cpu_w + self.gpu_w + self.dram_w


def dram_power_estimate(n_dimm: int, dimm_size_gb: float) -> float:
    """Paper Sec III-A: P_DRAM = N_DIMM x 3/8 x S_DIMM (load-independent)."""
    if n_dimm < 0 or dimm_size_gb < 0:
        raise ValueError("DIMM count/size must be non-negative")
    return n_dimm * (3.0 / 8.0) * dimm_size_gb


def integrate_power(samples: Sequence[PowerSample]) -> float:
    """Trapezoidal integral of total power over the sample trace -> joules."""
    if len(samples) < 2:
        return 0.0
    t = np.array([s.t for s in samples])
    p = np.array([s.total_w for s in samples])
    if np.any(np.diff(t) < 0):
        raise ValueError("power samples must be time-ordered")
    return float(np.trapezoid(p, t))


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Net energy of one pipeline phase (training or inference)."""
    gross_j: float            # int P_phase dt
    idle_j: float             # int_0^{T_m} P_idle dt  (subtracted, Eq 1/2)
    profile_j: float          # 8 * int P_pr dt        (added, Eq 4/5)
    duration_s: float

    @property
    def net_j(self) -> float:
        return self.profile_j + self.gross_j - self.idle_j

    @property
    def mean_power_w(self) -> float:
        # Paper Sec IV-A: P_tr = E_tr / T_tr.
        return self.gross_j / self.duration_s if self.duration_s > 0 else 0.0


class EnergyLedger:
    """Accumulates telemetry for one phase and produces an EnergyReport.

    Mirrors the FROST measurement flow: an idle trace is captured once per
    host (window T_m), each profiler probe contributes its own trace, and
    the phase trace is integrated at the end.
    """

    def __init__(self, idle_trace: Sequence[PowerSample] | None = None):
        self._idle_trace: list[PowerSample] = list(idle_trace or [])
        self._phase: list[PowerSample] = []
        self._profile_j: float = 0.0

    # -- telemetry ingestion ------------------------------------------------
    def record(self, sample: PowerSample) -> None:
        self._phase.append(sample)

    def extend(self, samples: Iterable[PowerSample]) -> None:
        self._phase.extend(samples)

    def record_idle(self, sample: PowerSample) -> None:
        self._idle_trace.append(sample)

    def add_profile_probe(self, probe_trace: Sequence[PowerSample]) -> None:
        """One of the 8 profiler probes (Eq 4/5 leading term)."""
        self._profile_j += integrate_power(probe_trace)

    def add_profile_energy(self, joules: float) -> None:
        self._profile_j += float(joules)

    # -- reporting ----------------------------------------------------------
    @property
    def idle_power_w(self) -> float:
        if len(self._idle_trace) < 2:
            return 0.0
        dur = self._idle_trace[-1].t - self._idle_trace[0].t
        return integrate_power(self._idle_trace) / dur if dur > 0 else 0.0

    def report(self) -> EnergyReport:
        dur = (self._phase[-1].t - self._phase[0].t) if len(self._phase) >= 2 else 0.0
        # Idle subtraction uses the phase duration at the measured idle power
        # (the paper's T_m idle window calibrates P_idle; the subtraction is
        # over the phase span).
        idle_j = self.idle_power_w * dur
        return EnergyReport(
            gross_j=integrate_power(self._phase),
            idle_j=idle_j,
            profile_j=self._profile_j,
            duration_s=dur,
        )
