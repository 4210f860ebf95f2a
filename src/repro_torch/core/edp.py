"""Energy-Delay Product metrics — paper Sec III-C.

EDP = E * D bridges algorithm and hardware (Gonzalez & Horowitz 1996).  The
paper generalises to ED^m P so A1 policies can weight delay:

    m = 1  -> energy-lean    (max energy savings)
    m = 2  -> the paper's empirical sweet spot (Fig 6)
    m = 3  -> delay-lean     (optimal cap drifts toward 100%)
"""
from __future__ import annotations

import dataclasses

import numpy as np


def edp(energy_j: float, delay_s: float, m: float = 1.0) -> float:
    """Generalised energy-delay product  E * D^m."""
    if energy_j < 0 or delay_s < 0:
        raise ValueError("energy and delay must be non-negative")
    return float(energy_j) * float(delay_s) ** float(m)


@dataclasses.dataclass(frozen=True)
class CapMeasurement:
    """One profiler probe result at a given power cap."""
    cap: float                 # fraction of TDP in [0.3, 1.0]
    energy_j: float            # net probe energy (idle-subtracted)
    delay_s: float             # time to process the probe workload
    samples: int = 0           # workload items processed during the probe

    @property
    def energy_per_sample(self) -> float:
        return self.energy_j / self.samples if self.samples else self.energy_j

    @property
    def time_per_sample(self) -> float:
        return self.delay_s / self.samples if self.samples else self.delay_s

    def cost(self, m: float = 1.0) -> float:
        """ED^mP on per-sample quantities so probes of different lengths
        compare fairly (the paper normalises by the energy-per-sample)."""
        return edp(self.energy_per_sample, self.time_per_sample, m)


def normalized_costs(measurements: list[CapMeasurement], m: float) -> np.ndarray:
    """ED^mP of each probe, normalised by the 100%-cap (or max-cap) probe so
    the fitted curve is scale-free."""
    if not measurements:
        raise ValueError("no measurements")
    ref = max(measurements, key=lambda r: r.cap)
    ref_cost = ref.cost(m)
    if ref_cost <= 0:
        raise ValueError("reference probe has non-positive cost")
    return np.array([r.cost(m) / ref_cost for r in measurements])
