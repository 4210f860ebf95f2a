"""Power meters — the FROST measurement backends (paper Sec III-A).

The paper reads Intel RAPL MSRs (CPU), Nvidia NVML (GPU) and estimates DRAM
analytically.  This container exposes none of those, so the same Meter
interface is served by:

  * RaplMeter          — real /sys/class/powercap RAPL counters when present,
  * CpuProcessMeter    — process CPU-time derivative x per-core active watts
                         (works everywhere; used by the Fig 3 overhead bench),
  * DramMeter          — the paper's rule: P = N_DIMM * 3/8 * S_DIMM (GB),
  * AnalyticDeviceMeter— the calibrated PowerCappedDevice model (the stand-in
                         for NVML on the simulated accelerators).

All meters return instantaneous watts; the sampler integrates.
"""
from __future__ import annotations

import os
import pathlib
import time
from typing import Protocol

from repro_torch.core.energy import dram_power_estimate
from repro_torch.core.powermodel import PowerCappedDevice, WorkloadProfile


class Meter(Protocol):
    name: str

    def read_watts(self) -> float: ...


class CpuProcessMeter:
    """Derivative of this process's CPU time, scaled by watts/active-core.

    ~10 W/core active is a documented assumption for modern server cores at
    mid utilisation; it only scales relative numbers (Fig 3 compares
    *overheads*, which are time-dominated).
    """
    name = "cpu-process"

    def __init__(self, watts_per_core: float = 10.0, idle_w: float = 2.0):
        self.watts_per_core = watts_per_core
        self.idle_w = idle_w
        self._last = (time.monotonic(), self._cpu_seconds())

    @staticmethod
    def _cpu_seconds() -> float:
        t = os.times()
        return t.user + t.system

    def read_watts(self) -> float:
        now = time.monotonic()
        cpu = self._cpu_seconds()
        t0, c0 = self._last
        self._last = (now, cpu)
        dt = max(now - t0, 1e-6)
        util_cores = max(0.0, (cpu - c0) / dt)
        return self.idle_w + util_cores * self.watts_per_core


class RaplMeter:
    """Intel RAPL via powercap sysfs (graceful if absent)."""
    name = "cpu-rapl"
    BASE = pathlib.Path("/sys/class/powercap")

    def __init__(self):
        self._zones = sorted(self.BASE.glob("intel-rapl:*/energy_uj")) \
            if self.BASE.exists() else []
        self._last: tuple[float, float] | None = None

    @property
    def available(self) -> bool:
        return bool(self._zones)

    def _energy_j(self) -> float:
        total = 0.0
        for z in self._zones:
            try:
                total += int(z.read_text()) * 1e-6
            except OSError:
                pass
        return total

    def read_watts(self) -> float:
        if not self._zones:
            return 0.0
        now, e = time.monotonic(), self._energy_j()
        if self._last is None:
            self._last = (now, e)
            return 0.0
        t0, e0 = self._last
        self._last = (now, e)
        return max(0.0, (e - e0) / max(now - t0, 1e-6))


class DramMeter:
    """Paper Sec III-A: P_DRAM = N_DIMM x 3/8 x S_DIMM — load-independent."""
    name = "dram"

    def __init__(self, n_dimm: int = 4, dimm_size_gb: float = 16.0):
        self._watts = dram_power_estimate(n_dimm, dimm_size_gb)

    def read_watts(self) -> float:
        return self._watts


class AnalyticDeviceMeter:
    """NVML stand-in: the calibrated device model under the current cap and
    workload.  ``set_workload``/``set_cap`` are driven by the profiler."""
    name = "accelerator"

    def __init__(self, device: PowerCappedDevice,
                 workload: WorkloadProfile | None = None, cap: float = 1.0):
        self.device = device
        self.workload = workload
        self.cap = cap
        self.busy = False

    def set_cap(self, cap: float):
        self.cap = float(cap)

    def set_workload(self, wl: WorkloadProfile | None, busy: bool = True):
        self.workload = wl
        self.busy = busy

    def read_watts(self) -> float:
        if not self.busy or self.workload is None:
            return self.device.spec.static_w
        return self.device.estimate(self.workload, self.cap).power_w


class StackedMeter:
    """Eq (3): P(t) = P_CPU + P_GPU + P_DRAM."""
    name = "total"

    def __init__(self, *meters: Meter):
        self.meters = meters

    def read_watts(self) -> float:
        return sum(m.read_watts() for m in self.meters)

    def read_components(self) -> dict[str, float]:
        return {m.name: m.read_watts() for m in self.meters}
