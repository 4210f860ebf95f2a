"""Device power/performance models — the hardware-adaptation layer.

The paper enforces caps with ``nvidia-smi -pl`` and reads power from NVML
MSRs.  This container has neither GPUs nor TPUs, so FROST's *mechanism*
(profile caps -> fit -> minimise) runs against a calibrated analytic device
model instead.  The model is physics-first, not outcome-fitted:

  * clock governor: dynamic power ~ C V^2 f with V ~ f  =>  P_dyn ~ f^3.
    Under cap x the governor picks the largest normalised clock f_hat <= 1
    such that   P_static + u * (P_tdp - P_static) * f_hat^3  <=  x * P_tdp
    (u = the workload's compute duty cycle; a starved GPU never hits its cap
    — this is what makes LeNet the paper's flat outlier).
  * runtime: the step is split into roofline terms.  Only the compute-bound
    seconds stretch when the core clock drops:
        T(x) = blend( t_c / f_hat(x),  t_m,  t_x ) + t_host
    matching the paper's observation that capping is nearly free while the
    program is partially memory-bound and blows up once compute-bound.
  * instability floor: the paper reports circuit instability below ~30%
    caps; the governor refuses caps below ``spec.min_cap``.

The same split (t_c, t_m, t_x) is exactly what the multi-pod dry-run's
roofline analysis produces, so FROST's recommendations for the LM archs are
driven by the compiled artifact, not hand-waving.
"""
from __future__ import annotations

import dataclasses

import numpy as np


# --------------------------------------------------------------------------
# Device catalogue
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Static description of one accelerator board/chip."""
    name: str
    tdp_w: float                  # board power at 100% cap
    static_w: float               # non-scalable (idle) power
    peak_flops: float             # peak FLOP/s in the training dtype
    hbm_bw: float                 # HBM bytes/s
    link_bw: float                # interconnect bytes/s per link
    min_cap: float = 0.30         # instability floor (paper Sec IV-C)
    min_clock: float = 0.25       # normalised clock floor
    matmul_efficiency: float = 0.85   # achievable fraction of peak on MXU/tensor cores
    vmem_bytes: int = 0
    hbm_bytes: int = 0

    def cap_watts(self, cap: float) -> float:
        return cap * self.tdp_w


# Paper setup no.1 / no.2 GPUs (desktop rigs) and our deployment target.
RTX_3080 = DeviceSpec(
    name="rtx-3080", tdp_w=320.0, static_w=28.0,
    peak_flops=29.8e12, hbm_bw=760e9, link_bw=16e9,   # fp32 shader peak, PCIe4 x16
    hbm_bytes=10 * 2**30,
)
RTX_3090 = DeviceSpec(
    name="rtx-3090", tdp_w=350.0, static_w=32.0,
    peak_flops=35.6e12, hbm_bw=936e9, link_bw=16e9,
    hbm_bytes=24 * 2**30,
)
# TPU v5e chip — constants from the assignment brief (197 TFLOP/s bf16,
# 819 GB/s HBM, ~50 GB/s/link ICI).  Board power is not officially published
# per chip; 215 W max / 75 W static are our documented assumptions
# (DESIGN.md Sec 5) in line with public v4 measurements scaled to v5e.
TPU_V5E = DeviceSpec(
    name="tpu-v5e", tdp_w=215.0, static_w=75.0,
    peak_flops=197e12, hbm_bw=819e9, link_bw=50e9,
    vmem_bytes=16 * 2**20, hbm_bytes=16 * 2**30,
)

# NVIDIA H100 SXM — the PyTorch port's target card, from NVIDIA's data
# sheet: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GiB, NVLink 900 GB/s
# all-to-all (450 GB/s each way), 700 W board power.  static_w is an
# assumption, not a published figure: ~100 W idle draw of a loaded SXM
# board (clocks up, HBM refreshing, no kernels resident).
H100_SXM = DeviceSpec(
    name="h100-sxm", tdp_w=700.0, static_w=100.0,
    peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
    hbm_bytes=80 * 2**30,
)

DEVICES: dict[str, DeviceSpec] = {d.name: d for d in (RTX_3080, RTX_3090,
                                                      TPU_V5E, H100_SXM)}


# --------------------------------------------------------------------------
# Workload roofline description
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-step workload character, derivable from the step's counted cost
    (``repro_torch.launch.stepcost``, which the dry-run
    ``repro_torch.launch.dryrun`` records for every cell)."""
    name: str
    flops_per_step: float
    hbm_bytes_per_step: float
    collective_bytes_per_step: float = 0.0
    host_overhead_s: float = 0.0       # launch/data-pipeline serial time
    samples_per_step: int = 1
    overlap: float = 0.7               # 0 = fully serial terms, 1 = perfect overlap

    def roofline_times(self, spec: DeviceSpec) -> tuple[float, float, float]:
        t_c = self.flops_per_step / (spec.peak_flops * spec.matmul_efficiency)
        t_m = self.hbm_bytes_per_step / spec.hbm_bw
        t_x = self.collective_bytes_per_step / spec.link_bw
        return t_c, t_m, t_x

    def compute_fraction(self, spec: DeviceSpec) -> float:
        t_c, t_m, t_x = self.roofline_times(spec)
        tot = t_c + t_m + t_x + self.host_overhead_s
        return t_c / tot if tot > 0 else 0.0


# --------------------------------------------------------------------------
# The capped device
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepEstimate:
    cap: float
    clock: float               # normalised f_hat
    step_time_s: float
    power_w: float             # board draw during the step
    energy_j: float            # per step
    utilization: float         # compute duty cycle


class PowerCappedDevice:
    """Analytic stand-in for one accelerator under a power cap.

    ``derate`` < 1 models thermal throttling / silicon lottery — the
    canonical straggler source the cluster power-shift allocator handles.
    """

    def __init__(self, spec: DeviceSpec, *, derate: float = 1.0):
        if not (0.0 < derate <= 1.0):
            raise ValueError("derate must be in (0, 1]")
        self.spec = spec
        self.derate = derate

    # -- governor -----------------------------------------------------------
    def clock_under_cap(self, cap: float, utilization: float) -> float:
        """Largest stable normalised clock meeting the cap at duty cycle u."""
        spec = self.spec
        cap = float(np.clip(cap, spec.min_cap, 1.0))
        budget = cap * spec.tdp_w - spec.static_w
        dyn_full = max(utilization, 1e-6) * (spec.tdp_w - spec.static_w)
        if budget <= 0.0:
            f = spec.min_clock
        else:
            f = min(1.0, (budget / dyn_full) ** (1.0 / 3.0))
        return max(f, spec.min_clock) * self.derate

    # -- step estimation ------------------------------------------------------
    def estimate(self, wl: WorkloadProfile, cap: float = 1.0) -> StepEstimate:
        spec = self.spec
        cap = float(np.clip(cap, spec.min_cap, 1.0))
        t_c, t_m, t_x = wl.roofline_times(spec)

        # Duty cycle and clock are mutually dependent (slower clock -> higher
        # compute fraction); a short fixed-point iteration converges fast.
        f = 1.0 * self.derate
        u = 0.0
        for _ in range(8):
            t_core_serial = t_c / f + t_m + t_x
            t_core_max = max(t_c / f, t_m, t_x)
            t_core = (1.0 - wl.overlap) * t_core_serial + wl.overlap * t_core_max
            step = t_core + wl.host_overhead_s
            u_new = (t_c / f) / step if step > 0 else 0.0
            f_new = self.clock_under_cap(cap, u_new)
            if abs(f_new - f) < 1e-6 and abs(u_new - u) < 1e-6:
                f, u = f_new, u_new
                break
            f, u = f_new, u_new

        t_core_serial = t_c / f + t_m + t_x
        t_core_max = max(t_c / f, t_m, t_x)
        t_core = (1.0 - wl.overlap) * t_core_serial + wl.overlap * t_core_max
        step_time = t_core + wl.host_overhead_s
        u = (t_c / f) / step_time if step_time > 0 else 0.0

        # Board draw: static + utilisation-weighted dynamic power at clock f,
        # with a light "active idle" term (boosted clocks while kernels are
        # resident draw power even when the MXU/SMs stall on memory).
        mem_duty = min(1.0, (t_m + t_x) / step_time) if step_time > 0 else 0.0
        dyn = (self.spec.tdp_w - self.spec.static_w)
        draw = (self.spec.static_w
                + u * dyn * f ** 3
                + 0.18 * mem_duty * dyn * f)        # memory-system + uncore draw
        draw = min(draw, cap * self.spec.tdp_w)     # governor guarantees the cap
        return StepEstimate(
            cap=cap, clock=f, step_time_s=step_time, power_w=draw,
            energy_j=draw * step_time, utilization=u,
        )

    # -- convenience ----------------------------------------------------------
    def probe(self, wl: WorkloadProfile, cap: float, duration_s: float) -> tuple[int, float, float]:
        """Run the workload under ``cap`` for ~``duration_s`` (simulated):
        returns (samples, energy_j, elapsed_s).  Mirrors one 30 s profiler
        probe (paper Sec III-C)."""
        est = self.estimate(wl, cap)
        n_steps = max(1, int(duration_s / max(est.step_time_s, 1e-9)))
        elapsed = n_steps * est.step_time_s
        return n_steps * wl.samples_per_step, est.energy_j * n_steps, elapsed
