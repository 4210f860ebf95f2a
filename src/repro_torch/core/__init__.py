"""FROST core — the paper's contribution as a composable library.

Energy accounting (Eqs 1-5), ED^mP metrics, the F(x) cost-curve fit
(Eqs 6-7), the downhill-simplex minimiser, the 8-point cap profiler, QoS
policies, device power models, cluster power shifting, and the O-RAN
service wrapper.
"""
from repro_torch.core.edp import CapMeasurement, edp, normalized_costs
from repro_torch.core.energy import (EnergyLedger, EnergyReport, PowerSample,
                               dram_power_estimate, integrate_power)
from repro_torch.core.fitting import FitResult, f_curve, fit_cost_curve, minimize_fit
from repro_torch.core.policy import BALANCED, ENERGY_LEAN, LATENCY_LEAN, QoSPolicy
from repro_torch.core.powermodel import (DEVICES, H100_SXM, RTX_3080,
                                         RTX_3090, TPU_V5E, DeviceSpec,
                                         PowerCappedDevice, StepEstimate,
                                         WorkloadProfile)
from repro_torch.core.powershift import (ClusterNode, NodeAllocation, ShiftPlan,
                                   allocate_power, detect_stragglers)
from repro_torch.core.profiler import (DEFAULT_CAP_GRID, CapDecision, CapProfiler,
                                 RecordingBackend, decide_cap,
                                 interp_measurements)
from repro_torch.core.service import FrostService, ModelCatalogue
from repro_torch.core.simplex import SimplexResult, minimize_scalar_on_interval, nelder_mead

__all__ = [
    "CapMeasurement", "edp", "normalized_costs",
    "EnergyLedger", "EnergyReport", "PowerSample", "dram_power_estimate",
    "integrate_power",
    "FitResult", "f_curve", "fit_cost_curve", "minimize_fit",
    "QoSPolicy", "ENERGY_LEAN", "BALANCED", "LATENCY_LEAN",
    "DeviceSpec", "PowerCappedDevice", "StepEstimate", "WorkloadProfile",
    "DEVICES", "H100_SXM", "RTX_3080", "RTX_3090", "TPU_V5E",
    "ClusterNode", "NodeAllocation", "ShiftPlan", "allocate_power",
    "detect_stragglers",
    "CapDecision", "CapProfiler", "RecordingBackend", "DEFAULT_CAP_GRID",
    "decide_cap", "interp_measurements",
    "FrostService", "ModelCatalogue",
    "SimplexResult", "nelder_mead", "minimize_scalar_on_interval",
]
