"""Power telemetry: meters + background sampler (paper Sec III-A)."""
from repro_torch.telemetry.meters import (AnalyticDeviceMeter, CpuProcessMeter,
                                    DramMeter, Meter, RaplMeter, StackedMeter)
from repro_torch.telemetry.sampler import PowerSampler

__all__ = ["Meter", "CpuProcessMeter", "RaplMeter", "DramMeter",
           "AnalyticDeviceMeter", "StackedMeter", "PowerSampler"]
