"""Background power sampler — FROST runs *in parallel to* the ML pipeline
(paper Sec I) at 0.1 Hz default (Fig 3: lower rate ⇒ lower overhead than
CodeCarbon/Eco2AI's 1 Hz, at equal energy-trend fidelity).

When handed a control-plane bus, every sample is also published as a
``PowerSampled`` event (from the sampler's daemon thread — the bus is
thread-safe), feeding the online profiler and the cluster coordinator in
addition to the private ``EnergyLedger``.
"""
from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Callable

from repro_torch.control.events import PowerSampled
from repro_torch.core.energy import EnergyLedger, PowerSample
from repro_torch.telemetry.meters import Meter, StackedMeter

if TYPE_CHECKING:
    from repro_torch.control.bus import EventBus


class PowerSampler:
    """Samples meters on a daemon thread into an EnergyLedger (and onto the
    control-plane bus, when attached)."""

    def __init__(self, meters: dict[str, Meter], *, rate_hz: float = 0.1,
                 clock: Callable[[], float] = time.monotonic,
                 bus: "EventBus | None" = None, node_id: str = "node-0"):
        self.meters = meters
        self.period = 1.0 / rate_hz
        self.clock = clock
        self.ledger = EnergyLedger()
        self.bus = bus
        self.node_id = node_id
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.n_samples = 0

    def sample_once(self) -> PowerSample:
        s = PowerSample(
            t=self.clock(),
            cpu_w=self.meters.get("cpu", _ZERO).read_watts(),
            gpu_w=self.meters.get("gpu", _ZERO).read_watts(),
            dram_w=self.meters.get("dram", _ZERO).read_watts(),
        )
        self.ledger.record(s)
        self.n_samples += 1
        if self.bus is not None:
            self.bus.publish(PowerSampled(node_id=self.node_id, t=s.t,
                                          cpu_w=s.cpu_w, gpu_w=s.gpu_w,
                                          dram_w=s.dram_w))
        return s

    def __enter__(self):
        self._stop.clear()
        self.sample_once()                       # t=0 anchor

        def loop():
            while not self._stop.wait(self.period):
                self.sample_once()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join()
        self.sample_once()                       # closing anchor
        return False

    def capture_idle(self, duration_s: float, rate_hz: float = 2.0):
        """The paper's T_m idle window: record the idle trace once per host."""
        t_end = self.clock() + duration_s
        while self.clock() < t_end:
            self.ledger.record_idle(PowerSample(
                t=self.clock(),
                cpu_w=self.meters.get("cpu", _ZERO).read_watts(),
                gpu_w=self.meters.get("gpu", _ZERO).read_watts(),
                dram_w=self.meters.get("dram", _ZERO).read_watts(),
            ))
            time.sleep(1.0 / rate_hz)


class _Zero:
    name = "zero"

    def read_watts(self) -> float:
        return 0.0


_ZERO = _Zero()
