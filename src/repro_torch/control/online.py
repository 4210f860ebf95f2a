"""Online cap profiler — FROST without dedicated probe windows.

The batch ``CapProfiler`` freezes the pipeline for 8 x ~30 s probes.  Under
production traffic (ROADMAP north star) that is a service interruption, so
this profiler *amortises* the probes across live work instead:

  * every ``StepDone`` event is attributed to the cap that was in force
    (bucketed onto the probe grid), accumulating decayed (energy, delay,
    samples) sums per cap — the same ``CapMeasurement`` shape the batch
    profiler produces, built incrementally from streamed telemetry;
  * an initial *sweep* visits each legal grid cap for ``steps_per_probe``
    live steps (a few seconds of traffic, not 4 minutes of probe windows),
    then fits F(x) (paper Eqs 6-7) and applies the ED^mP-optimal cap via
    :func:`repro_torch.core.profiler.decide_cap` — the identical decision rule;
  * afterwards it *holds* the chosen cap, refreshing ONE grid cap per
    ``hold_steps`` window (round-robin) so the fit tracks the workload with
    bounded overhead — the 8-point probe cost is spread over 8 hold cycles;
  * drift detection runs continuously: when the observed time/sample departs
    from the fit's expectation by more than ``drift_threshold``, it publishes
    ``DriftDetected`` and restarts the sweep (workload changed under us);
  * warm starts: pass a cached ``CapDecision`` (e.g. from a previous batch
    profile or a prior run) to skip the sweep entirely and go straight to
    hold — probes then only ever run as amortised refreshes.

Everything is driven by bus events; the profiler never blocks the pipeline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

from repro_torch.control.bus import EventBus
from repro_torch.control.events import (CapApplied, DriftDetected, FitUpdated,
                                  PolicyUpdated, PowerSampled, StepDone)
from repro_torch.core.edp import CapMeasurement
from repro_torch.core.policy import QoSPolicy
from repro_torch.core.profiler import (DEFAULT_CAP_GRID, CapBackend, CapDecision,
                                 interp_measurements, decide_cap)


@dataclasses.dataclass
class _CapBucket:
    """Decayed (energy, delay, samples) sums for one grid cap."""
    energy_j: float = 0.0
    delay_s: float = 0.0
    samples: float = 0.0

    def add(self, energy_j: float, delay_s: float, samples: float,
            decay: float) -> None:
        self.energy_j = self.energy_j * decay + energy_j
        self.delay_s = self.delay_s * decay + delay_s
        self.samples = self.samples * decay + samples

    def measurement(self, cap: float) -> CapMeasurement:
        return CapMeasurement(cap=cap, energy_j=self.energy_j,
                              delay_s=self.delay_s, samples=self.samples)


class OnlineCapProfiler:
    """Event-driven profiler: subscribe, stream, retune.

    Modes: ``sweep`` (initial grid coverage) -> ``hold`` (optimal cap in
    force) -> ``refresh`` (one amortised probe cap) -> ``hold`` -> ...
    plus ``waiting`` (no energy telemetry: parked at the highest legal cap
    until usable samples arrive — never throttle on blind data).
    """

    def __init__(
        self,
        bus: EventBus,
        backend: CapBackend,
        *,
        policy: QoSPolicy | None = None,
        node_id: str = "node-0",
        model_id: str = "",
        cap_grid: Sequence[float] = DEFAULT_CAP_GRID,
        steps_per_probe: int = 2,
        hold_steps: int = 32,
        decay: float = 0.6,
        drift_threshold: float = 0.15,
        drift_min_steps: int = 3,
        switch_margin: float = 0.02,
        min_refresh_interval_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        warm_start: CapDecision | None = None,
        on_decision: Callable[[CapDecision], None] | None = None,
    ) -> None:
        self.bus = bus
        self.backend = backend
        self.policy = policy or QoSPolicy()
        self.node_id = node_id
        self.model_id = model_id
        self.steps_per_probe = int(steps_per_probe)
        self.hold_steps = int(hold_steps)
        self.decay = float(decay)
        self.drift_threshold = float(drift_threshold)
        self.drift_min_steps = int(drift_min_steps)
        self.switch_margin = float(switch_margin)
        self.min_refresh_interval_s = float(min_refresh_interval_s)
        self._clock = clock
        self._last_refit_t = -float("inf")
        self.on_decision = on_decision

        self._full_grid = tuple(sorted(float(c) for c in cap_grid))
        self._grid = self._legal_grid()
        self._buckets: dict[float, _CapBucket] = {}
        self.decision: CapDecision | None = None
        self.mode = "sweep"
        self.n_steps = 0
        self.n_refits = 0
        self.n_cap_changes = 0
        self._probe_idx = 0
        self._refresh_idx = 0
        self._steps_in_state = 0
        self._last_watts = 0.0
        self._no_energy_steps = 0
        self._obs_time_ewma: float | None = None
        self._obs_count = 0
        self._obs_cap: float | None = None   # cap the EWMA was observed under
        self._expected_cache: dict[float, float] = {}   # cap -> time/sample

        self._unsubs = [
            bus.subscribe(StepDone, self._on_step),
            bus.subscribe(PowerSampled, self._on_power),
            bus.subscribe(PolicyUpdated, self._on_policy),
        ]

        if warm_start is not None and len(warm_start.measurements) >= 3:
            for m in warm_start.measurements:
                self._bucket(m.cap).add(m.energy_j, m.delay_s, m.samples, 0.0)
            self.decision = warm_start
            self.mode = "hold"
            self._apply(warm_start.cap, "decision")
        elif self._grid:
            self._apply(self._grid[0], "probe")

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        for u in self._unsubs:
            u()

    def _legal_grid(self) -> tuple[float, ...]:
        return tuple(c for c in self._full_grid
                     if self.policy.min_cap <= c <= self.policy.max_cap)

    def _bucket(self, cap: float) -> _CapBucket:
        key = self._nearest_grid_cap(cap)
        return self._buckets.setdefault(key, _CapBucket())

    def _nearest_grid_cap(self, cap: float) -> float:
        grid = self._grid or self._full_grid
        return float(min(grid, key=lambda c: abs(c - cap)))

    def _apply(self, cap: float, reason: str) -> None:
        if abs(self.backend.current_cap() - cap) > 1e-9:
            self.n_cap_changes += 1
        self.backend.apply_cap(cap)
        self.bus.publish(CapApplied(node_id=self.node_id, cap=float(cap),
                                    reason=reason, source="online-profiler",
                                    model_id=self.model_id))

    # -- event handlers -------------------------------------------------------
    def _on_power(self, ev: PowerSampled) -> None:
        if ev.node_id == self.node_id:
            self._last_watts = ev.total_w

    def _on_policy(self, ev: PolicyUpdated) -> None:
        if ev.node_id != self.node_id:
            return
        self.policy = ev.policy
        self._grid = self._legal_grid()
        # Cost exponents changed, but the (energy, delay) physics did not:
        # refit from the accumulated buckets when we can, otherwise resweep.
        # The cost landscape's SHAPE changed with the exponent, so the old
        # coefficients are not a trustworthy seed — full multi-start here.
        self._buckets = {c: b for c, b in self._buckets.items()
                         if self.policy.min_cap <= c <= self.policy.max_cap}
        if not self._try_refit(reason="policy", fresh=True):
            self._restart_sweep()

    def _on_step(self, ev: StepDone) -> None:
        if ev.node_id != self.node_id:
            return
        if self.model_id and ev.model_id and ev.model_id != self.model_id:
            return
        self.n_steps += 1
        cap = float(self.backend.current_cap())
        energy = ev.energy_j if ev.energy_j > 0 else self._last_watts * ev.duration_s

        if energy <= 0:
            # No usable energy telemetry yet (no sampler attached, or its
            # first 0.1 Hz sample hasn't landed).  Never probe-throttle the
            # pipeline on blind data: after a few such steps park at the
            # highest legal cap and wait for telemetry.
            self._no_energy_steps += 1
            if (self.mode in ("sweep", "refresh")
                    and self._no_energy_steps >= 3 and self._grid):
                self.mode = "waiting"
                self._apply(self._grid[-1], "fallback")
            elif self.mode == "hold":
                self._advance_hold(ev)       # drift check is time-based
            return
        self._no_energy_steps = 0
        if self.mode == "waiting":           # telemetry is back: start over
            # This step ran at the parked cap — its data is valid for that
            # bucket, but it must not count toward the fresh grid[0] probe
            # window (with steps_per_probe=1 it would skip grid[0] entirely).
            self._bucket(cap).add(energy, ev.duration_s, max(ev.samples, 1),
                                  self.decay)
            self._restart_sweep()
            return

        self._steps_in_state += 1
        self._bucket(cap).add(energy, ev.duration_s, max(ev.samples, 1),
                              self.decay)

        if self.mode == "sweep":
            self._advance_sweep()
        elif self.mode == "refresh":
            self._advance_refresh()
        else:
            self._advance_hold(ev)

    # -- state machine --------------------------------------------------------
    def _advance_sweep(self) -> None:
        if self._steps_in_state < self.steps_per_probe:
            return
        self._steps_in_state = 0
        self._probe_idx += 1
        if self._probe_idx < len(self._grid):
            self._apply(self._grid[self._probe_idx], "probe")
            return
        if not self._try_refit(reason="sweep"):
            self._restart_sweep()          # degenerate data; probe again
            return
        self.mode = "hold"

    def _advance_refresh(self) -> None:
        if self._steps_in_state < self.steps_per_probe:
            return
        self._steps_in_state = 0
        refitted = self._try_refit(reason="refresh")   # applies the new cap
        self.mode = "hold"
        if not refitted and self.decision is not None:
            self._apply(self.decision.cap, "decision") # leave the probe cap

    def _advance_hold(self, ev: StepDone) -> None:
        self._check_drift(ev)
        if self.mode != "hold":            # drift restarted the sweep
            return
        # Refresh cadence is bounded in BOTH steps and wall time: a fast step
        # loop must not refit (simplex over 7 coefficients) every few ms.
        if (self._steps_in_state >= self.hold_steps and self._grid
                and self._clock() - self._last_refit_t
                >= self.min_refresh_interval_s):
            # Amortised refresh: revisit ONE grid cap, round-robin.
            self._steps_in_state = 0
            self._refresh_idx = (self._refresh_idx + 1) % len(self._grid)
            self.mode = "refresh"
            self._apply(self._grid[self._refresh_idx], "probe")

    def _check_drift(self, ev: StepDone) -> None:
        if self.decision is None:
            return
        cap = float(self.backend.current_cap())
        if self._obs_cap is None or abs(cap - self._obs_cap) > 1e-9:
            # The enforced cap changed under us (e.g. a coordinator
            # rebalance): old-cap step times must not blend into the EWMA or
            # a legitimate cap change reads as workload drift.
            self._obs_cap = cap
            self._obs_time_ewma = None
            self._obs_count = 0
        observed = ev.duration_s / max(ev.samples, 1)
        if self._obs_time_ewma is None:
            self._obs_time_ewma = observed
        else:
            self._obs_time_ewma = 0.5 * self._obs_time_ewma + 0.5 * observed
        self._obs_count += 1
        if self._obs_count < self.drift_min_steps:
            return
        expected = self._expected_cache.get(cap)
        if expected is None:
            expected = interp_measurements(self.decision.measurements, cap)[1]
            self._expected_cache[cap] = expected
        if expected <= 0:
            return
        drift = abs(self._obs_time_ewma - expected) / expected
        if drift > self.drift_threshold:
            self.bus.publish(DriftDetected(
                node_id=self.node_id, model_id=self.model_id,
                drift=float(drift), expected_s=float(expected),
                observed_s=float(self._obs_time_ewma)))
            self._buckets.clear()
            self.decision = None
            self._restart_sweep()

    def _restart_sweep(self) -> None:
        self.mode = "sweep"
        self._probe_idx = 0
        self._steps_in_state = 0
        self._obs_time_ewma = None
        self._obs_count = 0
        if self._grid:
            self._apply(self._grid[0], "probe")

    def _cost_at(self, meas: Sequence[CapMeasurement], cap: float) -> float:
        """Measured (probe-interpolated) ED^mP cost at ``cap``."""
        e, t = interp_measurements(meas, cap)
        return e * t ** self.policy.edp_exponent

    def _delay_ok(self, meas: Sequence[CapMeasurement], cap: float) -> bool:
        if self.policy.max_delay_increase is None:
            return True
        ref = max(meas, key=lambda r: r.cap)
        _, t = interp_measurements(meas, cap)
        return t / ref.time_per_sample - 1.0 <= self.policy.max_delay_increase

    def _choose_cap(self, candidate: CapDecision,
                    meas: Sequence[CapMeasurement]) -> float:
        """Robustify the fitted minimiser against two streaming failure modes:

        the MSE of the 7-coefficient fit is dominated by the deep-cap cost
        blow-up, so a fit can pass the 5% gate yet miss the shallow bowl near
        100% and park the minimiser on the boundary.  Guard 1: if the best
        *measured* probe beats the fitted cap's measured cost by more than
        ``switch_margin``, trust the probe.  Guard 2 (hysteresis): only move
        off the currently-applied decision cap when the winner improves on it
        by more than ``switch_margin`` — otherwise refits on slightly
        perturbed buckets flap the cap for no energy win.  Genuine workload
        changes bypass the hysteresis via drift detection (full resweep)."""
        chosen = candidate.cap
        legal = [r for r in meas if self._delay_ok(meas, r.cap)]
        if legal:
            best_probe = min(legal, key=lambda r: r.cost(self.policy.edp_exponent))
            if (best_probe.cost(self.policy.edp_exponent)
                    < self._cost_at(meas, chosen) * (1.0 - self.switch_margin)):
                chosen = best_probe.cap
        # Hysteresis only ever defends a cap that is still LEGAL: a policy
        # update narrowing the window must not let the old cap persist.
        if self.decision is not None:
            held = self.decision.cap
            if (self.policy.min_cap <= held <= self.policy.max_cap
                    and self._delay_ok(meas, held)
                    and self._cost_at(meas, chosen)
                    > self._cost_at(meas, held) * (1.0 - self.switch_margin)):
                chosen = held
        return float(chosen)

    def _try_refit(self, reason: str, fresh: bool = False) -> bool:
        meas = [b.measurement(c) for c, b in sorted(self._buckets.items())
                if b.samples > 0 and b.delay_s > 0 and b.energy_j > 0]
        if len(meas) < 3:
            return False
        # Incremental refits (the data moved slightly) warm-start the simplex
        # from the previous coefficients and skip the multi-start sweep — an
        # order of magnitude cheaper per refit.  ``fresh`` forces the full
        # multi-start (policy changes reshape the cost landscape), and a fit
        # that failed the 5% gate is never a seed — warm-starting from it
        # could pin every later refit in the same rejected basin.
        x0 = None if (fresh or self.decision is None
                      or not self.decision.fit.accepted) \
            else self.decision.fit.coef
        try:
            decision = decide_cap(meas, self.policy, fit_x0=x0,
                                  fit_multi_start=x0 is None)
        except ValueError:
            return False
        cap = self._choose_cap(decision, meas)
        if abs(cap - decision.cap) > 1e-12:
            decision = dataclasses.replace(decision, cap=cap)
        self.n_refits += 1
        self._last_refit_t = self._clock()
        self._expected_cache.clear()
        changed = (self.decision is None
                   or abs(decision.cap - self.decision.cap) > 1e-9)
        self.decision = decision
        self._obs_time_ewma = None
        self._obs_count = 0
        self.bus.publish(FitUpdated(node_id=self.node_id,
                                    model_id=self.model_id,
                                    fit=decision.fit, cap=decision.cap,
                                    n_probes=len(meas)))
        self._apply(decision.cap, "decision")
        if changed and self.on_decision is not None:
            self.on_decision(decision)
        return True

    # -- introspection --------------------------------------------------------
    @property
    def measurements(self) -> list[CapMeasurement]:
        return [b.measurement(c) for c, b in sorted(self._buckets.items())
                if b.samples > 0]

    def expected_time_per_sample(self, cap: float | None = None) -> float:
        if self.decision is None:
            return float("nan")
        cap = self.backend.current_cap() if cap is None else cap
        return interp_measurements(self.decision.measurements, cap)[1]
