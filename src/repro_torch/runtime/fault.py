"""Fault tolerance + elasticity: the host-side supervisor.

At 1000+ nodes, mean-time-between-failures drops below a training day, so
the framework assumes failure is routine, not exceptional:

  * heartbeat monitor — every worker (simulated in-container; process/pod in
    deployment) reports per-step liveness + step latency,
  * checkpoint/restart — atomic resumable checkpoints (repro_torch.checkpoint),
    restore-on-failure with at-most-one-step loss of work,
  * elastic re-mesh — on permanent node loss, the supervisor rebuilds the
    mesh with a smaller DP extent and reshards the restored checkpoint (the
    param shardings are pure functions of (cfg, mesh), so resharding is
    just loading with the new rules),
  * straggler mitigation — per-node step latencies feed the FROST
    power-shift allocator (core/powershift): a thermally-derated node gets
    a *larger* power budget (or its neighbours get capped down to match) —
    the paper's power capping doubling as straggler control.

Everything here is host-side Python orchestration — testable on CPU,
hardware-agnostic by construction (the O-RAN portability argument).

Serving nodes get the same treatment via :class:`ServingSupervisor`:
``ServeEngine`` chunks emit heartbeats, missed heartbeats drive liveness
(-> preempt/requeue of the dead engine's slots through the restore path),
and chunk-wall inflation is folded into a derate estimate published as
``NodeDerated`` on the control bus — the FROST power-shift loop fed from
serving telemetry (see docs/fault_tolerance.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

from repro_torch.control.events import NodeDerated
from repro_torch.core.powershift import ClusterNode, allocate_power, detect_stragglers


@dataclasses.dataclass
class WorkerState:
    node_id: str
    last_heartbeat: float = 0.0
    step: int = 0
    step_latency_s: float = 0.0
    alive: bool = True
    derate: float = 1.0            # thermal/silicon derate (1 = healthy)


@dataclasses.dataclass
class SupervisorConfig:
    heartbeat_timeout_s: float = 10.0
    checkpoint_every: int = 50
    straggler_threshold: float = 1.15   # >15% above median step time
    max_restarts: int = 8
    elastic: bool = True                # drop dead DP ranks instead of stalling


class Supervisor:
    """Drives a training loop with failure injection + recovery.

    The ``step_fn(state, batch) -> (state, metrics)`` and checkpoint hooks
    are injected, so the same supervisor drives the in-container simulated
    cluster and a real multi-host launch.
    """

    def __init__(self, cfg: SupervisorConfig, *,
                 save_fn: Callable[[Any, int], None],
                 restore_fn: Callable[[], tuple[Any, int]],
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = cfg
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.clock = clock
        self.workers: dict[str, WorkerState] = {}
        self.restarts = 0
        self.events: list[dict] = []
        self._restored: tuple[Any, int] | None = None

    # -- worker lifecycle -----------------------------------------------------
    def register(self, node_id: str, derate: float = 1.0):
        self.workers[node_id] = WorkerState(node_id, self.clock(),
                                            derate=derate)

    def heartbeat(self, node_id: str, step: int, latency_s: float):
        w = self.workers.get(node_id)
        if w is None:
            # a worker reporting before registration is a join (elastic
            # scale-up), not a silent KeyError: register it and log the
            # event so the audit trail shows where it appeared
            self.register(node_id)
            w = self.workers[node_id]
            self.events.append({"t": self.clock(), "event": "auto_register",
                                "node": node_id})
        w.last_heartbeat = self.clock()
        w.step = step
        w.step_latency_s = latency_s

    def check_liveness(self) -> list[str]:
        """Returns newly-dead node ids."""
        now = self.clock()
        dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_heartbeat > self.cfg.heartbeat_timeout_s:
                w.alive = False
                dead.append(w.node_id)
                self.events.append({"t": now, "event": "node_dead",
                                    "node": w.node_id})
        return dead

    # -- failure handling -------------------------------------------------------
    def handle_failure(self, dead: list[str]) -> dict:
        """Decide the recovery action for the given dead nodes.  Restores
        the checkpoint exactly ONCE, stashing the state for the caller
        (``run()`` threads it through via ``take_restored`` instead of
        paying a second restore)."""
        self.restarts += 1
        if self.restarts > self.cfg.max_restarts:
            return {"action": "abort", "reason": "restart budget exhausted"}
        state, restore_step = self.restore_fn()
        self._restored = (state, restore_step)
        alive = [w for w in self.workers.values() if w.alive]
        if self.cfg.elastic and alive:
            # shrink the DP extent to the largest power of two that fits
            new_dp = 1 << (len(alive).bit_length() - 1)
            return {"action": "remesh", "new_dp": new_dp,
                    "restore_step": restore_step}
        return {"action": "restart", "restore_step": restore_step}

    def take_restored(self) -> tuple[Any, int]:
        """The (state, step) the last ``handle_failure`` restored; falls
        back to one restore if called without a stashed result (direct
        ``handle_failure`` users that discarded it)."""
        restored, self._restored = self._restored, None
        if restored is None:
            restored = self.restore_fn()
        return restored

    # -- stragglers -----------------------------------------------------------
    def straggler_report(self):
        nodes = [w.node_id for w in self.workers.values()
                 if w.alive and w.step_latency_s]
        lat = [self.workers[n].step_latency_s for n in nodes]
        if len(lat) < 2:
            return [], {}
        idx = detect_stragglers(lat, threshold=self.cfg.straggler_threshold)
        return [nodes[i] for i in idx], dict(zip(nodes, lat))

    def rebalance_power(self, nodes: list[ClusterNode], budget_w: float):
        """FROST-as-straggler-mitigation: re-split the global power budget
        so derated nodes stop dragging the DP step time."""
        plan = allocate_power(nodes, budget_w)
        self.events.append({"t": self.clock(), "event": "power_rebalance",
                            "plan": {a.node_id: a.cap for a in plan.allocations}})
        return plan

    # -- main loop ------------------------------------------------------------
    def run(self, step_fn, state, batches, *, start_step: int = 0,
            inject_failure_at: dict[int, str] | None = None) -> tuple[Any, dict]:
        """Run to completion with checkpoint/restart.

        ``inject_failure_at``: {step: node_id} — marks the node dead at that
        step (tests + chaos drills).
        """
        step = start_step
        inject = dict(inject_failure_at or {})
        history = []
        it = iter(batches)
        while True:
            try:
                batch = next(it)
            except StopIteration:
                break
            if step in inject:
                w = self.workers.get(inject.pop(step))   # one-shot fault
                if w:
                    # the node goes SILENT (stalled heartbeat) — liveness
                    # has to notice, exactly as a real hang would present
                    w.last_heartbeat = -1e9
            dead = self.check_liveness()
            dead += [w.node_id for w in self.workers.values()
                     if not w.alive and w.node_id not in dead]
            if dead:
                decision = self.handle_failure(dead)
                self.events.append({"t": self.clock(), "event": "recovery",
                                    **decision})
                if decision["action"] == "abort":
                    break
                state, step = self.take_restored()   # restored ONCE, above
                for d in dead:                      # node replaced / dropped
                    self.workers[d].alive = True
                    self.workers[d].last_heartbeat = self.clock()
                continue
            t0 = self.clock()
            state, metrics = step_fn(state, batch)
            latency = self.clock() - t0
            for w in self.workers.values():
                self.heartbeat(w.node_id, step, latency / max(w.derate, 1e-3))
            step += 1
            history.append({"step": step, **{k: float(v)
                                             for k, v in metrics.items()}})
            if step % self.cfg.checkpoint_every == 0:
                self.save_fn(state, step)
        return state, {"history": history, "events": self.events,
                       "final_step": step, "restarts": self.restarts}


class ServingSupervisor(Supervisor):
    """Supervisor-for-serving: liveness + derate inference for a
    ``ServeEngine`` node.

    Wiring: pass ``on_heartbeat`` as the engine's heartbeat hook — every
    decode chunk reports ``(clock_step, chunk_wall_s)``.  The first chunks
    calibrate a healthy-wall baseline (or pass ``baseline_wall_s``); after
    that, EWMA-filtered wall inflation becomes a thermal/silicon derate
    estimate, published as :class:`NodeDerated` on the control bus whenever
    it moves by ``publish_delta`` — the serving half of the FROST
    straggler-mitigation loop (``ClusterCoordinator`` folds it into its
    next power rebalance).  The launcher's outer loop calls :meth:`tick`;
    a missed heartbeat window fires ``on_dead(node_id)``, whose handler
    restores the engine and requeues the dead node's in-flight requests
    (``ServeEngine.restore``)."""

    def __init__(self, cfg: SupervisorConfig | None = None, *,
                 node_id: str = "serve-0", bus=None,
                 baseline_wall_s: float | None = None, ewma: float = 0.5,
                 min_derate: float = 0.2, publish_delta: float = 0.05,
                 on_dead: Callable[[str], None] | None = None,
                 save_fn=None, restore_fn=None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(cfg or SupervisorConfig(),
                         save_fn=save_fn or (lambda state, step: None),
                         restore_fn=restore_fn or (lambda: (None, 0)),
                         clock=clock)
        self.node_id = node_id
        self.bus = bus
        self.on_dead = on_dead
        self._baseline = baseline_wall_s
        self._ewma = float(ewma)
        self.min_derate = float(min_derate)
        self.publish_delta = float(publish_delta)
        self._wall_ewma: float | None = None
        self._published = 1.0
        self.n_derates_published = 0
        self.register(node_id)

    def on_heartbeat(self, step: int, wall_s: float) -> None:
        """ServeEngine heartbeat hook: records liveness, then turns chunk
        wall inflation into a derate estimate."""
        self.heartbeat(self.node_id, step, wall_s)
        if wall_s <= 0.0:
            return
        self._wall_ewma = wall_s if self._wall_ewma is None \
            else self._ewma * self._wall_ewma + (1 - self._ewma) * wall_s
        if self._baseline is None:
            # first reading calibrates "healthy" — a pre-derated engine
            # should pass an explicit baseline instead
            self._baseline = self._wall_ewma
            return
        derate = min(1.0, max(self.min_derate,
                              self._baseline / self._wall_ewma))
        self.workers[self.node_id].derate = derate
        if self.bus is not None \
                and abs(derate - self._published) >= self.publish_delta:
            self.bus.publish(NodeDerated(node_id=self.node_id,
                                         derate=derate,
                                         source="serving-supervisor"))
            self._published = derate
            self.n_derates_published += 1

    def tick(self) -> list[str]:
        """Periodic liveness sweep (launcher outer loop / tests): newly
        dead nodes fire ``on_dead`` so their slots get requeued."""
        dead = self.check_liveness()
        for node_id in dead:
            if self.on_dead is not None:
                self.on_dead(node_id)
        return dead
