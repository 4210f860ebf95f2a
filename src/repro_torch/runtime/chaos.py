"""Deterministic chaos injection for the serving stack.

FROST's target is an always-on RAN edge: the energy-control loop has to
keep serving through thermal derates, cap emergencies, and node churn —
not just minimise J/token on a clean run.  This module supplies the
*drill sergeant*: a seeded :class:`FaultInjector` that schedules faults on
the engine's decode-step clock, so every chaos run is reproducible and a
failing CI drill replays exactly.

Fault kinds (``FaultEvent.kind``):

  * ``slot_crash``     — one decode slot dies; its request must be
                         preempted/requeued with zero token loss,
  * ``engine_crash``   — the whole engine process dies mid-chunk; recovery
                         restores the last snapshot and replays,
  * ``page_corrupt``   — poison the paged-KV host metadata (refcount
                         inflation / free-list duplicate / stale trie page);
                         ``PagedKVCache.verify_invariants`` must catch and
                         quarantine it,
  * ``bus_drop`` / ``bus_delay`` — telemetry events vanish or arrive late
                         (exercises the bus's retry + dead-letter path),
  * ``stall``          — the engine misses a heartbeat window; the serving
                         supervisor must notice via liveness,
  * ``derate``         — thermal/silicon derate window (``arg`` = derate
                         fraction, ``duration`` = steps),
  * ``emergency_cap``  — site power emergency (``arg`` = cap fraction,
                         ``duration`` = steps); the engine degrades instead
                         of violating the cap.

This module deliberately imports nothing from ``repro_torch.serving`` /
``repro_torch.control`` at module level — the engine imports *us*, and the
injector stays usable from tests and benchmarks without the serving stack.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FAULT_KINDS = ("slot_crash", "engine_crash", "page_corrupt", "bus_drop",
               "bus_delay", "stall", "derate", "emergency_cap")


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault on the decode-step clock."""
    kind: str
    step: int
    duration: int = 0      # steps the condition persists (derate windows)
    arg: float = 0.0       # kind-specific: slot index / derate / cap fraction
    fired: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")


class FaultInjector:
    """Seeded fault schedule polled once per engine decode step.

    The injector is *passive*: the engine (or test harness) calls
    :meth:`poll` with its current step and applies whatever comes due.
    Each event fires exactly once — a restored engine re-attaching the
    same injector does not replay already-fired faults (the crash it just
    recovered from must not recur on resume).
    """

    def __init__(self, events=(), *, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.events: list[FaultEvent] = sorted(events, key=lambda e: e.step)
        self.log: list[FaultEvent] = []
        self.n_injected = 0

    # -- construction --------------------------------------------------------
    def schedule(self, kind: str, step: int, *, duration: int = 0,
                 arg: float = 0.0) -> FaultEvent:
        ev = FaultEvent(kind=kind, step=int(step), duration=int(duration),
                        arg=float(arg))
        self.events.append(ev)
        self.events.sort(key=lambda e: e.step)
        return ev

    @classmethod
    def from_spec(cls, spec: str, *, seed: int = 0) -> "FaultInjector":
        """Parse ``"kind@step[:duration[:arg]]"`` comma-separated — the CLI
        wire format (e.g. ``"engine_crash@40,emergency_cap@10:8:0.5"``)."""
        inj = cls(seed=seed)
        for item in filter(None, (s.strip() for s in spec.split(","))):
            kind, _, rest = item.partition("@")
            if not rest:
                raise ValueError(f"fault spec {item!r}: expected kind@step")
            parts = rest.split(":")
            inj.schedule(kind, int(parts[0]),
                         duration=int(parts[1]) if len(parts) > 1 else 0,
                         arg=float(parts[2]) if len(parts) > 2 else 0.0)
        return inj

    # -- polling -------------------------------------------------------------
    def poll(self, step: int) -> list[FaultEvent]:
        """Faults due at or before ``step`` that have not fired yet; marks
        them fired (one-shot semantics survive engine restore)."""
        due = [e for e in self.events if not e.fired and e.step <= step]
        for e in due:
            e.fired = True
            self.log.append(e)
            self.n_injected += 1
        return due

    def pending(self) -> int:
        return sum(1 for e in self.events if not e.fired)


# -- paged-KV corruption ------------------------------------------------------
def corrupt_paged_kv(kv, rng: np.random.Generator) -> str | None:
    """Inject one detectable host-metadata corruption into a
    ``PagedKVCache`` — the kind a bit-flip / torn write would leave behind.
    Returns a description, or None if the pool state offers no target.

    Only *detectable* corruptions are injected (refcount inflation,
    free-list duplicate, stale trie page pointer): the point is to drill
    ``verify_invariants(repair=True)``, not to silently poison KV content.
    """
    candidates = []
    held = [p for p in range(kv.n_slots, kv.n_pages)
            if kv.refcount[p] > 0 and p not in kv.quarantined]
    if held:
        candidates.append("refcount")
    if kv.free:
        candidates.append("free_dup")
    trie_nodes = [n for n in _trie_nodes(kv) if n.page >= 0]
    if trie_nodes and kv.free:
        candidates.append("stale_trie")
    if not candidates:
        return None
    kind = candidates[int(rng.integers(len(candidates)))]
    if kind == "refcount":
        page = held[int(rng.integers(len(held)))]
        bump = int(rng.integers(1, 4))
        kv.refcount[page] += bump
        return f"refcount: page {page} inflated by {bump}"
    if kind == "free_dup":
        free = list(kv.free)
        page = free[int(rng.integers(len(free)))]
        kv.free.append(page)
        return f"free_dup: page {page} duplicated in free list"
    node = trie_nodes[int(rng.integers(len(trie_nodes)))]
    free = list(kv.free)
    stale = free[int(rng.integers(len(free)))]
    old = node.page
    node.page = stale
    return f"stale_trie: trie node page {old} -> freed page {stale}"


def _trie_nodes(kv):
    out, stack = [], [kv._root]
    while stack:
        node = stack.pop()
        if node is not kv._root:
            out.append(node)
        stack.extend(node.children.values())
    return out


# -- bus fault wrapper --------------------------------------------------------
class ChaosBus:
    """EventBus wrapper that drops or delays the next N published events.

    Models a lossy/laggy telemetry transport in front of the in-process
    bus: dropped events never reach subscribers; delayed events are held
    and delivered (in order) before the next undisturbed publish, or on an
    explicit :meth:`flush`.  Everything else proxies to the inner bus, so
    a ``ChaosBus`` drops into any ``bus=`` parameter.
    """

    def __init__(self, inner):
        self.inner = inner
        self._drop = 0
        self._delay = 0
        self._held: list = []
        self.n_dropped = 0
        self.n_delayed = 0

    def drop_next(self, n: int = 1) -> None:
        self._drop += int(n)

    def delay_next(self, n: int = 1) -> None:
        self._delay += int(n)

    def publish(self, event) -> int:
        if self._drop > 0:
            self._drop -= 1
            self.n_dropped += 1
            return 0
        if self._delay > 0:
            self._delay -= 1
            self.n_delayed += 1
            self._held.append(event)
            return 0
        delivered = self.flush()
        return delivered + self.inner.publish(event)

    def flush(self) -> int:
        """Deliver held (delayed) events in arrival order."""
        delivered = 0
        while self._held:
            delivered += self.inner.publish(self._held.pop(0))
        return delivered

    def __getattr__(self, name):
        return getattr(self.inner, name)
