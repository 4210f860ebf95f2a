"""In-process event bus — the spine of the FROST control plane.

Synchronous, typed publish/subscribe.  Handlers are registered against an
event *class* and receive every published event that ``isinstance``-matches
it (so a handler on ``Event`` sees everything).  Publishing is synchronous
and in-order: by the time ``publish`` returns, every matching handler has
run.  That makes the control loop deterministic and testable — and keeps
the overhead per step down to a dict lookup plus direct calls (benchmarked
in ``benchmarks/ctrl_overhead.py`` against the paper's 0.1 Hz sampler).

Thread-safety: ``PowerSampler`` publishes from its daemon thread while the
step loop publishes ``StepDone`` from the main thread, so subscription
tables are guarded by an RLock (re-entrant: handlers may publish follow-up
events from within a dispatch).

Handler errors are isolated: a failing subscriber is retried up to
``max_retries`` times with exponential backoff, then recorded in
``bus.errors`` AND ``bus.dead_letters`` — never breaking the pipeline step
that published the event (O-RAN reliability mandate — telemetry must not
take down serving).  Dead letters keep the event so a recovered consumer
can be replayed via ``redeliver_dead_letters`` — dropped/late telemetry
degrades the control loop's freshness, never its liveness.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Deque, Iterable, Type

from repro_torch.control.events import Event

Handler = Callable[[Event], None]


@dataclasses.dataclass
class DeadLetter:
    """One undeliverable event: every retry of ``handler`` failed."""
    event: Event
    handler: Handler
    attempts: int
    error: Exception
    t: float


class EventBus:
    def __init__(self, *, history: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 max_retries: int = 2, backoff_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self._lock = threading.RLock()
        self._subs: dict[Type[Event], list[Handler]] = {}
        self._clock = clock
        # Delivery is at-most-(1 + max_retries) attempts per handler; the
        # default backoff of 0.0 keeps the synchronous fast path sleep-free
        # (a transiently-failing handler usually recovers on the immediate
        # retry); set backoff_s > 0 for true exponential spacing.
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self._sleep = sleep
        self.history: Deque[tuple[float, Event]] = collections.deque(maxlen=history)
        # Bounded like history: a persistently-failing subscriber on a
        # multi-day run must not grow memory linearly with steps.
        self.errors: Deque[tuple[Event, Handler, Exception]] = \
            collections.deque(maxlen=max(history, 64))
        self.dead_letters: Deque[DeadLetter] = \
            collections.deque(maxlen=max(history, 64))
        self.n_published = 0
        self.n_delivered = 0
        self.n_errors = 0
        self.n_retries = 0
        self.n_dead_lettered = 0

    # -- subscription ---------------------------------------------------------
    def subscribe(self, event_type: Type[Event], handler: Handler) -> Callable[[], None]:
        """Register ``handler`` for events matching ``event_type``; returns an
        unsubscribe callable."""
        with self._lock:
            self._subs.setdefault(event_type, []).append(handler)

        def unsubscribe() -> None:
            with self._lock:
                handlers = self._subs.get(event_type, [])
                if handler in handlers:
                    handlers.remove(handler)

        return unsubscribe

    def subscribers(self, event_type: Type[Event]) -> int:
        with self._lock:
            return len(self._subs.get(event_type, []))

    # -- publication ----------------------------------------------------------
    def publish(self, event: Event) -> int:
        """Dispatch ``event`` to every matching handler; returns the number of
        handlers that ran (exceptions included — see ``errors``)."""
        with self._lock:
            matched = [h for etype, handlers in self._subs.items()
                       if isinstance(event, etype) for h in handlers]
            self.history.append((self._clock(), event))
            self.n_published += 1
        delivered = 0
        for handler in matched:
            self._deliver(event, handler)
            delivered += 1
        with self._lock:
            self.n_delivered += delivered
        return delivered

    def _deliver(self, event: Event, handler: Handler) -> bool:
        """One handler, up to ``1 + max_retries`` attempts with exponential
        backoff.  On exhaustion the event is dead-lettered (one ``errors``
        record per *final* failure, not per attempt)."""
        attempts = 1 + max(0, self.max_retries)
        delay = self.backoff_s
        for attempt in range(1, attempts + 1):
            try:
                handler(event)
                return True
            except Exception as exc:            # noqa: BLE001 — isolation
                last = exc
                if attempt < attempts:
                    with self._lock:
                        self.n_retries += 1
                    if delay > 0.0:
                        self._sleep(delay)
                        delay *= 2.0
        with self._lock:                        # publishers race on errors
            self.errors.append((event, handler, last))
            self.n_errors += 1
            self.dead_letters.append(DeadLetter(
                event=event, handler=handler, attempts=attempts,
                error=last, t=self._clock()))
            self.n_dead_lettered += 1
        return False

    def tap(self, event_type: Type[Event]) -> list[Event]:
        """Lossless capture: returns a list that every future matching event
        is appended to (``history`` is a bounded ring — use this when an
        exact log matters, e.g. end-of-run cap-command accounting)."""
        captured: list[Event] = []
        self.subscribe(event_type, captured.append)
        return captured

    # -- introspection --------------------------------------------------------
    def events_of(self, event_type: Type[Event]) -> list[Event]:
        """Matching events still in the history ring (newest last)."""
        with self._lock:
            return [e for _, e in self.history if isinstance(e, event_type)]

    def drain_errors(self) -> list[tuple[Event, Handler, Exception]]:
        out = list(self.errors)
        self.errors.clear()
        return out

    def redeliver_dead_letters(self) -> int:
        """Replay dead letters to their original handlers (e.g. after a
        consumer recovered).  Returns the number redelivered successfully;
        still-failing letters are re-dead-lettered by ``_deliver``."""
        with self._lock:
            letters = list(self.dead_letters)
            self.dead_letters.clear()
        return sum(self._deliver(dl.event, dl.handler) for dl in letters)


def pipe(bus_from: EventBus, bus_to: EventBus,
         event_types: Iterable[Type[Event]] = (Event,)) -> list[Callable[[], None]]:
    """Forward selected event types between buses (e.g. per-node buses into a
    cluster coordinator bus).  Returns the unsubscribe callables."""
    return [bus_from.subscribe(t, bus_to.publish) for t in event_types]
