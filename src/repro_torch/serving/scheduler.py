"""Request queue + slot scheduler for the continuous-batching engine.

The engine owns a fixed grid of ``n_slots`` decode slots (the jitted loop's
batch dimension never changes — one AOT executable for every occupancy
pattern).  The scheduler's job is to map a stream of ragged requests onto
those slots: FIFO admission as slots and KV pages free up (with a bounded
*skip-ahead* window so a page-starved head request cannot indefinitely
starve smaller requests behind it), an optional *admission hook*
(energy-aware policies plug in here), and bookkeeping of which slot runs
which request.

Two admission shapes share this class:

  * **reserve** (``lazy=False``) — a request is admitted only when pages
    cover its whole context (prompt + generation budget); nothing can run
    out mid-decode.  This is the pre-preemption engine, kept as the
    baseline.
  * **lazy** (``lazy=True``) — admission covers only the prompt; decode
    pages are allocated chunk-by-chunk by the engine (``PagedKVCache
    .ensure``), and when the pool runs dry the engine preempts the
    lowest-priority slot and re-queues its request (generated tokens
    folded into the prompt, which the prefix cache then mostly restores).
    This replaces the old hard admission stall with graceful overcommit.

With ``prefix=True`` the page-fit check credits pages the prefix cache
already holds for the request's prompt (``can_admit_with_prefix``), so
shared-prompt traffic admits at higher concurrency for the same pool.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Callable

from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.request import Request


class RequestQueue:
    """Arrival-ordered queue with a virtual-step clock.  Supports pushing
    re-queued (preempted) requests mid-run and popping non-head entries
    for the bounded skip-ahead."""

    def __init__(self, requests: list[Request]):
        self._pending = sorted(requests,
                               key=lambda r: (r.arrival_step, r.rid))

    def __len__(self) -> int:
        return len(self._pending)

    def next_arrival(self) -> int | None:
        return self._pending[0].arrival_step if self._pending else None

    def peek_ready(self, now_step: int) -> Request | None:
        if self._pending and self._pending[0].arrival_step <= now_step:
            return self._pending[0]
        return None

    def ready(self, now_step: int):
        """(index, request) pairs that have arrived, in queue order."""
        for i, req in enumerate(self._pending):
            if req.arrival_step > now_step:
                break
            yield i, req

    def pop(self) -> Request:
        return self._pending.pop(0)

    def pop_at(self, index: int) -> Request:
        return self._pending.pop(index)

    def pending(self) -> list[Request]:
        """Queued requests in arrival order (snapshot/introspection)."""
        return list(self._pending)

    def push(self, request: Request) -> None:
        """Insert a (re-queued) request in arrival order."""
        keys = [(r.arrival_step, r.rid) for r in self._pending]
        self._pending.insert(
            bisect.bisect(keys, (request.arrival_step, request.rid)),
            request)


@dataclasses.dataclass
class SlotState:
    """A live request bound to a decode slot."""
    request: Request
    remaining: int                # decode-loop tokens still wanted
    next_token: object            # host-side (1,) or (1, n_cb) np token
    finished: bool = False
    seq: int = 0                  # admission order (preemption tie-break)
    tok_start: int = 0            # result-token index where this bind began


# admission hook: (request, n_active_after_admit) -> admit?  Policies that
# need device state (cap in force, power budget) close over it — see
# ``engine.EnergyAwareAdmission``.
AdmissionHook = Callable[[Request, int], bool]


class Scheduler:
    """Admits ragged requests into fixed decode slots, mid-stream.

    ``poll`` is called between chunks: it binds as many ready requests as
    slots, pages, and the admission hook allow.  Freeing (EOS / token
    budget / preemption) is driven by the engine at harvest time via
    ``finish``.
    """

    def __init__(self, n_slots: int, kv: PagedKVCache,
                 admission: AdmissionHook | None = None, *,
                 max_skip: int = 0, lazy: bool = False,
                 prefix: bool = False):
        self.n_slots = n_slots
        self.kv = kv
        self.admission = admission
        self.max_skip = int(max_skip)
        self.lazy = lazy
        self.prefix = prefix
        self.slots: list[SlotState | None] = [None] * n_slots
        self._free = deque(range(n_slots))
        self._seq = 0

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def _alloc_tokens(self, req: Request) -> int:
        # reserve mode: pages must cover every position a kept token
        # attends to — prompt + max_new - 1 (the last fed token's write).
        # lazy mode: the prompt only; the engine grows per chunk.
        if self.lazy:
            return req.prompt_len
        return req.prompt_len + req.max_new_tokens - 1

    def _fits(self, req: Request) -> bool:
        n = self._alloc_tokens(req)
        if self.prefix:
            return self.kv.can_admit_with_prefix(req.prompt, n)
        return self.kv.can_admit(n)

    def poll(self, queue: RequestQueue, now_step: int):
        """Admit ready requests into free slots; returns (slot, request,
        matched_len, copy_spec) tuples the engine must prefill-join this
        cycle (``matched_len``/``copy_spec`` are 0/None without prefix
        sharing).

        Admission is FIFO with a bounded skip-ahead: when the head cannot
        get pages, up to ``max_skip`` ready requests behind it are tried
        (smaller requests can use pages the head cannot) — but an
        admission-hook refusal still stops the poll cold, since the hook
        prices *occupancy* and would refuse every candidate alike."""
        joins = []
        while self._free:
            picked = None
            for tried, (idx, req) in enumerate(queue.ready(now_step)):
                if tried > self.max_skip:
                    break
                if self.admission is not None and \
                        not self.admission(req, self.n_active + 1):
                    break
                if self._fits(req):
                    picked = idx
                    break
            if picked is None:
                break
            req = queue.pop_at(picked)
            slot = self._free.popleft()
            matched, copy = 0, None
            if self.prefix:
                matched, copy = self.kv.admit_with_prefix(
                    slot, req.prompt, self._alloc_tokens(req))
            else:
                self.kv.admit(slot, self._alloc_tokens(req))
            self.slots[slot] = SlotState(request=req,
                                         remaining=req.max_new_tokens - 1,
                                         next_token=None, seq=self._seq)
            self._seq += 1
            joins.append((slot, req, matched, copy))
        return joins

    def victim(self) -> int | None:
        """The slot to preempt when pages run dry: lowest priority first,
        most-recently-admitted among ties (LIFO keeps the head of the
        line making progress).  The engine handles the case where the
        victim is the slot doing the asking (self-preempt or raise)."""
        cands = [(s.request.priority, -s.seq, i)
                 for i, s in enumerate(self.slots) if s is not None]
        if not cands:
            return None
        return min(cands)[2]

    def finish(self, slot: int) -> None:
        """Free the slot and its page holds (called at harvest on
        EOS/budget, and by the engine on preemption)."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not active")
        self.kv.release(slot)
        self.slots[slot] = None
        self._free.append(slot)
