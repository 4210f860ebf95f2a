"""Request objects for the continuous-batching serving engine.

A request is one user's generation job: a ragged prompt plus a token
budget.  The engine clock is counted in *decode steps* (one fused-loop
iteration = one token position across every slot), so arrival times,
waits, and latencies are all expressed in steps — deterministic and
host-speed-independent — with wall-clock seconds recorded alongside.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Request:
    """One generation job entering the queue."""
    rid: int
    prompt: np.ndarray            # (L,) int32 — or (L, n_cb) multi-codebook
    max_new_tokens: int
    arrival_step: int = 0         # engine decode-step clock
    eos_id: int | None = None     # None: run to max_new_tokens
    priority: int = 0             # higher = preempted later (ties: FIFO)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class RequestResult:
    """Per-request accounting the engine fills in as the request moves
    queue -> slot -> finished."""
    rid: int
    prompt_len: int
    arrival_step: int
    max_new_tokens: int
    admit_step: int = -1          # prefill-on-join step (also first token)
    finish_step: int = -1
    finish_reason: str = ""       # "eos" | "max_new_tokens"
    slot: int = -1
    tokens: list = dataclasses.field(default_factory=list)
    energy_j: float = 0.0         # share of chunk energy, occupied-slots only
    admit_t: float = 0.0          # wall clock, engine-relative seconds
    finish_t: float = 0.0
    n_preemptions: int = 0        # times this request was evicted + requeued
    prefill_tokens_saved: int = 0  # prompt tokens restored from the prefix cache

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def wait_steps(self) -> int:
        """Queueing delay: arrival -> admission (prefill)."""
        return self.admit_step - self.arrival_step

    @property
    def latency_steps(self) -> int:
        """Arrival -> last token, in decode steps."""
        return self.finish_step - self.arrival_step

    @property
    def j_per_token(self) -> float:
        return self.energy_j / max(self.n_tokens, 1)
