"""Drafters for speculative decoding — the port of
``repro.runtime.speculate``.

A drafter proposes ``K`` candidate tokens per verify step; the target model
scores all ``K+1`` (carried token + drafts) in ONE KV-cache sweep
(``transformer.verify_step``) and keeps the longest matching prefix.

The host side (``init_state``, ``seed_row``, ``seed_request``,
``seed_batch``) is the JAX package's, on numpy state that the serving
engine mirrors per slot.  ``propose`` and ``observe`` are torch functions
on the state moved to the device (``{name: tensor}``): they read nothing
back to the host, so speculation adds no sync to the decode loop.

Built-ins:

  * ``NgramDrafter``  — prompt-lookup self-drafting: find the most recent
    earlier occurrence of the last committed token in the request's
    history and propose the tokens that followed it.
  * ``RepeatDrafter`` — proposes the last token K times (the degenerate
    baseline, and a stress test of the rejection path).
  * ``ReplayDrafter`` — replays a recorded stream; acceptance is 1.0 by
    construction iff verify and commit are exact.
"""
from __future__ import annotations

import numpy as np
import torch


class Drafter:
    """Deterministic drafter driving the speculative decode loop.  State is
    a dict of arrays with a leading batch dim: numpy on the host, torch
    tensors of the same shapes inside the loop."""

    spec_k: int

    # -- host side ----------------------------------------------------------
    def init_state(self, batch: int) -> dict[str, np.ndarray]:
        """Fresh per-batch state (numpy: the engine mutates rows on join)."""
        raise NotImplementedError

    def seed_row(self, state: dict[str, np.ndarray], row: int,
                 tokens) -> None:
        """Fold a token stream (prompt + first sampled token) into one row
        of a host-side state."""
        raise NotImplementedError

    def seed_request(self, state: dict[str, np.ndarray], row: int,
                     prompt, first) -> None:
        """Canonical per-request seeding: the prompt followed by the
        prefill-sampled first token."""
        self.seed_row(state, row, np.concatenate(
            [np.asarray(prompt).reshape(-1), np.asarray(first).reshape(-1)]))

    def seed_batch(self, state: dict[str, np.ndarray], prompts,
                   firsts) -> None:
        """``seed_request`` over every row of a fixed batch."""
        for b in range(len(prompts)):
            self.seed_request(state, b, prompts[b], firsts[b])

    # -- device side --------------------------------------------------------
    def propose(self, state, last: torch.Tensor) -> torch.Tensor:
        """(B,) last committed token -> (B, K) int32 draft tokens."""
        raise NotImplementedError

    def observe(self, state, block: torch.Tensor, count):
        """Fold the emitted tokens back into the state.  ``block`` is the
        (B, K+1) emitted block, ``count`` (broadcastable to (B,)) how many
        leading entries are real; returns the updated state."""
        raise NotImplementedError


def _count(count, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(count, dtype=like.dtype,
                           device=like.device).expand(like.shape)


class NgramDrafter(Drafter):
    """Prompt-lookup self-drafting over a per-request token history ring
    (token i of the stream at slot ``i % hist_len``).  With no earlier
    occurrence of the last token it degrades to repeating it."""

    def __init__(self, spec_k: int, hist_len: int = 128):
        if hist_len < spec_k + 2:
            raise ValueError(f"hist_len {hist_len} too small for K={spec_k}")
        self.spec_k = int(spec_k)
        self.hist_len = int(hist_len)

    def init_state(self, batch: int) -> dict[str, np.ndarray]:
        return {"hist": np.full((batch, self.hist_len), -1, np.int32),
                "cnt": np.zeros((batch,), np.int32)}

    def seed_row(self, state, row: int, tokens) -> None:
        H = self.hist_len
        toks = np.asarray(tokens, np.int32).reshape(-1)
        state["hist"][row] = -1
        # token with stream index i lives at slot i % H (ring)
        for i, t in enumerate(toks[-H:] if len(toks) > H else toks):
            base = max(len(toks) - H, 0)
            state["hist"][row, (base + i) % H] = t
        state["cnt"][row] = len(toks)

    def propose(self, state, last):
        hist, cnt = state["hist"], state["cnt"].long()
        H, K = self.hist_len, self.spec_k
        dev = hist.device
        c0 = torch.remainder(cnt - 1, H)                       # newest slot
        idx = torch.arange(H, device=dev)[None, :]
        age = torch.remainder(c0[:, None] - idx, H)            # 0 = newest
        n_valid = torch.clamp(cnt, max=H)[:, None]
        match = (age >= 1) & (age < n_valid) & (hist == last[:, None])
        best = torch.where(match, age, H + 1).amin(dim=1)      # (B,)
        found = best <= H
        f_age = best[:, None] - 1 - torch.arange(K, device=dev)[None, :]
        f_slot = torch.remainder(c0[:, None] - f_age, H)
        cand = torch.gather(hist, 1, f_slot)
        return torch.where(found[:, None] & (f_age >= 0), cand,
                           last[:, None]).to(torch.int32)

    def observe(self, state, block, count):
        hist, cnt = state["hist"].clone(), state["cnt"]
        H = self.hist_len
        count = _count(count, cnt)
        rows = torch.arange(hist.shape[0], device=hist.device)
        for i in range(block.shape[1]):                        # K+1 is tiny
            slot = torch.remainder(cnt + i, H).long()
            cur = hist[rows, slot]
            hist[rows, slot] = torch.where(i < count,
                                           block[:, i].to(hist.dtype), cur)
        return {"hist": hist, "cnt": cnt + count}


class RepeatDrafter(Drafter):
    """Proposes the last committed token K times."""

    def __init__(self, spec_k: int):
        self.spec_k = int(spec_k)

    def init_state(self, batch: int) -> dict[str, np.ndarray]:
        return {"_": np.zeros((batch,), np.int32)}           # placeholder

    def seed_row(self, state, row: int, tokens) -> None:
        pass

    def propose(self, state, last):
        return last[:, None].repeat(1, self.spec_k).to(torch.int32)

    def observe(self, state, block, count):
        return state


class ReplayDrafter(Drafter):
    """Replays a pre-recorded token stream (B, L) as drafts; past its end
    it degrades to repeating the last token.  If the stream is the target
    model's own greedy output, acceptance is exactly 1.0 provided verify
    and commit are exact."""

    def __init__(self, spec_k: int, stream: np.ndarray):
        self.spec_k = int(spec_k)
        self.stream = np.asarray(stream, np.int32)           # (B, L)

    def init_state(self, batch: int) -> dict[str, np.ndarray]:
        if batch != self.stream.shape[0]:
            raise ValueError("replay stream batch mismatch")
        return {"stream": self.stream.copy(),
                "ptr": np.zeros((batch,), np.int32)}

    def seed_row(self, state, row: int, tokens) -> None:
        pass

    def propose(self, state, last):
        stream, ptr = state["stream"], state["ptr"].long()
        L = stream.shape[1]
        idx = ptr[:, None] + torch.arange(self.spec_k,
                                          device=stream.device)[None, :]
        cand = torch.gather(stream, 1, torch.clamp(idx, max=L - 1))
        return torch.where(idx < L, cand, last[:, None]).to(torch.int32)

    def observe(self, state, block, count):
        # the pointer moves with the committed position, so drafts stay
        # aligned to depth even after a divergence
        return {"stream": state["stream"],
                "ptr": state["ptr"] + _count(count, state["ptr"])}


def get_drafter(name: str, spec_k: int, *, hist_len: int = 128) -> Drafter:
    """CLI / engine factory for the built-in self-drafters."""
    if name == "ngram":
        return NgramDrafter(spec_k, hist_len=hist_len)
    if name == "repeat":
        return RepeatDrafter(spec_k)
    raise ValueError(f"unknown drafter {name!r} (replay is test-only: "
                     "construct ReplayDrafter with a recorded stream)")


def state_to(state: dict[str, np.ndarray], device) -> dict[str,
                                                            torch.Tensor]:
    """A host-side drafter state as device tensors (copies)."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in state.items()}


def state_to_host(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A device drafter state back on the host, as writable numpy."""
    return {k: v.cpu().numpy().copy() for k, v in state.items()}
