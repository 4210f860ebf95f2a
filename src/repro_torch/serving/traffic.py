"""Traffic generators: deterministic arrival processes for the engine.

Real RAN inference traffic (the O-RAN xAPP serving path this repo
reproduces) is a stream of ragged requests, classically modelled as a
Poisson process.  Arrivals are expressed on the engine's decode-step clock
so traces are exactly reproducible on any host speed.

Shared-system-prompt scenarios: real serving traffic overwhelmingly shares
prompt *heads* — system prompts, few-shot headers, RAG boilerplate — which
is exactly what the prefix-sharing page cache exploits.
``shared_prefix_len > 0`` prepends one of ``prompt_pools`` fixed random
prefixes to every request's unique suffix (total prompt length =
``shared_prefix_len`` + the drawn suffix length).  With
``shared_prefix_len=0`` the RNG stream is untouched, so existing traces
are bit-identical to before.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.request import Request


def _prompts(rng: np.random.Generator, n: int, lo: int, hi: int,
             vocab_size: int, n_codebooks: int) -> list[np.ndarray]:
    lens = rng.integers(lo, hi + 1, size=n)
    out = []
    for L in lens:
        shape = (int(L), n_codebooks) if n_codebooks else (int(L),)
        out.append(rng.integers(0, vocab_size, size=shape).astype(np.int32))
    return out


def _shared_prefixes(rng: np.random.Generator, prompts: list[np.ndarray],
                     shared_prefix_len: int, prompt_pools: int,
                     vocab_size: int, n_codebooks: int) -> list[np.ndarray]:
    """Prepend a pool-drawn shared prefix to every prompt."""
    shape = (shared_prefix_len, n_codebooks) if n_codebooks \
        else (shared_prefix_len,)
    pools = [rng.integers(0, vocab_size, size=shape).astype(np.int32)
             for _ in range(max(prompt_pools, 1))]
    picks = rng.integers(0, len(pools), size=len(prompts))
    return [np.concatenate([pools[picks[i]], p], axis=0)
            for i, p in enumerate(prompts)]


def poisson_trace(n_requests: int, *, rate_per_step: float, seed: int,
                  vocab_size: int, prompt_len: tuple[int, int],
                  max_new_tokens: tuple[int, int], n_codebooks: int = 0,
                  eos_id: int | None = None, shared_prefix_len: int = 0,
                  prompt_pools: int = 1) -> list[Request]:
    """Poisson arrivals: exponential inter-arrival gaps with mean
    ``1 / rate_per_step`` decode steps; ragged prompt lengths and token
    budgets drawn uniformly from the given inclusive ranges.  With
    ``shared_prefix_len > 0``, ``prompt_len`` bounds the *unique suffix*
    and every prompt is ``shared_prefix + suffix``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_per_step, 1e-9), size=n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    prompts = _prompts(rng, n_requests, *prompt_len, vocab_size, n_codebooks)
    gens = rng.integers(max_new_tokens[0], max_new_tokens[1] + 1,
                        size=n_requests)
    if shared_prefix_len > 0:
        prompts = _shared_prefixes(rng, prompts, shared_prefix_len,
                                   prompt_pools, vocab_size, n_codebooks)
    return [Request(rid=i, prompt=prompts[i], max_new_tokens=int(gens[i]),
                    arrival_step=int(arrivals[i]), eos_id=eos_id)
            for i in range(n_requests)]


def batch_trace(n_requests: int, *, seed: int, vocab_size: int,
                prompt_len: int, max_new_tokens: int, n_codebooks: int = 0,
                eos_id: int | None = None, shared_prefix_len: int = 0,
                prompt_pools: int = 1) -> list[Request]:
    """Everything arrives at step 0 with uniform shape — the static-batch
    baseline expressed as a trace.  ``shared_prefix_len`` prepends pooled
    shared heads exactly as in :func:`poisson_trace`."""
    rng = np.random.default_rng(seed)
    prompts = _prompts(rng, n_requests, prompt_len, prompt_len,
                       vocab_size, n_codebooks)
    if shared_prefix_len > 0:
        prompts = _shared_prefixes(rng, prompts, shared_prefix_len,
                                   prompt_pools, vocab_size, n_codebooks)
    return [Request(rid=i, prompt=prompts[i], max_new_tokens=max_new_tokens,
                    arrival_step=0, eos_id=eos_id)
            for i in range(n_requests)]
