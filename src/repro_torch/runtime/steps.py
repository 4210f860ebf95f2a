"""Step builders of the port's serving path: the paged decode chunk and the
chunked suffix-prefill step, counterparts of ``repro.runtime.steps``'s
``make_paged_decode_loop`` and ``make_prefill_suffix_step``.

Where the JAX package fused a chunk into one ``lax.scan`` compiled ahead
of time, the port runs a plain Python loop over the decode step (CUDA
graphs are later work).  Greedy decoding is an argmax; temperature
sampling draws from an explicit ``torch.Generator`` (seeded by the engine
from ``sample_seed``), so it is deterministic but cannot reproduce
``jax.random``'s numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RunCtx


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Runtime knobs orthogonal to the model config (serving subset)."""
    remat: str = "none"
    kernel_policy: KernelPolicy = KernelPolicy()


def with_decode_policy(step_cfg: StepConfig, *,
                       kv_splits: str | int | None = None,
                       decode_k_chunk: int | None = None,
                       kv_dtype: str | None = None) -> StepConfig:
    """``step_cfg`` with decode-sweep knobs swapped on its ``KernelPolicy``;
    ``None`` leaves a knob as it is."""
    repl: dict[str, Any] = {}
    if kv_splits is not None:
        repl["kv_splits"] = kv_splits
    if decode_k_chunk is not None:
        repl["decode_k_chunk"] = int(decode_k_chunk)
    if kv_dtype is not None:
        repl["kv_dtype"] = str(kv_dtype)
    if not repl:
        return step_cfg
    policy = dataclasses.replace(step_cfg.kernel_policy, **repl)
    return dataclasses.replace(step_cfg, kernel_policy=policy)


def make_run_ctx(cfg: ModelConfig, step_cfg: StepConfig) -> RunCtx:
    del cfg
    return RunCtx(kernel_policy=step_cfg.kernel_policy)


def sample(last, *, greedy: bool, temperature: float,
           generator: torch.Generator | None = None):
    """Next token from logits ``last`` (B, V): argmax, or a draw from
    softmax(last / temperature) with ``generator``."""
    if greedy:
        return torch.argmax(last, dim=-1).to(torch.int32)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def make_paged_decode_loop(cfg: ModelConfig, step_cfg: StepConfig,
                           n_tokens: int = 16, *, greedy: bool = True,
                           temperature: float = 1.0) -> Callable:
    """decode_loop(params, cache, tokens, active, generator=None)
    -> (token_block (B, n_tokens) int32, cache).

    ``n_tokens`` paged decode steps over every slot; only ``active`` slots
    advance their position, parked slots spin on their scratch page.
    ``tokens`` (B, 1) is the token that enters the model first."""
    ctx = make_run_ctx(cfg, step_cfg)

    def decode_loop(params, cache, tokens, active, generator=None):
        active = active.to(torch.int32)
        tok, out = tokens, []
        for _ in range(n_tokens):
            logits, cache = tfm._paged_decode_step(params, cache, tok, cfg,
                                                   ctx, active)
            nxt = sample(logits[:, -1], greedy=greedy,
                         temperature=temperature, generator=generator)
            out.append(nxt)
            tok = nxt[:, None]
        return torch.stack(out, dim=1), cache

    return decode_loop


def make_prefill_suffix_step(cfg: ModelConfig,
                             step_cfg: StepConfig) -> Callable:
    """suffix_step(params, cache, tokens, n_commit) -> (logits, cache): one
    chunked paged-prefill sweep (``transformer.prefill_suffix``); the
    joining slot's row of ``tokens`` (n_slots, chunk) holds its next
    ``n_commit[slot]`` suffix tokens, other rows are pad with
    ``n_commit == 0``."""
    ctx = make_run_ctx(cfg, step_cfg)
    blockers = tfm.chunked_prefill_blockers(cfg)
    if blockers:
        raise ValueError(f"{cfg.name}: chunked paged prefill blocked by "
                         f"{blockers[0]}")

    def suffix_step(params, cache, tokens, n_commit):
        return tfm.prefill_suffix(params, cache, tokens,
                                  n_commit.to(torch.int32), cfg, ctx)

    return suffix_step
