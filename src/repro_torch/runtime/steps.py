"""Step builders of the port, counterparts of ``repro.runtime.steps``'s
functions of the same names: the train step (``init_train_state``,
``make_train_step``: gradient accumulation over ``n_micro``
micro-batches in fp32, then AdamW in place), the prefill step,
the one-token serve step over the ring (``make_serve_step``, the graph of
the dry-run's decode cells), the decode chunks over the ring
(``make_decode_loop``) and the paged cache (``make_paged_decode_loop``), the speculative chunks over both
(``make_speculative_decode_loop``, ``make_paged_speculative_decode_loop``)
and the chunked suffix-prefill step.

Where the JAX package fused a chunk into one ``lax.scan`` compiled ahead
of time, the port runs a plain Python loop over the step (CUDA graphs are
later work); only the paged commit reads back to the host inside a chunk.
Greedy decoding is an argmax; temperature sampling draws from an explicit
``torch.Generator`` (seeded by the caller), so it is deterministic but
cannot reproduce ``jax.random``'s numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels.ops import KernelPolicy
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Runtime knobs orthogonal to the model config."""
    n_micro: int = 1                   # grad-accumulation microbatches
    remat: str = "dots"                # none | dots | full
    kernel_policy: KernelPolicy = KernelPolicy()
    optimizer: OptimizerConfig = OptimizerConfig()
    sequence_shard: bool = False
    moe_strategy: str = "gather"       # gather | a2a (see models.layers)


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


def make_run_ctx(cfg: ModelConfig, step_cfg: StepConfig,
                 rules=None) -> RunCtx:
    """The step's ``RunCtx``; with sharding ``rules``
    (``runtime.sharding.build_rules``) their mesh and constraint."""
    del cfg
    if rules is None:
        return RunCtx(kernel_policy=step_cfg.kernel_policy,
                      remat=step_cfg.remat)
    return RunCtx(parallel=rules.parallel_ctx(),
                  kernel_policy=step_cfg.kernel_policy,
                  constrain=rules.constrain, remat=step_cfg.remat)


def init_train_state(cfg: ModelConfig, step_cfg: StepConfig,
                     generator: torch.Generator, device=None) -> dict:
    """Random fp32 master params (``bridge.init_lm(master=True)``, drawn
    from ``generator``, requiring grad) and the optimizer state, as one
    state dict ``{"params", "opt", "step"}``."""
    from repro_torch import bridge
    params = bridge.init_lm(cfg, generator, device, master=True)
    for p in common.tree_leaves(params):
        p.requires_grad_(True)
    opt = adamw_init(params, step_cfg.optimizer)
    step = torch.zeros((), dtype=torch.int32, device=opt["count"].device)
    return {"params": params, "opt": opt, "step": step}


def train_state_sharding(rules, axes_tree) -> dict[str, Any]:
    """Specs of a train state: the params' from their logical axes, the
    moments the params', ``count`` and ``step`` replicated (``()``)."""
    psh = rules.param_sharding(axes_tree)
    return {"params": psh, "opt": {"count": (), "mu": psh, "nu": psh},
            "step": ()}


def make_loss_and_grads(cfg: ModelConfig, step_cfg: StepConfig) -> Callable:
    """(params, inputs, targets, extra) -> (loss, grads): the loss of one
    (micro-)batch and its gradient with respect to every leaf of
    ``params`` (a tree of the same structure, in the params' dtype; zeros
    for a leaf the loss does not reach)."""
    ctx = make_run_ctx(cfg, step_cfg)

    def loss_and_grads(params, inputs, targets, extra=None):
        leaves = common.tree_leaves(params)
        with torch.enable_grad():
            loss = tfm.lm_loss_pre_shifted(params, inputs, targets, cfg, ctx,
                                           extra_embeds=extra)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(p): torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)}
        return loss.detach(), common.tree_map(lambda p: by_id[id(p)], params)

    return loss_and_grads


def _as_tensor(x, device):
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def make_train_step(cfg: ModelConfig, step_cfg: StepConfig) -> Callable:
    """Returns step(state, batch) -> (state, metrics), updating ``state``
    in place.  batch = {"inputs": (B, S), "targets": (B, S), optional
    "image_embeds": (B, n_img, d)} (tensors or numpy).  With ``n_micro`` >
    1 the batch is cut into that many micro-batches along B, their
    gradients summed in fp32 in order and the sums (losses too) divided by
    ``n_micro``, as the JAX package's ``lax.scan`` does.  metrics =
    {"loss", "lr", "grad_norm"}, 0-d fp32 tensors."""
    loss_and_grads = make_loss_and_grads(cfg, step_cfg)

    def train_step(state, batch):
        params = state["params"]
        dev = state["step"].device
        inputs = _as_tensor(batch["inputs"], dev)
        targets = _as_tensor(batch["targets"], dev)
        extra = _as_tensor(batch.get("image_embeds"), dev)
        n_micro = step_cfg.n_micro
        if n_micro == 1:
            loss, grads = loss_and_grads(params, inputs, targets, extra)
        else:
            mb = inputs.shape[0] // n_micro
            gsum = common.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                sl = slice(i * mb, (i + 1) * mb)
                l, g = loss_and_grads(params, inputs[sl], targets[sl],
                                      None if extra is None else extra[sl])
                common.tree_map(lambda a, b: a.add_(b.to(a.dtype)), gsum, g)
                lsum = lsum + l
            grads = common.tree_map(lambda g: g / n_micro, gsum)
            loss = lsum / n_micro
        _, _, om = adamw_update(grads, state["opt"], params,
                                step_cfg.optimizer)
        state["step"] = state["step"] + 1
        return state, {"loss": loss, **om}

    return train_step


def sample(last, *, greedy: bool, temperature: float,
           generator: torch.Generator | None = None):
    """Next token from logits ``last`` (B, V), or a codebook model's (B,
    n_cb, V), over the last axis: argmax, or a draw from softmax(last /
    temperature) with ``generator``."""
    if greedy:
        return torch.argmax(last, dim=-1).to(torch.int32)
    probs = torch.softmax(last.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator)[:, 0].reshape(
        probs.shape[:-1]).to(torch.int32)


def make_prefill_step(cfg: ModelConfig, step_cfg: StepConfig,
                      max_len: int = 0) -> Callable:
    """prefill(params, batch) -> (last_logits (B, Vp), ring cache)."""
    ctx = make_run_ctx(cfg, step_cfg)

    def prefill_step(params, batch):
        logits, cache = tfm.prefill(params, batch["inputs"], cfg, ctx,
                                    max_len=max_len)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, step_cfg: StepConfig, rules=None,
                    greedy: bool = True) -> Callable:
    """serve(params, cache, tokens) -> (next_token_or_logits, cache).

    One new token a sequence against the ring cache
    (``transformer.decode_step``, which updates the cache in place): the
    greedy next token (B,) (a codebook model's (B, n_cb)) int32, or the
    logits (B, 1, Vp) with ``greedy=False``.  The graph the dry-run's
    decode_32k / long_500k cells count."""
    ctx = make_run_ctx(cfg, step_cfg, rules)

    def serve_step(params, cache, tokens):
        logits, cache = tfm.decode_step(params, cache, tokens, cfg, ctx)
        if greedy:
            return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
        return logits, cache

    return serve_step


def _decode_chunk(params, cache, tokens, active, generator, *, cfg, ctx,
                  n_tokens, greedy, temperature):
    """``n_tokens`` decode steps (model, sampling, cache update) over
    either layout; ``active`` is None for the ring."""
    tok, out = tokens, []
    for _ in range(n_tokens):
        logits, cache = tfm.decode_step(params, cache, tok, cfg, ctx,
                                        active=active)
        nxt = sample(logits[:, -1], greedy=greedy, temperature=temperature,
                     generator=generator)
        out.append(nxt)
        tok = nxt[:, None]
    return torch.stack(out, dim=1), cache


def make_decode_loop(cfg: ModelConfig, step_cfg: StepConfig,
                     n_tokens: int = 16, *, greedy: bool = True,
                     temperature: float = 1.0) -> Callable:
    """decode_loop(params, cache, tokens, generator=None)
    -> (token_block (B, n_tokens[, n_cb]) int32, cache) over the ring
    cache.

    ``tokens`` (B, 1) (a codebook model's (B, 1, n_cb)) is the token that
    enters the model first; the block holds the tokens sampled after it.
    The ring buffers update in place."""
    ctx = make_run_ctx(cfg, step_cfg)

    def decode_loop(params, cache, tokens, generator=None):
        return _decode_chunk(params, cache, tokens, None, generator, cfg=cfg,
                             ctx=ctx, n_tokens=n_tokens, greedy=greedy,
                             temperature=temperature)

    return decode_loop


def make_paged_decode_loop(cfg: ModelConfig, step_cfg: StepConfig,
                           n_tokens: int = 16, *, greedy: bool = True,
                           temperature: float = 1.0) -> Callable:
    """decode_loop(params, cache, tokens, active, generator=None)
    -> (token_block (B, n_tokens[, n_cb]) int32, cache).

    ``n_tokens`` paged decode steps over every slot; only ``active`` slots
    advance their position, parked slots spin on their scratch page.
    ``tokens`` (B, 1) (or (B, 1, n_cb)) is the token that enters the model
    first."""
    ctx = make_run_ctx(cfg, step_cfg)

    def decode_loop(params, cache, tokens, active, generator=None):
        return _decode_chunk(params, cache, tokens, active.to(torch.int32),
                             generator, cfg=cfg, ctx=ctx, n_tokens=n_tokens,
                             greedy=greedy, temperature=temperature)

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


# ==========================================================================
# speculative decoding
# ==========================================================================
def _spec_accept_greedy(logits, drafts):
    """Greedy exact-match acceptance.  logits (B, Q, V) for the fed block
    [t_last, d_1..d_K]; draft d_{i+1} is accepted iff it equals argmax(row
    i) and every earlier draft was accepted.  Returns the argmax rows (the
    emitted block: accepted drafts + the bonus token, exactly the plain
    greedy stream) and the per-row accepted counts (B,)."""
    g = torch.argmax(logits, dim=-1).to(torch.int32)           # (B, Q)
    match = (drafts == g[:, :-1]).to(torch.int32)              # (B, K)
    return g, torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)


def _spec_accept_sample(logits, drafts, acc_flags, a_vec, generator,
                        temperature):
    """Temperature rejection-sampling acceptance for point-mass drafters
    (Leviathan et al.): the emitted block is the drafts with row ``a_vec``
    replaced by the correction (resampled from p without the rejected
    draft) or the bonus token (all K accepted).  Where lockstep cut a row
    short of its own acceptance, its accepted draft at ``a_vec`` is a
    valid sample from p and is kept."""
    B, Q, V = logits.shape
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    a = a_vec.long()
    p_base = torch.gather(probs, 1, a[:, None, None].expand(B, 1, V))[:, 0]
    d_pad = torch.cat([drafts, drafts[:, -1:]], dim=1)         # (B, Q)
    d_at = torch.gather(d_pad, 1, a[:, None])[:, 0]
    is_bonus = a == Q - 1
    f_pad = torch.cat([acc_flags, torch.zeros_like(acc_flags[:, :1])], dim=1)
    accepted_here = torch.gather(f_pad, 1, a[:, None])[:, 0] > 0
    onehot = torch.nn.functional.one_hot(d_at.long(), V).to(probs.dtype)
    dist = torch.where(is_bonus[:, None], p_base, p_base * (1.0 - onehot))
    samp = torch.multinomial(dist + 1e-30, 1, generator=generator)[:, 0]
    last_tok = torch.where(is_bonus | ~accepted_here, samp.to(torch.int32),
                           d_at)
    pick = torch.arange(Q, device=logits.device)[None, :] == a[:, None]
    return torch.where(pick, last_tok[:, None], d_pad).to(torch.int32)


def _spec_chunk(params, cache, tokens, active, dstate, generator, *, cfg,
                ctx, drafter, n_steps, greedy, temperature):
    """``n_steps`` x (draft -> verify -> accept -> commit).  ``active`` None
    is the ring: its scalar ``pos`` advances the batch in lockstep, so
    acceptance truncates to the batch minimum (still exact).  Otherwise
    the paged layout keeps per-slot counts; parked slots neither commit
    nor advance, and their counts are 0."""
    toks, counts_out = [], []
    tok = tokens
    for _ in range(n_steps):
        drafts = drafter.propose(dstate, tok[:, 0])             # (B, K)
        block = torch.cat([tok, drafts], dim=1)                 # (B, Q)
        logits, pending = tfm.verify_step(params, cache, block, cfg, ctx)
        if greedy:
            emit, acc = _spec_accept_greedy(logits, drafts)
        else:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            p_draft = torch.gather(probs[:, :-1], 2,
                                   drafts.long()[..., None])[..., 0]
            u = torch.rand(p_draft.shape, generator=generator,
                           device=p_draft.device)
            ok = (u < p_draft).to(torch.int32)
            acc = torch.cumprod(ok, dim=1).sum(dim=1, dtype=torch.int32)
        a_vec = acc if active is not None else acc.min().expand(acc.shape)
        if not greedy:
            emit = _spec_accept_sample(logits, drafts, ok, a_vec, generator,
                                       temperature)
        counts = a_vec + 1
        if active is not None:
            counts = torch.where(active > 0, counts, 0)
            cache = tfm.commit_spec_paged(cache, pending, a_vec, active, cfg)
        else:
            cache = tfm.commit_spec(cache, pending, a_vec[0], cfg)
        dstate = drafter.observe(dstate, emit, counts)
        tok = torch.gather(emit, 1, a_vec.long()[:, None])
        toks.append(emit)
        counts_out.append(counts)
    return (torch.stack(toks, dim=1), torch.stack(counts_out, dim=1), cache,
            dstate)


def make_speculative_decode_loop(cfg: ModelConfig, step_cfg: StepConfig,
                                 n_steps: int = 8, *, drafter,
                                 greedy: bool = True,
                                 temperature: float = 1.0) -> Callable:
    """spec_loop(params, cache, tokens, drafter_state, generator=None)
    -> (token_blocks (B, n_steps, K+1), counts (B, n_steps), cache, state)
    over the ring cache.  ``counts[:, s]`` is step s's emitted-token count
    (accepted drafts + 1), equal across the batch; greedy emission is
    token for token ``make_decode_loop``'s stream."""
    ctx = make_run_ctx(cfg, step_cfg)
    blockers = tfm.speculative_blockers(cfg)
    if blockers:
        raise ValueError(f"{cfg.name}: speculative decode blocked by "
                         f"{blockers[0]}")

    def spec_loop(params, cache, tokens, drafter_state, generator=None):
        return _spec_chunk(params, cache, tokens, None, drafter_state,
                           generator, cfg=cfg, ctx=ctx, drafter=drafter,
                           n_steps=n_steps, greedy=greedy,
                           temperature=temperature)

    return spec_loop


def make_paged_speculative_decode_loop(cfg: ModelConfig, step_cfg: StepConfig,
                                       n_steps: int = 8, *, drafter,
                                       greedy: bool = True,
                                       temperature: float = 1.0) -> Callable:
    """spec_loop(params, cache, tokens, active, drafter_state,
    generator=None) -> (token_blocks (B, n_steps, K+1), counts (B,
    n_steps), cache, state) over the paged cache: every slot keeps its own
    accepted prefix."""
    ctx = make_run_ctx(cfg, step_cfg)
    blockers = (tfm.speculative_blockers(cfg)
                or tfm.chunked_prefill_blockers(cfg))
    if blockers:
        raise ValueError(f"{cfg.name}: paged speculative decode blocked by "
                         f"{blockers[0]}")

    def spec_loop(params, cache, tokens, active, drafter_state,
                  generator=None):
        return _spec_chunk(params, cache, tokens, active.to(torch.int32),
                           drafter_state, generator, cfg=cfg, ctx=ctx,
                           drafter=drafter, n_steps=n_steps, greedy=greedy,
                           temperature=temperature)

    return spec_loop
