"""The LM trunk of the port, dense GQA family: prefill, the paged decode
step, the paged verify sweep, suffix prefill and the paged commit —
counterparts of ``repro.models.transformer``'s functions of the same
names, with the same shapes and parameter layout.

Parameters are the nested dict of the JAX package (``embed``,
``layers/sub0/{norm1, attn/{wq,wk,wv,wo}, norm2, ffn/{wi_gate,wi_up,wo}}``
stacked on a leading ``n_units`` axis, ``final_norm``), so a JAX
checkpoint loads without reshaping (``repro_torch.bridge``).  Where JAX
scanned over the stacked layers, the port loops in Python.

The paged cache is a dict ``{"pos": (n_slots,) int32, "block_tables":
(n_slots, max_blocks) int32, "units": {"sub0": {"k", "v": (n_units,
n_pages, page_size, Hkv, hd)}}}``.  Its pools are updated IN PLACE (the
decode scatter and ``commit_spec_paged`` write through ``index_copy_`` on
the flattened ``(P * ps, Hkv, hd)`` view), where JAX donated the buffers
and returned new ones; the functions still return the cache dict, with a
new ``pos``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_forward

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


@dataclasses.dataclass(frozen=True)
class RunCtx:
    kernel_policy: ops.KernelPolicy = ops.DEFAULT_POLICY


def unit_size(cfg: ModelConfig) -> int:
    if cfg.local_global:
        return 2
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        return cfg.hybrid_attn_every
    return 1


def n_units(cfg: ModelConfig) -> int:
    u = unit_size(cfg)
    body_layers = cfg.n_layers - cfg.first_dense_layers
    if body_layers % u:
        raise ValueError(f"{cfg.name}: {body_layers} layers not divisible by "
                         f"pattern unit {u}")
    return body_layers // u


# ==========================================================================
# capability gates: what this port does not serve yet, by name
# ==========================================================================
def paged_cache_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """Named config features the port's paged engine does not serve yet
    (each family comes with its own slice; see ROADMAP.md).  Empty for the
    dense GQA family."""
    checks = (("uses_ssm", cfg.uses_ssm), ("use_mla", cfg.use_mla),
              ("n_experts", cfg.uses_moe),
              ("n_codebooks", bool(cfg.n_codebooks)),
              ("sliding_window", bool(cfg.sliding_window)),
              ("local_global", cfg.local_global),
              ("first_dense_layers", bool(cfg.first_dense_layers)),
              ("hybrid_attn_every",
               cfg.family == "hybrid" and bool(cfg.hybrid_attn_every)),
              ("heads_padded", cfg.heads_padded))
    return tuple(name for name, on in checks if on)


def chunked_prefill_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """Named features blocking the paged multi-query sweep behind suffix
    prefill (the JAX package's list, plus what the port does not serve)."""
    checks = (("uses_ssm", cfg.uses_ssm),
              ("n_codebooks", bool(cfg.n_codebooks)),
              ("hybrid_attn_every",
               cfg.family == "hybrid" and bool(cfg.hybrid_attn_every)),
              ("sliding_window", bool(cfg.sliding_window)),
              ("local_global", cfg.local_global))
    names = [name for name, on in checks if on]
    names += [b for b in paged_cache_blockers(cfg) if b not in names]
    return tuple(names)


def int8_paged_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """int8 KV pages (per-row fp32 scales) are the KV-tier slice: blocked
    for every config in this port so far."""
    del cfg
    return ("kv_dtype=int8 (KV-tier slice, not ported)",)


def _require_paged(cfg: ModelConfig) -> None:
    blockers = paged_cache_blockers(cfg)
    if blockers:
        raise NotImplementedError(f"{cfg.name}: {blockers[0]} is not ported "
                                  "to repro_torch yet")


# ==========================================================================
# parameters
# ==========================================================================
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "embed",
                "lm_head")


def prepare_params(params, cfg: ModelConfig):
    """Cast the matmul weights once to the compute dtype ``cfg.dtype``
    (the JAX package casts them at every use — same values); norm scales
    keep ``param_dtype``, since rmsnorm reads them in fp32."""
    adt = common.dt(cfg.dtype)

    def walk(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key in _MATMUL_KEYS:
                out[key] = val.to(adt)
            else:
                out[key] = val
        return out

    return walk(params)


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter (sub)tree, as views."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# ==========================================================================
# embedding / head
# ==========================================================================
def embed_tokens(params, tokens, cfg: ModelConfig, ctx: RunCtx | None = None):
    adt = common.dt(cfg.dtype)
    x = params["embed"].to(adt)[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt)
    return x


def lm_logits(params, x, cfg: ModelConfig, ctx: RunCtx | None = None):
    adt = x.dtype
    Vp = padded_vocab(cfg)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(adt).T
    else:
        logits = x @ params["lm_head"].to(adt)
    if cfg.final_logit_softcap > 0.0:
        logits = common.softcap(logits, cfg.final_logit_softcap)
    if Vp != cfg.vocab_size:
        mask = torch.arange(Vp, device=x.device) < cfg.vocab_size
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=x.device))
    return logits


def _norm(x, scale, cfg: ModelConfig):
    return common.rmsnorm(x, scale, cfg.norm_eps, gemma_style=cfg.post_norms)


def _ffn(blk, x, a, cfg: ModelConfig):
    """Residual add of the attention output, then the MLP half."""
    if cfg.post_norms:
        a = _norm(a, blk["post_attn_norm"], cfg)
    x = x + a
    h = _norm(x, blk["norm2"], cfg)
    f = mlp_forward(blk["ffn"], h, cfg)
    if cfg.post_norms:
        f = _norm(f, blk["post_ffn_norm"], cfg)
    return x + f


# ==========================================================================
# prefill
# ==========================================================================
def prefill(params, tokens, cfg: ModelConfig, ctx: RunCtx = RunCtx(), *,
            max_len: int = 0):
    """Process the whole prompt and build its decode cache.

    tokens (B, S) -> (logits (B, S, Vp), cache) with cache =
    ``{"pos": S, "units": {"sub0": {"k", "v": (n_units, B, max_len, Hkv,
    hd)}}}``.  The dense family has no windowed layers, so the cache is
    linear at capacity ``max_len`` (the JAX package's ``full_cache``
    layout)."""
    _require_paged(cfg)
    x = embed_tokens(params, tokens, cfg, ctx)
    B, S = x.shape[:2]
    max_len = max_len or max(cfg.max_seq_len, S)
    positions = torch.arange(S, device=x.device)[None, :]
    caches = {f"sub{i}": {"k": [], "v": []} for i in range(unit_size(cfg))}
    for l in range(n_units(cfg)):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            blk = unit[f"sub{i}"]
            h = _norm(x, blk["norm1"], cfg)
            a, (k, v) = attn.gqa_prefill(blk["attn"], h, positions, cfg,
                                         window=cfg.window_for_layer(i),
                                         cache_len=max_len,
                                         policy=ctx.kernel_policy)
            caches[f"sub{i}"]["k"].append(k)
            caches[f"sub{i}"]["v"].append(v)
            x = _ffn(blk, x, a, cfg)
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(params, x, cfg, ctx)
    units = {name: {key: torch.stack(vals) for key, vals in c.items()}
             for name, c in caches.items()}
    return logits, {"pos": S, "units": units}


# ==========================================================================
# paged cache, decode, verify, commit
# ==========================================================================
def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, max_blocks: int,
                     dtype: str = "bfloat16", device=None):
    """Zero-filled paged decode cache: per-unit k/v page pools shared by
    every slot (full-attention GQA group), one block table and one
    position counter per slot."""
    _require_paged(cfg)
    if dtype == "int8":
        raise NotImplementedError("int8 KV pages: KV-tier slice")
    adt = common.dt(dtype)
    hd = cfg.resolved_head_dim
    nu = n_units(cfg)
    hkv = cfg.padded_kv_heads
    shape = (nu, n_pages, page_size, hkv, hd)
    units = {f"sub{i}": {"k": torch.zeros(shape, dtype=adt, device=device),
                         "v": torch.zeros(shape, dtype=adt, device=device)}
             for i in range(unit_size(cfg))}
    return {"pos": torch.zeros((n_slots,), dtype=torch.int32, device=device),
            "block_tables": torch.zeros((n_slots, max_blocks),
                                        dtype=torch.int32, device=device),
            "units": units}


def _paged_decode_step(params, cache, tokens, cfg: ModelConfig, ctx: RunCtx,
                       active=None):
    """One decode step over the paged cache: tokens (B, 1) -> (logits
    (B, 1, Vp), cache with pos advanced where ``active``).  Parked slots
    keep rewriting row ``pos[b]`` of their scratch page; the engine drops
    their tokens."""
    _require_paged(cfg)
    pos = cache["pos"]
    bt = cache["block_tables"]
    x = embed_tokens(params, tokens, cfg, ctx)
    for l in range(n_units(cfg)):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            blk, c = unit[f"sub{i}"], cache["units"][f"sub{i}"]
            h = _norm(x, blk["norm1"], cfg)
            a, _ = attn.gqa_decode_paged(blk["attn"], h, pos,
                                         (c["k"][l], c["v"][l]), bt, cfg,
                                         window=cfg.window_for_layer(i),
                                         policy=ctx.kernel_policy)
            x = _ffn(blk, x, a, cfg)
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(params, x, cfg, ctx)
    adv = torch.ones_like(pos) if active is None else active.to(pos.dtype)
    return logits, {**cache, "pos": pos + adv}


def verify_step(params, cache, tokens, cfg: ModelConfig,
                ctx: RunCtx = RunCtx()):
    """Score ``Q`` fed tokens (B, Q) at positions ``pos .. pos+Q-1`` in ONE
    sweep of the paged pools.  Returns (logits (B, Q, Vp), pending) with
    pending ``{"sub0": {"k", "v": (n_units, B, Q, Hkv, hd)}}`` — nothing is
    committed until :func:`commit_spec_paged`."""
    if "block_tables" not in cache:
        raise NotImplementedError("ring-buffer verify (speculative batch "
                                  "mode, kernel K6) is not ported yet")
    blockers = chunked_prefill_blockers(cfg)
    if blockers:
        raise ValueError(f"{cfg.name}: paged verify sweep blocked by "
                         f"{blockers[0]}")
    pos = cache["pos"]
    bt = cache["block_tables"]
    x = embed_tokens(params, tokens, cfg, ctx)
    pend = {f"sub{i}": {"k": [], "v": []} for i in range(unit_size(cfg))}
    for l in range(n_units(cfg)):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            blk, c = unit[f"sub{i}"], cache["units"][f"sub{i}"]
            h = _norm(x, blk["norm1"], cfg)
            # paged sweeps run window-free, as in the JAX package
            a, (k, v) = attn.gqa_verify_paged(blk["attn"], h, pos,
                                              (c["k"][l], c["v"][l]), bt,
                                              cfg, window=0,
                                              policy=ctx.kernel_policy)
            pend[f"sub{i}"]["k"].append(k)
            pend[f"sub{i}"]["v"].append(v)
            x = _ffn(blk, x, a, cfg)
    x = _norm(x, params["final_norm"], cfg)
    logits = lm_logits(params, x, cfg, ctx)
    pending = {name: {key: torch.stack(vals) for key, vals in p.items()}
               for name, p in pend.items()}
    return logits, pending


def commit_spec_paged(cache, pending, n_accept, active, cfg: ModelConfig):
    """Paged commit: rows ``0..n_accept[b]`` of each active slot's pending
    k/v scatter through its block table into the shared pools (in place);
    rejected or inactive rows are dropped, and ``pos`` advances by
    ``n_accept + 1`` on active slots only.  bf16/fp32 pools."""
    pos = cache["pos"]
    bt = cache["block_tables"]
    nb = bt.shape[1]
    for name, c in cache["units"].items():
        pend = pending[name]
        ng, P, ps = c["k"].shape[0], c["k"].shape[1], c["k"].shape[2]
        Q = pend["k"].shape[2]
        i = torch.arange(Q, device=pos.device)[None, :]
        posq = pos[:, None].long() + i                       # (B, Q)
        page = torch.gather(bt.long(), 1, torch.clamp(posq // ps, max=nb - 1))
        row = page * ps + posq % ps
        ok = (i <= n_accept[:, None]) & (active[:, None] > 0)
        rows = row[ok]
        for key in ("k", "v"):
            pool = c[key]
            flat = pool.view(ng, P * ps, *pool.shape[3:])
            flat.index_copy_(1, rows, pend[key][:, ok].to(pool.dtype))
    adv = torch.where(active > 0, n_accept + 1, torch.zeros_like(n_accept))
    return {**cache, "pos": pos + adv.to(pos.dtype)}


def prefill_suffix(params, cache, tokens, n_commit, cfg: ModelConfig,
                   ctx: RunCtx = RunCtx()):
    """Chunked paged prefill: score a block of prompt-suffix tokens against
    a slot's cached prefix (the verify sweep with ``Q = chunk``) and commit
    each slot's first ``n_commit[b]`` rows.  Returns (logits, cache)."""
    logits, pending = verify_step(params, cache, tokens, cfg, ctx)
    active = (n_commit > 0).to(torch.int32)
    new_cache = commit_spec_paged(cache, pending, n_commit - 1, active, cfg)
    return logits, new_cache
