"""The LM trunk of the port, every family of the JAX package: the dense
GQA family with its windowed members (gemma2's local/global layer pairs,
sliding-window layers), the SSM family (Mamba2 layers, ``models/ssm.py``),
deepseek-v2's MLA + MoE family with its first dense layers, the hybrid
family (zamba2: ``hybrid_attn_every`` Mamba2 layers a unit, then ONE
shared attention block, a single copy of its parameters, on
``concat(x, emb0)``) and the codebook family (musicgen: tokens (B, S,
n_cb), per-codebook embeddings summed, ``n_cb`` heads): the training
forward and its losses
(``forward``, ``lm_loss``, ``lm_loss_pre_shifted``, with ``remat``),
prefill, the decode step and the verify sweep over both cache layouts
(ring and paged), suffix prefill and the speculative commits —
counterparts of ``repro.models.transformer``'s functions of the same
names, with the same shapes and parameter layout.

Parameters are the nested dict of the JAX package (``embed``,
``layers/sub0/{norm1, attn/{wq,wk,wv,wo}, norm2, ffn/{wi_gate,wi_up,wo}}``
stacked on a leading ``n_units`` axis, ``final_norm``; an SSM layer's sub
is ``{pre_norm, wz, wx, wB, wC, wdt, conv_w, conv_b, A_log, D, dt_bias,
norm_scale, wout}``; an MLA sub's attn is ``{wdkv, kv_norm, wuk, wuv, wo,
wdq, q_norm, wuq}``, a MoE sub's ffn ``{router, wi_gate, wi_up, wo,
shared}``; ``dense_layers`` is a LIST of unstacked blocks run before the
units; the hybrid family's ``shared_attn`` is ``{w_in (2d, d), block}``,
one unstacked block; a codebook model's ``embed`` is (n_cb, Vp, d) and its
``lm_head`` (n_cb, d, Vp)), so a JAX checkpoint loads without reshaping
(``repro_torch.bridge``). Where JAX scanned over the stacked layers, the
port loops in Python.

The ring cache (``prefill``, ``init_cache``) is a dict ``{"pos": 0-d int32
tensor, "units": {"sub<i>": {"k", "v": (n_units, B, C, Hkv, hd)}}}`` with
position p at slot ``p % C``; a windowed sub's C is ``min(max_len,
window)``; an MLA sub holds one latent row per token, ``{"lat": (n_units,
B, C, R)}``, R = kv_lora_rank + rope_head_dim; the first dense layers add
``"dense"``, a list of one such dict per layer without the unit axis, and
the hybrid shared block ``"shared"``, ``{"k", "v": (n_units, B, C, Hkv,
hd)}``, one ring per application. The paged cache is ``{"pos": (n_slots,)
int32, "block_tables": (n_slots, max_blocks) int32, "units": {"sub<i>":
{"k", "v": (n_units, n_pages, page_size, Hkv, hd)}}}``; a windowed sub
holds a private ring of ``nbw`` pages per slot instead, (n_units, n_slots
* nbw, page_size, Hkv, hd); an MLA sub a latent pool ``{"lat": (n_units,
n_pages, page_size, R)}``; the first dense layers a stacked group
``"dense"`` of the same form, (n_dense, n_pages, ...), on the same page
ids; the hybrid shared block a per-slot linear buffer ``"shared"``,
``{"k", "v": (n_units, n_slots, max_len, Hkv, hd)}``, no table. An SSM sub
holds its recurrent state instead, in both layouts: ``{"conv": (n_units,
B, conv_width - 1, conv_dim), "ssm": (n_units, B, H, P, N) fp32}``, one
state slot per batch row or engine slot. Both are updated IN PLACE (the
decode writes and the commits go through ``index_copy_``), where JAX
donated the buffers and returned new ones; the functions still return the
cache dict, with a new ``pos``. The decode steps and the ring commit
compute their indices on the device and read nothing back to the host; the
paged commit reads its accepted-row count once per sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import quant
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import common, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NO_MESH, ParallelCtx, mlp_forward,
                                       moe_forward)

VOCAB_PAD = 256


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return (v + VOCAB_PAD - 1) // VOCAB_PAD * VOCAB_PAD


@dataclasses.dataclass(frozen=True)
class RunCtx:
    """How a step runs: its mesh (``parallel``: the all-to-all MoE reads
    it), its kernels, the activation constraint of its sharding rules
    (``constrain``, called on the trunk's embeddings and logits as in JAX;
    ``runtime.sharding.ShardingRules.constrain`` raises where it would
    shard) and the training forward's remat."""
    parallel: ParallelCtx = NO_MESH
    kernel_policy: ops.KernelPolicy = ops.DEFAULT_POLICY
    constrain: Callable | None = None
    remat: str = "none"          # none | dots | full (training forward)


def unit_size(cfg: ModelConfig) -> int:
    if cfg.local_global:
        return 2
    if is_hybrid(cfg):
        return cfg.hybrid_attn_every
    return 1


def n_units(cfg: ModelConfig) -> int:
    u = unit_size(cfg)
    body_layers = cfg.n_layers - cfg.first_dense_layers
    if body_layers % u:
        raise ValueError(f"{cfg.name}: {body_layers} layers not divisible by "
                         f"pattern unit {u}")
    return body_layers // u


def is_hybrid(cfg: ModelConfig) -> bool:
    """Does ``cfg`` carry the hybrid family's shared attention block?"""
    return cfg.family == "hybrid" and bool(cfg.hybrid_attn_every)


# ==========================================================================
# capability gates: what this port does not serve yet, by name
# ==========================================================================
def paged_cache_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """Named config features the port does not serve, on either cache
    layout.  Empty, as in the JAX package, for every family of the zoo;
    only heads padded past the published counts (a TPU sharding layout
    that no config of the zoo sets) are refused."""
    return ("heads_padded",) if cfg.heads_padded else ()


def supports_paged_cache(cfg: ModelConfig) -> bool:
    return not paged_cache_blockers(cfg)


def chunked_prefill_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """Named features blocking the paged multi-query sweep behind suffix
    prefill (the JAX package's list, plus what the port does not serve)."""
    checks = (("uses_ssm", cfg.uses_ssm),
              ("n_codebooks", bool(cfg.n_codebooks)),
              ("hybrid_attn_every", is_hybrid(cfg)),
              ("sliding_window", bool(cfg.sliding_window)),
              ("local_global", cfg.local_global))
    names = [name for name, on in checks if on]
    names += [b for b in paged_cache_blockers(cfg) if b not in names]
    return tuple(names)


def int8_paged_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """Features blocking the int8 paged storage mode (the JAX package's
    list): the per-row scale leaves pair with full-length k/v page pools,
    which SSM state slots, latent (MLA) pools, private windowed rings and
    the hybrid shared buffer do not carry."""
    checks = (("uses_ssm", cfg.uses_ssm), ("use_mla", cfg.use_mla),
              ("sliding_window", bool(cfg.sliding_window)),
              ("local_global", cfg.local_global),
              ("first_dense_layers", bool(cfg.first_dense_layers)),
              ("hybrid_attn_every", is_hybrid(cfg)))
    return tuple(name for name, on in checks if on)


def speculative_blockers(cfg: ModelConfig) -> tuple[str, ...]:
    """Named features blocking speculative verify/commit (the JAX
    package's list)."""
    checks = (("uses_ssm", cfg.uses_ssm), ("use_mla", cfg.use_mla),
              ("n_codebooks", bool(cfg.n_codebooks)),
              ("first_dense_layers", bool(cfg.first_dense_layers)),
              ("hybrid_attn_every", is_hybrid(cfg)))
    return tuple(name for name, on in checks if on)


def supports_speculative(cfg: ModelConfig) -> bool:
    return not speculative_blockers(cfg)


def _require_ported(cfg: ModelConfig) -> None:
    """Refuse, by name, what ``paged_cache_blockers`` names."""
    blockers = paged_cache_blockers(cfg)
    if blockers:
        raise NotImplementedError(f"{cfg.name}: {blockers[0]} is not ported "
                                  "to repro_torch yet")


# ==========================================================================
# parameters
# ==========================================================================
_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "wi_gate", "wi_up", "embed",
                "lm_head", "wz", "wx", "wB", "wC", "wdt", "wout", "wdkv",
                "wuk", "wuv", "wdq", "wuq", "router", "w_in")


def prepare_params(params, cfg: ModelConfig):
    """Cast the matmul weights once to the compute dtype ``cfg.dtype``
    (the JAX package casts them at every use — same values); norm scales
    keep ``param_dtype``, since rmsnorm reads them in fp32, and so do an
    SSM layer's ``A_log``, ``D``, ``dt_bias`` and ``norm_scale``; its
    ``conv_w`` and ``conv_b`` are cast at use, as in JAX; an MLA layer's
    ``kv_norm`` and ``q_norm`` too.  ``dense_layers`` is a list of blocks.
    The serving paths' one-time cast: training never goes through it, so
    that gradients land on the fp32 masters."""
    adt = common.dt(cfg.dtype)

    def walk(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif isinstance(val, list):
                out[key] = [walk(v) for v in val]
            elif key in _MATMUL_KEYS:
                out[key] = val.to(adt)
            else:
                out[key] = val
        return out

    return walk(params)


def _unstack(tree, n: int) -> list:
    """The stacked unit tree as ``n`` per-unit trees, one ``torch.unbind``
    a leaf: its backward stacks the units' gradients in one copy, where
    indexing unit l (``_layer``) gives each unit's gradient the stacked
    leaf's full size, zero-filled, and autograd then sums n of them."""
    out = [{} for _ in range(n)]
    for key, val in tree.items():
        parts = (_unstack(val, n) if isinstance(val, dict)
                 else torch.unbind(val, 0))
        for l in range(n):
            out[l][key] = parts[l]
    return out


def _layer(tree, l: int):
    """Layer ``l`` of a stacked parameter (sub)tree, as views."""
    return {k: _layer(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


# ==========================================================================
# embedding / head
# ==========================================================================
def embed_tokens(params, tokens, cfg: ModelConfig, ctx: RunCtx | None = None):
    """Token ids (B, S) -> (B, S, d); a codebook model's (B, S, n_cb) ->
    the sum of its per-codebook embeddings, added in codebook order."""
    adt = common.dt(cfg.dtype)
    tokens = tokens.long()
    if cfg.n_codebooks:
        embs = params["embed"].to(adt)                  # (n_cb, Vp, d)
        x = embs[0][tokens[..., 0]]
        for c in range(1, cfg.n_codebooks):
            x = x + embs[c][tokens[..., c]]
    else:
        x = params["embed"].to(adt)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=adt)
    if ctx is not None and ctx.constrain is not None:
        x = ctx.constrain(x, ("batch", None, "embed_act"))
    return x


def _constrain_logits(logits, cfg: ModelConfig, ctx: RunCtx | None):
    if ctx is None or ctx.constrain is None:
        return logits
    spec = ("batch", None, None, "vocab") if cfg.n_codebooks \
        else ("batch", None, "vocab")
    return ctx.constrain(logits, spec)


SOFTCAP_BLOCK = 2 ** 26     # logits per soft-cap block


def _head(params, x, cfg: ModelConfig):
    """x (B, S, d) -> logits (B, S, Vp); a codebook model's (B, S, n_cb,
    Vp), JAX's ``einsum("bsd,cdv->bscv")`` as one product a codebook."""
    adt = x.dtype
    if cfg.n_codebooks:
        head = params["lm_head"].to(adt)                # (n_cb, d, Vp)
        return torch.stack([x @ head[c] for c in range(cfg.n_codebooks)],
                           dim=2)
    if cfg.tie_embeddings:
        return x @ params["embed"].to(adt).T
    return x @ params["lm_head"].to(adt)


def lm_logits(params, x, cfg: ModelConfig, ctx: RunCtx | None = None):
    """The head, with the final soft-cap and the padded vocab tail masked
    to -1e30.  Both update the logits in place: the soft-cap a block of
    rows at a time, so that its fp32 temporary stays at ``SOFTCAP_BLOCK``
    values, where a whole long prefill's would be twice the logits."""
    Vp = padded_vocab(cfg)
    logits = _head(params, x, cfg)
    if cfg.final_logit_softcap > 0.0:
        flat = logits.view(-1, Vp)
        step = max(1, SOFTCAP_BLOCK // Vp)
        for i in range(0, flat.shape[0], step):
            flat[i:i + step] = common.softcap(flat[i:i + step],
                                              cfg.final_logit_softcap)
    if Vp != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return _constrain_logits(logits, cfg, ctx)


def _norm(x, scale, cfg: ModelConfig, ctx: RunCtx):
    return ops.rmsnorm(x, scale, eps=cfg.norm_eps, gemma_style=cfg.post_norms,
                       policy=ctx.kernel_policy)


def _ffn_aux(blk, x, a, cfg: ModelConfig, ctx: RunCtx):
    """Residual add of the attention output, then the MLP or MoE half:
    -> (x, the MoE's load-balance loss or None)."""
    if cfg.post_norms:
        a = _norm(a, blk["post_attn_norm"], cfg, ctx)
    x = x + a
    h = _norm(x, blk["norm2"], cfg, ctx)
    aux = None
    if "router" in blk["ffn"]:
        f, aux = moe_forward(blk["ffn"], h, cfg, ctx.parallel)
    else:
        f = mlp_forward(blk["ffn"], h, cfg)
    if cfg.post_norms:
        f = _norm(f, blk["post_ffn_norm"], cfg, ctx)
    return x + f, aux


def _ffn(blk, x, a, cfg: ModelConfig, ctx: RunCtx):
    return _ffn_aux(blk, x, a, cfg, ctx)[0]


# ==========================================================================
# full forward (training)
# ==========================================================================
def _apply_block(blk, x, positions, cfg: ModelConfig, ctx: RunCtx, *,
                 window: int, aux):
    """One attention sublayer and its FFN half; the MoE aux loss adds to
    ``aux`` (fp32 0-d)."""
    h = _norm(x, blk["norm1"], cfg, ctx)
    if cfg.use_mla:
        a = attn.mla_forward(blk["attn"], h, positions, cfg,
                             policy=ctx.kernel_policy)[0]
    else:
        a = attn.gqa_forward(blk["attn"], h, positions, cfg, window=window,
                             policy=ctx.kernel_policy)
    x, aux_l = _ffn_aux(blk, x, a, cfg, ctx)
    return x, aux if aux_l is None else aux + aux_l


def _shared_in(shared, x, emb0):
    """The hybrid shared block's input: ``concat(x, emb0) @ w_in``, 2d ->
    d (Zamba2's fused-input projection)."""
    return torch.cat([x, emb0], dim=-1) @ shared["w_in"].to(x.dtype)


def _apply_unit(unit, x, emb0, positions, cfg: ModelConfig, ctx: RunCtx,
                shared, aux):
    """One pattern unit; the hybrid family's shared block after it adds its
    residual delta ``out - h`` to the trunk."""
    for i in range(unit_size(cfg)):
        sub = unit[f"sub{i}"]
        if cfg.uses_ssm:
            h = _norm(x, sub["pre_norm"], cfg, ctx)
            x = x + ssm.mamba_forward(sub, h, cfg, policy=ctx.kernel_policy)
        else:
            x, aux = _apply_block(sub, x, positions, cfg, ctx,
                                  window=cfg.window_for_layer(i), aux=aux)
    if shared is not None:
        h = _shared_in(shared, x, emb0)
        out, aux = _apply_block(shared["block"], h, positions, cfg, ctx,
                                window=0, aux=aux)
        x = x + (out - h)
    return x, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the matmuls without batch
    dimensions (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
    as the JAX package uses it), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, ctx: RunCtx):
    """``fn`` under ``ctx.remat``: as it is (``none``), or checkpointed per
    unit, recomputing its whole forward (``full``) or all but its matmuls
    (``dots``) in the backward."""
    if ctx.remat == "none":
        return fn
    import functools

    from torch.utils import checkpoint as ckpt
    if ctx.remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if ctx.remat == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _dots_policy)
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          context_fn=context)
    raise ValueError(f"unknown remat {ctx.remat!r} (none | dots | full)")


def _train_logits(params, x, cfg: ModelConfig, ctx: RunCtx | None = None):
    """The head as the JAX package's ``lm_logits`` computes it, out of
    place (autograd records it): the final soft-cap in fp32, the padded
    vocab tail at -1e30."""
    adt = x.dtype
    logits = _head(params, x, cfg)
    cap = cfg.final_logit_softcap
    if cap > 0.0:
        logits = (cap * torch.tanh(logits.float() / cap)).to(adt)
    Vp = padded_vocab(cfg)
    if Vp != cfg.vocab_size:
        keep = torch.arange(Vp, device=x.device) < cfg.vocab_size
        logits = torch.where(keep, logits,
                             torch.tensor(-1e30, dtype=adt, device=x.device))
    return _constrain_logits(logits, cfg, ctx)


def forward(params, tokens, cfg: ModelConfig, ctx: RunCtx = RunCtx(), *,
            extra_embeds=None):
    """Token ids (B, S) (a codebook model's (B, S, n_cb)) -> (logits (B,
    S', Vp) (B, S', n_cb, Vp), aux): the training forward,
    differentiable with respect to ``params`` (fp32 masters, cast to
    ``cfg.dtype`` at use; never through ``prepare_params``).
    ``extra_embeds`` (B, n_img, d) is the LLaVA vision prefix, put ahead of
    the token embeddings (S' = n_img + S); ``aux`` the MoE load-balance
    loss (fp32 0-d).  ``ctx.remat`` checkpoints each unit (the hybrid
    shared block with it)."""
    _require_ported(cfg)
    x = embed_tokens(params, tokens, cfg, ctx)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    emb0 = x
    shared = params.get("shared_attn")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.get("dense_layers", []):
        x, aux = _apply_block(blk, x, positions, cfg, ctx,
                              window=cfg.sliding_window, aux=aux)

    def body(x, aux, unit):
        return _apply_unit(unit, x, emb0, positions, cfg, ctx, shared, aux)

    body = _remat(body, ctx)
    for unit in _unstack(params["layers"], n_units(cfg)):
        x, aux = body(x, aux, unit)
    x = _norm(x, params["final_norm"], cfg, ctx)
    return _train_logits(params, x, cfg, ctx), aux


def _codebook_ce(logits, labels, cfg: ModelConfig):
    """The mean over codebooks of each codebook's CE."""
    losses = [common.cross_entropy(logits[:, :, c], labels[..., c])
              for c in range(cfg.n_codebooks)]
    return sum(losses) / cfg.n_codebooks


def lm_loss(params, tokens, cfg: ModelConfig, ctx: RunCtx = RunCtx(), *,
            extra_embeds=None):
    """Next-token CE (+ MoE aux); image-prefix positions carry no loss.  A
    codebook model's loss is the mean CE over its codebooks, no label
    masked (as in JAX)."""
    if cfg.n_codebooks:
        logits, aux = forward(params, tokens[:, :-1], cfg, ctx)
        return _codebook_ce(logits, tokens[:, 1:], cfg) + aux
    inputs, labels, mask = common.shift_labels(tokens)
    logits, aux = forward(params, inputs, cfg, ctx, extra_embeds=extra_embeds)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    return common.cross_entropy(logits, labels, mask) + aux


def lm_loss_pre_shifted(params, inputs, targets, cfg: ModelConfig,
                        ctx: RunCtx = RunCtx(), *, extra_embeds=None):
    """CE of a pre-shifted (inputs, targets) pair (+ MoE aux), as the data
    pipeline emits them; the mean over codebooks for a codebook model."""
    logits, aux = forward(params, inputs, cfg, ctx, extra_embeds=extra_embeds)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    if cfg.n_codebooks:
        return _codebook_ce(logits, targets, cfg) + aux
    return common.cross_entropy(logits, targets) + aux


# ==========================================================================
# prefill
# ==========================================================================
def _stack_layer(units, name: str, l: int, nu: int, leaves: dict) -> None:
    """Write layer ``l``'s cache leaves into the stacked cache of sub
    ``name``, allocated at layer 0: the cache is filled layer by layer."""
    if l == 0:
        units[name] = {key: t.new_empty((nu, *t.shape))
                       for key, t in leaves.items()}
    for key, t in leaves.items():
        units[name][key][l] = t


def _ssm_state(cfg: ModelConfig, batch: int, dtype, device):
    """Zero-filled recurrent state of one SSM sub, one slot per batch row:
    the conv tail in the cache dtype, the SSM state in fp32."""
    H, P, N = cfg.resolved_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    nu = n_units(cfg)
    return {"conv": torch.zeros((nu, batch, cfg.conv_width - 1,
                                 ssm.conv_dim(cfg)), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((nu, batch, H, P, N),
                               dtype=torch.float32, device=device)}


def _block_prefill(blk, x, positions, cfg: ModelConfig, ctx: RunCtx, *,
                   window: int, cache_len: int):
    """One attention sublayer over the prompt, plus its cache leaves:
    ``{"lat"}`` for MLA, ``{"k", "v"}`` otherwise."""
    h = _norm(x, blk["norm1"], cfg, ctx)
    if cfg.use_mla:
        a, lat = attn.mla_prefill(blk["attn"], h, positions, cfg,
                                  cache_len=cache_len,
                                  policy=ctx.kernel_policy)
        c = {"lat": lat}
    else:
        a, (k, v) = attn.gqa_prefill(blk["attn"], h, positions, cfg,
                                     window=window, cache_len=cache_len,
                                     policy=ctx.kernel_policy)
        c = {"k": k, "v": v}
    return _ffn(blk, x, a, cfg, ctx), c


def _ssm_decode(blk, x, c, l: int, cfg: ModelConfig, ctx: RunCtx):
    """One decode step of an SSM sub of layer ``l``: every state slot
    advances (parked engine slots too, as in JAX), written in place."""
    h = _norm(x, blk["pre_norm"], cfg, ctx)
    out, (conv, state) = ssm.mamba_decode(blk, h, (c["conv"][l],
                                                   c["ssm"][l]), cfg)
    c["conv"][l].copy_(conv)
    c["ssm"][l].copy_(state)
    return x + out


def prefill(params, tokens, cfg: ModelConfig, ctx: RunCtx = RunCtx(), *,
            max_len: int = 0, full_cache: bool = False):
    """Process the whole prompt and build its decode cache.

    tokens (B, S) -> (logits (B, S, Vp), cache) with the ring cache
    ``{"pos": S (0-d int32 on the tokens' device), "units": {"sub<i>":
    {"k", "v": (n_units, B, C, Hkv, hd)}}}``: position p at slot ``p % C``
    (linear while ``S <= C``), C = ``max_len``, or ``min(max_len, window)``
    for a windowed sub.  ``full_cache=True`` keeps the windowed subs
    linear at ``max_len`` too: the engine's page inject needs the rows of
    a padded prompt bucket in place, since in the ring layout the pad rows
    would overwrite the real window tail (the window still masks the
    scores).  An SSM sub's cache is its recurrent state after the prompt
    (``mamba_forward(..., return_state=True)``): every prompt token enters
    it, so the engine prefills SSM prompts at their exact length.  The
    first dense layers run before the units, each into its own entry of
    the ``"dense"`` list; the hybrid shared block's applications fill
    ``"shared"`` (capacity ``max_len``), its input built from ``emb0``, the
    prompt's embeddings.  A codebook model's tokens are (B, S, n_cb) and
    its logits (B, S, n_cb, Vp)."""
    _require_ported(cfg)
    x = embed_tokens(params, tokens, cfg, ctx)
    B, S = x.shape[:2]
    max_len = max_len or max(cfg.max_seq_len, S)
    positions = torch.arange(S, device=x.device)[None, :]
    emb0 = x
    shared = params.get("shared_attn")
    held = {}
    dense = []
    for blk in params.get("dense_layers", []):
        w = cfg.sliding_window
        cap = min(max_len, w) if (w and not full_cache) else max_len
        x, c = _block_prefill(blk, x, positions, cfg, ctx, window=w,
                              cache_len=cap)
        dense.append(c)
    nu = n_units(cfg)
    units = {}
    for l in range(nu):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            blk = unit[f"sub{i}"]
            if cfg.uses_ssm:
                h = _norm(x, blk["pre_norm"], cfg, ctx)
                out, (conv, state) = ssm.mamba_forward(
                    blk, h, cfg, policy=ctx.kernel_policy, return_state=True)
                x = x + out
                _stack_layer(units, f"sub{i}", l, nu,
                             {"conv": conv, "ssm": state})
                continue
            w = cfg.window_for_layer(i)
            cap = min(max_len, w) if (w > 0 and not full_cache) else max_len
            x, c = _block_prefill(blk, x, positions, cfg, ctx, window=w,
                                  cache_len=cap)
            _stack_layer(units, f"sub{i}", l, nu, c)
        if shared is not None:
            h = _shared_in(shared, x, emb0)
            out, c = _block_prefill(shared["block"], h, positions, cfg, ctx,
                                    window=0, cache_len=max_len)
            x = x + (out - h)
            _stack_layer(held, "shared", l, nu, c)
    x = _norm(x, params["final_norm"], cfg, ctx)
    logits = lm_logits(params, x, cfg, ctx)
    pos = torch.tensor(S, dtype=torch.int32, device=x.device)
    cache = {"pos": pos, "units": units}
    if dense:
        cache["dense"] = dense
    cache.update(held)
    return logits, cache


# ==========================================================================
# ring cache, decode, verify, commit (the static batch path)
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: str = "bfloat16", device=None):
    """Zero-filled ring decode cache: per-unit k/v ring buffers of capacity
    ``max_len`` (``min(max_len, window)`` for a windowed sub), or one
    latent row per slot for MLA, ``pos`` 0; an SSM sub's zero state, one
    slot per batch row; the first dense layers' list of caches of
    capacity ``max_len``; the hybrid shared block's rings ``"shared"``,
    one an application, of capacity ``max_len`` (``min(max_len, window)``
    under a sliding window, as in JAX)."""
    _require_ported(cfg)
    if dtype == "int8":
        # the JAX ring would cast to int8 without scales; int8 KV is the
        # paged engine's storage mode (init_paged_cache)
        raise NotImplementedError("int8 ring KV caches: no scale leaves; "
                                  "int8 KV pages are the paged engine's")
    adt = common.dt(dtype)
    hd, hkv = cfg.resolved_head_dim, cfg.padded_kv_heads
    R = cfg.kv_lora_rank + cfg.rope_head_dim

    def attn_cache(lead):
        if cfg.use_mla:
            return {"lat": torch.zeros((*lead, R), dtype=adt, device=device)}
        return {key: torch.zeros((*lead, hkv, hd), dtype=adt, device=device)
                for key in ("k", "v")}

    units = {}
    for i in range(unit_size(cfg)):
        if cfg.uses_ssm:
            units[f"sub{i}"] = _ssm_state(cfg, batch, adt, device)
            continue
        w = cfg.window_for_layer(i)
        cap = min(max_len, w) if w > 0 else max_len
        units[f"sub{i}"] = attn_cache((n_units(cfg), batch, cap))
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             "units": units}
    if cfg.first_dense_layers:
        cache["dense"] = [attn_cache((batch, max_len))
                          for _ in range(cfg.first_dense_layers)]
    if is_hybrid(cfg):
        w = cfg.sliding_window
        cap = min(max_len, w) if w else max_len
        cache["shared"] = {key: torch.zeros((n_units(cfg), batch, cap, hkv,
                                             hd), dtype=adt, device=device)
                           for key in ("k", "v")}
    return cache


def _pos_tensor(pos, device) -> torch.Tensor:
    return torch.as_tensor(pos, dtype=torch.int32, device=device)


def _block_decode(blk, x, pos, c, cfg: ModelConfig, ctx: RunCtx, *,
                  window: int, block_tables=None, private: bool = False):
    """One attention sublayer's decode step against this layer's cache
    leaves ``c`` (views, written in place): the MLA latent pool or ring,
    a windowed sub's private rings (paged), the slots' private buffers
    (paged, ``private``: the hybrid shared block's, decoded as rings that
    never wrap, each row at its own position), the shared k/v pools
    (paged) or the ring buffers."""
    h = _norm(x, blk["norm1"], cfg, ctx)
    pol = ctx.kernel_policy
    if cfg.use_mla and block_tables is not None:
        a, _ = attn.mla_decode_paged(blk["attn"], h, pos, c["lat"],
                                     block_tables, cfg, policy=pol)
    elif cfg.use_mla:
        a, _ = attn.mla_decode(blk["attn"], h, pos, c["lat"], cfg,
                               policy=pol)
    elif block_tables is not None and (window > 0 or private):
        B = pos.shape[0]
        ring = tuple(c[key].view(B, -1, *c[key].shape[2:])
                     for key in ("k", "v"))
        a, _ = attn.gqa_decode_ragged(blk["attn"], h, pos, ring, cfg,
                                      window=window, policy=pol)
    elif block_tables is not None:
        a, _ = attn.gqa_decode_paged(blk["attn"], h, pos, _kv_leaves(c),
                                     block_tables, cfg, window=window,
                                     policy=pol)
    else:
        a, _ = attn.gqa_decode(blk["attn"], h, pos, (c["k"], c["v"]), cfg,
                               window=window, policy=pol)
    return _ffn(blk, x, a, cfg, ctx)


def _kv_leaves(c) -> tuple:
    """A paged sub's (k, v) pools, with their scale leaves for int8."""
    if "k_scale" in c:
        return c["k"], c["v"], c["k_scale"], c["v_scale"]
    return c["k"], c["v"]


def _group_layer(group, l: int) -> dict:
    """Layer ``l``'s leaves of a stacked cache group, as views."""
    return {key: t[l] for key, t in group.items()}


def decode_step(params, cache, tokens, cfg: ModelConfig,
                ctx: RunCtx = RunCtx(), *, active=None):
    """One decode step: tokens (B, 1) (a codebook model's (B, 1, n_cb)) +
    cache -> (logits (B, 1, Vp) (or (B, 1, n_cb, Vp)), cache with ``pos``
    advanced).  The two layouts share this seam, told apart by the cache's
    keys as in the JAX package: the ring (scalar ``pos``) and the paged
    layout (``block_tables``; ``active`` gates which slots advance there).
    The hybrid shared block decodes after each unit, its input built from
    this token's embedding."""
    if "block_tables" in cache:
        return _paged_decode_step(params, cache, tokens, cfg, ctx, active)
    _require_ported(cfg)
    x = embed_tokens(params, tokens, cfg, ctx)
    emb0 = x
    shared = params.get("shared_attn")
    pos = _pos_tensor(cache["pos"], x.device)
    for blk, c in zip(params.get("dense_layers", []), cache.get("dense", [])):
        x = _block_decode(blk, x, pos, c, cfg, ctx,
                          window=cfg.sliding_window)
    for l in range(n_units(cfg)):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            blk, c = unit[f"sub{i}"], cache["units"][f"sub{i}"]
            if cfg.uses_ssm:
                x = _ssm_decode(blk, x, c, l, cfg, ctx)
                continue
            x = _block_decode(blk, x, pos, _group_layer(c, l), cfg, ctx,
                              window=cfg.window_for_layer(i))
        if shared is not None:
            h = _shared_in(shared, x, emb0)
            x = x + (_block_decode(shared["block"], h, pos,
                                   _group_layer(cache["shared"], l), cfg,
                                   ctx, window=0) - h)
    x = _norm(x, params["final_norm"], cfg, ctx)
    logits = lm_logits(params, x, cfg, ctx)
    return logits, {**cache, "pos": pos + 1}


def commit_spec(cache, pending, n_accept, cfg: ModelConfig):
    """Ring commit: rows ``0..n_accept`` of the pending k/v (t_last plus
    the accepted drafts) go to slots ``(pos + i) % C`` and ``pos`` advances
    by ``n_accept + 1``.  All Q target slots are computed on the device;
    rejected rows write back what the slot already holds (the JAX package
    drops them out of bounds), so the commit reads nothing back to the
    host.  Needs Q <= C, so that the slots are distinct."""
    del cfg
    units = cache["units"]
    pos = _pos_tensor(cache["pos"], units["sub0"]["k"].device)
    for name, c in units.items():
        pend = pending[name]
        Q, C = pend["k"].shape[2], c["k"].shape[2]
        if Q > C:
            raise ValueError(f"verify block {Q} exceeds cache capacity {C}")
        i = torch.arange(Q, device=pos.device)
        slots = torch.remainder(pos + i, C).long()
        keep = (i <= n_accept).reshape(1, 1, Q, 1, 1)
        for key in ("k", "v"):
            buf = c[key]
            rows = torch.where(keep, pend[key].to(buf.dtype),
                               buf.index_select(2, slots))
            buf.index_copy_(2, slots, rows)
    return {**cache, "pos": (pos + n_accept + 1).to(pos.dtype)}


# ==========================================================================
# paged cache, decode, verify, commit
# ==========================================================================
def init_paged_cache(cfg: ModelConfig, n_slots: int, n_pages: int,
                     page_size: int, max_blocks: int,
                     dtype: str = "bfloat16", device=None):
    """Zero-filled paged decode cache, one block table and one position
    counter per slot.  A full-attention sub holds k/v page pools shared by
    every slot, addressed through the block tables; a windowed sub holds a
    PRIVATE ring of ``nbw = ceil(min(max_len, window) / page_size)`` pages
    per slot, pool (n_units, n_slots * nbw, page_size, Hkv, hd), slot s's
    ring being pages ``s * nbw .. s * nbw + nbw - 1`` (no table): O(window)
    bytes per slot however deep its stream runs.  An SSM sub holds one
    state slot per engine slot instead, (n_units, n_slots, ...): no pages,
    no table.  An MLA sub holds ONE latent pool (n_units, n_pages,
    page_size, R) on the block tables, a single row per token shared by
    every head; the first dense layers a stacked group ``"dense"``
    (n_dense, n_pages, page_size, ...) on the same page ids.  The hybrid
    shared block holds a linear buffer per slot, ``"shared"`` (n_units,
    n_slots, max_len, Hkv, hd), position p of slot s at row p: no table.

    ``dtype="int8"`` selects the quantized storage mode: int8 k/v pools
    plus per-row, per-kv-head fp32 scale leaves ``k_scale`` / ``v_scale``
    (n_units, n_pages, page_size, Hkv, 1).  Rows are quantized once, when
    they are written, and never rescale; the seams downstream tell the
    mode by ``"k_scale" in`` a sub.  A config with int8 blockers raises
    naming the first."""
    _require_ported(cfg)
    quantized = dtype == "int8"
    if quantized:
        i8_block = int8_paged_blockers(cfg)
        if i8_block:
            raise ValueError(f"{cfg.name}: int8 paged cache blocked by "
                             f"{i8_block[0]}")
    adt = torch.int8 if quantized else common.dt(dtype)
    hd = cfg.resolved_head_dim
    nu = n_units(cfg)
    hkv = cfg.padded_kv_heads
    R = cfg.kv_lora_rank + cfg.rope_head_dim
    max_len = max_blocks * page_size

    def pools(lead):
        if cfg.use_mla:
            return {"lat": torch.zeros((*lead, R), dtype=adt, device=device)}
        return {key: torch.zeros((*lead, hkv, hd), dtype=adt, device=device)
                for key in ("k", "v")}

    units = {}
    for i in range(unit_size(cfg)):
        if cfg.uses_ssm:
            units[f"sub{i}"] = _ssm_state(cfg, n_slots, adt, device)
            continue
        w = 0 if cfg.use_mla else cfg.window_for_layer(i)
        n = n_slots * -(-min(max_len, w) // page_size) if w > 0 else n_pages
        units[f"sub{i}"] = pools((nu, n, page_size))
        if quantized:
            for key in ("k_scale", "v_scale"):
                units[f"sub{i}"][key] = torch.zeros(
                    (nu, n_pages, page_size, hkv, 1), dtype=torch.float32,
                    device=device)
    cache = {"pos": torch.zeros((n_slots,), dtype=torch.int32,
                                device=device),
             "block_tables": torch.zeros((n_slots, max_blocks),
                                         dtype=torch.int32, device=device),
             "units": units}
    if cfg.first_dense_layers:
        cache["dense"] = pools((cfg.first_dense_layers, n_pages, page_size))
    if is_hybrid(cfg):
        cache["shared"] = pools((nu, n_slots, max_len))
    return cache


def _paged_decode_step(params, cache, tokens, cfg: ModelConfig, ctx: RunCtx,
                       active=None):
    """One decode step over the paged cache: tokens (B, 1) -> (logits
    (B, 1, Vp), cache with pos advanced where ``active``).  Parked slots
    keep rewriting row ``pos[b]`` of their scratch page (or of their
    private ring); the engine drops their tokens.  A windowed sub decodes
    against the slots' private rings, viewed as (B, nbw * page_size, Hkv,
    hd), at each slot's own position.  An SSM sub advances every slot's
    state, parked slots included (the engine's inject overwrites a slot's
    state when a request joins).  The hybrid shared block decodes against
    the slots' linear buffers as rings of ``max_len`` rows, each row at
    its own position, where JAX sweeps them as pages behind an identity
    table: the same rows, the same masks; a parked slot rewrites row
    ``pos[b]`` of its own buffer, which the next join's inject
    overwrites."""
    _require_ported(cfg)
    pos = cache["pos"]
    bt = cache["block_tables"]
    x = embed_tokens(params, tokens, cfg, ctx)
    emb0 = x
    shared = params.get("shared_attn")
    for j, blk in enumerate(params.get("dense_layers", [])):
        x = _block_decode(blk, x, pos, _group_layer(cache["dense"], j), cfg,
                          ctx, window=cfg.sliding_window, block_tables=bt)
    for l in range(n_units(cfg)):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            blk, c = unit[f"sub{i}"], cache["units"][f"sub{i}"]
            if cfg.uses_ssm:
                x = _ssm_decode(blk, x, c, l, cfg, ctx)
                continue
            x = _block_decode(blk, x, pos, _group_layer(c, l), cfg, ctx,
                              window=cfg.window_for_layer(i),
                              block_tables=bt)
        if shared is not None:
            h = _shared_in(shared, x, emb0)
            x = x + (_block_decode(shared["block"], h, pos,
                                   _group_layer(cache["shared"], l), cfg,
                                   ctx, window=0, block_tables=bt,
                                   private=True) - h)
    x = _norm(x, params["final_norm"], cfg, ctx)
    logits = lm_logits(params, x, cfg, ctx)
    adv = torch.ones_like(pos) if active is None else active.to(pos.dtype)
    return logits, {**cache, "pos": pos + adv}


def _block_verify(blk, x, pos, c, cfg: ModelConfig, ctx: RunCtx, *,
                  window: int, block_tables=None):
    """_block_decode's multi-query sibling: scores the fed block in one
    sweep of this layer's cache and returns its PENDING rows (``{"lat"}``
    for MLA, ``{"k", "v"}`` otherwise) instead of writing them."""
    h = _norm(x, blk["norm1"], cfg, ctx)
    pol = ctx.kernel_policy
    if cfg.use_mla:         # paged only: the ring gate names use_mla
        a, lat = attn.mla_verify_paged(blk["attn"], h, pos, c["lat"],
                                       block_tables, cfg, policy=pol)
        pend = {"lat": lat}
    elif block_tables is not None:
        a, (k, v) = attn.gqa_verify_paged(blk["attn"], h, pos,
                                          _kv_leaves(c), block_tables,
                                          cfg, window=window, policy=pol)
        pend = {"k": k, "v": v}
    else:
        a, (k, v) = attn.gqa_verify(blk["attn"], h, pos, (c["k"], c["v"]),
                                    cfg, window=window, policy=pol)
        pend = {"k": k, "v": v}
    return _ffn(blk, x, a, cfg, ctx), pend


def _stack_pending(rows: list) -> dict:
    return {key: torch.stack([p[key] for p in rows]) for key in rows[0]}


def verify_step(params, cache, tokens, cfg: ModelConfig,
                ctx: RunCtx = RunCtx()):
    """Score ``Q`` fed tokens (B, Q) at positions ``pos .. pos+Q-1`` in ONE
    sweep of the cache, ring or paged (told apart as in ``decode_step``).
    Returns (logits (B, Q, Vp), pending) with pending ``{"sub0": {"k", "v":
    (n_units, B, Q, Hkv, hd)}}`` (``{"lat": (n_units, B, Q, R)}`` for MLA;
    the first dense layers' rows under ``"__dense__"``, stacked over the
    layers) — nothing is committed until :func:`commit_spec` /
    :func:`commit_spec_paged`.  The ring sweep needs
    ``speculative_blockers`` empty, the paged one
    ``chunked_prefill_blockers``."""
    paged = "block_tables" in cache
    blockers = chunked_prefill_blockers(cfg) if paged \
        else speculative_blockers(cfg)
    if blockers:
        kind = "paged verify sweep" if paged else "speculative decode"
        raise ValueError(f"{cfg.name}: {kind} blocked by {blockers[0]}")
    _require_ported(cfg)
    bt = cache.get("block_tables")
    x = embed_tokens(params, tokens, cfg, ctx)
    pos = cache["pos"] if paged else _pos_tensor(cache["pos"], x.device)
    dense = []
    for j, blk in enumerate(params.get("dense_layers", [])):
        x, p = _block_verify(blk, x, pos, _group_layer(cache["dense"], j),
                             cfg, ctx, window=cfg.sliding_window,
                             block_tables=bt)
        dense.append(p)
    pend = {f"sub{i}": [] for i in range(unit_size(cfg))}
    for l in range(n_units(cfg)):
        unit = _layer(params["layers"], l)
        for i in range(unit_size(cfg)):
            c = _group_layer(cache["units"][f"sub{i}"], l)
            # paged sweeps run window-free, as in JAX
            w = 0 if paged else cfg.window_for_layer(i)
            x, p = _block_verify(unit[f"sub{i}"], x, pos, c, cfg, ctx,
                                 window=w, block_tables=bt)
            pend[f"sub{i}"].append(p)
    x = _norm(x, params["final_norm"], cfg, ctx)
    logits = lm_logits(params, x, cfg, ctx)
    pending = {name: _stack_pending(rows) for name, rows in pend.items()}
    if dense:
        pending["__dense__"] = _stack_pending(dense)
    return logits, pending


def _commit_group(c, pend, pos, bt, n_accept, active) -> None:
    """Scatter rows ``0..n_accept[b]`` of each active slot's pending rows
    through its block table into one stacked pool group, in place.  An
    int8 group quantizes its k/v rows here and writes each row's scale
    through the same index."""
    keys = [key for key in ("k", "v", "lat") if key in c]
    ng, P, ps = c[keys[0]].shape[:3]
    nb = bt.shape[1]
    Q = pend[keys[0]].shape[2]
    i = torch.arange(Q, device=pos.device)[None, :]
    posq = pos[:, None].long() + i                           # (B, Q)
    page = torch.gather(bt.long(), 1, torch.clamp(posq // ps, max=nb - 1))
    row = page * ps + posq % ps
    ok = (i <= n_accept[:, None]) & (active[:, None] > 0)
    rows = row[ok]

    def scatter(pool, vals):
        flat = pool.view(ng, P * ps, *pool.shape[3:])
        flat.index_copy_(1, rows, vals.to(pool.dtype))

    for key in keys:
        vals = pend[key][:, ok]
        if key + "_scale" in c:
            vals, scales = quant.quantize_int8_rows(vals)
            scatter(c[key + "_scale"], scales)
        scatter(c[key], vals)


def commit_spec_paged(cache, pending, n_accept, active, cfg: ModelConfig):
    """Paged commit: rows ``0..n_accept[b]`` of each active slot's pending
    k/v (or latent) rows scatter through its block table into the shared
    pools (in place), the first dense layers' into ``cache["dense"]`` on
    the same page ids; rejected or inactive rows are dropped, and ``pos``
    advances by ``n_accept + 1`` on active slots only.  int8 pools
    quantize the accepted rows per row at commit, their scales written
    beside them."""
    del cfg
    pos = cache["pos"]
    bt = cache["block_tables"]
    for name, c in cache["units"].items():
        _commit_group(c, pending[name], pos, bt, n_accept, active)
    if "__dense__" in pending:
        _commit_group(cache["dense"], pending["__dense__"], pos, bt,
                      n_accept, active)
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
