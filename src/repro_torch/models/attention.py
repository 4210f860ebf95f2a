"""GQA attention blocks of the port (RoPE / sliding window / logit
soft-cap): prefill, ring decode and verify, paged decode and verify, and
the decode over per-slot private rings at ragged positions, counterparts
of ``repro.models.attention``'s ``gqa_prefill``, ``gqa_decode``,
``gqa_verify``, ``gqa_decode_paged``, ``gqa_verify_paged`` and
``gqa_decode_ragged`` with the same shapes.

Parameters are a dict ``{"wq": (d, Hq, hd), "wk": (d, Hkv, hd),
"wv": (d, Hkv, hd), "wo": (Hq, hd, d)}``; weights are cast to the
activation dtype at use (a no-op once ``transformer.prepare_params`` has
cast them at load).  The decodes write their new k/v row into the ring
buffers or the shared page pools IN PLACE (``index_copy_`` at an index
computed on the device), where the JAX package returned updated (donated)
buffers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def _proj(x, w):
    """x (B, S, d) @ w (d, H, hd) -> (B, S, H, hd) in x.dtype."""
    B, S, d = x.shape
    H, hd = w.shape[1], w.shape[2]
    return (x.reshape(B * S, d) @ w.to(x.dtype).reshape(d, H * hd)
            ).reshape(B, S, H, hd)


def _out_proj(o, w):
    """o (B, S, Hq, hd) @ wo (Hq, hd, d) -> (B, S, d)."""
    B, S, H, hd = o.shape
    return (o.reshape(B * S, H * hd) @ w.to(o.dtype).reshape(H * hd, -1)
            ).reshape(B, S, -1)


def _mask_padded_heads(o, cfg: ModelConfig):
    """Zero the padded heads' outputs (exactly the published n_heads
    model); a no-op for configs without head padding."""
    if not cfg.heads_padded:
        return o
    mask = torch.arange(cfg.padded_q_heads, device=o.device) < cfg.n_heads
    return o * mask[..., None].to(o.dtype)


def _qkv(params, x, positions, cfg: ModelConfig):
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    q = common.apply_rope_partial(q, positions, cfg.rope_theta,
                                  cfg.rope_fraction)
    k = common.apply_rope_partial(k, positions, cfg.rope_theta,
                                  cfg.rope_fraction)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale or cfg.resolved_head_dim ** -0.5


def gqa_prefill(params, x, positions, cfg: ModelConfig, *, window: int = 0,
                cache_len: int, policy=ops.DEFAULT_POLICY):
    """Prefill: attention over the prompt, plus its (k, v) laid into a
    cache of capacity ``cache_len`` (ring layout, slot = pos % cache_len).
    x (B, S, d) -> (out (B, S, d), (k_c, v_c) (B, cache_len, Hkv, hd))."""
    q, k, v = _qkv(params, x, positions, cfg)
    o = ops.attention(q, k, v, causal=True, window=window,
                      logit_cap=cfg.attn_logit_softcap, scale=_scale(cfg),
                      policy=policy)
    o = _mask_padded_heads(o, cfg)
    out = _out_proj(o, params["wo"])
    S = x.shape[1]
    if cache_len >= S:
        pad = cache_len - S
        k_c = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v_c = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    else:   # ring: keep the last cache_len entries at slot pos % cache_len
        shift = S % cache_len
        k_c = torch.roll(k[:, -cache_len:], shift, dims=1)
        v_c = torch.roll(v[:, -cache_len:], shift, dims=1)
    return out, (k_c, v_c)


def gqa_decode(params, x, pos, cache_kv, cfg: ModelConfig, *,
               window: int = 0,
               policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """One-token decode against ring buffers.  x (B, 1, d); cache_kv =
    (k, v) of shape (B, C, Hkv, hd); pos a 0-d int32 tensor, the position
    of the new token.  Its k/v row goes to slot ``pos % C`` in place,
    before the sweep."""
    k_cache, v_cache = cache_kv
    C = k_cache.shape[1]
    q, k, v = _qkv(params, x, pos.reshape(1, 1), cfg)
    slot = torch.remainder(pos, C).long().reshape(1)
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    o = ops.decode_attention(q, k_cache, v_cache, pos, window=window,
                             logit_cap=cfg.attn_logit_softcap,
                             scale=_scale(cfg), policy=policy)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), (k_cache, v_cache)


def gqa_decode_ragged(params, x, pos, cache_kv, cfg: ModelConfig, *,
                      window: int = 0,
                      policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """One-token decode against per-slot PRIVATE ring buffers at ragged
    positions: the paged engine's windowed-layer decode.  x (B, 1, d);
    cache_kv = (k, v) of shape (B, C, Hkv, hd), views of the slots' ring
    pages; pos (B,) int32, each row's position.  Row b writes its k/v to
    ring slot ``pos[b] % C`` in place, then the ring sweep masks each row
    by its own ``pos`` (the kernel's per-row position)."""
    k_cache, v_cache = cache_kv
    B, C = k_cache.shape[0], k_cache.shape[1]
    q, k, v = _qkv(params, x, pos[:, None], cfg)
    row = torch.arange(B, device=pos.device) * C \
        + torch.remainder(pos, C).long()                   # (B,)
    k_cache.view(B * C, *k_cache.shape[2:]).index_copy_(
        0, row, k[:, 0].to(k_cache.dtype))
    v_cache.view(B * C, *v_cache.shape[2:]).index_copy_(
        0, row, v[:, 0].to(v_cache.dtype))
    o = ops.decode_attention(q, k_cache, v_cache, pos, window=window,
                             logit_cap=cfg.attn_logit_softcap,
                             scale=_scale(cfg), policy=policy)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), (k_cache, v_cache)


def gqa_verify(params, x, pos, cache_kv, cfg: ModelConfig, *,
               window: int = 0,
               policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """Speculative verify: score ``Q = K+1`` fed tokens at positions ``pos
    .. pos+Q-1`` in one sweep of the ring buffers (committed through
    ``pos - 1``).  Nothing is written: the block's own (k, v) (B, Q, Hkv,
    hd) come back as pending rows for ``transformer.commit_spec``."""
    k_cache, v_cache = cache_kv
    Q = x.shape[1]
    posq = pos.reshape(1, 1) + torch.arange(Q, device=pos.device)[None, :]
    q, k, v = _qkv(params, x, posq, cfg)
    o = ops.verify_attention(q, k_cache, v_cache, k, v, pos, window=window,
                             logit_cap=cfg.attn_logit_softcap,
                             scale=_scale(cfg), policy=policy)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), (k, v)


def gqa_decode_paged(params, x, pos, cache_kv, block_tables,
                     cfg: ModelConfig, *, window: int = 0,
                     policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """One-token decode against the paged KV cache.  x (B, 1, d);
    cache_kv = (k_pages, v_pages) pools (P, ps, Hkv, hd); block_tables
    (B, nb) int32; pos (B,) int32 per-request position of the new token.

    The new k/v row goes to physical row ``block_tables[b, pos[b] // ps]
    * ps + pos[b] % ps`` of the flattened pools, in place; slots parked on
    their scratch page overwrite that scratch harmlessly."""
    k_pages, v_pages = cache_kv
    P, ps = k_pages.shape[0], k_pages.shape[1]
    q, k, v = _qkv(params, x, pos[:, None], cfg)
    page = torch.gather(block_tables, 1,
                        (pos // ps)[:, None].long())[:, 0].long()
    row = page * ps + (pos % ps).long()                    # (B,)
    k_pages.view(P * ps, *k_pages.shape[2:]).index_copy_(
        0, row, k[:, 0].to(k_pages.dtype))
    v_pages.view(P * ps, *v_pages.shape[2:]).index_copy_(
        0, row, v[:, 0].to(v_pages.dtype))
    o = ops.paged_decode_attention(q, k_pages, v_pages, block_tables, pos,
                                   window=window,
                                   logit_cap=cfg.attn_logit_softcap,
                                   scale=_scale(cfg), policy=policy)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), (k_pages, v_pages)


def gqa_verify_paged(params, x, pos, cache_kv, block_tables,
                     cfg: ModelConfig, *, window: int = 0,
                     policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """Score ``Q`` fed tokens at positions ``pos .. pos+Q-1`` in one sweep
    of the pools (committed through ``pos[b] - 1``).  Nothing is written:
    the block's own (k, v) (B, Q, Hkv, hd) come back as pending rows for
    ``commit_spec_paged``.  Behind both speculative verify and the
    prefix-hit suffix prefill."""
    k_pages, v_pages = cache_kv
    Q = x.shape[1]
    posq = pos[:, None] + torch.arange(Q, device=pos.device)[None, :]
    q, k, v = _qkv(params, x, posq, cfg)
    o = ops.paged_verify_attention(q, k_pages, v_pages, k, v, block_tables,
                                   pos, window=window,
                                   logit_cap=cfg.attn_logit_softcap,
                                   scale=_scale(cfg), policy=policy)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), (k, v)
