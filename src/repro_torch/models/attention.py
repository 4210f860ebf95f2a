"""Attention blocks of the port.  GQA (RoPE / sliding window / logit
soft-cap): prefill, ring decode and verify, paged decode and verify, and
the decode over per-slot private rings at ragged positions, counterparts
of ``repro.models.attention``'s ``gqa_forward``, ``gqa_prefill``,
``gqa_decode``,
``gqa_verify``, ``gqa_decode_paged``, ``gqa_verify_paged`` and
``gqa_decode_ragged`` with the same shapes.  MLA (deepseek-v2): the
counterparts of ``mla_forward``, ``mla_prefill``, ``mla_decode`` (ring),
``mla_decode_paged`` and ``mla_verify_paged``, whose cache is one
compressed latent row ``[c_kv | k_rope]`` (R = kv_lora_rank +
rope_head_dim) per token, shared by every head.

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

from repro_torch import quant
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


def _gqa_attend(params, x, positions, cfg: ModelConfig, *, window: int,
                policy):
    """Causal attention over the whole sequence: -> (out (B, S, d), k, v)."""
    q, k, v = _qkv(params, x, positions, cfg)
    o = ops.attention(q, k, v, causal=True, window=window,
                      logit_cap=cfg.attn_logit_softcap, scale=_scale(cfg),
                      policy=policy)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), k, v


def gqa_forward(params, x, positions, cfg: ModelConfig, *, window: int = 0,
                policy=ops.DEFAULT_POLICY):
    """Full-sequence attention (training).  x (B, S, d) -> (B, S, d).  On
    the card, with a gradient, K4 runs forward and backward (its autograd
    function); the padded heads' outputs are zeroed, so their weight
    slices get zero gradient."""
    return _gqa_attend(params, x, positions, cfg, window=window,
                       policy=policy)[0]


def gqa_prefill(params, x, positions, cfg: ModelConfig, *, window: int = 0,
                cache_len: int, policy=ops.DEFAULT_POLICY):
    """Prefill: attention over the prompt, plus its (k, v) laid into a
    cache of capacity ``cache_len`` (ring layout, slot = pos % cache_len).
    x (B, S, d) -> (out (B, S, d), (k_c, v_c) (B, cache_len, Hkv, hd))."""
    out, k, v = _gqa_attend(params, x, positions, cfg, window=window,
                            policy=policy)
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


def _decode_rows(block_tables, pos, ps: int):
    """Flat pool row of each slot's new token, ``block_tables[b, pos[b] //
    ps] * ps + pos[b] % ps``.  A position past the table's width (a
    chunk's overrun past ``max_len``, after the request's budget is spent,
    as after a requeue that folded its tokens into the prompt) writes to
    the slot's scratch page ``b``, as a block not yet allocated does."""
    nb = block_tables.shape[1]
    blk = (pos // ps).long()
    page = torch.gather(block_tables, 1,
                        blk.clamp(max=nb - 1)[:, None])[:, 0].long()
    scratch = torch.arange(pos.shape[0], device=pos.device)
    return torch.where(blk < nb, page, scratch) * ps + (pos % ps).long()


def gqa_decode_paged(params, x, pos, cache_kv, block_tables,
                     cfg: ModelConfig, *, window: int = 0,
                     policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """One-token decode against the paged KV cache.  x (B, 1, d);
    cache_kv = (k_pages, v_pages) pools (P, ps, Hkv, hd); block_tables
    (B, nb) int32; pos (B,) int32 per-request position of the new token.

    The new k/v row goes to physical row ``block_tables[b, pos[b] // ps]
    * ps + pos[b] % ps`` of the flattened pools, in place; slots parked on
    their scratch page overwrite that scratch harmlessly.

    ``cache_kv`` may be the 4-tuple ``(k_pages, v_pages, k_scales,
    v_scales)`` of int8 pools with per-row fp32 scales (P, ps, Hkv, 1):
    the new row is quantized per kv-head row, its scale written at the
    same physical row, and the scales ride into the sweep for its fused
    dequant.  Returns the cache in the arity it came."""
    k_pages, v_pages = cache_kv[:2]
    P, ps = k_pages.shape[0], k_pages.shape[1]
    q, k, v = _qkv(params, x, pos[:, None], cfg)
    row = _decode_rows(block_tables, pos, ps)              # (B,)
    k_row, v_row = k[:, 0], v[:, 0]                        # (B, Hkv, hd)
    k_scales = v_scales = None
    if len(cache_kv) == 4:
        k_scales, v_scales = cache_kv[2:]
        k_row, ks_row = quant.quantize_int8_rows(k_row)
        v_row, vs_row = quant.quantize_int8_rows(v_row)
        k_scales.view(P * ps, *k_scales.shape[2:]).index_copy_(0, row, ks_row)
        v_scales.view(P * ps, *v_scales.shape[2:]).index_copy_(0, row, vs_row)
    k_pages.view(P * ps, *k_pages.shape[2:]).index_copy_(
        0, row, k_row.to(k_pages.dtype))
    v_pages.view(P * ps, *v_pages.shape[2:]).index_copy_(
        0, row, v_row.to(v_pages.dtype))
    o = ops.paged_decode_attention(q, k_pages, v_pages, block_tables, pos,
                                   window=window,
                                   logit_cap=cfg.attn_logit_softcap,
                                   scale=_scale(cfg), policy=policy,
                                   k_scale=k_scales, v_scale=v_scales)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), cache_kv


def gqa_verify_paged(params, x, pos, cache_kv, block_tables,
                     cfg: ModelConfig, *, window: int = 0,
                     policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """Score ``Q`` fed tokens at positions ``pos .. pos+Q-1`` in one sweep
    of the pools (committed through ``pos[b] - 1``).  Nothing is written:
    the block's own (k, v) (B, Q, Hkv, hd) come back as pending rows for
    ``commit_spec_paged``.  Behind both speculative verify and the
    prefix-hit suffix prefill.

    ``cache_kv`` may be the int8 4-tuple (see :func:`gqa_decode_paged`);
    its scales are read only.  The sweep then sees the candidates at cache
    precision: they go through the row quantizer and back (the pair the
    commit will write), since a decode step reads its own row dequantized,
    and a chunk boundary must not change the logits.  They stay in the
    activation dtype, as the kernels take them; the pending rows returned
    are the raw ones."""
    k_pages, v_pages = cache_kv[:2]
    k_scales = v_scales = None
    if len(cache_kv) == 4:
        k_scales, v_scales = cache_kv[2:]
    Q = x.shape[1]
    posq = pos[:, None] + torch.arange(Q, device=pos.device)[None, :]
    q, k, v = _qkv(params, x, posq, cfg)
    k_sweep, v_sweep = k, v
    if k_scales is not None:
        k_sweep = quant.dequantize_int8_rows(
            *quant.quantize_int8_rows(k)).to(k.dtype)
        v_sweep = quant.dequantize_int8_rows(
            *quant.quantize_int8_rows(v)).to(v.dtype)
    o = ops.paged_verify_attention(q, k_pages, v_pages, k_sweep, v_sweep,
                                   block_tables, pos, window=window,
                                   logit_cap=cfg.attn_logit_softcap,
                                   scale=_scale(cfg), policy=policy,
                                   k_scale=k_scales, v_scale=v_scales)
    o = _mask_padded_heads(o, cfg)
    return _out_proj(o, params["wo"]), (k, v)


# ==========================================================================
# MLA (DeepSeek-V2)
# ==========================================================================
# Parameters {"wdkv": (d, r_kv + dr), "kv_norm": (r_kv,), "wuk": (r_kv, H,
# dn), "wuv": (r_kv, H, dv), "wo": (H, dv, d), "wdq": (d, r_q), "q_norm":
# (r_q,), "wuq": (r_q, H, dn + dr)} (``wuq`` (d, H, dn + dr) without a q
# LoRA), as ``repro.models.attention.init_mla`` lays them out.
def _mla_scale(cfg: ModelConfig) -> float:
    """MLA scales by the decompressed head dim, not the latent width."""
    return cfg.query_scale or (cfg.nope_head_dim + cfg.rope_head_dim) ** -0.5


def _mla_norm(x, scale, cfg: ModelConfig, policy):
    return ops.rmsnorm(x.contiguous(), scale, eps=cfg.norm_eps,
                       policy=policy)


def _mla_queries(params, x, positions, cfg: ModelConfig, policy):
    """-> (q_nope (B, S, H, dn), q_rope (B, S, H, dr) rotated)."""
    dn = cfg.nope_head_dim
    if cfg.q_lora_rank:
        cq = x @ params["wdq"].to(x.dtype)
        cq = _mla_norm(cq, params["q_norm"], cfg, policy)
        q = _proj(cq, params["wuq"])
    else:
        q = _proj(x, params["wuq"])
    q_rope = common.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    return q[..., :dn], q_rope


def _mla_latent(params, x, positions, cfg: ModelConfig, policy):
    """Down-project to the compressed latent: -> (c_kv (B, S, r_kv),
    k_rope (B, S, dr) rotated)."""
    r_kv = cfg.kv_lora_rank
    ckv_rope = x @ params["wdkv"].to(x.dtype)
    c_kv = _mla_norm(ckv_rope[..., :r_kv], params["kv_norm"], cfg, policy)
    k_rope = common.apply_rope(ckv_rope[:, :, None, r_kv:], positions,
                               cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _absorb(q_nope, wuk):
    """q_nope (B, S, H, dn) through W_uk (r_kv, H, dn) -> (B, S, H, r_kv),
    the absorbed query that scores the latent directly."""
    return torch.einsum("bshk,rhk->bshr", q_nope, wuk.to(q_nope.dtype))


def _mla_out(o_lat, params):
    """Latent outputs (B, S, H, r_kv) through W_uv (r_kv, H, dv), then W_o
    -> (B, S, d)."""
    o = torch.einsum("bshr,rhk->bshk", o_lat, params["wuv"].to(o_lat.dtype))
    return _out_proj(o, params["wo"])


def mla_forward(params, x, positions, cfg: ModelConfig, *,
                policy=ops.DEFAULT_POLICY):
    """Prefill MLA: the latent expanded to per-head k / v, flash attention
    with ``[nope | rope]`` q and k (head dim dn + dr, v head dim dv).
    -> (out (B, S, d), (c_kv, k_rope))."""
    H, dr = cfg.n_heads, cfg.rope_head_dim
    q_nope, q_rope = _mla_queries(params, x, positions, cfg, policy)
    c_kv, k_rope = _mla_latent(params, x, positions, cfg, policy)
    k_nope = _proj(c_kv, params["wuk"])
    v = _proj(c_kv, params["wuv"])
    k_rope_h = k_rope[:, :, None, :].expand(*k_rope.shape[:2], H, dr)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    o = ops.attention(q, k, v, causal=True, scale=_mla_scale(cfg),
                      logit_cap=cfg.attn_logit_softcap, policy=policy)
    return _out_proj(o, params["wo"]), (c_kv, k_rope)


def mla_prefill(params, x, positions, cfg: ModelConfig, *, cache_len: int,
                policy=ops.DEFAULT_POLICY):
    """Prefill that also emits the compressed cache: the latent rows
    ``[c_kv | k_rope]`` (B, cache_len, R) in the ring layout (slot = pos %
    cache_len).  -> (out (B, S, d), lat)."""
    out, (c_kv, k_rope) = mla_forward(params, x, positions, cfg,
                                      policy=policy)
    S = x.shape[1]
    lat = torch.cat([c_kv, k_rope], dim=-1)
    if cache_len >= S:
        lat = torch.nn.functional.pad(lat, (0, 0, 0, cache_len - S))
    else:
        lat = torch.roll(lat[:, -cache_len:], S % cache_len, dims=1)
    return out, lat


def mla_decode(params, x, pos, cache_lat, cfg: ModelConfig, *,
               policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """Absorbed-matmul decode against the ring latent cache (B, C, R): the
    new latent row goes to slot ``pos % C`` in place, then the absorbed
    attend (``ops.mla_absorbed_attend_torch``, the body the paged torch
    path shares, as in JAX) and the W_uv / W_o expansion.  pos a 0-d int32
    tensor.  -> (out (B, 1, d), cache_lat)."""
    r_kv = cfg.kv_lora_rank
    B, C = cache_lat.shape[0], cache_lat.shape[1]
    posb = pos.reshape(1, 1)
    q_nope, q_rope = _mla_queries(params, x, posb, cfg, policy)
    c_kv, k_rope = _mla_latent(params, x, posb, cfg, policy)
    lat_t = torch.cat([c_kv, k_rope], dim=-1)
    slot = torch.remainder(pos, C).long().reshape(1)
    cache_lat.index_copy_(1, slot, lat_t.to(cache_lat.dtype))
    q_abs = _absorb(q_nope, params["wuk"])[:, 0]             # (B, H, r_kv)
    k_pos = pos - torch.remainder(pos - torch.arange(C, device=x.device), C)
    valid = ((k_pos >= 0) & (k_pos <= pos))[None].expand(B, C)
    o_lat = ops.mla_absorbed_attend_torch(
        q_abs, q_rope[:, 0], cache_lat[..., :r_kv].to(x.dtype),
        cache_lat[..., r_kv:].to(x.dtype), valid, scale=_mla_scale(cfg),
        logit_cap=cfg.attn_logit_softcap)
    return _mla_out(o_lat[:, None], params), cache_lat


def mla_decode_paged(params, x, pos, cache_lat, block_tables,
                     cfg: ModelConfig, *,
                     policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """One-token absorbed MLA decode against the paged latent pool (P, ps,
    R).  The new latent row goes to physical row ``block_tables[b, pos[b]
    // ps] * ps + pos[b] % ps`` in place, then the latent queries ``[q_abs
    | q_rope]`` (B, 1, H, R) sweep the pool through
    ``ops.mla_decode_paged``: the latent row serves scores and values.
    pos (B,) int32.  -> (out (B, 1, d), cache_lat)."""
    r_kv = cfg.kv_lora_rank
    P, ps, R = cache_lat.shape
    posb = pos[:, None]
    q_nope, q_rope = _mla_queries(params, x, posb, cfg, policy)
    c_kv, k_rope = _mla_latent(params, x, posb, cfg, policy)
    lat_row = torch.cat([c_kv, k_rope], dim=-1)[:, 0]           # (B, R)
    row = _decode_rows(block_tables, pos, ps)
    cache_lat.view(P * ps, R).index_copy_(0, row,
                                          lat_row.to(cache_lat.dtype))
    q_lat = torch.cat([_absorb(q_nope, params["wuk"]), q_rope], dim=-1)
    o_lat = ops.mla_decode_paged(q_lat, cache_lat, block_tables, pos,
                                 r_kv=r_kv, scale=_mla_scale(cfg),
                                 logit_cap=cfg.attn_logit_softcap,
                                 policy=policy)                # (B,1,H,r_kv)
    return _mla_out(o_lat, params), cache_lat


def mla_verify_paged(params, x, pos, cache_lat, block_tables,
                     cfg: ModelConfig, *,
                     policy: ops.KernelPolicy = ops.DEFAULT_POLICY):
    """Multi-query MLA sweep over the paged latent pool (the prefix-hit
    suffix prefill; speculation stays blocked by ``use_mla``, as in JAX).
    In absorbed form the pool is a GQA pool with one kv head: k = the
    latent rows (P, ps, 1, R), v = their first r_kv lanes, queries
    ``[q_abs | q_rope]`` (B, Q, H, R), through
    ``ops.paged_verify_attention`` (which sends this form to the latent
    sweep on the card).  The pool is not written: the pending latent rows
    (B, Q, R) come back for the caller's commit.  -> (out (B, Q, d),
    lat_new)."""
    r_kv = cfg.kv_lora_rank
    Q = x.shape[1]
    posq = pos[:, None] + torch.arange(Q, device=pos.device)[None, :]
    q_nope, q_rope = _mla_queries(params, x, posq, cfg, policy)
    c_kv, k_rope = _mla_latent(params, x, posq, cfg, policy)
    lat_new = torch.cat([c_kv, k_rope], dim=-1)                # (B, Q, R)
    q_lat = torch.cat([_absorb(q_nope, params["wuk"]), q_rope], dim=-1)
    o_lat = ops.paged_verify_attention(
        q_lat, cache_lat[:, :, None, :], cache_lat[:, :, None, :r_kv],
        lat_new[:, :, None, :], lat_new[:, :, None, :r_kv], block_tables,
        pos, scale=_mla_scale(cfg), logit_cap=cfg.attn_logit_softcap,
        policy=policy)                                         # (B,Q,H,r_kv)
    return _mla_out(o_lat, params), lat_new
