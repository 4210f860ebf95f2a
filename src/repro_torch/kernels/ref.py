"""Plain-torch oracles for the ported kernels — the correctness ground
truth: small, obviously-correct, O(S^2)-memory implementations in fp32.

Counterparts of ``repro.kernels.ref``'s ``attention_ref``,
``decode_attention_ref``, ``decode_attention_split_ref``,
``verify_attention_ref``, ``merge_kv_splits_ref``,
``paged_decode_attention_split_ref``, ``paged_verify_attention_ref``,
``paged_decode_attention_ref``, ``mla_decode_paged_ref``,
``mla_decode_split_ref``, ``ssd_ref`` and ``rmsnorm_ref`` (same shapes,
layouts and masks), for bf16 and fp32 caches, and with ``k_scale`` /
``v_scale`` the QUANTIZED oracles of int8 caches: the whole cache is
dequantized up front (:func:`_dequant`) and the unquantized body runs.
In-flight candidates stay unquantized, as in JAX.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _dequant(cache, scale) -> torch.Tensor:
    """Whole-cache dequant for the quantized oracles: ``cache`` in fp32,
    times the (..., 1) per-row ``scale`` (broadcast over head_dim) when
    one is given."""
    cf = cache.float()
    return cf if scale is None else cf * scale


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  logit_cap: float = 0.0, scale: float | None = None,
                  q_offset: int = 0, k_len=None) -> torch.Tensor:
    """Naive GQA attention.  q (B, Sq, Hq, D), k (B, Sk, Hkv, D),
    v (B, Sk, Hkv, Dv) -> (B, Sq, Hq, Dv).  fp32 math."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    if k_len is not None:
        mask &= k_pos < int(k_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, Dv).to(q.dtype)


def _ring_scores(q, kf, k_pos, pos, *, window, logit_cap, scale):
    """Masked single-token scores (B, Hkv, G, C) against a (dequantized)
    fp32 ring cache with explicit slot positions ``k_pos`` (C,) or (B, C);
    ``pos`` () or (B,)."""
    B, _, Hq, D = q.shape
    C, Hkv = kf.shape[1], kf.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kf) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_posb = torch.as_tensor(k_pos, device=q.device).reshape(-1, C)
    posb = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    valid = (k_posb >= 0) & (k_posb <= posb)
    if window > 0:
        valid &= k_posb > posb - window
    return torch.where(valid[:, None, None], s, NEG_INF)


def decode_attention_ref(q, k_cache, v_cache, k_pos, pos, *, window: int = 0,
                         logit_cap: float = 0.0, scale: float | None = None,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """Naive ring decode oracle: whole-cache fp32 math, explicit slot
    positions.  q (B, 1, Hq, D), caches (B, C, Hkv, D) -> (B, 1, Hq, Dv);
    with ``k_scale`` / ``v_scale`` (B, C, Hkv, 1) the quantized oracle."""
    B, _, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = _ring_scores(q, _dequant(k_cache, k_scale), k_pos, pos,
                     window=window, logit_cap=logit_cap, scale=scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, _dequant(v_cache, v_scale))
    return o.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, k_pos, pos, *,
                               n_splits: int, block_k: int = 256,
                               window: int = 0, logit_cap: float = 0.0,
                               scale: float | None = None, k_scale=None,
                               v_scale=None):
    """Stage-1 oracle for the split ring decode sweep: the kernel's
    k-block partitioning (the divisor-of-C ``block_k`` rule), whole-cache
    fp32 math per split.  -> ``(partial (B, Hq, S, 1, Dv), lse (B, Hq, S,
    1))``."""
    C = k_cache.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    block_k = min(block_k, C)
    if C % block_k:
        block_k = next(b for b in range(block_k, 0, -1) if C % b == 0)
    s = _ring_scores(q, _dequant(k_cache, k_scale), k_pos, pos,
                     window=window, logit_cap=logit_cap, scale=scale)
    return _split_partials(s, _dequant(v_cache, v_scale),
                           n_units=C // block_k, unit=block_k,
                           n_splits=n_splits)


def verify_attention_ref(q, k_cache, v_cache, k_new, v_new, k_pos, pos, *,
                         window: int = 0, logit_cap: float = 0.0,
                         scale: float | None = None, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """Speculative verify oracle over a ring cache: query i sits at
    ``pos + i`` and sees the committed cache (``k_pos`` valid, at most
    ``pos + i``, and newer than ``pos + i - C``: the sequential loop would
    have overwritten older slots) plus candidates ``j <= i``.
    -> (B, Q, Hq, Dv)."""
    B, Q, Hq, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    qf = q.float().reshape(B, Q, Hkv, G, D)
    q_pos = torch.as_tensor(pos, device=dev).reshape(()) \
        + torch.arange(Q, device=dev)[:, None]                    # (Q, 1)
    kp = torch.as_tensor(k_pos, device=dev).reshape(1, C)
    s_c = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                       _dequant(k_cache, k_scale)) * scale
    valid_c = (kp >= 0) & (kp <= q_pos) & (kp > q_pos - C)
    if window > 0:
        valid_c &= kp > q_pos - window
    s_n = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_new.float()) * scale
    n_pos = q_pos.reshape(1, Q)
    valid_n = n_pos <= q_pos
    if window > 0:
        valid_n &= n_pos > q_pos - window
    s = torch.cat([s_c, s_n], dim=-1)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    valid = torch.cat([valid_c, valid_n], dim=-1)                 # (Q, C+Q)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vf = torch.cat([_dequant(v_cache, v_scale), v_new.float()], dim=1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Q, Hq, Dv).to(q.dtype)


def merge_kv_splits_ref(partial, lse) -> torch.Tensor:
    """Stage-2 oracle: ``partial (..., S, R, Dv)`` + ``lse (..., S, R)`` ->
    ``(..., R, Dv)``; splits with ``lse == NEG_INF`` weigh ~0."""
    m = torch.amax(lse, dim=-2, keepdim=True)
    w = torch.exp(lse - m)
    den = torch.clamp(w.sum(dim=-2), min=1e-30)
    acc = (partial * w[..., None]).sum(dim=-3)
    return acc / den[..., None]


def _gather_pages(pages, block_tables, scale=None):
    """(P, ps, Hkv, D) pool + (B, nb) table -> (B, nb*ps, Hkv, D) fp32 in
    logical order, dequantized by the (P, ps, Hkv, 1) ``scale`` when one
    is given."""
    B, nb = block_tables.shape
    ps = pages.shape[1]
    g = _dequant(pages, scale)[block_tables.long()]
    return g.reshape(B, nb * ps, *pages.shape[2:])


def _split_partials(s, vf, *, n_units: int, unit: int, n_splits: int):
    """Stage-1 oracle body: masked scores ``s (B, Hkv, G, K)`` over
    ``n_units`` blocks of ``unit`` keys, values ``vf (B, K, Hkv, Dv)`` ->
    ``(partial (B, Hq, S, 1, Dv), lse (B, Hq, S, 1))``."""
    B, Hkv, G, _ = s.shape
    Dv = vf.shape[-1]
    S = max(1, min(int(n_splits), n_units))
    upb = -(-n_units // S)
    parts, lses = [], []
    for si in range(S):
        lo = si * upb * unit
        hi = min((si + 1) * upb, n_units) * unit
        if lo >= hi:                              # ragged tail: empty split
            parts.append(s.new_zeros((B, Hkv, G, Dv)))
            lses.append(s.new_full((B, Hkv, G), NEG_INF))
            continue
        ss = s[..., lo:hi]
        m = torch.amax(ss, dim=-1)
        p = torch.exp(ss - m[..., None])
        l = p.sum(dim=-1)
        acc = torch.einsum("bhgk,bkhd->bhgd", p, vf[:, lo:hi].float())
        empty = m <= 0.5 * NEG_INF
        part = torch.where(empty[..., None], 0.0,
                           acc / torch.clamp(l, min=1e-30)[..., None])
        lse = torch.where(empty, NEG_INF,
                          m + torch.log(torch.clamp(l, min=1e-30)))
        parts.append(part)
        lses.append(lse)
    Hq = Hkv * G
    partial = torch.stack(parts, dim=3).reshape(B, Hq, S, 1, Dv)
    lse = torch.stack(lses, dim=3).reshape(B, Hq, S, 1)
    return partial, lse


def _decode_scores(q, kg, pos, *, window, logit_cap, scale):
    B, _, Hq, D = q.shape
    Hkv = kg.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kg) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(kg.shape[1], device=q.device)[None, :]
    posb = pos.reshape(B, 1).to(q.device)
    valid = k_pos <= posb
    if window > 0:
        valid &= k_pos > posb - window
    return torch.where(valid[:, None, None], s, NEG_INF)


def paged_decode_attention_split_ref(q, k_pages, v_pages, block_tables, pos,
                                     *, n_splits: int, window: int = 0,
                                     logit_cap: float = 0.0,
                                     scale: float | None = None,
                                     k_scale=None, v_scale=None):
    """Stage-1 oracle for the split paged decode sweep: pages gathered into
    logical order (dequantized for int8 pools), split over pages."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kg = _gather_pages(k_pages, block_tables, k_scale)
    vg = _gather_pages(v_pages, block_tables, v_scale)
    s = _decode_scores(q, kg, pos, window=window, logit_cap=logit_cap,
                       scale=scale)
    return _split_partials(s, vg, n_units=block_tables.shape[1],
                           unit=k_pages.shape[1], n_splits=n_splits)


def paged_verify_attention_ref(q, k_pages, v_pages, k_new, v_new,
                               block_tables, pos, *, window: int = 0,
                               logit_cap: float = 0.0,
                               scale: float | None = None, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Paged multi-query oracle: the pool is committed through
    ``pos[b] - 1``; query i (position ``pos[b] + i``) also sees in-flight
    candidates ``j <= i``; ``k_scale`` / ``v_scale`` dequantize an int8
    pool up front.  -> (B, Q, Hq, Dv)."""
    B, Q, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    Dv = v_pages.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kg = _gather_pages(k_pages, block_tables, k_scale)
    vg = _gather_pages(v_pages, block_tables, v_scale)
    K = kg.shape[1]
    qf = q.float().reshape(B, Q, Hkv, G, D)
    posb = pos.reshape(B, 1, 1).to(dev)
    q_pos = posb + torch.arange(Q, device=dev)[None, :, None]      # (B, Q, 1)
    s_c = torch.einsum("bqhgd,bkhd->bhgqk", qf, kg) * scale
    k_pos = torch.arange(K, device=dev)[None, None, :]
    valid_c = k_pos < posb
    if window > 0:
        valid_c = valid_c & (k_pos > q_pos - window)
    valid_c = valid_c.expand(B, Q, K)
    s_n = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_new.float()) * scale
    n_pos = posb + torch.arange(Q, device=dev)[None, None, :]
    valid_n = n_pos <= q_pos
    if window > 0:
        valid_n &= n_pos > q_pos - window
    s = torch.cat([s_c, s_n], dim=-1)
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    valid = torch.cat([valid_c, valid_n], dim=-1)                 # (B, Q, K+Q)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vf = torch.cat([vg, v_new.float()], dim=1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Q, Hq, Dv).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, pos, *,
                               window: int = 0, logit_cap: float = 0.0,
                               scale: float | None = None, k_scale=None,
                               v_scale=None) -> torch.Tensor:
    """Naive paged decode oracle: gather each request's pages into logical
    order (dequantized for int8 pools), then whole-cache fp32 math.
    -> (B, 1, Hq, Dv)."""
    B, _, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    kg = _gather_pages(k_pages, block_tables, k_scale)
    vg = _gather_pages(v_pages, block_tables, v_scale)
    s = _decode_scores(q, kg, pos, window=window, logit_cap=logit_cap,
                       scale=scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vg)
    return o.reshape(B, 1, Hq, v_pages.shape[-1]).to(q.dtype)


# --------------------------------------------------------------------------
# MLA compressed-latent paged decode oracles, absorbed-matmul form
# --------------------------------------------------------------------------
def _mla_scores(q_lat, lat_pages, block_tables, pos, *, scale, logit_cap):
    """Gathered latent rows (B, K, R) fp32 and the masked scores (B, 1, Hq,
    K) of the latent queries against the whole row, ``k_pos <= pos``."""
    B, _, Hq, R = q_lat.shape
    ps, nb = lat_pages.shape[1], block_tables.shape[1]
    latg = lat_pages.float()[block_tables.long()].reshape(B, nb * ps, R)
    qf = q_lat.float().reshape(B, 1, Hq, R)               # (B, Hkv=1, G, R)
    s = torch.einsum("bhgd,bkd->bhgk", qf, latg) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(nb * ps, device=q_lat.device)[None, :]
    valid = k_pos <= pos.reshape(B, 1).to(q_lat.device)
    return latg, torch.where(valid[:, None, None], s, NEG_INF)


def mla_decode_paged_ref(q_lat, lat_pages, block_tables, pos, *, r_kv: int,
                         scale: float, logit_cap: float = 0.0):
    """Naive MLA paged decode oracle in absorbed form: one latent row per
    token shared by every q head (Hkv = 1, G = Hq); the score is one dot
    of ``[q_abs | q_rope]`` against the whole row, the value its first
    ``r_kv`` lanes.  q_lat (B, 1, Hq, R), lat_pages (P, ps, R) -> latent
    outputs (B, 1, Hq, r_kv).  ``scale`` is mandatory: MLA scales by the
    decompressed head dim, not R."""
    B, _, Hq, _ = q_lat.shape
    latg, s = _mla_scores(q_lat, lat_pages, block_tables, pos, scale=scale,
                          logit_cap=logit_cap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkd->bhgd", p, latg[..., :r_kv])
    return o.reshape(B, 1, Hq, r_kv).to(q_lat.dtype)


def mla_decode_split_ref(q_lat, lat_pages, block_tables, pos, *, r_kv: int,
                         n_splits: int, scale: float,
                         logit_cap: float = 0.0):
    """Stage-1 oracle of the split MLA sweep: the gather of
    :func:`mla_decode_paged_ref`, split over pages by the shared
    ``_split_partials`` body at Hkv = 1, G = Hq, Dv = r_kv ->
    ``(partial (B, Hq, S, 1, r_kv), lse (B, Hq, S, 1))``."""
    latg, s = _mla_scores(q_lat, lat_pages, block_tables, pos, scale=scale,
                          logit_cap=logit_cap)
    return _split_partials(s, latg[..., :r_kv][:, :, None, :],
                           n_units=block_tables.shape[1],
                           unit=lat_pages.shape[1], n_splits=n_splits)


# --------------------------------------------------------------------------
# Mamba2 SSD oracle: the sequential recurrence over time
# --------------------------------------------------------------------------
def ssd_ref(x, dt, A, B_mat, C_mat, D=None, *, initial_state=None,
            return_state: bool = False):
    """Exact recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
    ``y_t = C_t h_t + D x_t``, in fp32.  x (B, S, H, P), dt (B, S, H), A
    (H,), B_mat / C_mat (B, S, G, N) shared by the H // G heads of a group,
    D (H,) or None, initial_state (B, H, P, N) or None.  Returns y in x's
    dtype, and with ``return_state`` also the final state (B, H, P, N)
    fp32."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    xf = x.float()
    dtf = dt.float()
    Af = A.float()
    Bf = torch.repeat_interleave(B_mat.float(), rep, dim=2)   # (B, S, H, N)
    Cf = torch.repeat_interleave(C_mat.float(), rep, dim=2)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]    # (B, H, 1, 1)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bf[:, t, :, None, :]                              # (B, H, P, N)
        h = decay * h + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bb, 0, H, P))
    if D is not None:
        y = y + D.float()[:, None] * xf
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


# --------------------------------------------------------------------------
# RMSNorm oracle
# --------------------------------------------------------------------------
def rmsnorm_ref(x, scale, *, eps: float = 1e-6,
                gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis in fp32, cast back to x's dtype;
    ``gemma_style`` uses the (1 + scale) parameterisation."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.float()
    if gemma_style:
        w = 1.0 + w
    return (y * w).to(x.dtype)
