"""Plain-torch oracles for the ported kernels — the correctness ground
truth: small, obviously-correct, O(S^2)-memory implementations in fp32.

Counterparts of ``repro.kernels.ref``'s ``attention_ref``,
``merge_kv_splits_ref``, ``paged_decode_attention_split_ref``,
``paged_verify_attention_ref`` and ``paged_decode_attention_ref`` (same
shapes, layouts and masks).  The int8 (scaled) forms belong to the KV-tier
slice and are not here yet.
"""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


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


def merge_kv_splits_ref(partial, lse) -> torch.Tensor:
    """Stage-2 oracle: ``partial (..., S, R, Dv)`` + ``lse (..., S, R)`` ->
    ``(..., R, Dv)``; splits with ``lse == NEG_INF`` weigh ~0."""
    m = torch.amax(lse, dim=-2, keepdim=True)
    w = torch.exp(lse - m)
    den = torch.clamp(w.sum(dim=-2), min=1e-30)
    acc = (partial * w[..., None]).sum(dim=-3)
    return acc / den[..., None]


def _gather_pages(pages, block_tables):
    """(P, ps, Hkv, D) pool + (B, nb) table -> (B, nb*ps, Hkv, D) fp32 in
    logical order."""
    B, nb = block_tables.shape
    ps = pages.shape[1]
    g = pages.float()[block_tables.long()]
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
                                     scale: float | None = None):
    """Stage-1 oracle for the split paged decode sweep: pages gathered into
    logical order, split over pages."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kg = _gather_pages(k_pages, block_tables)
    vg = _gather_pages(v_pages, block_tables)
    s = _decode_scores(q, kg, pos, window=window, logit_cap=logit_cap,
                       scale=scale)
    return _split_partials(s, vg, n_units=block_tables.shape[1],
                           unit=k_pages.shape[1], n_splits=n_splits)


def paged_verify_attention_ref(q, k_pages, v_pages, k_new, v_new,
                               block_tables, pos, *, window: int = 0,
                               logit_cap: float = 0.0,
                               scale: float | None = None) -> torch.Tensor:
    """Paged multi-query oracle: the pool is committed through
    ``pos[b] - 1``; query i (position ``pos[b] + i``) also sees in-flight
    candidates ``j <= i``.  -> (B, Q, Hq, Dv)."""
    B, Q, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    Dv = v_pages.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kg = _gather_pages(k_pages, block_tables)
    vg = _gather_pages(v_pages, block_tables)
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
                               scale: float | None = None) -> torch.Tensor:
    """Naive paged decode oracle: gather each request's pages into logical
    order, then whole-cache fp32 math.  -> (B, 1, Hq, Dv)."""
    B, _, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    kg = _gather_pages(k_pages, block_tables)
    vg = _gather_pages(v_pages, block_tables)
    s = _decode_scores(q, kg, pos, window=window, logit_cap=logit_cap,
                       scale=scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vg)
    return o.reshape(B, 1, Hq, v_pages.shape[-1]).to(q.dtype)
