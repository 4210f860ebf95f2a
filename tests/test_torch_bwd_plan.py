"""The host-side logic of K4's and K9's Hopper backward kernels, on the
CPU: K4's q tiling (``bwd_plan``), the walks of its dk / dv and dq blocks
and the class of each (q rows, key tile) pair (skipped, unmasked,
masked) against brute-force masks; the gradients summed in the kernels'
tile order and classes, mirrored in torch, against the plain twin; K9's
backward launch shape at every zoo width; its d scale summed in the
kernel's fixed order, mirrored in torch, against the plain twin."""
import math

import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _visible(Sq, Sk, causal, window, q_offset):
    """Brute force: which (q row, key) pairs the mask keeps."""
    qpos = q_offset + np.arange(Sq)[:, None]
    kpos = np.arange(Sk)[None, :]
    vis = np.ones((Sq, Sk), dtype=bool)
    if causal:
        vis &= kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    return vis


def _dq_blocks(Sq, G, bq, rows):
    """(q tile, q0, first and last position, rows [r0, r1)) of every dq
    block (64 rows of a q tile) that holds a live row."""
    for t in range(-(-Sq // bq)):
        q0 = t * bq
        live = min(bq, Sq - q0) * G
        for r0 in range(0, rows, 64):
            r1 = min(r0 + 64, live)
            if r0 < r1:
                yield t, q0, q0 + r0 // G, q0 + (r1 - 1) // G, r0, r1


@settings(max_examples=80, deadline=None)
@given(Sq=st.integers(1, 140), Sk=st.integers(1, 200),
       G=st.sampled_from([1, 2, 3, 4, 7]), form=st.sampled_from(
           sorted(fa.BWD_WGMMA_ROWS)), causal=st.booleans(),
       window=st.sampled_from([0, 1, 3, 40, 100]),
       q_offset=st.integers(0, 90))
def test_k4_bwd_walks_and_tile_classes(Sq, Sk, G, form, causal, window,
                                       q_offset):
    """Each dk / dv block walks exactly the q tiles that see one of its
    keys, each dq block at least the key tiles its rows see; a pair is
    SKIP exactly where no (row, key) is visible and FULL exactly where
    every one is and the key tile is whole."""
    rows = fa.BWD_WGMMA_ROWS[form]
    bq, n_ws = fa.bwd_plan(*form, torch.bfloat16, 2, Sq, 3 * G, 3)
    assert bq == rows // G and 1 <= bq * G <= rows
    assert n_ws == 2 * 3 * -(-Sq // bq) * 2 * rows
    vis = _visible(Sq, Sk, causal, window, q_offset)
    nkt, ntq = -(-Sk // fa.BWD_KEYS), -(-Sq // bq)

    def check(cls, block, nk):
        assert (cls == fa.TILE_SKIP) == (not block.any())
        assert (cls == fa.TILE_FULL) == (bool(block.all())
                                         and nk == fa.BWD_KEYS)

    for kt in range(nkt):
        k0 = kt * fa.BWD_KEYS
        nk = min(fa.BWD_KEYS, Sk - k0)
        walk = fa.bwd_q_walk(k0, nk, Sq, bq, causal, window, q_offset)
        seen = set()
        for t in range(ntq):
            q0 = t * bq
            block = vis[q0:q0 + bq, k0:k0 + nk]
            check(fa.bwd_tile_class(q_offset + q0,
                                    q_offset + min(Sq, q0 + bq) - 1, k0, nk,
                                    causal, window), block, nk)
            if block.any():
                seen.add(t)
        assert set(walk) == seen
    for t, q0, p_lo, p_hi, r0, r1 in _dq_blocks(Sq, G, bq, rows):
        walk = fa.bwd_k_walk(q_offset + p_lo, q_offset + p_hi, Sk, causal,
                             window)
        assert set(walk) <= set(range(nkt))
        for kt in range(nkt):
            k0 = kt * fa.BWD_KEYS
            nk = min(fa.BWD_KEYS, Sk - k0)
            block = vis[p_lo:p_hi + 1, k0:k0 + nk]
            check(fa.bwd_tile_class(q_offset + p_lo, q_offset + p_hi, k0, nk,
                                    causal, window), block, nk)
            if block.any():
                assert kt in walk


def _bwd_in_tile_order(q, k, v, out, lse, dout, *, causal=True, window=0,
                       logit_cap=0.0, scale=None, q_offset=0):
    """K4's backward as the Hopper kernels sum it, in fp32 torch: the
    workspace of lse (+inf on rows that hold no q row) and delta by q
    tile; dk / dv by key tile over ``bwd_q_walk``, dq by 64-row part of a
    q tile over ``bwd_k_walk``; SKIP pairs left out, the mask only on
    MASKED ones (keys past Sk weigh 0 there)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G, KT = Hq // Hkv, fa.BWD_KEYS
    rows = fa.BWD_WGMMA_ROWS[(D, Dv)]
    bq = fa.bwd_plan(D, Dv, torch.bfloat16, B, Sq, Hq, Hkv)[0]
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.zeros_like(t, dtype=torch.float32)
                  for t in (q, k, v))
    ntq = -(-Sq // bq)

    def tile(x, b, hk, t, W):
        """The packed rows of q tile t (zeros past the live ones)."""
        rows_t = torch.zeros(rows, W)
        q0 = t * bq
        nq = min(bq, Sq - q0)
        rows_t[:nq * G] = x[b, q0:q0 + nq, hk * G:(hk + 1) * G].reshape(
            nq * G, W)
        return rows_t

    def p_ds(s, dp, lse_r, del_r, mask):
        x = s * scale
        t = None
        if logit_cap > 0.0:
            t = torch.tanh(x / logit_cap)
            x = logit_cap * t
        if mask is not None:
            x = torch.where(mask, x, torch.tensor(ref.NEG_INF))
        p = torch.exp(x - lse_r)
        ds = p * (dp - del_r)
        if t is not None:
            ds = ds * (1 - t * t)
        return p, ds * scale

    for b in range(B):
        for hk in range(Hkv):
            ws_l = torch.full((ntq, rows), math.inf)
            ws_d = torch.zeros((ntq, rows))
            for t in range(ntq):
                q0 = t * bq
                nq = min(bq, Sq - q0)
                heads = slice(hk * G, (hk + 1) * G)
                ws_l[t, :nq * G] = lse[b, heads, q0:q0 + nq].T.reshape(-1)
                ws_d[t, :nq * G] = (of[b, q0:q0 + nq, heads]
                                    * dof[b, q0:q0 + nq, heads]).sum(
                                        -1).reshape(-1)
            rpos = torch.arange(rows) // G
            for kt in range(-(-Sk // KT)):
                k0, nk = kt * KT, min(KT, Sk - kt * KT)
                kk = torch.zeros(KT, D)
                vv = torch.zeros(KT, Dv)
                kk[:nk], vv[:nk] = kf[b, k0:k0 + nk, hk], vf[b, k0:k0 + nk, hk]
                kpos = k0 + torch.arange(KT)[:, None]
                adk, adv = torch.zeros(KT, D), torch.zeros(KT, Dv)
                for t in fa.bwd_q_walk(k0, nk, Sq, bq, causal, window,
                                       q_offset):
                    q0 = t * bq
                    qlo = q_offset + q0
                    cls = fa.bwd_tile_class(
                        qlo, qlo + min(bq, Sq - q0) - 1, k0, nk, causal,
                        window)
                    if cls == fa.TILE_SKIP:
                        continue
                    mask = None
                    if cls == fa.TILE_MASKED:
                        qp = (qlo + rpos)[None, :]
                        mask = torch.ones(KT, rows, dtype=torch.bool)
                        if causal:
                            mask &= kpos <= qp
                        if window > 0:
                            mask &= kpos > qp - window
                    qt, dot = tile(qf, b, hk, t, D), tile(dof, b, hk, t, Dv)
                    p, ds = p_ds(kk @ qt.T, vv @ dot.T, ws_l[t][None],
                                 ws_d[t][None], mask)
                    adv += p @ dot
                    adk += ds @ qt
                dk[b, k0:k0 + nk, hk] = adk[:nk]
                dv[b, k0:k0 + nk, hk] = adv[:nk]
            for t, q0, p_lo, p_hi, r0, r1 in _dq_blocks(Sq, G, bq, rows):
                qt = tile(qf, b, hk, t, D)[r0:r0 + 64]
                dot = tile(dof, b, hk, t, Dv)[r0:r0 + 64]
                lr = ws_l[t, r0:r0 + 64][:, None]
                dr = ws_d[t, r0:r0 + 64][:, None]
                qp = (q_offset + q0 + torch.arange(r0, r0 + 64) // G)[:, None]
                adq = torch.zeros(64, D)
                for kt in fa.bwd_k_walk(q_offset + p_lo, q_offset + p_hi, Sk,
                                        causal, window):
                    k0, nk = kt * KT, min(KT, Sk - kt * KT)
                    cls = fa.bwd_tile_class(q_offset + p_lo, q_offset + p_hi,
                                            k0, nk, causal, window)
                    if cls == fa.TILE_SKIP:
                        continue
                    kk = torch.zeros(KT, D)
                    vv = torch.zeros(KT, Dv)
                    kk[:nk] = kf[b, k0:k0 + nk, hk]
                    vv[:nk] = vf[b, k0:k0 + nk, hk]
                    mask = None
                    if cls == fa.TILE_MASKED:
                        key = (k0 + torch.arange(KT))[None, :]
                        mask = torch.ones(64, KT, dtype=torch.bool)
                        if causal:
                            mask &= key <= qp
                        if window > 0:
                            mask &= key > qp - window
                    p, ds = p_ds(qt @ kk.T, dot @ vv.T, lr, dr, mask)
                    if mask is not None:
                        ds = torch.where(key < Sk, ds, 0.0)
                    adq += ds @ kk
                for r in range(r0, r1):
                    dq[b, q0 + r // G, hk * G + r % G] = adq[r - r0]
    return dq, dk, dv


BWD_ORDER_CASES = [
    (2, 100, 100, 9, 3, 64, {}),
    (1, 37, 37, 9, 3, 64, {}),
    (1, 70, 130, 7, 1, 64, {"q_offset": 60, "window": 50}),
    (1, 45, 45, 4, 2, 128, {"logit_cap": 30.0, "window": 20}),
    (1, 40, 90, 3, 3, 120, {"causal": False}),
]


@pytest.mark.parametrize("case", BWD_ORDER_CASES, ids=lambda c: "-".join(
    map(str, c[:6])) + "".join(f"-{k}{v}" for k, v in c[6].items()))
def test_k4_bwd_in_tile_order_matches_twin(case):
    """The gradients summed over the walks and classes the Hopper
    kernels use (lse +inf on empty rows, no mask on FULL pairs) equal the
    plain twin's in fp32 within 1e-5 of their scale."""
    B, Sq, Sk, Hq, Hkv, D, kw = case
    rng = np.random.default_rng(Sq + 3 * D)
    q, k, v, dout = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                     for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D),
                               (B, Sk, Hkv, D), (B, Sq, Hq, D)))
    out, lse = fa.attention_lse_torch(q, k, v, **kw)
    want = fa.flash_attention_bwd_torch(q, k, v, out, lse, dout, **kw)
    got = _bwd_in_tile_order(q, k, v, out, lse, dout, **kw)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-5


def _zoo_norm_widths():
    from repro_torch.configs import ARCH_SPECS
    out = set()
    for spec in ARCH_SPECS.values():
        cfg = spec.config
        out.add(cfg.d_model)
        if cfg.use_mla:
            out.update(w for w in (cfg.kv_lora_rank, cfg.q_lora_rank) if w)
    return sorted(out)


@pytest.mark.parametrize("d", sorted({8, 24, 136, 296, 1000, 5000, 8192,
                                      *_zoo_norm_widths()}))
def test_rmsnorm_bwd_launch_shape(d):
    """K9's backward launch shape at every zoo width and phase 7's odd
    ones: every vector of a row held by exactly one thread, at most
    ``BWD_VMAX`` a thread, every thread of a row holding one; a row a
    power of two up to 32 threads (shuffles only) wherever ``BWD_VMAX``
    vectors a thread allow it, else whole warps; a block whole warps of at
    most ``BLOCK`` threads."""
    tpr, nvec, rpb = rms.bwd_launch_shape(d)
    nv = d // 8
    held = sorted(i + c * tpr for i in range(tpr) for c in range(nvec)
                  if i + c * tpr < nv)
    assert held == list(range(nv))
    assert 1 <= nvec <= rms.BWD_VMAX and tpr <= nv
    assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
    assert (tpr <= 32) == (nv <= 32 * rms.BWD_VMAX)
    assert tpr * rpb <= rms.BLOCK and (tpr * rpb) % 32 == 0
    assert rpb * d <= 2048 * rms.BWD_VMAX      # the partial rows' smem


@pytest.mark.parametrize("rows, d, n_sm", [(1000, 576, 4), (37, 2048, 2),
                                           (300, 136, 3)])
def test_rmsnorm_bwd_dscale_fixed_order(rows, d, n_sm):
    """K9's d scale as the kernel sums it: block b walks row groups b, b +
    nblk, ...; row slot r of a group adds dy xhat into its own sums; the
    block adds its slots in order into its partial row; the reduce sums
    partial rows b = k, k + 8, ... for each of 8 warps, then the warps in
    order.  Every row is summed once, and the result is the plain twin's
    within fp32 rounding."""
    tpr, nvec, rpb = rms.bwd_launch_shape(d)
    nblk = rms.bwd_blocks(rows, d, n_sm)
    rng = np.random.default_rng(rows + d)
    x = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal(d), dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32)
    _, rstd = rms.rmsnorm_rstd_torch(x, w)
    g_xh = dy * (x * rstd[:, None])
    seen = torch.zeros(rows, dtype=torch.int64)
    part = torch.zeros(nblk, d)
    groups = -(-rows // rpb)
    for b in range(nblk):
        slots = torch.zeros(rpb, d)
        for grp in range(b, groups, nblk):
            for r in range(rpb):
                row = grp * rpb + r
                if row < rows:
                    slots[r] += g_xh[row]
                    seen[row] += 1
        for r in range(rpb):
            part[b] += slots[r]
    warps = rms.BLOCK // 32
    sums = torch.zeros(warps, d)
    for k in range(warps):
        for b in range(k, nblk, warps):
            sums[k] += part[b]
    dw = torch.zeros(d)
    for k in range(warps):
        dw += sums[k]
    assert bool((seen == 1).all())
    want = rms.rmsnorm_bwd_torch(x, w, dy, rstd)[1]
    assert float((dw - want).abs().max() / want.abs().max()) <= 1e-5
