"""GQA attention sweeps + LSE merge: the hand-written Hopper kernels of
the serving hot paths, their wrappers, and their plain PyTorch versions.

Four kernels replace the eleven Pallas functions of the JAX package's
paged, ring and MLA families:

  * **K-sweep** ``paged_attention_sweep`` (``csrc/paged_attention.cu``) —
    stage 1 of paged GQA attention: ``Q`` query rows per ``(b, h)`` (1 for
    decode, the chunk length for the prefix-hit suffix prefill, K+1 for
    speculative verify) over the pages in ``block_tables[b]`` for kv head
    ``h // G``, online softmax in fp32.  One block per (16 of the kv
    head's ``Q * G`` (query, head) rows, split, kv head, batch); the
    split's keys are spread over the block's warps in tiles of 16, and
    bf16 runs on the tensor cores.
  * **Ring sweep** ``ring_attention_sweep`` (``csrc/ring_attention.cu``) —
    the same stage 1, the same kernel template (``csrc/sweep_fragments.cuh``)
    over the static batch's and the engine's private rings ``(B, C, Hkv,
    D)``: slot s holds position ``ref - ((ref - s) mod C)`` (``ref = pos``
    for decode, ``pos - 1`` for verify, which also masks the slots the
    sequential loop would have overwritten); ``ring_block_k`` blocks,
    skipped where no row sees a slot, cut the splits.
  * **Latent sweep** ``mla_latent_sweep`` (``csrc/mla_attention.cu``) —
    stage 1 of deepseek-v2's absorbed MLA attention over the paged latent
    pool ``(P, ps, R)``: every (query, head) row ``[q_abs | q_rope]``
    scores the whole R-wide latent row, whose first ``Dv = r_kv`` lanes
    are the value.  It serves the decode (K7a, K7b) and the MLA form of
    the paged verify (K3's, Hkv 1 with v a leading slice of k's rows).
    bf16 runs on the tensor cores: one block per (16 or 32 rows, split,
    b), every latent tile in shared memory feeding all of them, the
    512-wide value split over four warps a 16-row tile; fp32 keeps a
    CUDA-core kernel of 16 rows a block.
  * **K-merge** ``lse_merge`` — stage 2 of all three: ``out = sum_s
    partial_s exp(lse_s - m) / sum_s exp(lse_s - m)``, denominator clamped
    at 1e-30.  On the main paths it is no launch of its own: with
    ``merge=True`` a split sweep merges its own splits in the last block
    of each row tile to finish (a split-K fix-up through a device counter,
    ``merge_counters``), on the same device code (``csrc/lse_merge.cuh``),
    so the fused output is bit for bit ``lse_merge`` of the launch's
    partials.

The paged and ring sweeps also read int8 caches with per-row fp32 scales
(``k_scale`` / ``v_scale``, the pool's or ring's layout with a last axis
of 1), so a kv row costs D + 4 bytes where bf16 costs 2D: both keep the
int8 values as products' operands and apply the scales outside them.  q,
the candidates and the output stay in the query dtype.

The sweeps fold verify's in-flight candidate rows, causally, into the
last split only.  One split writes the normalised output in the query
dtype; several write fp32 ``partial (B, Hq, S, Q, Dv)`` + ``lse (B, Hq,
S, Q)`` and, with ``merge=True``, also the merged output ``(B, Q, Hq,
Dv)`` in the query dtype, which is then what the sweep returns.

Each wrapper takes its plain version (``*_torch``, same arithmetic block
by block, vectorised over batch, heads and splits) for a tensor that lies
on the CPU, and for a CUDA tensor launches the kernel or raises — there is
no fallback.  ``LAUNCHES`` (``kernels/binding.py``) counts kernel
launches; the plain versions never touch it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.binding import (DTYPE_CODE, LAUNCHES, check, ptr,
                                         refuse_grad,
                                         reset_launches)  # noqa: F401
from repro_torch.kernels.ref import NEG_INF


def split_blocks(n_blocks: int, n_splits: int) -> tuple[int, int]:
    """Clamp the split count to the block count and size each split's
    contiguous block slice (ceil: the last split may sweep fewer blocks,
    or none)."""
    s = max(1, min(int(n_splits), n_blocks))
    return s, -(-n_blocks // s)


def ring_block_k(cache_len: int, block_k: int) -> int:
    """The ring sweep's block: ``min(block_k, C)``, then the largest divisor
    of ``C`` not above it (the JAX kernels' rule, which the split
    boundaries follow)."""
    C = int(cache_len)
    bk = max(1, min(int(block_k), C))
    while C % bk:
        bk -= 1
    return bk


# ==========================================================================
# plain PyTorch versions (the CPU path; on the card only for comparison)
# ==========================================================================
def paged_attention_sweep_torch(q, k_pages, v_pages, block_tables, pos, *,
                                k_new=None, v_new=None, n_splits: int = 1,
                                window: int = 0, logit_cap: float = 0.0,
                                scale: float | None = None, k_scale=None,
                                v_scale=None):
    """The K-sweep's function in plain torch, page by page as the kernel
    (and the Pallas grid) walks it: a page whose every score is masked for
    every row is skipped, masked scores are NEG_INF, and the state update
    is the reference's online softmax.  int8 pools are dequantized page by
    page with their (P, ps, Hkv, 1) scales.  Returns the output
    ``(B, Q, Hq, Dv)`` in ``q.dtype`` when the (clamped) split count is 1,
    else ``(partial (B, Hq, S, Q, Dv), lse (B, Hq, S, Q))`` in fp32."""
    B, Q, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    Dv = v_pages.shape[-1]
    nb = block_tables.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    verify = k_new is not None
    S, ppb = split_blocks(nb, n_splits)
    dev = q.device
    bt = block_tables.long()
    qf = q.float().permute(0, 2, 1, 3)                          # (B, Hq, Q, D)
    kv_head = torch.arange(Hq, device=dev) // G
    m = torch.full((B, Hq, S, Q), NEG_INF, device=dev)
    l = torch.zeros((B, Hq, S, Q), device=dev)
    acc = torch.zeros((B, Hq, S, Q, Dv), device=dev)
    posb = pos.to(dev).long().reshape(B, 1, 1, 1)               # (B, S, Q, ps)
    qi = torch.arange(Q, device=dev).reshape(1, 1, Q, 1)
    kk = torch.arange(ps, device=dev).reshape(1, 1, 1, ps)
    sidx = torch.arange(S, device=dev)

    for j in range(ppb):
        gj = sidx * ppb + j
        in_range = (gj < nb).reshape(1, S, 1, 1)
        gjc = gj.clamp(max=nb - 1)
        k_pos = gjc.reshape(1, S, 1, 1) * ps + kk               # (1, S, 1, ps)
        if verify:
            valid = k_pos < posb
            if window > 0:
                valid = valid & (k_pos > posb + qi - window)
        else:
            valid = k_pos <= posb
            if window > 0:
                valid = valid & (k_pos > posb - window)
        valid = (valid & in_range).expand(B, S, Q, ps)
        pages = bt[:, gjc]                                      # (B, S)
        kt = _rows(k_pages, k_scale, pages, kv_head)            # (B,S,ps,Hq,D)
        vt = _rows(v_pages, v_scale, pages, kv_head)
        s = torch.einsum("bhqd,bskhd->bhsqk", qf, kt) * scale
        run = valid.reshape(B, S, -1).any(dim=-1).reshape(B, 1, S, 1)
        m, l, acc = _online_update((m, l, acc), s,
                                   vt.permute(0, 3, 1, 2, 4), valid[:, None],
                                   run, logit_cap)

    if verify:
        m, l, acc = _fold_candidates((m, l, acc), qf, k_new, v_new, kv_head,
                                     window=window, logit_cap=logit_cap,
                                     scale=scale)
    return _sweep_result(m, l, acc, q.dtype)


def _rows(cache, scale, idx, kv_head):
    """``cache[idx]`` at every q head's kv head, in fp32, dequantized by
    the same rows of ``scale`` for an int8 cache (the kernels'
    dequantizing load)."""
    rows = cache[idx][..., kv_head, :].float()
    if scale is None:
        return rows
    return rows * scale[idx][..., kv_head, :]


def _online_update(state, s, vt, valid, run, logit_cap: float):
    """One key block's online-softmax update, the reference's
    ``_online_softmax_update``: scores ``s (B, Hq, S, Q, k)`` (capped, then
    masked to NEG_INF by ``valid``), values ``vt (B, Hq, S, k, Dv)``.  Where
    ``run`` (broadcast over the state) is False the block is skipped, as
    the kernels skip a block with no valid key; ``None`` always runs."""
    m, l, acc = state
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhsqk,bhskd->bhsqd", p, vt)
    if run is None:
        return m_new, l_new, acc_new
    return (torch.where(run, m_new, m), torch.where(run, l_new, l),
            torch.where(run[..., None], acc_new, acc))


def _fold_candidates(state, qf, k_new, v_new, kv_head, *, window: int,
                     logit_cap: float, scale: float):
    """Fold the in-flight candidates (B, Q, Hkv, D) causally (``j <= i``,
    and ``j > i - window``) into the LAST split of the state only; no skip,
    since row i always sees candidate i.  ``qf`` is (B, Hq, Q, D) fp32."""
    m, l, acc = state
    Q = qf.shape[2]
    dev = qf.device
    kn = k_new.float()[:, :, kv_head].permute(0, 2, 1, 3)       # (B,Hq,Q,D)
    vn = v_new.float()[:, :, kv_head].permute(0, 2, 1, 3)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kn)[:, :, None] * scale
    ri = torch.arange(Q, device=dev)[:, None]
    cj = torch.arange(Q, device=dev)[None, :]
    cvalid = cj <= ri
    if window > 0:
        cvalid = cvalid & (cj > ri - window)
    last = (m[:, :, -1:], l[:, :, -1:], acc[:, :, -1:])
    ml, ll, al = _online_update(last, s, vn[:, :, None], cvalid, None,
                                logit_cap)
    return (torch.cat([m[:, :, :-1], ml], dim=2),
            torch.cat([l[:, :, :-1], ll], dim=2),
            torch.cat([acc[:, :, :-1], al], dim=2))


def _sweep_result(m, l, acc, dtype):
    """A sweep's epilogue from its state (B, Hq, S, Q[, Dv]): one split ->
    the normalised output (B, Q, Hq, Dv) in ``dtype``; several ->
    ``(partial, lse)`` in fp32, ``lse = NEG_INF`` where ``l == 0``."""
    partial = acc / torch.clamp(l, min=1e-30)[..., None]
    if partial.shape[2] == 1:
        return partial[:, :, 0].permute(0, 2, 1, 3).to(dtype)
    lse = torch.where(l > 0.0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(m, NEG_INF))
    return partial, lse


def ring_attention_sweep_torch(q, k_cache, v_cache, pos, *, k_new=None,
                               v_new=None, n_splits: int = 1,
                               block_k: int = 256, window: int = 0,
                               logit_cap: float = 0.0,
                               scale: float | None = None, k_scale=None,
                               v_scale=None):
    """The ring sweep's function in plain torch, block by block as the
    kernel (and the Pallas grid) walks the cache (B, C, Hkv, D).  Slot s
    holds ``ref - ((ref - s) mod C)``, with ``ref = pos`` for decode and
    ``pos - 1`` for verify; a slot is valid when that position is >= 0,
    and verify row i (at ``pos + i``) also drops positions ``<= pos + i -
    C``, which the sequential loop would have overwritten.  A block whose
    every slot is masked for every row is skipped; masked scores are
    NEG_INF.  ``pos`` is (1,) or (B,).  An int8 cache is dequantized
    block by block with its (B, C, Hkv, 1) scales.  Returns as
    :func:`paged_attention_sweep_torch`."""
    B, Q, Hq, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    verify = k_new is not None
    bk = ring_block_k(C, block_k)
    n_k = C // bk
    S, kpb = split_blocks(n_k, n_splits)
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3)                          # (B, Hq, Q, D)
    kv_head = torch.arange(Hq, device=dev) // G
    m = torch.full((B, Hq, S, Q), NEG_INF, device=dev)
    l = torch.zeros((B, Hq, S, Q), device=dev)
    acc = torch.zeros((B, Hq, S, Q, Dv), device=dev)
    posb = pos.to(dev).long().reshape(-1, 1, 1, 1)              # (B, S, Q, bk)
    ref = posb - 1 if verify else posb
    q_pos = posb + torch.arange(Q, device=dev).reshape(1, 1, Q, 1) \
        if verify else posb
    kk = torch.arange(bk, device=dev)
    sidx = torch.arange(S, device=dev)
    for j in range(kpb):
        g = sidx * kpb + j
        in_range = (g < n_k).reshape(1, S, 1, 1)
        slots = g.clamp(max=n_k - 1)[:, None] * bk + kk         # (S, bk)
        k_pos = ref - torch.remainder(ref - slots[None, :, None], C)
        valid = (k_pos >= 0) & in_range
        if verify:
            valid = valid & (k_pos > q_pos - C)
        if window > 0:
            valid = valid & (k_pos > q_pos - window)
        valid = valid.expand(B, S, Q, bk)
        kt = _rows(k_cache, k_scale, (slice(None), slots),
                   kv_head)                                 # (B,S,bk,Hq,D)
        vt = _rows(v_cache, v_scale, (slice(None), slots), kv_head)
        s = torch.einsum("bhqd,bskhd->bhsqk", qf, kt) * scale
        run = valid.reshape(B, S, -1).any(dim=-1).reshape(B, 1, S, 1)
        m, l, acc = _online_update((m, l, acc), s,
                                   vt.permute(0, 3, 1, 2, 4), valid[:, None],
                                   run, logit_cap)
    if verify:
        m, l, acc = _fold_candidates((m, l, acc), qf, k_new, v_new, kv_head,
                                     window=window, logit_cap=logit_cap,
                                     scale=scale)
    return _sweep_result(m, l, acc, q.dtype)


def lse_merge_torch(partial, lse, out_dtype):
    """The K-merge's function in plain torch: ``partial (..., S, R, Dv)``
    fp32 + ``lse (..., S, R)`` -> ``(..., R, Dv)`` in ``out_dtype``."""
    m = torch.amax(lse, dim=-2)                                 # (..., R)
    w = torch.exp(lse - m[..., None, :])                        # (..., S, R)
    den = torch.clamp(w.sum(dim=-2), min=1e-30)
    acc = (partial * w[..., None]).sum(dim=-3)
    return (acc / den[..., None]).to(out_dtype)


def mla_latent_sweep_torch(q, pool, block_tables, pos, *, r_kv: int,
                           pending=None, n_splits: int = 1,
                           logit_cap: float = 0.0, scale: float):
    """The latent sweep's function in plain torch: the paged K-sweep's twin
    at the MLA form, one kv head whose k rows are the whole latent rows
    ``pool (P, ps, R)`` and whose v rows are their first ``r_kv`` lanes
    (the pending rows ``(B, Q, R)`` likewise), page by page as the kernel
    walks them.  Returns as :func:`paged_attention_sweep_torch`, with
    ``Dv = r_kv``."""
    k_new = v_new = None
    if pending is not None:
        k_new, v_new = pending[:, :, None], pending[:, :, None, :r_kv]
    return paged_attention_sweep_torch(
        q, pool[:, :, None], pool[:, :, None, :r_kv], block_tables, pos,
        k_new=k_new, v_new=v_new, n_splits=n_splits, logit_cap=logit_cap,
        scale=scale)


# ==========================================================================
# kernel wrappers
# ==========================================================================
# head dims both sweeps are built for, bf16 / fp32 and int8 alike:
# smollm's 64, h2o-danube's 120 (its int8 rows take 8-byte loads) and 128
SWEEP_HEAD_DIMS = (64, 120, 128)
# query rows a call of either sweep takes (the C interface's SW_MAX_Q)
SWEEP_MAX_Q = 128


def _kv_storage(name, k_scale, v_scale, q_dtype):
    """The pools' dtype the sweep expects: int8 when both scales are
    given, else the query dtype."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: k_scale and v_scale must be given "
                         "together")
    return q_dtype if k_scale is None else torch.int8


# (query, head) rows of a sweep block's tile (the C interface's SW_ROWS);
# the latent sweep's bf16 blocks take one or two such tiles
SWEEP_ROWS = 16


def merge_counter_cells(B: int, Hkv: int, rows: int) -> int:
    """Counters a merging split launch needs: one per (batch row, kv head,
    tile of ``SWEEP_ROWS`` of the kv head's ``rows = Q * G`` (query, head)
    rows); the latent sweep is one kv head of ``Q * Hq`` rows."""
    return B * Hkv * -(-rows // SWEEP_ROWS)


_COUNTERS: dict = {}     # device -> int32 counters, all zero between launches
_OUTGROWN: list = []     # earlier workspaces, which a captured graph may use


def merge_counters(device: torch.device, cells: int) -> torch.Tensor:
    """The device's counter workspace, at least ``cells`` long: zeroed when
    it is allocated, and zero again after every merging launch (its last
    block resets each counter), as a CUDA-graph replay needs it.  It grows
    only outside a graph capture; a capture that would need it grown
    raises.  Launches that share it are ordered (one stream)."""
    ws = _COUNTERS.get(device)
    if ws is not None and ws.numel() >= cells:
        return ws
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"merge_counters: a merging launch inside a CUDA-graph capture "
            f"needs {cells} counters and the workspace holds "
            f"{0 if ws is None else ws.numel()}: run the launch once before "
            f"the capture")
    if ws is not None:
        _OUTGROWN.append(ws)
    ws = torch.zeros(max(cells, 2 * (0 if ws is None else ws.numel())),
                     dtype=torch.int32, device=device)
    _COUNTERS[device] = ws
    return ws


def _split_buffers(q, out_shape, S, merge, Hkv, rows):
    """One sweep launch's buffers on q's device: ``out`` (``out_shape``,
    q's dtype) at one split or when merging; the fp32 ``partial`` (B, Hq,
    S, Q, Dv) and ``lse`` (B, Hq, S, Q) at several; the counters when
    merging several."""
    B, Q, Hq, Dv = out_shape
    dev = q.device
    out = partial = lse = counters = None
    if S == 1 or merge:
        out = torch.empty(out_shape, dtype=q.dtype, device=dev)
    if S > 1:
        partial = torch.empty((B, Hq, S, Q, Dv), dtype=torch.float32,
                              device=dev)
        lse = torch.empty((B, Hq, S, Q), dtype=torch.float32, device=dev)
        if merge:
            counters = merge_counters(dev, merge_counter_cells(B, Hkv, rows))
    return out, partial, lse, counters


def _launched(key, out, partial, lse, counters):
    """Count a sweep launch under ``key`` (and ``merge_fused`` where it
    merged its splits); its result: ``out`` where it wrote one, else
    ``(partial, lse)``."""
    LAUNCHES[key] += 1
    if counters is not None:
        LAUNCHES["merge_fused"] += 1
    return (partial, lse) if out is None else out


def _plain_result(res, dtype, merge):
    """A plain sweep's result as its wrapper returns it: with ``merge``,
    split partials merged (``lse_merge_torch``) into (B, Q, Hq, Dv),
    contiguous."""
    if isinstance(res, torch.Tensor) or not merge:
        return res
    return lse_merge_torch(*res, dtype).transpose(1, 2).contiguous()


def paged_attention_sweep(q, k_pages, v_pages, block_tables, pos, *,
                          k_new=None, v_new=None, n_splits: int = 1,
                          window: int = 0, logit_cap: float = 0.0,
                          scale: float | None = None, k_scale=None,
                          v_scale=None, merge: bool = False):
    """K-sweep.  q (B, Q, Hq, D); pools (P, ps, Hkv, D), in q's dtype, or
    int8 with per-row fp32 ``k_scale`` / ``v_scale`` (P, ps, Hkv, 1);
    block_tables (B, nb) int32; pos (B,) int32; optional in-flight
    candidates k_new / v_new (B, Q, Hkv, D) in q's dtype select the verify
    mask.  Output as :func:`paged_attention_sweep_torch`; with ``merge``,
    ``(B, Q, Hq, D)`` in q's dtype at every split count (the splits merged
    in the launch, :func:`merge_counters`)."""
    kv_dtype = _kv_storage("paged_attention_sweep", k_scale, v_scale,
                           q.dtype)
    if q.device.type == "cpu":
        return _plain_result(paged_attention_sweep_torch(
            q, k_pages, v_pages, block_tables, pos, k_new=k_new, v_new=v_new,
            n_splits=n_splits, window=window, logit_cap=logit_cap,
            scale=scale, k_scale=k_scale, v_scale=v_scale), q.dtype, merge)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_sweep: unsupported device "
                         f"{q.device}")
    refuse_grad("paged_attention_sweep", q, k_pages, v_pages, k_new, v_new)
    from repro_torch.kernels import build
    B, Q, Hq, D = q.shape
    P, ps, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    verify = k_new is not None
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"paged_attention_sweep: dtype {q.dtype} not "
                         "supported (float32 | bfloat16)")
    if D not in SWEEP_HEAD_DIMS:
        raise ValueError(f"paged_attention_sweep: head_dim {D} not "
                         f"supported {SWEEP_HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"paged_attention_sweep: Hq {Hq} not a multiple of "
                         f"Hkv {Hkv}")
    if not 1 <= Q <= SWEEP_MAX_Q:
        raise ValueError(f"paged_attention_sweep: {Q} query rows "
                         f"(1..{SWEEP_MAX_Q})")
    dev = q.device
    check("q", q, dtype=q.dtype, shape=(B, Q, Hq, D), device=dev,
          vector=True)
    check("k_pages", k_pages, dtype=kv_dtype, shape=(P, ps, Hkv, D),
          device=dev, vector=True)
    check("v_pages", v_pages, dtype=kv_dtype, shape=(P, ps, Hkv, D),
          device=dev, vector=True)
    if k_scale is not None:
        check("k_scale", k_scale, dtype=torch.float32, shape=(P, ps, Hkv, 1),
              device=dev)
        check("v_scale", v_scale, dtype=torch.float32, shape=(P, ps, Hkv, 1),
              device=dev)
    check("block_tables", block_tables, dtype=torch.int32, shape=(B, nb),
          device=dev)
    check("pos", pos, dtype=torch.int32, shape=(B,), device=dev)
    if verify:
        check("k_new", k_new, dtype=q.dtype, shape=(B, Q, Hkv, D),
              device=dev, vector=True)
        check("v_new", v_new, dtype=q.dtype, shape=(B, Q, Hkv, D),
              device=dev, vector=True)
    if scale is None:
        scale = D ** -0.5
    S, ppb = split_blocks(nb, n_splits)
    out, partial, lse, counters = _split_buffers(
        q, (B, Q, Hq, D), S, merge, Hkv, Q * (Hq // Hkv))
    err = build.library().paged_attention_sweep(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale),
        ptr(k_new), ptr(v_new), ptr(block_tables), ptr(pos), ptr(out),
        ptr(partial), ptr(lse), ptr(counters), B, Q, Hq, Hkv, P, ps, nb, D,
        S, ppb, int(verify), int(window), float(logit_cap), float(scale),
        DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_sweep: CUDA error {err}")
    return _launched(launch_key("sweep", verify, k_scale), out, partial,
                     lse, counters)


def sweep_occupancy(head_dim: int, dtype, int8: bool = False,
                    sweep: str = "paged") -> dict:
    """Blocks per SM, dynamic shared memory (bytes) and registers a thread
    of the ``paged`` or ``ring`` sweep's kernel for one form (``dtype`` the
    query's, ``int8`` the cached rows'), at its widest block, as the card
    runs it."""
    from repro_torch.kernels import build
    info = (ctypes.c_int * 3)()
    entry = f"{sweep}_attention_occupancy"
    err = getattr(build.library(), entry)(int(head_dim), DTYPE_CODE[dtype],
                                          int(int8), info)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    return dict(blocks_per_sm=info[0], smem_bytes=info[1],
                registers=info[2])


def launch_key(kernel: str, verify: bool, k_scale) -> str:
    """The ``LAUNCHES`` key of a paged (``sweep``) or ring (``ring``)
    sweep launch: its mode, and ``_int8`` for the int8 template."""
    key = f"{kernel}_{'verify' if verify else 'decode'}"
    return key if k_scale is None else key + "_int8"


_SMEM_MAX = 227 * 1024       # shared memory a block may use on Hopper


def ring_attention_sweep(q, k_cache, v_cache, pos, *, k_new=None, v_new=None,
                         n_splits: int = 1, block_k: int = 256,
                         window: int = 0, logit_cap: float = 0.0,
                         scale: float | None = None, k_scale=None,
                         v_scale=None, merge: bool = False):
    """The ring sweep.  q (B, Q, Hq, D); ring caches (B, C, Hkv, D), in
    q's dtype, or int8 with per-row fp32 ``k_scale`` / ``v_scale`` (B, C,
    Hkv, 1); pos (1,) or (B,) int32 on the card (the position of q's first
    row); optional in-flight candidates k_new / v_new (B, Q, Hkv, D) in
    q's dtype select the verify mask.  ``block_k`` is the requested block
    (``ring_block_k`` adjusts it).  Output as
    :func:`ring_attention_sweep_torch`; ``merge`` as in
    :func:`paged_attention_sweep`."""
    kv_dtype = _kv_storage("ring_attention_sweep", k_scale, v_scale, q.dtype)
    if q.device.type == "cpu":
        return _plain_result(ring_attention_sweep_torch(
            q, k_cache, v_cache, pos, k_new=k_new, v_new=v_new,
            n_splits=n_splits, block_k=block_k, window=window,
            logit_cap=logit_cap, scale=scale, k_scale=k_scale,
            v_scale=v_scale), q.dtype, merge)
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention_sweep: unsupported device "
                         f"{q.device}")
    refuse_grad("ring_attention_sweep", q, k_cache, v_cache, k_new, v_new)
    from repro_torch.kernels import build
    B, Q, Hq, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    verify = k_new is not None
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"ring_attention_sweep: dtype {q.dtype} not "
                         "supported (float32 | bfloat16)")
    if D not in SWEEP_HEAD_DIMS:
        raise ValueError(f"ring_attention_sweep: head_dim {D} not "
                         f"supported {SWEEP_HEAD_DIMS}")
    if Hq % Hkv:
        raise ValueError(f"ring_attention_sweep: Hq {Hq} not a multiple of "
                         f"Hkv {Hkv}")
    if not 1 <= Q <= SWEEP_MAX_Q:
        raise ValueError(f"ring_attention_sweep: {Q} query rows "
                         f"(1..{SWEEP_MAX_Q})")
    if verify and Q > C:
        raise ValueError(f"ring_attention_sweep: verify block {Q} exceeds "
                         f"cache capacity {C}")
    bk = ring_block_k(C, block_k)
    n_k = C // bk
    dev = q.device
    check("q", q, dtype=q.dtype, shape=(B, Q, Hq, D), device=dev,
          vector=True)
    check("k_cache", k_cache, dtype=kv_dtype, shape=(B, C, Hkv, D),
          device=dev, vector=True)
    check("v_cache", v_cache, dtype=kv_dtype, shape=(B, C, Hkv, D),
          device=dev, vector=True)
    if k_scale is not None:
        check("k_scale", k_scale, dtype=torch.float32, shape=(B, C, Hkv, 1),
              device=dev)
        check("v_scale", v_scale, dtype=torch.float32, shape=(B, C, Hkv, 1),
              device=dev)
    if pos.numel() not in (1, B):
        raise ValueError(f"ring_attention_sweep: pos must hold 1 or {B} "
                         f"positions, got {tuple(pos.shape)}")
    check("pos", pos, dtype=torch.int32, shape=(pos.numel(),), device=dev)
    if verify:
        check("k_new", k_new, dtype=q.dtype, shape=(B, Q, Hkv, D),
              device=dev, vector=True)
        check("v_new", v_new, dtype=q.dtype, shape=(B, Q, Hkv, D),
              device=dev, vector=True)
    if scale is None:
        scale = D ** -0.5
    S, kpb = split_blocks(n_k, n_splits)
    out, partial, lse, counters = _split_buffers(
        q, (B, Q, Hq, D), S, merge, Hkv, Q * (Hq // Hkv))
    err = build.library().ring_attention_sweep(
        ptr(q), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale),
        ptr(k_new), ptr(v_new), ptr(pos), ptr(out), ptr(partial), ptr(lse),
        ptr(counters), B, Q, Hq, Hkv, C, D, bk, n_k, S, kpb,
        int(pos.numel() > 1), int(verify), int(window), float(logit_cap),
        float(scale), DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_attention_sweep: CUDA error {err}")
    return _launched(launch_key("ring", verify, k_scale), out, partial, lse,
                     counters)


def lse_merge(partial, lse, out_dtype):
    """K-merge: ``partial (..., S, R, Dv)`` fp32 + ``lse (..., S, R)`` fp32
    -> ``(..., R, Dv)`` in ``out_dtype``; on the card Dv is a multiple of
    4.  The standalone launch, for a caller that holds partials: the
    sweeps merge their own with ``merge=True``."""
    if partial.device.type == "cpu":
        return lse_merge_torch(partial, lse, out_dtype)
    if partial.device.type != "cuda":
        raise ValueError(f"lse_merge: unsupported device {partial.device}")
    from repro_torch.kernels import build
    lead = partial.shape[:-3]
    S, R, Dv = partial.shape[-3:]
    if out_dtype not in DTYPE_CODE:
        raise ValueError(f"lse_merge: out dtype {out_dtype} not supported")
    if Dv % 4:
        raise ValueError(f"lse_merge: Dv {Dv} is not a multiple of 4")
    check("partial", partial, dtype=torch.float32, shape=partial.shape,
          device=partial.device, vector=True)
    check("lse", lse, dtype=torch.float32, shape=lead + (S, R),
          device=partial.device)
    N = partial.numel() // (S * R * Dv)
    out = torch.empty(lead + (R, Dv), dtype=out_dtype, device=partial.device)
    err = build.library().lse_merge(
        ptr(partial), ptr(lse), ptr(out), N, S, R, Dv,
        DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(partial.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lse_merge: CUDA error {err}")
    LAUNCHES["merge"] += 1
    return out


# (latent width, value width) the latent sweep is built for: deepseek-v2's
# kv_lora_rank 512 + rope 64
MLA_DIMS = ((576, 512),)
# (query, head) rows a latent-sweep block takes, by q dtype: the tensor-
# core kernel's forms (the launch picks one) and the CUDA-core kernel's
MLA_ROWS = {torch.bfloat16: (16, 32), torch.float32: (16,)}


def mla_smem_bytes(dtype, *, rows: int = 16, kt: int = 16) -> int:
    """The latent sweep's dynamic shared memory at R 576.  bf16: the q tile
    of ``rows`` rows and a ring of three 16-key latent tiles, rows 584 bf16
    apart, and two tiles' partial 16 x 16 scores of every warp (four a 16-
    row tile); fp32: q and ``kt`` key rows of 580 floats, the p tile and
    the (m, l, corr) state."""
    if dtype == torch.bfloat16:
        return 2 * 584 * (rows + 3 * 16) + 2 * (rows // 16) * 4 * 1024
    return 4 * ((16 + kt) * 580 + 16 * kt + 3 * 16)


def mla_latent_sweep(q, pool, block_tables, pos, *, r_kv: int, pending=None,
                     n_splits: int = 1, logit_cap: float = 0.0,
                     scale: float, merge: bool = False):
    """The latent sweep.  q (B, Q, Hq, R) latent queries ``[q_abs |
    q_rope]``; pool (P, ps, R); block_tables (B, nb) int32; pos (B,) int32;
    optional pending latent rows (B, Q, R) select the verify form (pool
    rows ``k_pos < pos``, then pending row j for query i when ``j <= i``).
    ``scale`` is MLA's, of the decompressed head dim.  Output as
    :func:`mla_latent_sweep_torch`; ``merge`` as in
    :func:`paged_attention_sweep`."""
    if q.device.type == "cpu":
        return _plain_result(mla_latent_sweep_torch(
            q, pool, block_tables, pos, r_kv=r_kv, pending=pending,
            n_splits=n_splits, logit_cap=logit_cap, scale=scale), q.dtype,
            merge)
    if q.device.type != "cuda":
        raise ValueError(f"mla_latent_sweep: unsupported device {q.device}")
    refuse_grad("mla_latent_sweep", q, pool, pending)
    from repro_torch.kernels import build
    B, Q, Hq, R = q.shape
    P, ps = pool.shape[0], pool.shape[1]
    nb = block_tables.shape[1]
    verify = pending is not None
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"mla_latent_sweep: dtype {q.dtype} not supported "
                         "(float32 | bfloat16)")
    if (R, r_kv) not in MLA_DIMS:
        raise ValueError(f"mla_latent_sweep: (R, r_kv) {(R, r_kv)} not "
                         f"supported {MLA_DIMS}")
    if q.dtype == torch.float32:
        # the CUDA-core kernel holds a page, or all pending rows, at once
        kt = max(ps, Q) if verify else ps
        smem = mla_smem_bytes(q.dtype, kt=kt)
        if smem > _SMEM_MAX:
            raise ValueError(f"mla_latent_sweep: {kt} key rows need {smem} "
                             f"bytes of shared memory (max {_SMEM_MAX})")
    dev = q.device
    check("q", q, dtype=q.dtype, shape=(B, Q, Hq, R), device=dev,
          vector=True)
    check("pool", pool, dtype=q.dtype, shape=(P, ps, R), device=dev,
          vector=True)
    check("block_tables", block_tables, dtype=torch.int32, shape=(B, nb),
          device=dev)
    check("pos", pos, dtype=torch.int32, shape=(B,), device=dev)
    if verify:
        check("pending", pending, dtype=q.dtype, shape=(B, Q, R),
              device=dev, vector=True)
    S, ppb = split_blocks(nb, n_splits)
    out, partial, lse, counters = _split_buffers(
        q, (B, Q, Hq, r_kv), S, merge, 1, Q * Hq)
    err = build.library().mla_latent_sweep(
        ptr(q), ptr(pool), ptr(pending), ptr(block_tables), ptr(pos),
        ptr(out), ptr(partial), ptr(lse), ptr(counters), B, Q, Hq, P, ps, nb,
        R, r_kv, S, ppb, int(verify), float(logit_cap), float(scale),
        DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_latent_sweep: CUDA error {err}")
    return _launched("mla_verify" if verify else "mla_decode", out, partial,
                     lse, counters)


def mla_occupancy(dtype, rows: int = 16) -> dict:
    """Blocks per SM, dynamic shared memory (bytes) and registers a thread
    of the latent sweep's kernel for one form: bf16 at ``rows`` (query,
    head) rows a block (``MLA_ROWS``), fp32 at 16 rows and 16 key rows, as
    the card runs it."""
    from repro_torch.kernels import build
    info = (ctypes.c_int * 3)()
    err = build.library().mla_latent_occupancy(DTYPE_CODE[dtype], int(rows),
                                               info)
    if err != 0:
        raise RuntimeError(f"mla_latent_occupancy: CUDA error {err}")
    return dict(blocks_per_sm=info[0], smem_bytes=info[1],
                registers=info[2])


# ==========================================================================
# the attention function the model calls (backend "cuda")
# ==========================================================================
def paged_attention(q, k_pages, v_pages, block_tables, pos, *, k_new=None,
                    v_new=None, window: int = 0, logit_cap: float = 0.0,
                    scale: float | None = None, n_splits: int = 1,
                    k_scale=None, v_scale=None):
    """Paged GQA attention on the kernels: one K-sweep launch, which
    merges its splits in its last blocks.  Without candidates it is the
    single-token decode; with the in-flight ``k_new`` / ``v_new`` it is
    the multi-query verify sweep; ``k_scale`` / ``v_scale`` select the
    int8 pools' template.  -> (B, Q, Hq, Dv) in ``q.dtype``,
    contiguous."""
    return paged_attention_sweep(q, k_pages, v_pages, block_tables, pos,
                                 k_new=k_new, v_new=v_new, n_splits=n_splits,
                                 window=window, logit_cap=logit_cap,
                                 scale=scale, k_scale=k_scale,
                                 v_scale=v_scale, merge=True)


def ring_attention(q, k_cache, v_cache, pos, *, k_new=None, v_new=None,
                   window: int = 0, logit_cap: float = 0.0,
                   scale: float | None = None, n_splits: int = 1,
                   block_k: int = 256, k_scale=None, v_scale=None):
    """GQA attention over the ring cache on the kernels: one ring-sweep
    launch, which merges its splits in its last blocks.  Without
    candidates it is the single-token decode; with the in-flight ``k_new``
    / ``v_new`` the multi-query verify sweep; ``k_scale`` / ``v_scale``
    select the int8 caches' template.  -> (B, Q, Hq, Dv) in ``q.dtype``,
    contiguous."""
    return ring_attention_sweep(q, k_cache, v_cache, pos, k_new=k_new,
                                v_new=v_new, n_splits=n_splits,
                                block_k=block_k, window=window,
                                logit_cap=logit_cap, scale=scale,
                                k_scale=k_scale, v_scale=v_scale, merge=True)


def mla_attention(q, pool, block_tables, pos, *, r_kv: int, pending=None,
                  logit_cap: float = 0.0, scale: float, n_splits: int = 1):
    """Absorbed MLA attention over the paged latent pool on the kernels:
    one latent-sweep launch, which merges its splits in its last blocks.
    Without pending rows it is the single-token decode (K7a / K7b); with
    them the multi-query verify sweep.  -> (B, Q, Hq, r_kv) in
    ``q.dtype``, contiguous."""
    return mla_latent_sweep(q, pool, block_tables, pos, r_kv=r_kv,
                            pending=pending, n_splits=n_splits,
                            logit_cap=logit_cap, scale=scale, merge=True)
