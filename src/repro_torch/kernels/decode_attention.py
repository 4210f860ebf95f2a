"""Paged GQA attention sweep + LSE merge: the hand-written Hopper kernels
of the serving hot path, their wrappers, and their plain PyTorch versions.

Two kernels (``csrc/paged_attention.cu``) replace the five Pallas
functions of the JAX package's paged family:

  * **K-sweep** ``paged_attention_sweep`` — stage 1 of paged GQA attention:
    ``Q`` query rows per ``(b, h)`` (1 for decode, the chunk length for the
    prefix-hit suffix prefill) over the pages in ``block_tables[b]`` for kv
    head ``h // G``, online softmax in fp32, one block per
    ``(b * Hq + h, split)`` looping over its split's contiguous page slice.
    Verify folds the in-flight candidate rows, causally, into the last
    split only.  One split writes the normalised output in the query dtype;
    several write fp32 ``partial (B, Hq, S, Q, Dv)`` + ``lse (B, Hq, S, Q)``.
  * **K-merge** ``lse_merge`` — stage 2: ``out = sum_s partial_s
    exp(lse_s - m) / sum_s exp(lse_s - m)``, denominator clamped at 1e-30.

Each wrapper takes its plain version (``*_torch``, same arithmetic page by
page, vectorised over batch, heads and splits) for a tensor that lies on
the CPU, and for a CUDA tensor launches the kernel or raises — there is no
fallback.  ``LAUNCHES`` counts kernel launches; the plain versions never
touch it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF

# kernel launches, by kernel and mode (plain integers, reset by callers)
LAUNCHES = {"sweep_decode": 0, "sweep_verify": 0, "merge": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def split_blocks(n_blocks: int, n_splits: int) -> tuple[int, int]:
    """Clamp the split count to the block count and size each split's
    contiguous block slice (ceil: the last split may sweep fewer blocks,
    or none)."""
    s = max(1, min(int(n_splits), n_blocks))
    return s, -(-n_blocks // s)


# ==========================================================================
# plain PyTorch versions (the CPU path; on the card only for comparison)
# ==========================================================================
def paged_attention_sweep_torch(q, k_pages, v_pages, block_tables, pos, *,
                                k_new=None, v_new=None, n_splits: int = 1,
                                window: int = 0, logit_cap: float = 0.0,
                                scale: float | None = None):
    """The K-sweep's function in plain torch, page by page as the kernel
    (and the Pallas grid) walks it: a page whose every score is masked for
    every row is skipped, masked scores are NEG_INF, and the state update
    is the reference's online softmax.  Returns the output
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

    def update(state, s, vt, valid, skip_empty):
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
        if skip_empty is None:
            return m_new, l_new, acc_new
        run = skip_empty                                        # (B, 1, S, 1)
        return (torch.where(run, m_new, m), torch.where(run, l_new, l),
                torch.where(run[..., None], acc_new, acc))

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
        kt = k_pages[pages][:, :, :, kv_head].float()           # (B,S,ps,Hq,D)
        vt = v_pages[pages][:, :, :, kv_head].float()
        s = torch.einsum("bhqd,bskhd->bhsqk", qf, kt) * scale
        run = valid.reshape(B, S, -1).any(dim=-1).reshape(B, 1, S, 1)
        m, l, acc = update((m, l, acc), s, vt.permute(0, 3, 1, 2, 4),
                           valid[:, None], run)

    if verify:
        # candidates fold into the LAST split only (no skip: row i always
        # sees candidate i)
        kn = k_new.float()[:, :, kv_head].permute(0, 2, 1, 3)   # (B,Hq,Q,D)
        vn = v_new.float()[:, :, kv_head].permute(0, 2, 1, 3)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kn)[:, :, None] * scale
        ri = torch.arange(Q, device=dev)[:, None]
        cj = torch.arange(Q, device=dev)[None, :]
        cvalid = cj <= ri
        if window > 0:
            cvalid = cvalid & (cj > ri - window)
        last = (m[:, :, -1:], l[:, :, -1:], acc[:, :, -1:])
        ml, ll, al = update(last, s, vn[:, :, None], cvalid, None)
        m = torch.cat([m[:, :, :-1], ml], dim=2)
        l = torch.cat([l[:, :, :-1], ll], dim=2)
        acc = torch.cat([acc[:, :, :-1], al], dim=2)

    partial = acc / torch.clamp(l, min=1e-30)[..., None]
    if S == 1:
        return partial[:, :, 0].permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l > 0.0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(m, NEG_INF))
    return partial, lse


def lse_merge_torch(partial, lse, out_dtype):
    """The K-merge's function in plain torch: ``partial (..., S, R, Dv)``
    fp32 + ``lse (..., S, R)`` -> ``(..., R, Dv)`` in ``out_dtype``."""
    m = torch.amax(lse, dim=-2)                                 # (..., R)
    w = torch.exp(lse - m[..., None, :])                        # (..., S, R)
    den = torch.clamp(w.sum(dim=-2), min=1e-30)
    acc = (partial * w[..., None]).sum(dim=-3)
    return (acc / den[..., None]).to(out_dtype)


# ==========================================================================
# kernel wrappers
# ==========================================================================
def _check(name, t, *, dtype, shape, device, vector=False):
    """Raise unless ``t`` is what the kernel takes; ``vector`` tensors are
    read with 16-byte loads, so their base must be 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if vector and t.data_ptr() % 16:
        raise ValueError(f"{name}: base address not 16-byte aligned")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def paged_attention_sweep(q, k_pages, v_pages, block_tables, pos, *,
                          k_new=None, v_new=None, n_splits: int = 1,
                          window: int = 0, logit_cap: float = 0.0,
                          scale: float | None = None):
    """K-sweep.  q (B, Q, Hq, D); pools (P, ps, Hkv, D); block_tables
    (B, nb) int32; pos (B,) int32; optional in-flight candidates k_new /
    v_new (B, Q, Hkv, D) select the verify mask.  Output as
    :func:`paged_attention_sweep_torch`."""
    if q.device.type == "cpu":
        return paged_attention_sweep_torch(
            q, k_pages, v_pages, block_tables, pos, k_new=k_new, v_new=v_new,
            n_splits=n_splits, window=window, logit_cap=logit_cap,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_sweep: unsupported device "
                         f"{q.device}")
    from repro_torch.kernels import build
    B, Q, Hq, D = q.shape
    P, ps, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    nb = block_tables.shape[1]
    verify = k_new is not None
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"paged_attention_sweep: dtype {q.dtype} not "
                         "supported (float32 | bfloat16)")
    if D not in (64, 128):
        raise ValueError(f"paged_attention_sweep: head_dim {D} not "
                         "supported (64 | 128)")
    if Hq % Hkv:
        raise ValueError(f"paged_attention_sweep: Hq {Hq} not a multiple of "
                         f"Hkv {Hkv}")
    if not 1 <= Q <= 128:
        raise ValueError(f"paged_attention_sweep: {Q} query rows (1..128)")
    dev = q.device
    _check("q", q, dtype=q.dtype, shape=(B, Q, Hq, D), device=dev,
           vector=True)
    _check("k_pages", k_pages, dtype=q.dtype, shape=(P, ps, Hkv, D),
           device=dev, vector=True)
    _check("v_pages", v_pages, dtype=q.dtype, shape=(P, ps, Hkv, D),
           device=dev, vector=True)
    _check("block_tables", block_tables, dtype=torch.int32, shape=(B, nb),
           device=dev)
    _check("pos", pos, dtype=torch.int32, shape=(B,), device=dev)
    if verify:
        _check("k_new", k_new, dtype=q.dtype, shape=(B, Q, Hkv, D),
               device=dev, vector=True)
        _check("v_new", v_new, dtype=q.dtype, shape=(B, Q, Hkv, D),
               device=dev, vector=True)
    if scale is None:
        scale = D ** -0.5
    S, ppb = split_blocks(nb, n_splits)
    out = partial = lse = None
    if S == 1:
        out = torch.empty((B, Q, Hq, D), dtype=q.dtype, device=dev)
    else:
        partial = torch.empty((B, Hq, S, Q, D), dtype=torch.float32,
                              device=dev)
        lse = torch.empty((B, Hq, S, Q), dtype=torch.float32, device=dev)
    err = build.library().paged_attention_sweep(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(k_new), _ptr(v_new),
        _ptr(block_tables), _ptr(pos), _ptr(out), _ptr(partial), _ptr(lse),
        B, Q, Hq, Hkv, P, ps, nb, D, S, ppb, int(verify), int(window),
        float(logit_cap), float(scale), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_sweep: CUDA error {err}")
    LAUNCHES["sweep_verify" if verify else "sweep_decode"] += 1
    return out if S == 1 else (partial, lse)


def lse_merge(partial, lse, out_dtype):
    """K-merge: ``partial (..., S, R, Dv)`` fp32 + ``lse (..., S, R)`` fp32
    -> ``(..., R, Dv)`` in ``out_dtype``."""
    if partial.device.type == "cpu":
        return lse_merge_torch(partial, lse, out_dtype)
    if partial.device.type != "cuda":
        raise ValueError(f"lse_merge: unsupported device {partial.device}")
    from repro_torch.kernels import build
    lead = partial.shape[:-3]
    S, R, Dv = partial.shape[-3:]
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"lse_merge: out dtype {out_dtype} not supported")
    _check("partial", partial, dtype=torch.float32, shape=partial.shape,
           device=partial.device)
    _check("lse", lse, dtype=torch.float32, shape=lead + (S, R),
           device=partial.device)
    N = partial.numel() // (S * R * Dv)
    out = torch.empty(lead + (R, Dv), dtype=out_dtype, device=partial.device)
    err = build.library().lse_merge(
        _ptr(partial), _ptr(lse), _ptr(out), N, S, R, Dv,
        _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(partial.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lse_merge: CUDA error {err}")
    LAUNCHES["merge"] += 1
    return out


# ==========================================================================
# the attention function the model calls (backend "cuda")
# ==========================================================================
def paged_attention(q, k_pages, v_pages, block_tables, pos, *, k_new=None,
                    v_new=None, window: int = 0, logit_cap: float = 0.0,
                    scale: float | None = None, n_splits: int = 1):
    """Paged GQA attention on the kernels: K-sweep, then K-merge when it
    split.  Without candidates it is the single-token decode; with the
    in-flight ``k_new`` / ``v_new`` it is the multi-query verify sweep.
    -> (B, Q, Hq, Dv) in ``q.dtype``."""
    res = paged_attention_sweep(q, k_pages, v_pages, block_tables, pos,
                                k_new=k_new, v_new=v_new, n_splits=n_splits,
                                window=window, logit_cap=logit_cap,
                                scale=scale)
    if isinstance(res, torch.Tensor):
        return res
    return lse_merge(*res, q.dtype).transpose(1, 2)
