"""Prefill flash attention: the hand-written Hopper kernels of K4
(``csrc/flash_attention.cu``, replacing the JAX package's Pallas
``flash_attention``) and their wrapper.  bf16 runs on the tensor cores
(``mma.sync`` m16n8k16, fp32 accumulators, k/v tiles copied
asynchronously); fp32 on the CUDA cores, in full fp32.

Its plain version is ``ops.flash_attention_torch`` (the JAX
``flash_attention_jnp`` mirror, chunked online softmax in plain torch).
The wrapper takes it for a tensor that lies on the CPU; for a CUDA tensor
it launches the kernel or raises, with no fallback.  ``LAUNCHES
["flash_attention"]`` counts the launches.

Training: on a CUDA tensor that requires grad (with grad mode on) the
wrapper goes through ``FlashAttentionFn``, whose forward is the same
kernel given a log-sum-exp output as well (a null one writes none), and
whose backward is the hand-written kernels of
``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``,
FlashAttention-2's form: dk / dv by key tile, dq by q tile, p recomputed
from the log-sum-exp; ``LAUNCHES["flash_attention_bwd"]`` counts its
calls).  In bf16 at (64, 64), (120, 120) and (128, 128) they are Hopper
kernels (wgmma products, TMA copies through a two-stage ring, the mask
only on the tiles it cuts: ``bwd_tile_class``); fp32, and bf16 at
(192, 128), keep the first kernels (CUDA cores, ``mma.sync``).  Their
plain twins, ``attention_lse_torch`` and
``flash_attention_bwd_torch``, are what the two take for CPU tensors, so
the autograd function runs on the CPU too.  The backward takes every
form of ``HEAD_DIMS`` at G up to ``BWD_ROWS``; a larger G raises when the
forward is asked for a gradient.

Rows that see no key (only ``q_offset`` or window edge cases make them;
every model row sees itself) follow the reference's finite ``NEG_INF``: the
kernel returns the mean of the v rows of the in-range keys of the key
tiles its block visits (64 keys; 32 in the bf16 kernel at D 192), or 0
when the block visits none.  Like the reference's, that value depends on
the tile size, so it differs from the plain version's; it is finite.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr
from repro_torch.kernels.ref import NEG_INF

ROWS = 128          # (q position, q head) rows per kernel block
# (q/k head dim, v head dim) pairs built: the dense families' (h2o-danube's
# 120 among them) and deepseek-v2's MLA prefill ([nope 128 | rope 64] q/k,
# v 128); the kernels' shared memory at each is checked against Hopper's
# 227 KB when they compile
HEAD_DIMS = ((64, 64), (120, 120), (128, 128), (192, 128))
BWD_ROWS = 64       # the most q heads a kv head the backward takes, and
                    # the (q position, q head) rows a q tile of its fp32
                    # and mma.sync kernels
# rows a q tile of the Hopper (wgmma) backward kernels, by the bf16 forms
# that take them
BWD_WGMMA_ROWS = {(64, 64): 128, (120, 120): 64, (128, 128): 64}
BWD_KEYS = 64       # keys a key tile of the backward kernels
TILE_SKIP, TILE_FULL, TILE_MASKED = 0, 1, 2


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, scale: float | None = None,
                    q_offset: int = 0):
    """K4.  q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) ->
    (B, Sq, Hq, Dv) in q's dtype, (D, Dv) one of ``HEAD_DIMS``.  fp32
    online softmax; the soft-cap ``logit_cap * tanh(s / logit_cap)`` comes
    before the causal / window mask; ``scale`` defaults to ``D ** -0.5``;
    query row i sits at position ``q_offset + i``."""
    if q.device.type == "cpu":
        from repro_torch.kernels.ops import flash_attention_torch
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, scale=scale,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, logit_cap,
                                      scale, q_offset)
    return _forward(q, k, v, causal=causal, window=window,
                    logit_cap=logit_cap, scale=scale, q_offset=q_offset)[0]


def _forward(q, k, v, *, causal, window, logit_cap, scale, q_offset,
             with_lse: bool = False):
    """The kernel's launch: (out, lse (B, Hq, Sq) fp32 or None)."""
    from repro_torch.kernels import build
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(float32 | bfloat16)")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: (head_dim, v head_dim) "
                         f"{(D, Dv)} not supported {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > ROWS:
        raise ValueError(f"flash_attention: Hq {Hq} not a multiple of Hkv "
                         f"{Hkv} with at most {ROWS} q heads per kv head")
    if Sk < 1:
        raise ValueError("flash_attention: no keys")
    dev = q.device
    check("q", q, dtype=q.dtype, shape=(B, Sq, Hq, D), device=dev,
          vector=True)
    check("k", k, dtype=q.dtype, shape=(B, Sk, Hkv, D), device=dev,
          vector=True)
    check("v", v, dtype=q.dtype, shape=(B, Sk, Hkv, Dv), device=dev,
          vector=True)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if B == 0 or Sq == 0:
        return out, lse
    if scale is None:
        scale = D ** -0.5
    lib = build.library()
    args = (B, Sq, Sk, Hq, Hkv, D, Dv, ROWS // (Hq // Hkv), int(causal),
            int(window), int(q_offset), float(logit_cap), float(scale),
            DTYPE_CODE[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    err = lib.flash_attention_fwd(ptr(q), ptr(k), ptr(v), ptr(out),
                                  ptr(lse), *args)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out, lse


def attention_lse_torch(q, k, v, *, causal: bool = True, window: int = 0,
                        logit_cap: float = 0.0, scale: float | None = None,
                        q_offset: int = 0):
    """The plain twin of the training forward: (out in q's dtype, lse (B,
    Hq, Sq) fp32), whole-matrix softmax in fp32, lse = log sum exp of the
    scaled, soft-capped, masked scores (natural log)."""
    s, _ = _scores(q, k, causal=causal, window=window, logit_cap=logit_cap,
                   scale=scale, q_offset=q_offset)
    lse = torch.logsumexp(s, dim=-1)                       # (B, Hkv, G, Sq)
    p = torch.exp(s - lse[..., None])
    B, Sq, Hq = q.shape[:3]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype),
            lse.reshape(B, Hq, Sq))


def _scores(q, k, *, causal, window, logit_cap, scale, q_offset):
    """The masked fp32 scores (B, Hkv, G, Sq, Sk) and, under the soft-cap,
    tanh of the scaled scores (else None)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    t = None
    if logit_cap > 0.0:
        t = torch.tanh(s / logit_cap)
        s = logit_cap * t
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    k_pos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return torch.where(mask, s, NEG_INF), t


def flash_attention_bwd_torch(q, k, v, out, lse, dout, *, causal=True,
                              window=0, logit_cap=0.0, scale=None,
                              q_offset=0):
    """The plain twin of the backward kernels: p recomputed from the saved
    ``lse``, delta = rowsum(dout * out), ds = p (dp - delta) (times 1 -
    tanh^2 under the soft-cap, times the scale), in fp32; -> (dq, dk, dv)
    in q's dtype, the G heads of a kv head summed into its dk, dv."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    s, t = _scores(q, k, causal=causal, window=window, logit_cap=logit_cap,
                   scale=scale, q_offset=q_offset)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq)[..., None])
    do = dout.float().reshape(B, Sq, Hkv, G, Dv)
    delta = (dout.float() * out.float()).sum(-1)            # (B, Sq, Hq)
    delta = delta.reshape(B, Sq, Hkv, G).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do, v.float())
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(B, Sq, Hkv, G, D))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(
        B, Sq, Hq, D)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0, logit_cap: float = 0.0,
                        scale: float | None = None, q_offset: int = 0):
    """K4's backward: (dq, dk, dv) in q's dtype from the forward's inputs,
    its ``out`` and ``lse`` (``FlashAttentionFn``'s forward) and the
    output gradient ``dout``.  The plain twin for CPU tensors; for CUDA
    tensors the three launches of ``flash_attention_bwd`` (delta, or lse
    and delta packed by q tile for the Hopper kernels; dk / dv; dq) or a
    raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_torch(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         logit_cap=logit_cap, scale=scale,
                                         q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    from repro_torch.kernels import build
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    _check_backward(q, k, v)
    dev = q.device
    for name, t, shape in (("q", q, (B, Sq, Hq, D)), ("k", k, (B, Sk, Hkv, D)),
                           ("v", v, (B, Sk, Hkv, Dv)),
                           ("out", out, (B, Sq, Hq, Dv)),
                           ("dout", dout, (B, Sq, Hq, Dv))):
        check(name, t, dtype=q.dtype, shape=shape, device=dev, vector=True)
    check("lse", lse, dtype=torch.float32, shape=(B, Hq, Sq), device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    bq, n_ws = bwd_plan(D, Dv, q.dtype, B, Sq, Hq, Hkv)
    delta = torch.empty((n_ws,), dtype=torch.float32, device=dev)
    if scale is None:
        scale = D ** -0.5
    err = build.library().flash_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(dout), ptr(lse), ptr(delta),
        ptr(dq), ptr(dk), ptr(dv), B, Sq, Sk, Hq, Hkv, D, Dv,
        bq, int(causal), int(window), int(q_offset),
        float(logit_cap), float(scale), DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def bwd_plan(head_dim: int, v_head_dim: int, dtype, B: int, Sq: int,
             Hq: int, Hkv: int) -> tuple[int, int]:
    """The backward kernels' q tiling: (bq q positions a q tile, fp32
    values of the workspace).  The Hopper kernels take q tiles of
    ``BWD_WGMMA_ROWS`` rows (bq = rows // G) and a workspace of lse and
    delta by q tile, 2 x rows values a (batch, kv head, q tile); the
    others q tiles of ``BWD_ROWS`` rows and delta as (B, Hq, Sq)."""
    G = Hq // Hkv
    rows = (BWD_WGMMA_ROWS.get((head_dim, v_head_dim))
            if dtype == torch.bfloat16 else None)
    if rows is None:
        return BWD_ROWS // G, B * Hq * Sq
    bq = rows // G
    return bq, B * Hkv * -(-Sq // bq) * 2 * rows


def bwd_tile_class(qlo: int, qhi: int, k0: int, nk: int, causal: bool,
                   window: int) -> int:
    """The Hopper backward kernels' class of a (q rows, key tile) pair,
    as ``tile_class`` in ``csrc/flash_attention_bwd.cu`` computes it: q
    positions ``[qlo, qhi]`` against keys ``[k0, k0 + nk)`` of a
    ``BWD_KEYS`` tile.  ``TILE_SKIP`` where no position sees a key,
    ``TILE_FULL`` where every position sees every key of a whole tile (no
    per-element mask), else ``TILE_MASKED``."""
    khi = k0 + nk - 1
    if nk <= 0 or qhi < qlo or (causal and k0 > qhi) \
            or (window > 0 and qlo - khi >= window):
        return TILE_SKIP
    if nk == BWD_KEYS and (not causal or khi <= qlo) \
            and (window <= 0 or qhi - k0 < window):
        return TILE_FULL
    return TILE_MASKED


def bwd_q_walk(k0: int, nk: int, Sq: int, bq: int, causal: bool,
               window: int, q_offset: int) -> range:
    """The q tiles (of bq positions) a dk / dv block of keys ``[k0, k0 +
    nk)`` walks: those holding a position that sees one of its keys."""
    i_lo = max(0, k0 - q_offset) if causal else 0
    i_hi = Sq - 1
    if window > 0:
        i_hi = min(i_hi, k0 + nk - 2 + window - q_offset)
    t_lo = i_lo // bq
    return range(t_lo, t_lo if i_hi < i_lo else i_hi // bq + 1)


def bwd_k_walk(plo: int, phi: int, Sk: int, causal: bool,
               window: int) -> range:
    """The key tiles a dq block of q positions ``[plo, phi]`` walks: those
    holding a key one of them can see (and, without the causal mask, the
    tile holding the window's start where it lies past every key: a
    SKIP)."""
    k_hi = max(0, min(Sk, phi + 1) if causal else Sk)
    k_lo = max(0, plo - window + 1) if window > 0 else 0
    return range(k_lo // BWD_KEYS, -(-k_hi // BWD_KEYS))


def _check_backward(q, k, v):
    """Raise for a form the backward kernels do not take."""
    D, Dv = q.shape[-1], v.shape[-1]
    Hq, Hkv = q.shape[2], k.shape[2]
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: (head_dim, v head_dim) "
                         f"{(D, Dv)} not supported {HEAD_DIMS}")
    if Hq % Hkv or Hq // Hkv > BWD_ROWS:
        raise ValueError(f"flash_attention_bwd: {Hq // max(Hkv, 1)} q heads "
                         f"per kv head (at most {BWD_ROWS}) has no backward "
                         "kernel")


class FlashAttentionFn(torch.autograd.Function):
    """K4 with a gradient: the forward kernel with the log-sum-exp, the
    backward kernels of ``flash_attention_bwd``; on CPU tensors their plain
    twins."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap, scale, q_offset):
        kw = dict(causal=causal, window=window, logit_cap=logit_cap,
                  scale=scale, q_offset=q_offset)
        if q.device.type == "cpu":
            out, lse = attention_lse_torch(q, k, v, **kw)
        else:
            _check_backward(q, k, v)
            out, lse = _forward(q, k, v, with_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def bwd_occupancy(head_dim: int, v_head_dim: int, dtype, part: str) -> dict:
    """The dk / dv (``part`` "dkdv") or dq ("dq") kernel the backward
    launches for a (D, Dv, dtype) form, as the card runs it: blocks per
    SM, dynamic shared memory bytes and registers a thread."""
    from repro_torch.kernels import build
    info = (ctypes.c_int * 3)()
    err = build.library().flash_attention_bwd_occupancy(
        head_dim, v_head_dim, DTYPE_CODE[dtype], ("dkdv", "dq").index(part),
        info)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_occupancy: CUDA error {err}")
    return dict(blocks_per_sm=info[0], smem_bytes=info[1],
                registers=info[2])


def occupancy(head_dim: int, v_head_dim: int, dtype) -> dict:
    """The kernel ``flash_attention`` launches for a (D, Dv, dtype) form, as
    the card runs it: blocks per SM, dynamic shared memory bytes and
    registers a thread."""
    from repro_torch.kernels import build
    info = (ctypes.c_int * 3)()
    err = build.library().flash_attention_occupancy(
        head_dim, v_head_dim, DTYPE_CODE[dtype], info)
    if err != 0:
        raise RuntimeError(f"flash_attention_occupancy: CUDA error {err}")
    return dict(blocks_per_sm=info[0], smem_bytes=info[1],
                registers=info[2])
