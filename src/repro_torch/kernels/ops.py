"""Kernel entry points of the port, with backend dispatch.

Counterpart of ``repro.kernels.ops`` for the ops this slice runs:

  * ``attention`` (prefill): ``ref`` (whole-matrix oracle) or ``chunked``
    (flash-style online softmax in plain torch), chosen exactly as the JAX
    package chooses under ``auto``.
  * ``paged_decode_attention`` / ``paged_verify_attention`` (the serving
    hot path) on ``KernelPolicy.decode``: ``ref`` the fp32 oracle,
    ``torch`` the gather-then-attend path that mirrors the JAX ``jnp``
    backend, ``cuda`` the hand-written Hopper kernels
    (``kernels/decode_attention.py``).  ``auto`` is ``cuda`` for CUDA
    tensors and ``torch`` for CPU tensors.

Each plain version of the paged sweep has one role:

  * ``ref`` (``kernels/ref.py``): the fp32 oracle, whole-matrix softmax.
  * ``torch`` (``paged_*_attention_torch`` here): the JAX ``jnp`` backend's
    mirror, gather then attend.  It is what ``auto`` runs on the CPU, and
    on the card it is the independent reference that ``chip_smoke.py``
    holds the kernel-backed engine against.
  * ``decode_attention.paged_attention_sweep_torch`` / ``lse_merge_torch``:
    the kernels' twins, page by page as the kernel walks.  The wrappers
    take them for CPU tensors (so ``cuda`` on CPU tensors runs them), and
    ``chip_smoke.py`` holds each kernel against its twin.  The split
    merge here reuses ``lse_merge_torch``.

The split count of the two-stage sweep comes from the same occupancy
heuristic as the JAX package; the executors are the card's SMs on CUDA and
the host's threads on the CPU, so a CPU run picks the same split count as
the JAX package on the same box.
"""
from __future__ import annotations

import dataclasses
import os

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_attention import lse_merge_torch
from repro_torch.kernels.ref import NEG_INF


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Which implementation backs each op."""
    attention: str = "auto"      # auto | ref | chunked
    ssd: str = "auto"
    rmsnorm: str = "auto"
    decode: str = "auto"         # auto | ref | torch | cuda
    q_chunk: int = 1024
    k_chunk: int = 1024
    ssd_chunk: int = 128
    decode_k_chunk: int = 256    # split-K block of the ring kernels (not ported)
    kv_splits: str | int = "auto"  # two-stage split count: "auto" | int (1 = single-stage)
    kv_dtype: str = "bfloat16"   # KV-pool storage; "int8" is the KV-tier slice


DEFAULT_POLICY = KernelPolicy()


# ==========================================================================
# Two-stage split-KV: occupancy heuristic + plain split helper
# ==========================================================================
def _sweep_executors(device: torch.device | None = None) -> int:
    """Independent executors for the decode-sweep grid: the SMs of the
    card for CUDA tensors, the host's threads on the CPU."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return os.cpu_count() or 1


def choose_kv_splits(batch: int, kv_len: int, q_heads: int,
                     n_cores: int | None = None, *,
                     block: int = 256, max_splits: int = 16,
                     device: torch.device | None = None) -> int:
    """Occupancy-model heuristic for the two-stage split-KV sweep (same
    rule as the JAX package): split only when ``batch * q_heads`` cells
    underfill the executors, just enough to cover them twice, never past
    the block count or ``max_splits``."""
    if n_cores is None:
        n_cores = _sweep_executors(device)
    cells = int(batch) * int(q_heads)
    n_blocks = -(-int(kv_len) // max(1, int(block)))
    if cells >= 2 * n_cores or n_blocks <= 1:
        return 1
    return max(1, min(-(-2 * n_cores // max(1, cells)), n_blocks, max_splits))


def effective_kv_len(kv_len: int, window: int = 0) -> int:
    """Clip the logical KV length to the attention window for occupancy
    decisions: a windowed layer never attends past ``window`` keys."""
    kv_len = int(kv_len)
    return min(kv_len, int(window)) if window > 0 else kv_len


def _resolve_kv_splits(policy: KernelPolicy, batch: int, kv_len: int,
                       q_heads: int, *, block: int,
                       device: torch.device) -> int:
    if policy.kv_splits == "auto":
        return choose_kv_splits(batch, kv_len, q_heads, block=block,
                                device=device)
    return max(1, int(policy.kv_splits))


def _split_attend_torch(s, vf, n_splits: int):
    """Two-stage softmax-weighted sum, mirror of the JAX ``_split_attend_jnp``:
    partition the masked score axis into ``n_splits`` slices, per-split
    normalised partials + LSE, then LSE-merge.

    s:  (B, Hkv, G, R, K) fp32 masked scores (invalid entries = NEG_INF)
    vf: (B, K, Hkv, Dv)   values in logical key order
    -> (B, Hkv, G, R, Dv) fp32
    """
    B, Hkv, G, R, K = s.shape
    Dv = vf.shape[-1]
    S = max(1, min(int(n_splits), K))
    kps = -(-K // S)
    pad = S * kps - K
    sp = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
    vp = torch.nn.functional.pad(vf.float(), (0, 0, 0, 0, 0, pad))
    sp = sp.reshape(B, Hkv, G, R, S, kps)
    vp = vp.reshape(B, S, kps, Hkv, Dv)
    m = torch.amax(sp, dim=-1)
    p = torch.exp(sp - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgrsk,bskhd->bhgrsd", p, vp)
    partial = acc / torch.clamp(l, min=1e-30)[..., None]
    # fully-masked splits: the m-guard (not l > 0) zeroes their weight
    lse = torch.where(m > 0.5 * NEG_INF,
                      m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(m, NEG_INF))
    # the merge takes the split axis ahead of the row axis
    return lse_merge_torch(partial.transpose(-3, -2), lse.transpose(-2, -1),
                           torch.float32)


def _no_int8(k_scale, v_scale) -> None:
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("int8 KV pages: KV-tier slice")


# ==========================================================================
# Attention (prefill)
# ==========================================================================
def _chunk_attend(q, k, v, carry, mask, scale, logit_cap):
    """One (q-chunk, k-chunk) online-softmax update, all fp32.
    q (B,Hkv,G,Cq,D), k (B,Hkv,Ck,D), v (B,Hkv,Ck,Dv), mask (Cq, Ck)."""
    m, l, acc = carry
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return m_new, l_new, acc_new


def flash_attention_torch(q, k, v, *, causal: bool = True, window: int = 0,
                          logit_cap: float = 0.0, scale: float | None = None,
                          q_offset: int = 0, q_chunk: int = 1024,
                          k_chunk: int = 1024):
    """Flash-style chunked attention in plain torch (mirror of the JAX
    ``flash_attention_jnp``): k-chunks wholly outside the causal/window
    band are never computed; ragged shapes fall back to the oracle."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    if Sq % q_chunk or Sk % k_chunk:
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap, scale=scale,
                                  q_offset=q_offset)
    dev = q.device
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    outs = []
    for i in range(Sq // q_chunk):
        q_lo = q_offset + i * q_chunk
        q_hi = q_lo + q_chunk - 1
        k_hi = min(Sk, q_hi + 1) if causal else Sk
        k_lo = max(0, q_lo - window + 1) if window > 0 else 0
        j_lo, j_hi = k_lo // k_chunk, -(-k_hi // k_chunk)
        j_lo = min(j_lo, j_hi - 1)
        qi = qf[:, :, :, i * q_chunk:(i + 1) * q_chunk]
        carry = (torch.full((B, Hkv, G, q_chunk), NEG_INF, device=dev),
                 torch.zeros((B, Hkv, G, q_chunk), device=dev),
                 torch.zeros((B, Hkv, G, q_chunk, Dv), device=dev))
        q_pos = q_lo + torch.arange(q_chunk, device=dev)[:, None]
        for j in range(j_lo, j_hi):
            k_pos = j * k_chunk + torch.arange(k_chunk, device=dev)[None, :]
            mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window > 0:
                mask &= k_pos > q_pos - window
            sl = slice(j * k_chunk, (j + 1) * k_chunk)
            carry = _chunk_attend(qi, kf[:, :, sl], vf[:, :, sl], carry,
                                  mask, scale, logit_cap)
        m, l, acc = carry
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    o = torch.cat(outs, dim=3)                            # (B,Hkv,G,Sq,Dv)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, logit_cap=0.0, scale=None,
              q_offset=0, policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching attention entry point (prefill)."""
    backend = policy.attention
    if backend == "auto":
        backend = "ref" if q.shape[1] * k.shape[1] <= 512 * 512 else "chunked"
    if backend == "ref":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap, scale=scale,
                                  q_offset=q_offset)
    if backend == "chunked":
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, scale=scale,
                                     q_offset=q_offset, q_chunk=policy.q_chunk,
                                     k_chunk=policy.k_chunk)
    raise ValueError(f"unknown attention backend {backend!r} "
                     "(ported: auto | ref | chunked)")


# ==========================================================================
# Paged decode / verify
# ==========================================================================
def _gather(pages, block_tables):
    B, nb = block_tables.shape
    return pages[block_tables.long()].reshape(B, nb * pages.shape[1],
                                              *pages.shape[2:])


def paged_verify_attention_torch(q, k_pages, v_pages, k_new, v_new,
                                 block_tables, pos, *, window: int = 0,
                                 logit_cap: float = 0.0,
                                 scale: float | None = None,
                                 n_splits: int = 1):
    """Gather-then-attend paged multi-query sweep, mirror of the JAX
    ``paged_verify_attention_jnp``: pool committed through ``pos[b] - 1``,
    in-flight candidates causal within the fed block."""
    B, Q, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    nb, ps = block_tables.shape[1], k_pages.shape[1]
    Dv = v_pages.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kg = _gather(k_pages, block_tables).float()
    vg = _gather(v_pages, block_tables).float()
    qf = q.float().reshape(B, Q, Hkv, G, D)
    posb = pos.reshape(B, 1, 1).to(dev)
    q_pos = posb + torch.arange(Q, device=dev)[None, :, None]
    s_c = torch.einsum("bqhgd,bkhd->bhgqk", qf, kg)
    s_n = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_new.float())
    s = torch.cat([s_c, s_n], dim=-1) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(nb * ps, device=dev)[None, None, :]
    valid_c = (k_pos < posb).expand(B, Q, nb * ps)
    n_pos = posb + torch.arange(Q, device=dev)[None, None, :]
    valid_n = n_pos <= q_pos
    if window > 0:
        valid_c = valid_c & (k_pos > q_pos - window)
        valid_n &= n_pos > q_pos - window
    valid = torch.cat([valid_c, valid_n], dim=-1)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    vf = torch.cat([vg, v_new.float()], dim=1)
    if n_splits > 1:
        o = _split_attend_torch(s, vf, n_splits).permute(0, 3, 1, 2, 4)
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Q, Hq, Dv).to(q.dtype)


def paged_decode_attention_torch(q, k_pages, v_pages, block_tables, pos, *,
                                 window: int = 0, logit_cap: float = 0.0,
                                 scale: float | None = None,
                                 n_splits: int = 1):
    """Gather-then-attend paged single-token decode, mirror of the JAX
    ``paged_decode_attention_jnp``."""
    B, _, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    nb, ps = block_tables.shape[1], k_pages.shape[1]
    Dv = v_pages.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kg = _gather(k_pages, block_tables).float()
    vg = _gather(v_pages, block_tables).float()
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kg) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_pos = torch.arange(nb * ps, device=dev)[None, :]
    posb = pos.reshape(B, 1).to(dev)
    valid = k_pos <= posb
    if window > 0:
        valid &= k_pos > posb - window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    if n_splits > 1:
        o = _split_attend_torch(s[:, :, :, None, :], vg, n_splits)[..., 0, :]
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p, vg)
    return o.reshape(B, 1, Hq, Dv).to(q.dtype)


def _decode_backend(policy: KernelPolicy, q) -> str:
    backend = policy.decode
    if backend == "auto":
        backend = "cuda" if q.device.type == "cuda" else "torch"
    return backend


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           window: int = 0, logit_cap: float = 0.0,
                           scale: float | None = None, k_scale=None,
                           v_scale=None,
                           policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching paged decode attention (the continuous-batching
    hot path).  The split-K block is the page size."""
    _no_int8(k_scale, v_scale)
    backend = _decode_backend(policy, q)
    ps, nb = k_pages.shape[1], block_tables.shape[1]
    n_splits = _resolve_kv_splits(policy, q.shape[0],
                                  effective_kv_len(nb * ps, window),
                                  q.shape[2], block=ps, device=q.device)
    if backend == "cuda":
        return da.paged_attention(q, k_pages, v_pages, block_tables, pos,
                                  window=window, logit_cap=logit_cap,
                                  scale=scale, n_splits=n_splits)
    if backend == "ref":
        return _ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, pos, window=window,
            logit_cap=logit_cap, scale=scale)
    if backend == "torch":
        return paged_decode_attention_torch(
            q, k_pages, v_pages, block_tables, pos, window=window,
            logit_cap=logit_cap, scale=scale, n_splits=n_splits)
    raise ValueError(f"unknown decode backend {backend!r}")


def paged_verify_attention(q, k_pages, v_pages, k_new, v_new, block_tables,
                           pos, *, window: int = 0, logit_cap: float = 0.0,
                           scale: float | None = None, k_scale=None,
                           v_scale=None,
                           policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching multi-query attention over the paged KV cache:
    speculative verify and the prefix-hit suffix prefill share it."""
    _no_int8(k_scale, v_scale)
    backend = _decode_backend(policy, q)
    ps, nb = k_pages.shape[1], block_tables.shape[1]
    n_splits = _resolve_kv_splits(policy, q.shape[0],
                                  effective_kv_len(nb * ps, window),
                                  q.shape[2], block=ps, device=q.device)
    if backend == "cuda":
        return da.paged_attention(q, k_pages, v_pages, block_tables, pos,
                                  k_new=k_new, v_new=v_new, window=window,
                                  logit_cap=logit_cap, scale=scale,
                                  n_splits=n_splits)
    if backend == "ref":
        return _ref.paged_verify_attention_ref(
            q, k_pages, v_pages, k_new, v_new, block_tables, pos,
            window=window, logit_cap=logit_cap, scale=scale)
    if backend == "torch":
        return paged_verify_attention_torch(
            q, k_pages, v_pages, k_new, v_new, block_tables, pos,
            window=window, logit_cap=logit_cap, scale=scale,
            n_splits=n_splits)
    raise ValueError(f"unknown decode backend {backend!r}")
