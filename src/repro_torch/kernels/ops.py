"""Kernel entry points of the port, with backend dispatch.

Counterpart of ``repro.kernels.ops`` for the ops the port runs:

  * ``attention`` (prefill) on ``KernelPolicy.attention``: ``ref``
    (whole-matrix oracle), ``chunked`` (flash-style online softmax in
    plain torch, ``flash_attention_torch``) or ``cuda`` (the hand-written
    Hopper kernel K4, ``kernels/flash_attention.py``).  ``auto`` is
    ``cuda`` for CUDA tensors; for CPU tensors it chooses between ``ref``
    and ``chunked`` exactly as the JAX package does under ``auto``.
  * ``rmsnorm`` on ``KernelPolicy.rmsnorm``: ``ref`` (the oracle,
    ``ref.rmsnorm_ref``) or ``cuda`` (the fused kernel K9,
    ``kernels/rmsnorm.py``).  ``auto`` is ``cuda`` for CUDA tensors and
    ``ref`` for CPU tensors, as in the JAX package.
  * ``ssd`` (Mamba2's chunked scan, every SSM prefill) on
    ``KernelPolicy.ssd``: ``ref`` (the sequential recurrence,
    ``ref.ssd_ref``), ``chunked`` (``ssd_chunked_torch``, the JAX
    ``ssd_chunked_jnp`` mirror, which falls back to ``ref`` when the
    chunk does not divide S, as JAX does) or ``cuda`` (the hand-written
    Hopper kernel K8, ``kernels/ssd_scan.py``, any S).  ``auto`` is
    ``cuda`` for CUDA tensors; for CPU tensors it chooses as the JAX
    package does under ``auto`` (``ref`` up to 64 steps, else
    ``chunked``).  ``ssd_decode_step``, the O(1) recurrence of a decode
    step, is plain torch: it is no Pallas kernel in JAX either.
  * ``paged_decode_attention`` / ``paged_verify_attention`` (the engine's
    hot path) and ``decode_attention`` / ``verify_attention`` (the static
    batch's ring cache) on ``KernelPolicy.decode``: ``ref`` the fp32
    oracle, ``torch`` the path that mirrors the JAX ``jnp`` backend,
    ``cuda`` the hand-written Hopper kernels
    (``kernels/decode_attention.py``).  ``auto`` is ``cuda`` for CUDA
    tensors and ``torch`` for CPU tensors.  The ring kernel derives slot
    positions from ``pos``, so a custom ring ``k_pos`` slot layout raises
    on CUDA tensors under ``cuda``; on CPU tensors it takes ``torch``, with
    a warning given once per entry point.
  * ``mla_decode_paged`` (deepseek-v2's absorbed MLA decode over the
    paged latent pool) on ``KernelPolicy.decode``: ``ref``
    (``ref.mla_decode_paged_ref``), ``torch`` (``mla_decode_paged_torch``,
    the JAX ``mla_decode_paged_jnp`` mirror) or ``cuda`` (the latent sweep,
    ``decode_attention.mla_attention``).  Under ``cuda``,
    ``paged_verify_attention`` sends the latent form that
    ``mla_verify_paged`` gives it (one kv head whose v rows are a leading
    slice of its k rows) to the same latent sweep.  The ring
    ``mla_decode`` runs ``mla_absorbed_attend_torch``, plain torch, as the
    JAX package runs its jnp body there.

Gradients: on a CUDA tensor that requires grad (grad mode on),
``attention`` and ``rmsnorm`` reach K4's and K9's autograd functions
(``flash_attention.FlashAttentionFn``, ``rmsnorm.RMSNormFn``), whose
backward is a hand-written kernel; with no grad needed they launch what
they always did.  ``ssd`` (K8) and every decode, verify and latent sweep
raise there (``binding.refuse_grad``): they have no backward kernel.  On
CPU tensors the plain versions run, and autograd differentiates them.

The four paged and ring entries take ``k_scale`` / ``v_scale`` (per-row
fp32, int8 caches) on every backend: ``ref`` dequantizes the whole cache
up front, ``torch`` gathers the scale rows through the block tables (or
reads the ring's in place) and dequantizes before the einsums, and
``cuda`` launches the sweeps' int8 templates, which dequantize each row as
it lands in shared memory.  In-flight candidates stay unquantized.

Each plain version of a sweep has one role:

  * ``ref`` (``kernels/ref.py``): the fp32 oracle, whole-matrix softmax.
  * ``torch`` (``*_attention_torch`` here): the JAX ``jnp`` backend's
    mirror, gather (paged) then attend.  It is what ``auto`` runs on the
    CPU, and on the card it is the independent reference that
    ``chip_smoke.py`` holds the kernel-backed paths against.
  * ``decode_attention.*_attention_sweep_torch`` / ``lse_merge_torch``:
    the kernels' twins, block by block as the kernel walks.  The wrappers
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
import warnings

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.decode_attention import lse_merge_torch
from repro_torch.kernels.ref import NEG_INF


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Which implementation backs each op."""
    attention: str = "auto"      # auto | ref | chunked | cuda
    ssd: str = "auto"            # auto | ref | chunked | cuda
    rmsnorm: str = "auto"        # auto | ref | cuda
    decode: str = "auto"         # auto | ref | torch | cuda
    q_chunk: int = 1024
    k_chunk: int = 1024
    ssd_chunk: int = 128
    decode_k_chunk: int = 256    # ring sweep block (divisor-of-C rule)
    kv_splits: str | int = "auto"  # two-stage split count: "auto" | int (1 = single-stage)
    kv_dtype: str = "bfloat16"   # KV-pool storage: "bfloat16" | "int8" (per-row fp32 scales)


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
    if backend == "auto" and q.device.type == "cuda":
        backend = "cuda"
    elif backend == "auto":
        backend = "ref" if q.shape[1] * k.shape[1] <= 512 * 512 else "chunked"
    if backend == "cuda":
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  logit_cap=logit_cap, scale=scale,
                                  q_offset=q_offset)
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
                     "(ported: auto | ref | chunked | cuda)")


# ==========================================================================
# RMSNorm
# ==========================================================================
def rmsnorm(x, scale, *, eps=1e-6, gemma_style=False,
            policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching RMSNorm over the last axis."""
    backend = policy.rmsnorm
    if backend == "auto":
        backend = "cuda" if x.device.type == "cuda" else "ref"
    if backend == "cuda":
        return rms.rmsnorm(x, scale, eps=eps, gemma_style=gemma_style)
    if backend == "ref":
        return _ref.rmsnorm_ref(x, scale, eps=eps, gemma_style=gemma_style)
    raise ValueError(f"unknown rmsnorm backend {backend!r} "
                     "(ported: auto | ref | cuda)")


# ==========================================================================
# Mamba2 SSD
# ==========================================================================
def _segsum(a):
    """L[t, s] = sum_{r=s+1..t} a[r] for s <= t, else -inf.  a: (..., Q)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    L = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return L.masked_fill(~mask, float("-inf"))


def ssd_chunked_torch(x, dt, A, B_mat, C_mat, D=None, *, chunk: int = 128,
                      initial_state=None, return_state: bool = False):
    """Chunked SSD (state-space duality), Mamba2's Algorithm 1 in plain
    torch: the quadratic form inside each chunk of ``chunk`` steps, the
    state carried from chunk to chunk.  Same contract as ``ref.ssd_ref``,
    which it falls back to when ``chunk`` does not divide S (as the JAX
    ``ssd_chunked_jnp`` does)."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    if S % chunk:
        return _ref.ssd_ref(x, dt, A, B_mat, C_mat, D,
                            initial_state=initial_state,
                            return_state=return_state)
    nc = S // chunk
    xf = x.float().reshape(Bb, nc, chunk, H, P)
    dtf = dt.float().reshape(Bb, nc, chunk, H)
    Af = A.float()
    Bf = torch.repeat_interleave(B_mat.float(), rep, dim=2).reshape(
        Bb, nc, chunk, H, N)
    Cf = torch.repeat_interleave(C_mat.float(), rep, dim=2).reshape(
        Bb, nc, chunk, H, N)
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        a_t = (dtc * Af).transpose(1, 2)                    # (B, H, Q)
        cs = torch.cumsum(a_t, dim=-1)
        # 1. inside the chunk (the diagonal block), attention-like
        L = torch.exp(_segsum(a_t))                         # (B, H, Q, Q)
        Gm = torch.einsum("bqhn,bshn->bhqs", Cc, Bc)
        M = Gm * L * dtc.transpose(1, 2)[:, :, None, :]
        y_diag = torch.einsum("bhqs,bshp->bqhp", M, xc)
        # 2. the carried-in state's contribution
        y_off = torch.einsum("bqhn,bhpn,bhq->bqhp", Cc, h, torch.exp(cs))
        # 3. the next state
        total = cs[..., -1:]                                # (B, H, 1)
        w = dtc * torch.exp(total - cs).transpose(1, 2)     # (B, Q, H)
        dBx = torch.einsum("bqhn,bqhp->bhpn", Bc * w[..., None], xc)
        h = torch.exp(total)[..., None] * h + dBx
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(Bb, S, H, P)
    if D is not None:
        y = y + D.float()[:, None] * x.float()
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D=None):
    """One-token SSD recurrence for decode, O(1) in context length.
    h (B, H, P, N), x_t (B, H, P), dt_t (B, H), B_t / C_t (B, G, N) ->
    (new h fp32, y (B, H, P) in x_t's dtype)."""
    H = x_t.shape[1]
    rep = H // B_t.shape[1]
    Bf = torch.repeat_interleave(B_t.float(), rep, dim=1)      # (B, H, N)
    Cf = torch.repeat_interleave(C_t.float(), rep, dim=1)
    dtf = dt_t.float()
    decay = torch.exp(dtf * A.float())[..., None, None]
    upd = (dtf[..., None] * x_t.float())[..., None] * Bf[:, :, None, :]
    h_new = decay * h.float() + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, Cf)
    if D is not None:
        y = y + D.float()[:, None] * x_t.float()
    return h_new, y.to(x_t.dtype)


def ssd(x, dt, A, B_mat, C_mat, D=None, *, initial_state=None,
        return_state: bool = False, policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching SSD scan over a whole sequence (prefill)."""
    backend = policy.ssd
    if backend == "auto" and x.device.type == "cuda":
        backend = "cuda"
    elif backend == "auto":
        backend = "ref" if x.shape[1] <= 64 else "chunked"
    if backend == "cuda":
        return ss.ssd_scan(x, dt, A, B_mat, C_mat, D, chunk=policy.ssd_chunk,
                           initial_state=initial_state,
                           return_state=return_state)
    if backend == "ref":
        return _ref.ssd_ref(x, dt, A, B_mat, C_mat, D,
                            initial_state=initial_state,
                            return_state=return_state)
    if backend == "chunked":
        return ssd_chunked_torch(x, dt, A, B_mat, C_mat, D,
                                 chunk=policy.ssd_chunk,
                                 initial_state=initial_state,
                                 return_state=return_state)
    raise ValueError(f"unknown ssd backend {backend!r} "
                     "(ported: auto | ref | chunked | cuda)")


# ==========================================================================
# Paged decode / verify
# ==========================================================================
def _gather(pages, block_tables):
    B, nb = block_tables.shape
    return pages[block_tables.long()].reshape(B, nb * pages.shape[1],
                                              *pages.shape[2:])


def _gather_kv(pages, block_tables, scale):
    """The pages in logical order, fp32; an int8 pool's scale rows are
    gathered through the same tables and multiply in (the JAX ``jnp``
    backend's dequant)."""
    g = _gather(pages, block_tables).float()
    return g if scale is None else g * _gather(scale, block_tables)


def paged_verify_attention_torch(q, k_pages, v_pages, k_new, v_new,
                                 block_tables, pos, *, window: int = 0,
                                 logit_cap: float = 0.0,
                                 scale: float | None = None,
                                 n_splits: int = 1, k_scale=None,
                                 v_scale=None):
    """Gather-then-attend paged multi-query sweep, mirror of the JAX
    ``paged_verify_attention_jnp``: pool committed through ``pos[b] - 1``
    (dequantized when ``k_scale`` / ``v_scale`` are given), in-flight
    candidates causal within the fed block."""
    B, Q, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    nb, ps = block_tables.shape[1], k_pages.shape[1]
    Dv = v_pages.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kg = _gather_kv(k_pages, block_tables, k_scale)
    vg = _gather_kv(v_pages, block_tables, v_scale)
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
                                 n_splits: int = 1, k_scale=None,
                                 v_scale=None):
    """Gather-then-attend paged single-token decode, mirror of the JAX
    ``paged_decode_attention_jnp`` (int8 pools dequantized after the
    gather)."""
    B, _, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    nb, ps = block_tables.shape[1], k_pages.shape[1]
    Dv = v_pages.shape[-1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kg = _gather_kv(k_pages, block_tables, k_scale)
    vg = _gather_kv(v_pages, block_tables, v_scale)
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
    hot path).  The split-K block is the page size.  ``k_scale`` /
    ``v_scale`` (P, ps, Hkv, 1) fp32 flag int8 pools."""
    backend = _decode_backend(policy, q)
    ps, nb = k_pages.shape[1], block_tables.shape[1]
    n_splits = _resolve_kv_splits(policy, q.shape[0],
                                  effective_kv_len(nb * ps, window),
                                  q.shape[2], block=ps, device=q.device)
    if backend == "cuda":
        return da.paged_attention(q, k_pages, v_pages, block_tables, pos,
                                  window=window, logit_cap=logit_cap,
                                  scale=scale, n_splits=n_splits,
                                  k_scale=k_scale, v_scale=v_scale)
    if backend == "ref":
        return _ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, pos, window=window,
            logit_cap=logit_cap, scale=scale, k_scale=k_scale,
            v_scale=v_scale)
    if backend == "torch":
        return paged_decode_attention_torch(
            q, k_pages, v_pages, block_tables, pos, window=window,
            logit_cap=logit_cap, scale=scale, n_splits=n_splits,
            k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"unknown decode backend {backend!r}")


def _latent_form(k_pages, v_pages, k_new, v_new) -> bool:
    """Is this the MLA form of the paged verify: one kv head whose v rows
    (pool and pending) are a leading slice of the same memory as its k
    rows?"""
    def leading(k, v):
        return (k.shape[2] == 1 and v.shape[-1] < k.shape[-1]
                and v.data_ptr() == k.data_ptr()
                and v.stride() == k.stride())
    return leading(k_pages, v_pages) and leading(k_new, v_new)


def paged_verify_attention(q, k_pages, v_pages, k_new, v_new, block_tables,
                           pos, *, window: int = 0, logit_cap: float = 0.0,
                           scale: float | None = None, k_scale=None,
                           v_scale=None,
                           policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching multi-query attention over the paged KV cache:
    speculative verify and the prefix-hit suffix prefill share it.  Under
    ``cuda`` the MLA latent form goes to the latent sweep.  ``k_scale`` /
    ``v_scale`` flag int8 pools; the candidates stay unquantized."""
    backend = _decode_backend(policy, q)
    ps, nb = k_pages.shape[1], block_tables.shape[1]
    n_splits = _resolve_kv_splits(policy, q.shape[0],
                                  effective_kv_len(nb * ps, window),
                                  q.shape[2], block=ps, device=q.device)
    if backend == "cuda" and k_scale is None \
            and _latent_form(k_pages, v_pages, k_new, v_new):
        if window > 0:
            raise ValueError("paged_verify_attention: the latent sweep has "
                             "no window")
        if scale is None:
            scale = q.shape[-1] ** -0.5
        return da.mla_attention(q, k_pages[:, :, 0], block_tables, pos,
                                r_kv=v_pages.shape[-1],
                                pending=k_new[:, :, 0], logit_cap=logit_cap,
                                scale=scale, n_splits=n_splits)
    if backend == "cuda":
        return da.paged_attention(q, k_pages, v_pages, block_tables, pos,
                                  k_new=k_new, v_new=v_new, window=window,
                                  logit_cap=logit_cap, scale=scale,
                                  n_splits=n_splits, k_scale=k_scale,
                                  v_scale=v_scale)
    if backend == "ref":
        return _ref.paged_verify_attention_ref(
            q, k_pages, v_pages, k_new, v_new, block_tables, pos,
            window=window, logit_cap=logit_cap, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    if backend == "torch":
        return paged_verify_attention_torch(
            q, k_pages, v_pages, k_new, v_new, block_tables, pos,
            window=window, logit_cap=logit_cap, scale=scale,
            n_splits=n_splits, k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"unknown decode backend {backend!r}")


# ==========================================================================
# MLA compressed-latent decode (absorbed-matmul form)
# ==========================================================================
def mla_absorbed_attend_torch(q_abs, q_rope, c_kv, k_rope, valid, *,
                              scale: float, logit_cap: float = 0.0,
                              n_splits: int = 1):
    """The absorbed MLA attend shared by the ring ``mla_decode`` and the
    paged torch path (mirror of the JAX ``mla_absorbed_attend_jnp``): one
    latent row per token attended by every head, the value the compressed
    latent itself.  q_abs (B, H, r_kv), q_rope (B, H, dr), c_kv (B, C,
    r_kv), k_rope (B, C, dr), valid (B, C) bool.  Scores and values
    accumulate in fp32 (the JAX ``preferred_element_type``); ``n_splits >
    1`` runs the two-stage split-and-merge.  -> (B, H, r_kv) in q_abs's
    dtype."""
    s = torch.einsum("bhr,bcr->bhc", q_abs.float(), c_kv.float()) \
        + torch.einsum("bhk,bck->bhc", q_rope.float(), k_rope.float())
    s = s * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    if n_splits > 1:
        o = _split_attend_torch(s[:, None, :, None, :], c_kv[:, :, None, :],
                                n_splits)[:, 0, :, 0, :]
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhc,bcr->bhr", p, c_kv.float())
    return o.to(q_abs.dtype)


def mla_decode_paged_torch(q_lat, lat_pages, block_tables, pos, *,
                           r_kv: int, scale: float, logit_cap: float = 0.0,
                           n_splits: int = 1):
    """Paged MLA decode in plain torch (mirror of the JAX
    ``mla_decode_paged_jnp``): gather the latent pages into logical order,
    then the shared absorbed attend; valid is ``k_pos <= pos[b]``."""
    B = q_lat.shape[0]
    ps, nb = lat_pages.shape[1], block_tables.shape[1]
    latg = _gather(lat_pages, block_tables)                   # (B, K, R)
    valid = torch.arange(nb * ps, device=q_lat.device)[None, :] \
        <= pos.reshape(B, 1).to(q_lat.device)
    o = mla_absorbed_attend_torch(
        q_lat[:, 0, :, :r_kv], q_lat[:, 0, :, r_kv:], latg[..., :r_kv],
        latg[..., r_kv:], valid, scale=scale, logit_cap=logit_cap,
        n_splits=n_splits)
    return o[:, None]                                         # (B,1,Hq,r_kv)


def mla_decode_paged(q_lat, lat_pages, block_tables, pos, *, r_kv: int,
                     scale: float, logit_cap: float = 0.0,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching absorbed MLA decode over the paged latent pool.
    The split count is the JAX package's rule at the MLA grid: every head
    shares the one latent row, so ``q_heads = 1`` and the block is the
    page.  -> latent outputs (B, 1, Hq, r_kv); the ``W_uv`` / ``W_o``
    expansion is the caller's."""
    backend = _decode_backend(policy, q_lat)
    ps, nb = lat_pages.shape[1], block_tables.shape[1]
    n_splits = _resolve_kv_splits(policy, q_lat.shape[0], nb * ps, 1,
                                  block=ps, device=q_lat.device)
    if backend == "cuda":
        return da.mla_attention(q_lat, lat_pages, block_tables, pos,
                                r_kv=r_kv, logit_cap=logit_cap, scale=scale,
                                n_splits=n_splits)
    if backend == "ref":
        return _ref.mla_decode_paged_ref(q_lat, lat_pages, block_tables, pos,
                                         r_kv=r_kv, scale=scale,
                                         logit_cap=logit_cap)
    if backend == "torch":
        return mla_decode_paged_torch(q_lat, lat_pages, block_tables, pos,
                                      r_kv=r_kv, scale=scale,
                                      logit_cap=logit_cap, n_splits=n_splits)
    raise ValueError(f"unknown decode backend {backend!r}")


# ==========================================================================
# Ring decode / verify (the static batch path)
# ==========================================================================
_KPOS_FALLBACK_WARNED: set[str] = set()


def _warn_k_pos_fallback(entry: str) -> None:
    """One warning per entry point when a custom ``k_pos`` on CPU tensors
    takes the torch backend instead of the ring kernel's twin."""
    if entry in _KPOS_FALLBACK_WARNED:
        return
    _KPOS_FALLBACK_WARNED.add(entry)
    warnings.warn(
        f"{entry}: custom k_pos slot layout disables the ring kernel (it "
        "derives ring positions from pos, assuming the canonical slot = "
        "p % C layout); falling back to the torch backend for this call",
        RuntimeWarning, stacklevel=4)


_KV_DTYPE_FALLBACK_WARNED: set[str] = set()


def warn_kv_dtype_fallback(family: str, reason: str) -> None:
    """One warning per model family when ``kv_dtype=int8`` was asked for
    but the family's cache cannot hold int8 pages (``reason`` names the
    blocking feature); the engine then serves its cache dtype, as the JAX
    package does."""
    if family in _KV_DTYPE_FALLBACK_WARNED:
        return
    _KV_DTYPE_FALLBACK_WARNED.add(family)
    warnings.warn(
        f"kv_dtype=int8 requested for model family {family!r} but {reason}; "
        "falling back to unquantized (bfloat16) KV pools for this engine",
        RuntimeWarning, stacklevel=3)


def ring_positions(pos, cache_len: int):
    """Absolute position held by each ring slot under the canonical layout
    (slot = p % C): ``pos - ((pos - s) mod C)``, negative for slots not yet
    written.  ``pos`` () -> (C,); (B,) -> (B, C)."""
    p = torch.as_tensor(pos)
    s = torch.arange(cache_len, device=p.device)
    if p.ndim == 0:
        return p - torch.remainder(p - s, cache_len)
    return p[:, None] - torch.remainder(p[:, None] - s, cache_len)


def decode_attention_torch(q, k_cache, v_cache, k_pos, pos, *,
                           window: int = 0, logit_cap: float = 0.0,
                           scale: float | None = None, n_splits: int = 1,
                           k_scale=None, v_scale=None):
    """Single-token decode against a ring cache, mirror of the JAX
    ``decode_attention_jnp``: ``k_pos`` (C,) or (B, C), ``pos`` () or
    (B,); ``n_splits > 1`` runs the two-stage split-and-merge; an int8
    cache is dequantized by ``k_scale`` / ``v_scale`` first."""
    B, _, Hq, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kf = _ref._dequant(k_cache, k_scale)
    vf = _ref._dequant(v_cache, v_scale)
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, kf) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_posb = torch.as_tensor(k_pos, device=q.device).reshape(-1, C)
    posb = torch.as_tensor(pos, device=q.device).reshape(-1, 1)
    valid = (k_posb >= 0) & (k_posb <= posb)
    if window > 0:
        valid &= k_posb > posb - window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    if n_splits > 1:
        o = _split_attend_torch(s[:, :, :, None, :], vf, n_splits)[..., 0, :]
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgk,bkhd->bhgd", p, vf)
    return o.reshape(B, 1, Hq, v_cache.shape[-1]).to(q.dtype)


def verify_attention_torch(q, k_cache, v_cache, k_new, v_new, k_pos, pos, *,
                           window: int = 0, logit_cap: float = 0.0,
                           scale: float | None = None, n_splits: int = 1,
                           k_scale=None, v_scale=None):
    """Speculative multi-query decode against a ring cache, mirror of the
    JAX ``verify_attention_jnp``: query i at ``pos + i`` sees the committed
    cache (newer than ``pos + i - C``, the ring's eviction; dequantized by
    ``k_scale`` / ``v_scale`` for int8) and candidates ``j <= i``."""
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
                       _ref._dequant(k_cache, k_scale))
    s_n = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_new.float())
    s = torch.cat([s_c, s_n], dim=-1) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(s / logit_cap)
    valid_c = (kp >= 0) & (kp <= q_pos) & (kp > q_pos - C)
    n_pos = q_pos.reshape(1, Q)
    valid_n = n_pos <= q_pos
    if window > 0:
        valid_c &= kp > q_pos - window
        valid_n &= n_pos > q_pos - window
    valid = torch.cat([valid_c, valid_n], dim=-1)                 # (Q, C+Q)
    s = torch.where(valid, s, NEG_INF)
    vf = torch.cat([_ref._dequant(v_cache, v_scale), v_new.float()], dim=1)
    if n_splits > 1:
        o = _split_attend_torch(s, vf, n_splits).permute(0, 3, 1, 2, 4)
    else:
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, Q, Hq, Dv).to(q.dtype)


def _ring_backend(policy: KernelPolicy, q, k_pos, entry: str) -> str:
    backend = _decode_backend(policy, q)
    if backend == "cuda" and k_pos is not None:
        if q.is_cuda:
            raise NotImplementedError(
                f"{entry}: the ring kernel has no custom k_pos slot layout "
                "(it derives positions from pos, slot = p % C); ask for the "
                "'torch' or 'ref' decode backend to use one")
        _warn_k_pos_fallback(entry)
        backend = "torch"      # custom slot layout: ring derivation invalid
    return backend


def _ring_splits(policy: KernelPolicy, q, k_cache, window: int) -> int:
    """The JAX package's split count: from the requested block (not the
    divisor-adjusted one); the sweep then clamps it to its block count."""
    return _resolve_kv_splits(policy, q.shape[0],
                              effective_kv_len(k_cache.shape[1], window),
                              q.shape[2], block=policy.decode_k_chunk,
                              device=q.device)


def _pos_arg(pos, device) -> torch.Tensor:
    """``pos`` as the kernel reads it: (1,) or (B,) int32 on ``device``."""
    return torch.as_tensor(pos, device=device).reshape(-1).to(torch.int32)


def decode_attention(q, k_cache, v_cache, pos, *, k_pos=None, window: int = 0,
                     logit_cap: float = 0.0, scale: float | None = None,
                     k_scale=None, v_scale=None,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching single-token decode against the ring cache
    (B, C, Hkv, D); ``pos`` () or (B,) is the position of q, already
    written at slot ``pos % C``; ``k_scale`` / ``v_scale`` (B, C, Hkv, 1)
    fp32 flag an int8 cache."""
    backend = _ring_backend(policy, q, k_pos, "decode_attention")
    n_splits = _ring_splits(policy, q, k_cache, window)
    if backend == "cuda":
        return da.ring_attention(q, k_cache, v_cache, _pos_arg(pos, q.device),
                                 window=window, logit_cap=logit_cap,
                                 scale=scale, n_splits=n_splits,
                                 block_k=policy.decode_k_chunk,
                                 k_scale=k_scale, v_scale=v_scale)
    if k_pos is None:
        k_pos = ring_positions(pos, k_cache.shape[1])
    if backend == "ref":
        return _ref.decode_attention_ref(q, k_cache, v_cache, k_pos, pos,
                                         window=window, logit_cap=logit_cap,
                                         scale=scale, k_scale=k_scale,
                                         v_scale=v_scale)
    if backend == "torch":
        return decode_attention_torch(q, k_cache, v_cache, k_pos, pos,
                                      window=window, logit_cap=logit_cap,
                                      scale=scale, n_splits=n_splits,
                                      k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"unknown decode backend {backend!r}")


def verify_attention(q, k_cache, v_cache, k_new, v_new, pos, *, k_pos=None,
                     window: int = 0, logit_cap: float = 0.0,
                     scale: float | None = None, k_scale=None, v_scale=None,
                     policy: KernelPolicy = DEFAULT_POLICY):
    """Backend-dispatching speculative verify against the ring cache,
    committed through ``pos - 1``: ``Q = K+1`` queries at ``pos ..
    pos+K`` in one sweep, the in-flight candidates ``k_new`` / ``v_new``
    (B, Q, Hkv, D) folded causally (never quantized), nothing written;
    ``k_scale`` / ``v_scale`` flag an int8 cache."""
    backend = _ring_backend(policy, q, k_pos, "verify_attention")
    n_splits = _ring_splits(policy, q, k_cache, window)
    if backend == "cuda":
        return da.ring_attention(q, k_cache, v_cache, _pos_arg(pos, q.device),
                                 k_new=k_new, v_new=v_new, window=window,
                                 logit_cap=logit_cap, scale=scale,
                                 n_splits=n_splits,
                                 block_k=policy.decode_k_chunk,
                                 k_scale=k_scale, v_scale=v_scale)
    if k_pos is None:
        # the committed prefix ends at pos - 1: that is the ring reference
        k_pos = ring_positions(torch.as_tensor(pos) - 1, k_cache.shape[1])
    if backend == "ref":
        return _ref.verify_attention_ref(
            q, k_cache, v_cache, k_new, v_new, k_pos, pos, window=window,
            logit_cap=logit_cap, scale=scale, k_scale=k_scale,
            v_scale=v_scale)
    if backend == "torch":
        return verify_attention_torch(
            q, k_cache, v_cache, k_new, v_new, k_pos, pos, window=window,
            logit_cap=logit_cap, scale=scale, n_splits=n_splits,
            k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"unknown decode backend {backend!r}")
