"""Mamba2's chunked SSD scan: the hand-written Hopper kernel of K8
(``csrc/ssd_scan.cu``, replacing the JAX package's Pallas ``ssd_pallas``)
and its wrapper.

Its plain version is :func:`ssd_scan_torch`: ``ops.ssd_chunked_torch``
(the JAX ``ssd_chunked_jnp`` mirror) over the sequence padded to a whole
number of chunks, as the kernel pads its last chunk.  The wrapper takes it
for a tensor that lies on the CPU; for a CUDA tensor it launches the
kernel or raises, with no fallback.  ``LAUNCHES["ssd"]`` counts the
launches.

The kernel's contract is ``ssd_chunked_jnp``'s, ``initial_state`` and
``return_state`` included (the serving prefill seeds its state slots from
``return_state``), for any S >= 1: the padded steps have dt = 0 and x, B,
C = 0, so they leave the state unchanged, and their outputs are never
written.  In bf16 the kernel pads every chunk to a multiple of 16 steps
that way, and runs Mamba2's chunk-parallel form, whose stages
:func:`ssd_staged_torch` mirrors in plain torch; the wrapper allocates
its workspace (:func:`ssd_workspace`) from the caching allocator, so a
launch inside a CUDA-graph capture allocates nothing itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr

MAX_CHUNK = 128     # steps per chunk the kernel's shared memory holds
MAX_STATE = 128     # N, the state size per head
# fp32 values the bf16 kernels' workspace may hold: longer sequences run in
# groups of chunks, each group's chunk states within it (256 MB)
WORKSPACE_FLOATS = 1 << 26


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def ssd_workspace(B: int, S: int, H: int, P: int, G: int, N: int,
                  chunk: int) -> tuple[int, int]:
    """(fp32 values, chunks per group) of the bf16 kernels' workspace, as
    ``csrc/ssd_scan.cu`` lays it out: for a sequence of one chunk, that
    chunk's C B^T scores (Qp x Qp per batch row and group, Qp the chunk
    rounded up to 16); else, per group of chunks, their scores, one state
    slot (P x Np, Np = N rounded up to 16) per chunk plus one, the state
    carried between groups, and a decay per chunk.  The group is as many
    chunks as ``WORKSPACE_FLOATS`` holds, at least one."""
    nc, Qp, Np = -(-S // chunk), _round16(chunk), _round16(N)
    if nc <= 1:
        return B * G * Qp * Qp, 1
    per_chunk = B * G * Qp * Qp + B * H * P * Np + B * H
    fixed = 2 * B * H * P * Np
    group = max(1, min(nc, (WORKSPACE_FLOATS - fixed) // per_chunk))
    return group * per_chunk + fixed, group


def _pad_steps(t, n: int):
    """``t`` (B, S, ...) with ``n`` zero steps appended on axis 1."""
    if n == 0:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], n, *t.shape[2:]))], dim=1)


def ssd_scan_torch(x, dt, A, B_mat, C_mat, D=None, *, chunk: int = 128,
                   initial_state=None, return_state: bool = False):
    """The kernel's twin in plain torch: the sequence padded to a multiple
    of ``chunk`` with zero steps (dt = 0 and x, B, C = 0 leave the state
    as it is), run through ``ops.ssd_chunked_torch``, cut back to S."""
    from repro_torch.kernels.ops import ssd_chunked_torch
    S = x.shape[1]
    pad = -S % chunk
    res = ssd_chunked_torch(_pad_steps(x, pad), _pad_steps(dt, pad), A,
                            _pad_steps(B_mat, pad), _pad_steps(C_mat, pad),
                            D, chunk=chunk, initial_state=initial_state,
                            return_state=return_state)
    if return_state:
        return res[0][:, :S], res[1]
    return res[:, :S]


def ssd_staged_torch(x, dt, A, B_mat, C_mat, D=None, *, chunk: int = 128,
                     initial_state=None, return_state: bool = False):
    """The bf16 kernel's stages in plain torch, in fp32 (used by nothing
    on the main path; the tests hold it against JAX): the sequence cut
    into chunks of ``chunk`` steps, each padded with zero steps (dt = 0,
    x = B = C = 0) to a multiple of 16, then (1) per (batch, group,
    chunk) the scores C B^T; (2) per (batch, head, chunk) the chunk's
    state from zero, x^T (w B) with w = dt exp(cs_last - cs), and its
    decay exp(cs_last); (3) the pass h_c = decay_c h_{c-1} + S_c over the
    chunks from the initial state, which leaves each chunk's incoming
    state; (4) y = (G o L o dt) x + exp(cs) C h_in^T + D x, with L =
    exp(min(cs_t - cs_s, 0)) on s <= t and 0 above."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    nc, Qp = -(-S // chunk), _round16(chunk)

    def chunks(t):   # (B, S, ...) -> (B, nc, Qp, ...) fp32, zero steps padded
        t = _pad_steps(t.float(), nc * chunk - S)
        t = t.reshape(Bb, nc, chunk, *t.shape[2:])
        return torch.cat([t, t.new_zeros((Bb, nc, Qp - chunk,
                                          *t.shape[3:]))], dim=2)

    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(B_mat), chunks(C_mat)
    scores = torch.einsum("bctgn,bcsgn->bcgts", Cc, Bc)          # (1)
    cs = torch.cumsum(dtc * A.float(), dim=2)                     # (B,nc,Qp,H)
    w = dtc * torch.exp(cs[:, :, -1:] - cs)                       # (2)
    Bh = Bc.repeat_interleave(rep, dim=3)
    states = torch.einsum("bcshp,bcsh,bcshn->bchpn", xc, w, Bh)
    decay = torch.exp(cs[:, :, -1])                               # (B,nc,H)
    h = (x.new_zeros((Bb, H, P, N), dtype=torch.float32)         # (3)
         if initial_state is None else initial_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                               # (B,nc,H,P,N)
    tri = torch.tril(torch.ones(Qp, Qp, dtype=torch.bool))        # (4)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]            # (B,nc,t,s,H)
    L = torch.where(tri[:, :, None], torch.exp(diff.clamp(max=0.0)), 0.0)
    M = (scores.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2) * L
         * dtc[:, :, None])
    y = torch.einsum("bctsh,bcshp->bcthp", M, xc)
    y = y + torch.exp(cs)[..., None] * torch.einsum(
        "bcthn,bchpn->bcthp", Cc.repeat_interleave(rep, dim=3), h_in)
    y = y[:, :, :chunk].reshape(Bb, nc * chunk, H, P)[:, :S]
    if D is not None:
        y = y + D.float()[:, None] * x.float()
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def _rows(t, S, width):
    """``t`` (B, S, k, width) as the kernel reads it: unit stride inside a
    step, steps of every batch row ``stride(1)`` elements apart.  The
    slices of the model's fused projection are read in place; any other
    layout is copied."""
    ok = (t.stride(3) == 1 and t.stride(2) == width
          and (t.shape[0] == 1 or t.stride(0) == S * t.stride(1)))
    if not ok:
        t = t.contiguous()
    return t, t.stride(1)


def ssd_scan(x, dt, A, B_mat, C_mat, D=None, *, chunk: int = 128,
             initial_state=None, return_state: bool = False):
    """K8.  x (B, S, H, P) in bf16 or fp32, dt (B, S, H) fp32 (> 0), A
    (H,) fp32 (< 0), B_mat / C_mat (B, S, G, N) in x's dtype with H % G ==
    0, D (H,) or None, initial_state (B, H, P, N) fp32 or None -> y (B, S,
    H, P) in x's dtype, and the final state (B, H, P, N) fp32 with
    ``return_state``.  fp32 inside; ``chunk`` <= 128 and N <= 128 on the
    card."""
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, A, B_mat, C_mat, D, chunk=chunk,
                              initial_state=initial_state,
                              return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    from repro_torch.kernels import build
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    dev = x.device
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"ssd_scan: dtype {x.dtype} not supported "
                         "(float32 | bfloat16)")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {N} not in "
                         f"[1, {MAX_STATE}]")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: {H} heads not a multiple of {G} groups")
    for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
        if t.dtype != x.dtype or tuple(t.shape) != (Bb, S, G, N):
            raise ValueError(f"ssd_scan: {name} {t.dtype} {tuple(t.shape)}, "
                             f"expected {x.dtype} {(Bb, S, G, N)}")
    x, x_rs = _rows(x, S, P)
    B_mat, b_rs = _rows(B_mat, S, N)
    C_mat, c_rs = _rows(C_mat, S, N)
    check("dt", dt, dtype=torch.float32, shape=(Bb, S, H), device=dev)
    check("A", A, dtype=torch.float32, shape=(H,), device=dev)
    if D is not None:
        D = D.float().contiguous()
        check("D", D, dtype=torch.float32, shape=(H,), device=dev)
    if initial_state is not None:
        check("initial_state", initial_state, dtype=torch.float32,
              shape=(Bb, H, P, N), device=dev)
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    h_T = (torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
           if return_state else None)
    if Bb == 0 or H == 0 or P == 0:
        return (y, h_T) if return_state else y
    ws, n_ws, group = None, 0, 1
    if x.dtype == torch.bfloat16:
        n_ws, group = ssd_workspace(Bb, S, H, P, G, N, chunk)
        ws = torch.empty(n_ws, dtype=torch.float32, device=dev)
    err = build.library().ssd_scan_fwd(
        ptr(x), ptr(dt), ptr(A), ptr(B_mat), ptr(C_mat), ptr(D),
        ptr(initial_state), ptr(y), ptr(h_T), ptr(ws), Bb, S, H, P, G, N,
        chunk, group, x_rs, b_rs, c_rs, n_ws, DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA error {err}")
    LAUNCHES["ssd"] += 1
    return (y, h_T) if return_state else y
