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

The gradient: :class:`SSDScanFn`, which ``ssd_scan`` takes on CUDA
tensors that require grad.  Its backward is :func:`ssd_scan_bwd`, the
kernels of ``csrc/ssd_scan_bwd.cu`` (``LAUNCHES["ssd_bwd"]`` counts one a
call), whose plain twin :func:`ssd_scan_bwd_torch` runs on CPU tensors.
It saves the inputs only: each chunk's incoming state is recomputed in
the backward by the forward's own stage kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr

MAX_CHUNK = 128     # steps per chunk the kernel's shared memory holds
MAX_STATE = 128     # N, the state size per head
MAX_HEAD_DIM_BWD = 64   # P the backward kernels' registers hold
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


def ssd_scan_bwd_torch(x, dt, A, B_mat, C_mat, D, dy, *, chunk: int = 128,
                       initial_state=None, dh_T=None):
    """The plain twin of ``ssd_scan_bwd``: the gradients of
    ``ssd_scan_torch`` (its final state included when ``dh_T`` is given)
    by explicit stages in fp32, no autograd, mirroring the backward
    kernels as ``ssd_staged_torch`` mirrors the forward's.  The sequence
    is padded with zero steps to whole chunks (dt = 0, x = B = C = dy =
    0), whose gradients are cut off.  Per (batch, chunk, head), with cs
    the inclusive scan of dt A, L[t, s] = exp(cs_t - cs_s) on s <= t, M =
    scores o L o dt_s, w = dt exp(cs_last - cs):

      (0) the forward's chunk states and each chunk's incoming state h_in;
      (4') dx = M^T dy, dM = dy x^T on the band, d scores = dM o L o dt_s,
           ddt_s += sum_t dM scores L, d cs from Z = dM o M (rows +,
           columns -) and from the carried-in term exp(cs_t) C_t h_in^T,
           whose dC_t and d h_in = sum_t exp(cs_t) dy_t^T C_t it also
           gives;
      (3') in reverse over the chunks, g = d h_in + decay g from dh_T:
           d states = g, d decay = <g, h_in>, d initial_state = g at 0;
      (2') dx += w B g^T, dB += w x g, dw = sum x B g into ddt and d cs;
      (1') dC += d scores B, dB += d scores^T C over the heads of a group;
      and d cs into da by a reversed cumulative sum inside each chunk:
      ddt += da A, dA = sum da dt.  Returns (dx in x's dtype, ddt fp32,
      dA fp32, dB and dC in their own dtype, dD fp32 or None, d
      initial_state fp32 or None)."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    rep = H // G
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(t):       # (B, S, ...) -> (B, nc, Q, ...) fp32, zero steps
        t = _pad_steps(t.float(), pad)
        return t.reshape(Bb, nc, chunk, *t.shape[2:])

    xc, dtc, dyc = chunks(x), chunks(dt), chunks(dy)     # (B, nc, Q, H, ..)
    Bc, Cc = chunks(B_mat), chunks(C_mat)                # (B, nc, Q, G, N)
    Bh = Bc.repeat_interleave(rep, dim=3)                # (B, nc, Q, H, N)
    Ch = Cc.repeat_interleave(rep, dim=3)
    Af = A.float()
    cs = torch.cumsum(dtc * Af, dim=2)                   # (B, nc, Q, H)
    cs_last = cs[:, :, -1:]
    w = dtc * torch.exp(cs_last - cs)
    decay = torch.exp(cs[:, :, -1])                      # (B, nc, H)
    # (0) the forward's chunk states and each chunk's incoming state
    states = torch.einsum("bcshp,bcsh,bcshn->bchpn", xc, w, Bh)
    h = (x.new_zeros((Bb, H, P, N), dtype=torch.float32)
         if initial_state is None else initial_state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                      # (B, nc, H, P, N)
    # (4') the outputs' band and carried-in terms, layout (b, c, h, t, s)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    csh = cs.permute(0, 1, 3, 2)                         # (B, nc, H, Q)
    L = torch.where(tri, torch.exp(csh[..., :, None] - csh[..., None, :]),
                    0.0)
    dts = dtc.permute(0, 1, 3, 2)[..., None, :]          # dt_s
    scores = torch.einsum("bctgn,bcsgn->bcgts", Cc, Bc).repeat_interleave(
        rep, dim=2)                                      # (B, nc, H, Q, Q)
    M = scores * L * dts
    dM = torch.einsum("bcthp,bcshp->bchts", dyc, xc) * tri
    dx = torch.einsum("bchts,bcthp->bcshp", M, dyc)
    d_scores = dM * L * dts
    Z = dM * M
    dcs = Z.sum(-1) - Z.sum(-2)                          # (B, nc, H, Q)
    ddt = (dM * scores * L).sum(-2)                      # (B, nc, H, Q)
    e = torch.exp(cs)                                    # (B, nc, Q, H)
    dC_h = e[..., None] * torch.einsum("bcthp,bchpn->bcthn", dyc, h_in)
    dcs = dcs + torch.einsum("bcthn,bcthn->bcht", dC_h, Ch)
    dh_loc = torch.einsum("bcth,bcthp,bcthn->bchpn", e, dyc, Ch)
    # (3') the pass, in reverse over the chunks
    g = (x.new_zeros((Bb, H, P, N), dtype=torch.float32)
         if dh_T is None else dh_T.float())
    g_out, d_decay = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        g_out[c] = g
        d_decay[c] = (g * h_in[:, c]).sum((-1, -2))      # (B, H)
        g = dh_loc[:, c] + decay[:, c, :, None, None] * g
    dh0 = g if initial_state is not None else None
    g_out = torch.stack(g_out, dim=1)                    # (B, nc, H, P, N)
    d_decay = torch.stack(d_decay, dim=1)                # (B, nc, H)
    # (2') the chunk states
    u = torch.einsum("bcshn,bchpn->bcshp", Bh, g_out)
    dx = dx + w[..., None] * u                           # (B, nc, Q, H, P)
    dB_h = w[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc, g_out)
    dw = (xc * u).sum(-1)                                # (B, nc, Q, H)
    ddt = ddt.permute(0, 1, 3, 2) + dw * torch.exp(cs_last - cs)
    dcs = dcs.permute(0, 1, 3, 2) - dw * w               # (B, nc, Q, H)
    dcs[:, :, -1] += (dw * w).sum(2) + decay * d_decay
    # (1') the scores, summed over the heads of each group
    d_sg = d_scores.reshape(Bb, nc, G, rep, chunk, chunk).sum(3)
    dC = torch.einsum("bcgts,bcsgn->bctgn", d_sg, Bc) + dC_h.reshape(
        Bb, nc, chunk, G, rep, N).sum(4)
    dB = torch.einsum("bcgts,bctgn->bcsgn", d_sg, Cc) + dB_h.reshape(
        Bb, nc, chunk, G, rep, N).sum(4)
    # d cs -> da, reversed cumulative sum inside each chunk
    da = torch.flip(torch.cumsum(torch.flip(dcs, (2,)), dim=2), (2,))
    ddt = ddt + da * Af
    dA = (da * dtc).sum((0, 1, 2))
    dD = None
    if D is not None:
        dx = dx + D.float()[:, None] * dyc
        dD = (dyc * xc).sum((0, 1, 2, 4))

    def cut(t):
        return t.reshape(Bb, nc * chunk, *t.shape[3:])[:, :S]

    return (cut(dx).to(x.dtype), cut(ddt), dA, cut(dB).to(B_mat.dtype),
            cut(dC).to(C_mat.dtype), dD, dh0)


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


def _check_forms(what, x, B_mat, chunk):
    """Raise for a form the kernels do not take: dtype, chunk, N, groups."""
    H, N, G = x.shape[2], B_mat.shape[3], B_mat.shape[2]
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not supported "
                         "(float32 | bfloat16)")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{what}: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"{what}: state size {N} not in [1, {MAX_STATE}]")
    if G < 1 or H % G:
        raise ValueError(f"{what}: {H} heads not a multiple of {G} groups")


def _check_head_dim(x):
    """Raise for a head dim the backward kernels do not take."""
    if x.shape[3] > MAX_HEAD_DIM_BWD:
        raise ValueError(f"ssd_scan_bwd: head dim {x.shape[3]} past the "
                         f"backward kernel's {MAX_HEAD_DIM_BWD}")


def _operands(what, x, dt, A, B_mat, C_mat, D, initial_state, chunk):
    """The kernels' operands, checked: x, B and C read in place with their
    row strides (or copied), D fp32 contiguous.  Returns (x, x_rs, B_mat,
    b_rs, C_mat, c_rs, D)."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    dev = x.device
    _check_forms(what, x, B_mat, chunk)
    for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
        if t.dtype != x.dtype or tuple(t.shape) != (Bb, S, G, N):
            raise ValueError(f"{what}: {name} {t.dtype} {tuple(t.shape)}, "
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
    return x, x_rs, B_mat, b_rs, C_mat, c_rs, D


def _forward(x, dt, A, B_mat, C_mat, D, chunk, initial_state, return_state):
    """K8's launch on CUDA tensors (no autograd)."""
    from repro_torch.kernels import build
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    dev = x.device
    x, x_rs, B_mat, b_rs, C_mat, c_rs, D = _operands(
        "ssd_scan", x, dt, A, B_mat, C_mat, D, initial_state, chunk)
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


def ssd_bwd_workspace(B: int, S: int, H: int, P: int, G: int, N: int,
                      chunk: int) -> int:
    """fp32 values of the backward kernels' workspace, as
    ``csrc/ssd_scan_bwd.cu`` lays it out (each piece a multiple of 4): the
    incoming states ((B H) x (nc + 1) x P x Np, Np = N rounded up to 16),
    the forward's decays, the state gradients ((B H) x nc x P x N) and
    their decays, the scores ((B G) x nc x Q x Q), the heads' d scores
    ((B H) x nc x Q x Q), the dC and dB partials (B S H N each), the dA and
    dD partials ((B H) x nc each)."""
    nc, bh = -(-S // chunk), B * H

    def a4(n):
        return -(-n // 4) * 4

    return (a4(bh * (nc + 1) * P * _round16(N)) + 2 * a4(bh * nc)
            + a4(bh * nc * P * N) + a4(B * G * nc * chunk * chunk)
            + a4(bh * nc * chunk * chunk) + 2 * a4(B * S * H * N)
            + 2 * a4(bh * nc))


def ssd_scan_bwd(x, dt, A, B_mat, C_mat, D, dy, *, chunk: int = 128,
                 initial_state=None, dh_T=None):
    """K8's backward: (dx, ddt, dA, dB, dC, dD, dh0) from the forward's
    inputs, the output gradient dy and, where the final state was
    returned, its gradient dh_T.  dx, dB and dC in x's dtype (dB and dC
    contiguous, in B_mat's shape), ddt, dA, dD (None without D) and dh0
    (None without an initial state) fp32.  The plain twin
    ``ssd_scan_bwd_torch`` for CPU tensors; for CUDA tensors the kernels of
    ``csrc/ssd_scan_bwd.cu`` (the incoming states recomputed by the
    forward's stage kernels) or a raise."""
    if x.device.type == "cpu":
        return ssd_scan_bwd_torch(x, dt, A, B_mat, C_mat, D, dy, chunk=chunk,
                                  initial_state=initial_state, dh_T=dh_T)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd: unsupported device {x.device}")
    from repro_torch.kernels import build
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    dev = x.device
    _check_head_dim(x)
    x, x_rs, B_mat, b_rs, C_mat, c_rs, D = _operands(
        "ssd_scan_bwd", x, dt, A, B_mat, C_mat, D, initial_state, chunk)
    check("dy", dy, dtype=x.dtype, shape=(Bb, S, H, P), device=dev)
    if dh_T is not None:
        check("dh_T", dh_T, dtype=torch.float32, shape=(Bb, H, P, N),
              device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((Bb, S, H, P), dtype=x.dtype, device=dev)
    dB = torch.empty((Bb, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bb, S, G, N), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bb, S, H), **f32)
    dA = torch.empty((H,), **f32)
    dD = None if D is None else torch.empty((H,), **f32)
    dh0 = (None if initial_state is None
           else torch.empty((Bb, H, P, N), **f32))
    if Bb == 0 or S == 0:           # no step: the state passes through
        for t in (dx, dB, dC, ddt, dA, dD, dh0):
            if t is not None:
                t.zero_()
        if dh0 is not None and dh_T is not None:
            dh0.copy_(dh_T)
        return dx, ddt, dA, dB, dC, dD, dh0
    n_ws = ssd_bwd_workspace(Bb, S, H, P, G, N, chunk)
    ws = torch.empty(n_ws, **f32)
    err = build.library().ssd_scan_bwd(
        ptr(x), ptr(dt), ptr(A), ptr(B_mat), ptr(C_mat), ptr(D),
        ptr(initial_state), ptr(dy), ptr(dh_T), ptr(dx), ptr(ddt), ptr(dA),
        ptr(dB), ptr(dC), ptr(dD), ptr(dh0), ptr(ws), Bb, S, H, P, G, N,
        chunk, x_rs, b_rs, c_rs, n_ws, DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd: CUDA error {err}")
    LAUNCHES["ssd_bwd"] += 1
    return dx, ddt, dA, dB, dC, dD, dh0


class SSDScanFn(torch.autograd.Function):
    """K8 with a gradient: the forward kernel (its output bit for bit that
    of a call without a gradient), the backward kernels of
    ``ssd_scan_bwd``; on CPU tensors their plain twins ``ssd_scan_torch``
    and ``ssd_scan_bwd_torch``.  Saves the inputs only.  Returns y, or (y,
    the final state) with ``return_state``."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C_mat, D, initial_state, chunk,
                return_state):
        if x.device.type == "cpu":
            out = ssd_scan_torch(x, dt, A, B_mat, C_mat, D, chunk=chunk,
                                 initial_state=initial_state,
                                 return_state=return_state)
        else:
            _check_head_dim(x)
            out = _forward(x, dt, A, B_mat, C_mat, D, chunk, initial_state,
                           return_state)
        ctx.save_for_backward(x, dt, A, B_mat, C_mat, D, initial_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, dy, dh_T=None):
        x, dt, A, B_mat, C_mat, D, initial_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ssd_scan_bwd(x, dt, A, B_mat, C_mat, D, dy,
                             chunk=ctx.chunk, initial_state=initial_state,
                             dh_T=None if dh_T is None else
                             dh_T.float().contiguous())
        return (*grads, None, None)


def ssd_scan(x, dt, A, B_mat, C_mat, D=None, *, chunk: int = 128,
             initial_state=None, return_state: bool = False):
    """K8.  x (B, S, H, P) in bf16 or fp32, dt (B, S, H) fp32 (> 0), A
    (H,) fp32 (< 0), B_mat / C_mat (B, S, G, N) in x's dtype with H % G ==
    0, D (H,) or None, initial_state (B, H, P, N) fp32 or None -> y (B, S,
    H, P) in x's dtype, and the final state (B, H, P, N) fp32 with
    ``return_state``.  fp32 inside; ``chunk`` <= 128 and N <= 128 on the
    card.  On CUDA tensors that require grad, with grad mode on, it runs
    through :class:`SSDScanFn` (the backward also takes P <= 64)."""
    if x.device.type == "cpu":
        return ssd_scan_torch(x, dt, A, B_mat, C_mat, D, chunk=chunk,
                              initial_state=initial_state,
                              return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B_mat, C_mat, D, initial_state)):
        return SSDScanFn.apply(x, dt, A, B_mat, C_mat, D, initial_state,
                               chunk, return_state)
    return _forward(x, dt, A, B_mat, C_mat, D, chunk, initial_state,
                    return_state)
