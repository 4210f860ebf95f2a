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
written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr

MAX_CHUNK = 128     # steps per chunk the kernel's shared memory holds
MAX_STATE = 128     # N, the state size per head


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
    err = build.library().ssd_scan_fwd(
        ptr(x), ptr(dt), ptr(A), ptr(B_mat), ptr(C_mat), ptr(D),
        ptr(initial_state), ptr(y), ptr(h_T), Bb, S, H, P, G, N, chunk,
        x_rs, b_rs, c_rs, DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan: CUDA error {err}")
    LAUNCHES["ssd"] += 1
    return (y, h_T) if return_state else y
