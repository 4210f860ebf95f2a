"""Fused RMSNorm: the hand-written Hopper kernel of K9
(``csrc/rmsnorm.cu``, replacing the JAX package's Pallas
``rmsnorm_pallas``) and its wrapper.

Its plain version is the port's ``models.common.rmsnorm``.  The wrapper
takes it for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises, with no fallback.  ``LAUNCHES["rmsnorm"]`` counts
the launches.

Training: on a CUDA tensor that requires grad (with grad mode on) the
wrapper goes through ``RMSNormFn``, whose forward is the same kernel
given an fp32 rstd output as well (a null one writes none) and whose
backward is the hand-written ``rmsnorm_bwd`` (``LAUNCHES["rmsnorm_bwd"]``
counts its calls): rows in registers as the forward holds them (its own
launch shape, ``bwd_launch_shape``), dx by row, d scale as per-block fp32
partial rows summed in a fixed order by a second launch.  Their plain
twins, ``rmsnorm_rstd_torch`` and ``rmsnorm_bwd_torch``, are what the two
take for CPU tensors.  The
backward takes widths up to ``MAX_WIDTH``; a wider row raises when the
forward is asked for a gradient.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr
from repro_torch.models import common

VMAX = 9            # vectors of 8 values a thread of the kernel holds
BLOCK = 256         # threads a block, at most
MAX_WIDTH = 8192    # widest row the register kernel takes
FEW_ROWS = 132      # fewer rows than the card's SMs: a call is one row's chain
BWD_VMAX = 4        # vectors of 8 values a thread of the backward holds
BWD_BLOCKS_PER_SM = 2   # blocks of the backward's row kernel an SM


def launch_shape(d: int, rows: int) -> tuple[int, int, int]:
    """The kernel's launch shape for ``rows`` rows of width ``d`` (a
    multiple of 8): (threads a row, vectors of 8 values a thread, rows a
    block).  Where it can, every thread holds a whole, equal count of
    vectors, and a row is a power of two up to 32 threads or a multiple of
    32 up to ``BLOCK``: for fewer than ``FEW_ROWS`` rows (decode steps,
    where a call lasts one row's chain of latencies) the fewest vectors a
    thread, else the fewest but at least two where a width allows (one
    16-byte load a thread left 4096 rows of 2048 slower than two, and two
    left 4 rows slower than one).  Other widths up to ``MAX_WIDTH`` give
    the last threads of a row fewer vectors; wider rows take the two-pass
    kernel, named by (0, 0, 1)."""
    return _shape(d, rows < FEW_ROWS)


@functools.lru_cache(maxsize=None)
def _shape(d: int, few: bool) -> tuple[int, int, int]:
    nv = d // 8
    if d > MAX_WIDTH:
        return 0, 0, 1
    for v in (range(1, VMAX + 1) if few else [*range(2, VMAX + 1), 1]):
        t, rest = divmod(nv, v)
        if rest == 0 and ((t <= 32 and t & (t - 1) == 0)
                          or (t % 32 == 0 and t <= BLOCK)):
            return t, v, BLOCK // t
    v = -(-nv // BLOCK)
    t = 32 * -(-nv // (32 * v))
    return t, v, BLOCK // t


@functools.lru_cache(maxsize=None)
def bwd_launch_shape(d: int) -> tuple[int, int, int]:
    """The backward kernel's launch shape for width ``d`` (a multiple of 8
    up to ``MAX_WIDTH``): (threads a row, vectors of 8 values a thread,
    rows a block).  A thread holds x's and dy's vectors and 8 d scale sums
    a vector, so at most ``BWD_VMAX`` vectors.  First a whole, equal split
    over a power of two up to 32 threads (the row's sum is shuffles only),
    then over whole warps (a warp sum and one exchange), each with two
    vectors a thread where it can (as the forward's prefill rows); else
    the fewest threads that hold the row at ``BWD_VMAX`` vectors, the last
    ones with fewer."""
    nv = d // 8
    for small in (True, False):
        for v in (2, 3, 4, 1):
            t, rest = divmod(nv, v)
            if rest == 0 and ((t <= 32 and t & (t - 1) == 0) if small
                              else (t % 32 == 0 and t <= BLOCK)):
                return t, v, BLOCK // t
    need = -(-nv // BWD_VMAX)
    t = 1 << (need - 1).bit_length() if need <= 32 else 32 * -(-need // 32)
    return t, -(-nv // t), BLOCK // t


def bwd_blocks(rows: int, d: int, n_sm: int) -> int:
    """Blocks of the backward's row kernel (its partial rows of d scale):
    ``BWD_BLOCKS_PER_SM`` an SM, or one a row group where there are
    fewer."""
    rpb = bwd_launch_shape(d)[2]
    return min(-(-rows // rpb), BWD_BLOCKS_PER_SM * n_sm)


def rmsnorm(x, scale, *, eps: float = 1e-6, gemma_style: bool = False):
    """K9.  RMSNorm over the last axis of ``x`` (any leading shape; rows =
    their product): fp32 mean-square, ``x * rsqrt(mean + eps) * scale``
    (``* (1 + scale)`` with ``gemma_style``), in x's dtype.  ``scale`` (d,)
    is fp32 or bf16; d a multiple of 8 on the card."""
    if x.device.type == "cpu":
        return common.rmsnorm(x, scale, eps, gemma_style=gemma_style)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps, gemma_style)
    return _forward(x, scale, eps, gemma_style)[0]


def _forward(x, scale, eps, gemma_style, with_rstd: bool = False):
    """The kernel's launch: (out, rstd (rows,) fp32 or None)."""
    from repro_torch.kernels import build
    d = x.shape[-1]
    if x.dtype not in DTYPE_CODE or scale.dtype not in DTYPE_CODE:
        raise ValueError(f"rmsnorm: dtypes x {x.dtype}, scale {scale.dtype} "
                         "not supported (float32 | bfloat16)")
    if d < 8 or d % 8:
        raise ValueError(f"rmsnorm: width {d} is not a multiple of 8")
    check("x", x, dtype=x.dtype, shape=x.shape, device=x.device, vector=True)
    check("scale", scale, dtype=scale.dtype, shape=(d,), device=x.device,
          vector=True)
    out = torch.empty_like(x)
    rows = x.numel() // d
    rstd = (torch.empty((rows,), dtype=torch.float32, device=x.device)
            if with_rstd else None)
    if rows == 0:
        return out, rstd
    lib = build.library()
    args = (rows, d, float(eps), int(gemma_style), DTYPE_CODE[x.dtype],
            DTYPE_CODE[scale.dtype], *launch_shape(d, rows),
            torch.cuda.current_stream(x.device).cuda_stream)
    err = lib.rmsnorm_fwd(ptr(x), ptr(scale), ptr(out), ptr(rstd), *args)
    if err != 0:
        raise RuntimeError(f"rmsnorm: CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out, rstd


def rmsnorm_rstd_torch(x, scale, eps: float = 1e-6,
                       gemma_style: bool = False):
    """The plain twin of the training forward: (out, rstd (rows,) fp32)."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1) + eps)
    w = scale.float()
    if gemma_style:
        w = 1.0 + w
    return (xf * rstd[..., None] * w).to(x.dtype), rstd.reshape(-1)


def rmsnorm_bwd_torch(x, scale, dy, rstd, *, gemma_style: bool = False):
    """The plain twin of ``rmsnorm_bwd``, in fp32: dx = rstd (w' dy - xhat
    mean(xhat w' dy)), xhat = x rstd, w' = scale (1 + scale in the gemma
    form), in x's dtype; d scale = the sum over rows of dy xhat, in
    scale's dtype."""
    d = x.shape[-1]
    xh = x.float().reshape(-1, d) * rstd[:, None]
    g = dy.float().reshape(-1, d)
    w = scale.float()
    if gemma_style:
        w = 1.0 + w
    wg = w * g
    mean = (xh * wg).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (wg - xh * mean)
    return (dx.reshape(x.shape).to(x.dtype),
            (g * xh).sum(dim=0).to(scale.dtype))


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rmsnorm_bwd(x, scale, dy, rstd, *, gemma_style: bool = False):
    """K9's backward: (dx in x's dtype, d scale in scale's dtype) from the
    forward's x, scale and rstd and the output gradient dy.  The plain twin
    for CPU tensors; for CUDA tensors ``rmsnorm_bwd`` (``bwd_blocks``
    blocks of ``bwd_launch_shape`` walking the row groups, then the
    partial rows' reduce) or a raise."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_torch(x, scale, dy, rstd, gemma_style=gemma_style)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {x.device}")
    from repro_torch.kernels import build
    d = x.shape[-1]
    _check_backward(d)
    rows = x.numel() // d
    dev = x.device
    check("x", x, dtype=x.dtype, shape=x.shape, device=dev, vector=True)
    check("dy", dy, dtype=x.dtype, shape=x.shape, device=dev, vector=True)
    check("scale", scale, dtype=scale.dtype, shape=(d,), device=dev)
    check("rstd", rstd, dtype=torch.float32, shape=(rows,), device=dev)
    dx = torch.empty_like(x)
    dw = torch.empty_like(scale)
    if rows == 0:
        return dx, dw.zero_()
    nblk = bwd_blocks(rows, d, _n_sm(dev.index or 0))
    part = torch.empty((nblk, d), dtype=torch.float32, device=dev)
    err = build.library().rmsnorm_bwd(
        ptr(x), ptr(scale), ptr(dy), ptr(rstd), ptr(dx), ptr(dw), ptr(part),
        rows, d, int(gemma_style), DTYPE_CODE[x.dtype],
        DTYPE_CODE[scale.dtype], *bwd_launch_shape(d), nblk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm_bwd: CUDA error {err}")
    LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dw


def _check_backward(d: int) -> None:
    if d > MAX_WIDTH:
        raise ValueError(f"rmsnorm_bwd: width {d} is past the backward "
                         f"kernel's {MAX_WIDTH}")


class RMSNormFn(torch.autograd.Function):
    """K9 with a gradient: the forward kernel with rstd, the backward
    kernel ``rmsnorm_bwd``; on CPU tensors their plain twins."""

    @staticmethod
    def forward(ctx, x, scale, eps, gemma_style):
        if x.device.type == "cpu":
            out, rstd = rmsnorm_rstd_torch(x, scale, eps, gemma_style)
        else:
            _check_backward(x.shape[-1])
            out, rstd = _forward(x, scale, eps, gemma_style, with_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        ctx.gemma_style = gemma_style
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, rstd = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, scale, dy.contiguous(), rstd,
                             gemma_style=ctx.gemma_style)
        return dx, dw, None, None
