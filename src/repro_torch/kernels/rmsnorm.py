"""Fused RMSNorm: the hand-written Hopper kernel of K9
(``csrc/rmsnorm.cu``, replacing the JAX package's Pallas
``rmsnorm_pallas``) and its wrapper.

Its plain version is the port's ``models.common.rmsnorm``.  The wrapper
takes it for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises, with no fallback.  ``LAUNCHES["rmsnorm"]`` counts
the launches.
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


def rmsnorm(x, scale, *, eps: float = 1e-6, gemma_style: bool = False):
    """K9.  RMSNorm over the last axis of ``x`` (any leading shape; rows =
    their product): fp32 mean-square, ``x * rsqrt(mean + eps) * scale``
    (``* (1 + scale)`` with ``gemma_style``), in x's dtype.  ``scale`` (d,)
    is fp32 or bf16; d a multiple of 8 on the card."""
    if x.device.type == "cpu":
        return common.rmsnorm(x, scale, eps, gemma_style=gemma_style)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
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
    if rows == 0:
        return out
    err = build.library().rmsnorm_fwd(
        ptr(x), ptr(scale), ptr(out), rows, d, float(eps), int(gemma_style),
        DTYPE_CODE[x.dtype], DTYPE_CODE[scale.dtype],
        *launch_shape(d, rows),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out
