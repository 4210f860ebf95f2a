"""Fused RMSNorm: the hand-written Hopper kernel of K9
(``csrc/rmsnorm.cu``, replacing the JAX package's Pallas
``rmsnorm_pallas``) and its wrapper.

Its plain version is the port's ``models.common.rmsnorm``.  The wrapper
takes it for a tensor that lies on the CPU; for a CUDA tensor it launches
the kernel or raises, with no fallback.  ``LAUNCHES["rmsnorm"]`` counts
the launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.binding import DTYPE_CODE, LAUNCHES, check, ptr
from repro_torch.models import common


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
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm: CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return out
