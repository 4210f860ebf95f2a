"""Symmetric int8 quantization helpers, the port's copy of ``repro.quant``.

Two consumers share one arithmetic:

  * the quantized KV pages (``serving`` + ``kernels``): per-ROW scales, one
    fp32 scale for each (token, kv head) row over head_dim.  Decode
    appends one row at a time, so a row's scale is fixed when it is
    written and never changes: shared prefix pages and host-tier blobs
    stay bit-stable.
  * the per-tensor pair, kept for the gradient-compression path when it is
    ported.

``q = round(x / scale)`` clipped to [-127, 127] with ``scale = max|x| /
127`` (at least 1e-12 / 127), in fp32.  The division is a true division
and ``torch.round`` rounds half to even, as ``jnp.round`` does, so equal
fp32 inputs give the JAX package's int8 values and scales bit for bit.
Dequant is ``q * scale`` in fp32, the multiply the fused-dequant sweeps do
on each row as it lands in shared memory (``kernels/csrc``).  Plain torch
on every device: the JAX package computes this in XLA, not in a kernel.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: ``(q, scale)`` with a 0-d fp32 scale."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the LAST axis: ``q`` shaped like ``x``
    (int8), ``scale`` shaped ``x.shape[:-1] + (1,)`` (fp32), the KV-pool
    layout.  An all-zero row gets scale 1e-12 / 127 and exact zeros."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor) \
        -> torch.Tensor:
    """Inverse of :func:`quantize_int8_rows` (the (..., 1) scale
    broadcasts over head_dim)."""
    return q.float() * scale
