"""Shared model building blocks of the port: dtypes, RMSNorm, Mamba2's
gated RMSNorm, activations, soft-cap, RoPE — counterparts of ``repro.models.common`` with the same
shapes and fp32 internals."""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "int32": torch.int32}


def dt(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def rmsnorm(x, scale, eps: float = 1e-6, gemma_style: bool = False):
    """RMSNorm in fp32, cast back to x.dtype; ``gemma_style`` uses the
    (1 + scale) parameterisation."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if gemma_style:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def gated_rmsnorm(x, gate, scale, eps: float = 1e-6):
    """Mamba2's norm: RMSNorm(x * silu(gate)) in fp32, cast back to
    x.dtype."""
    x32 = x.float() * torch.nn.functional.silu(gate.float())
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def activation(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown activation {name!r}")


def softcap(x, cap: float):
    """cap * tanh(x / cap), computed in fp32.  The fp32 temporary is
    updated in place, so a call holds one fp32 copy of ``x`` at a time (the
    full-sequence logits of a long prefill are GBs)."""
    y = x.float()
    if y is x:
        y = y.clone()
    return y.div_(cap).tanh_().mul_(cap).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — llama convention.
    x: (..., seq, heads, head_dim); positions broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(head_dim, theta),
                            dtype=torch.float32, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_partial(x, positions, theta: float, fraction: float = 1.0):
    """stablelm-style partial rotary: rotate only the first ``fraction`` of
    head dims, pass the rest through."""
    if fraction >= 1.0:
        return apply_rope(x, positions, theta)
    rd = int(x.shape[-1] * fraction)
    rd -= rd % 2
    rot = apply_rope(x[..., :rd], positions, theta)
    return torch.cat([rot, x[..., rd:]], dim=-1)
