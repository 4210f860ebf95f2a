"""The Mamba2 block of the port (SSD, state-space duality,
arXiv:2405.21060): counterparts of ``repro.models.ssm``'s ``conv_dim``,
``_causal_conv``, ``mamba_forward`` and ``mamba_decode``, with the same
parameter names and layouts.

Layer = in-projections -> short causal conv over the x, B and C channels
-> SSD -> gated RMSNorm -> out-projection.  Prefill runs the chunked SSD
scan (``ops.ssd``: K8 on the card); decode is the O(1)-state recurrence
(``ops.ssd_decode_step``, plain torch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv as W shifted adds.  x (B, S, C), w (W, C), b
    (C,), state (B, W-1, C) or None (zeros).  Returns (y, tail), tail =
    the last W-1 inputs (the decode conv state)."""
    W = w.shape[0]
    if state is None:
        x_pad = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + x_pad[:, i:i + S] * w[i]
    tail = x_pad[:, -(W - 1):] if W > 1 else None
    return y + b, tail


def _gates(params, dt_raw):
    """dt = softplus(dt_raw + dt_bias) and A = -exp(A_log), in fp32."""
    dt = torch.nn.functional.softplus(dt_raw.float()
                                      + params["dt_bias"].float())
    return dt, -torch.exp(params["A_log"].float())


def mamba_forward(params, x, cfg: ModelConfig, *,
                  policy: ops.KernelPolicy = ops.DEFAULT_POLICY,
                  initial=None, return_state: bool = False):
    """Full-sequence Mamba2 block.  x (B, S, d) -> (B, S, d).

    ``initial`` / ``return_state``: the optional (conv_tail (B, W-1, cd),
    ssm_state (B, H, P, N) fp32) carry of a decode cache."""
    adt = x.dtype
    B, S, _ = x.shape
    di, H = cfg.d_inner, cfg.resolved_ssm_heads
    P, N, G = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups

    z = x @ params["wz"].to(adt)
    xc = x @ params["wx"].to(adt)
    Bc = x @ params["wB"].to(adt)
    Cc = x @ params["wC"].to(adt)
    dt_raw = x @ params["wdt"].to(adt)

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out, conv_tail = _causal_conv(
        conv_in, params["conv_w"].to(adt), params["conv_b"].to(adt),
        None if initial is None else initial[0])
    conv_out = torch.nn.functional.silu(conv_out)
    # views of the conv output: the kernel reads them in place
    xc = conv_out[..., :di].reshape(B, S, H, P)
    Bc = conv_out[..., di:di + G * N].reshape(B, S, G, N)
    Cc = conv_out[..., di + G * N:].reshape(B, S, G, N)
    dt, A = _gates(params, dt_raw)

    res = ops.ssd(xc, dt, A, Bc, Cc, params["D"], policy=policy,
                  initial_state=None if initial is None else initial[1],
                  return_state=return_state)
    y, ssm_state = res if return_state else (res, None)
    y = common.gated_rmsnorm(y.reshape(B, S, di), z, params["norm_scale"],
                             cfg.norm_eps)
    out = y @ params["wout"].to(adt)
    if return_state:
        return out, (conv_tail, ssm_state)
    return out


def mamba_decode(params, x, cache, cfg: ModelConfig):
    """One-token decode.  x (B, 1, d), cache = (conv_tail (B, W-1, cd),
    ssm_state (B, H, P, N)) -> (out (B, 1, d), (new conv_tail, new
    ssm_state fp32)).  O(1) in context length."""
    adt = x.dtype
    B = x.shape[0]
    di, H = cfg.d_inner, cfg.resolved_ssm_heads
    P, N, G = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    conv_state, ssm_state = cache
    xt = x[:, 0]

    z = xt @ params["wz"].to(adt)
    xc = xt @ params["wx"].to(adt)
    Bc = xt @ params["wB"].to(adt)
    Cc = xt @ params["wC"].to(adt)
    dt_raw = xt @ params["wdt"].to(adt)

    conv_in = torch.cat([xc, Bc, Cc], dim=-1)                # (B, cd)
    w = params["conv_w"].to(adt)                             # (W, cd)
    hist = torch.cat([conv_state.to(adt), conv_in[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, w) + params["conv_b"].to(adt)
    conv_out = torch.nn.functional.silu(conv_out)
    new_conv_state = hist[:, 1:]

    xc = conv_out[:, :di].reshape(B, H, P)
    Bc = conv_out[:, di:di + G * N].reshape(B, G, N)
    Cc = conv_out[:, di + G * N:].reshape(B, G, N)
    dt, A = _gates(params, dt_raw)

    ssm_state, y = ops.ssd_decode_step(ssm_state, xc, dt, A, Bc, Cc,
                                       params["D"])
    y = common.gated_rmsnorm(y.reshape(B, di), z, params["norm_scale"],
                             cfg.norm_eps)
    out = (y @ params["wout"].to(adt))[:, None]
    return out, (new_conv_state, ssm_state)
