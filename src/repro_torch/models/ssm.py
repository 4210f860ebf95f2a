"""The Mamba2 block of the port (SSD, state-space duality,
arXiv:2405.21060): counterparts of ``repro.models.ssm``'s ``conv_dim``,
``_causal_conv``, ``mamba_forward`` and ``mamba_decode``, with the same
parameter names and layouts.

Layer = in-projections -> short causal conv over the x, B and C channels
-> SSD -> gated RMSNorm -> out-projection.  Prefill runs the chunked SSD
scan (``ops.ssd``: K8 on the card); decode is the O(1)-state recurrence
(``ops.ssd_decode_step``, plain torch).

On a live mesh whose "model" axis cuts the inner dims (``ParallelCtx.tp(
"ssm_inner")``) each rank runs its ``H / tp`` heads, Megatron style:
``wz``, ``wx`` and ``wdt`` are column-parallel (their input enters
through f), ``wB`` and ``wC`` are replicated and their B and C, which
feed every rank's heads, enter the conv through f (so that their
gradient, each rank's a part, is summed over "model"), the gated norm
takes its mean over the squares gathered whole over "model", and
``wout`` is row-parallel, summed through g in fp32
(``collectives.row_parallel``).  ``conv_w`` / ``conv_b`` are stored cut
contiguously over the conv channels (JAX's layout), which does not
follow the heads: they are gathered whole at use and this rank's
columns taken, the compute layout ``[its x channels | B | C]``, which is
also the layout of its conv state in a decode cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import NO_MESH, ParallelCtx
from repro_torch.runtime import collectives as col


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


def _tp(cfg: ModelConfig, par: ParallelCtx) -> bool:
    """Does this rank run a "model" cut of the block (its heads and their
    channels)?  The heads must go over "model" with the inner dims, and
    one group of B and C must serve every head."""
    tp = par.tp("ssm_inner")
    if tp != par.tp("ssm_heads") or (tp and cfg.ssm_groups != 1):
        raise NotImplementedError(
            f"{cfg.name}: the SSM inner dims over \"model\" need the "
            f"heads cut with them and one B/C group (ssm_groups "
            f"{cfg.ssm_groups})")
    return tp


def _in_proj(params, x, tp: bool, par: ParallelCtx, constrain=None):
    """x (..., d) -> (z, the conv's input [xc | B | C], dt_raw) of this
    rank: under ``tp`` its channels of z and xc and its heads' dt_raw
    (column-parallel, x entering through f) and all of B and C, entered
    through f."""
    adt = x.dtype
    g = par.model_group if tp else None
    xp = col.copy_to(x, g) if tp else x
    z = xp @ params["wz"].to(adt)
    xc = xp @ params["wx"].to(adt)
    dt_raw = xp @ params["wdt"].to(adt)
    bc = torch.cat([x @ params["wB"].to(adt), x @ params["wC"].to(adt)],
                   dim=-1)
    if tp:
        bc = col.copy_to(bc, g)
    if constrain is not None:
        held = (None, None, "model" if tp else None)
        z = constrain(z, ("batch", None, "ssm_act"), held=held)
        xc = constrain(xc, ("batch", None, "ssm_act"), held=held)
    return z, torch.cat([xc, bc], dim=-1), dt_raw


def _conv_params(params, cfg: ModelConfig, tp: bool, par: ParallelCtx):
    """conv_w (W, c) and conv_b (c,) in this rank's compute layout: the
    columns of its x channels, then those of B and C.  Where the conv
    channels go over "model" the stored shards are gathered whole first:
    under ``tp`` through ``all_gather`` (its backward sums the ranks'
    gradients: each rank's x columns are its own and its B/C columns a
    part), otherwise through ``gather`` (every rank computes the whole
    gradient; the backward keeps its chunk)."""
    w, b = params["conv_w"], params["conv_b"]
    if par.tp("conv_channels"):
        cat = col.all_gather if tp else col.gather
        w = cat(w, 1, par.model_group)
        b = cat(b, 0, par.model_group)
    if not tp:
        return w, b
    di = cfg.d_inner
    n = di // par.model_size
    lo = par.model_rank * n
    return (torch.cat([w[:, lo:lo + n], w[:, di:]], dim=1),
            torch.cat([b[lo:lo + n], b[di:]]))


def mamba_forward(params, x, cfg: ModelConfig, *,
                  policy: ops.KernelPolicy = ops.DEFAULT_POLICY,
                  initial=None, return_state: bool = False,
                  par: ParallelCtx = NO_MESH, constrain=None):
    """Full-sequence Mamba2 block.  x (B, S, d) -> (B, S, d).

    ``initial`` / ``return_state``: the optional (conv_tail (B, W-1, c),
    ssm_state (B, H, P, N) fp32) carry of a decode cache, c the conv
    channels and H the heads this rank computes (all of them off a
    mesh).  ``par`` / ``constrain``: the mesh and the activation
    constraint of a sharded step."""
    adt = x.dtype
    B, S, _ = x.shape
    tp = _tp(cfg, par)
    H = cfg.resolved_ssm_heads // (par.model_size if tp else 1)
    P, N, G = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = H * P

    z, conv_in, dt_raw = _in_proj(params, x, tp, par, constrain)
    w, b = _conv_params(params, cfg, tp, par)
    conv_out, conv_tail = _causal_conv(
        conv_in, w.to(adt), b.to(adt), None if initial is None else initial[0])
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
                             cfg.norm_eps, par.model_group if tp else None)
    out = col.row_parallel(y, params["wout"].to(adt),
                           par.model_group if tp else None)
    if constrain is not None:
        out = constrain(out, ("batch", None, "embed_act"))
    if return_state:
        return out, (conv_tail, ssm_state)
    return out


def mamba_decode(params, x, cache, cfg: ModelConfig, *,
                 par: ParallelCtx = NO_MESH):
    """One-token decode.  x (B, 1, d), cache = (conv_tail (B, W-1, c),
    ssm_state (B, H, P, N)) as :func:`mamba_forward` returns them -> (out
    (B, 1, d), (new conv_tail, new ssm_state fp32)).  O(1) in context
    length."""
    adt = x.dtype
    B = x.shape[0]
    tp = _tp(cfg, par)
    H = cfg.resolved_ssm_heads // (par.model_size if tp else 1)
    P, N, G = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di = H * P
    conv_state, ssm_state = cache

    z, conv_in, dt_raw = _in_proj(params, x[:, 0], tp, par)   # (B, c)
    w, b = _conv_params(params, cfg, tp, par)                   # (W, c)
    hist = torch.cat([conv_state.to(adt), conv_in[:, None]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, w.to(adt)) + b.to(adt)
    conv_out = torch.nn.functional.silu(conv_out)
    new_conv_state = hist[:, 1:]

    xc = conv_out[:, :di].reshape(B, H, P)
    Bc = conv_out[:, di:di + G * N].reshape(B, G, N)
    Cc = conv_out[:, di + G * N:].reshape(B, G, N)
    dt, A = _gates(params, dt_raw)

    ssm_state, y = ops.ssd_decode_step(ssm_state, xc, dt, A, Bc, Cc,
                                       params["D"])
    y = common.gated_rmsnorm(y.reshape(B, di), z, params["norm_scale"],
                             cfg.norm_eps, par.model_group if tp else None)
    out = col.row_parallel(y, params["wout"].to(adt),
                           par.model_group if tp else None)
    return out[:, None], (new_conv_state, ssm_state)
