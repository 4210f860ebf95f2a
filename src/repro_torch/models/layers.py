"""Feed-forward layers of the port: the dense (gated or plain) MLP and the
top-k MoE with shared experts, counterparts of ``repro.models.layers``'s
``mlp_forward``, ``moe_forward`` (its mesh-free branch), ``_moe_local``,
``_capacity`` and ``_shared_expert``.  The MoE's weight shapes are
``bridge``'s (``init_moe``'s): ``router`` (d, E), ``wi_gate`` / ``wi_up``
(E, d, ff), ``wo`` (E, ff, d), ``shared/{wi_gate, wi_up, wo}`` over the
shared experts' concatenated hidden."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def mlp_forward(params, x, cfg: ModelConfig):
    """x (B, S, d) -> (B, S, d); weights {"wi_gate"?, "wi_up", "wo"}."""
    adt = x.dtype
    act = common.activation(cfg.act)
    if "wi_gate" in params:
        h = act(x @ params["wi_gate"].to(adt)) * (x @ params["wi_up"].to(adt))
    else:
        h = act(x @ params["wi_up"].to(adt))
    return h @ params["wo"].to(adt)


def _top_k(probs, k: int):
    """The k largest gates per row, largest first.  On ties the lower
    expert index comes first, as ``jax.lax.top_k`` orders them: a stable
    descending sort on the CPU.  On the card one ``torch.topk``, which
    the kernel path and the plain path share."""
    if probs.is_cuda:
        return torch.topk(probs, k, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _capacity(cfg: ModelConfig, k: int, T: int, E: int) -> int:
    """Expert capacity: a decode step or a short prompt (T <= 256) never
    drops; longer inputs keep ``capacity_factor`` of the even share."""
    if T <= 256:
        return T
    return max(1, min(T, int(cfg.capacity_factor * k * T / E)))


def _shared_expert(shared, x2d, act):
    adt = x2d.dtype
    h = act(x2d @ shared["wi_gate"].to(adt)) * (x2d @ shared["wi_up"].to(adt))
    return h @ shared["wo"].to(adt)


def _moe_local(x2d, gates, idx, wi_gate, wi_up, wo, capacity: int, act):
    """Dispatch, expert compute and combine over all E experts.  x2d (T, d),
    gates / idx (T, k).  The (token, choice) pairs take slots in their
    expert's buffer in the flattened ``(T * k)`` order (a running count
    over the one-hot choices); pairs past ``capacity`` are dropped.  Kept
    rows go to unique slots (``index_copy_``); the expert products are
    batched matmuls over the (E, capacity, d) buffer; the combine sums each
    token's k weighted rows in order, as the JAX scatter-add into zeros
    does (no atomics)."""
    T, d = x2d.shape
    k = idx.shape[1]
    E = wi_gate.shape[0]
    adt = x2d.dtype
    flat_e = idx.reshape(-1).long()                            # (T*k,)
    oh = torch.nn.functional.one_hot(flat_e, E)                # (T*k, E)
    pos_at = (torch.cumsum(oh, dim=0) - oh).gather(1, flat_e[:, None])[:, 0]
    keep = pos_at < capacity
    tok = torch.arange(T, device=x2d.device).repeat_interleave(k)
    slot = flat_e * capacity + pos_at
    # dropped pairs all land on one spare row past the buffer, cut off
    # after: no host read of the kept count
    drop = E * capacity
    buf = torch.zeros((drop + 1, d), dtype=adt, device=x2d.device)
    buf.index_copy_(0, torch.where(keep, slot, drop), x2d[tok])
    buf = buf[:drop].view(E, capacity, d)
    h = act(torch.bmm(buf, wi_gate)) * torch.bmm(buf, wi_up)
    out_buf = torch.bmm(h, wo).view(E * capacity, d)
    kept = keep[:, None].to(adt)
    gathered = out_buf[torch.where(keep, slot, 0)] * kept
    weighted = (gathered * gates.reshape(-1)[:, None].to(adt)).view(T, k, d)
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]
    return out


def moe_forward(params, x, cfg: ModelConfig):
    """Top-k MoE FFN, no mesh.  x (B, S, d) -> (out (B, S, d), aux) with
    the Switch-style load-balance loss ``aux``.  The router's softmax and
    the gates are fp32; without a mesh ``route_group_limit`` does not
    apply, as in JAX."""
    B, S, d = x.shape
    adt = x.dtype
    E, k = cfg.n_experts, cfg.experts_per_token
    act = common.activation(cfg.act)
    x2d = x.reshape(B * S, d)
    logits = (x2d @ params["router"].to(adt)).float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    frac_tokens = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0)) * cfg.aux_loss_weight
    capacity = _capacity(cfg, k, B * S, E)
    out2d = _moe_local(x2d, gates, idx, params["wi_gate"].to(adt),
                       params["wi_up"].to(adt), params["wo"].to(adt),
                       capacity, act)
    if "shared" in params:
        out2d = out2d + _shared_expert(params["shared"], x2d, act)
    return out2d.reshape(B, S, d), aux
