"""Feed-forward layers of the port: the dense (gated or plain) MLP and the
top-k MoE with shared experts, counterparts of ``repro.models.layers``'s
``ParallelCtx``, ``mlp_forward``, ``moe_forward``, ``_moe_local``,
``_place``, ``moe_forward_a2a``, ``_capacity`` and ``_shared_expert``.
The MoE's weight shapes are ``bridge``'s (``init_moe``'s): ``router`` (d,
E), ``wi_gate`` / ``wi_up`` (E, d, ff), ``wo`` (E, ff, d),
``shared/{wi_gate, wi_up, wo}`` over the shared experts' concatenated
hidden.

``moe_forward`` takes the all-to-all dispatch (``moe_forward_a2a``) as
JAX does: only on a live mesh (``ParallelCtx.mesh``, a
``launch.mesh.HostMesh``) with ``moe_strategy == "a2a"``; everywhere else
the local path, which is JAX's gather path at one model shard."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import common
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """How model code sees the mesh.  ``mesh`` None: one process, no
    collectives (every path but the all-to-all MoE)."""
    mesh: Any = None
    batch_axes: tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    data_axis: str = "data"
    moe_strategy: str = "gather"   # gather | a2a (see moe_forward_a2a)

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape.get(self.model_axis, 1)

    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape.get(self.data_axis, 1)


NO_MESH = ParallelCtx()


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
    expert's buffer in the flattened ``(T * k)`` order (``_place``); pairs
    past ``capacity`` are dropped.  Kept rows go to unique slots
    (``index_copy_``); the expert products are batched matmuls over the
    (E, capacity, d) buffer; the combine sums each token's k weighted rows
    in order, as the JAX scatter-add into zeros does (no atomics)."""
    T, d = x2d.shape
    k = idx.shape[1]
    E = wi_gate.shape[0]
    adt = x2d.dtype
    slot, keep = _place(idx.reshape(-1), None, capacity, E)
    tok = torch.arange(T, device=x2d.device).repeat_interleave(k)
    # dropped pairs all land on one spare row past the buffer, cut off
    # after: no host read of the kept count
    drop = E * capacity
    buf = torch.zeros((drop + 1, d), dtype=adt, device=x2d.device)
    buf.index_copy_(0, slot, x2d[tok])
    buf = buf[:drop].view(E, capacity, d)
    h = act(torch.bmm(buf, wi_gate)) * torch.bmm(buf, wi_up)
    out_buf = torch.bmm(h, wo).view(E * capacity, d)
    gathered = out_buf[torch.where(keep, slot, 0)] * keep[:, None].to(adt)
    return _sum_rows(gathered * gates.reshape(-1)[:, None].to(adt), T, k)


def _route(probs, cfg: ModelConfig, ctx: ParallelCtx):
    """Top-k gates (renormalised) and expert ids of each token, and the
    Switch-style load-balance loss.  On a mesh, DeepSeek-V2's
    device-limited routing keeps each token's experts on at most
    ``route_group_limit`` device groups (chosen by the groups' summed
    affinity), as in JAX."""
    E, k = cfg.n_experts, cfg.experts_per_token
    if cfg.route_group_limit and ctx.mesh is not None:
        n_groups = ctx.data_size if ctx.moe_strategy == "a2a" \
            else ctx.model_size
        if E % n_groups == 0 and n_groups > cfg.route_group_limit:
            gsz = E // n_groups
            gscore = probs.reshape(-1, n_groups, gsz).sum(-1)
            _, top_g = _top_k(gscore, cfg.route_group_limit)
            gmask = torch.zeros_like(gscore).scatter_(1, top_g, 1.0)
            probs = probs * torch.repeat_interleave(gmask, gsz, dim=1)
    gates, idx = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    frac_tokens = torch.nn.functional.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(frac_tokens * probs.mean(0)) * cfg.aux_loss_weight
    return gates, idx, aux


def moe_forward(params, x, cfg: ModelConfig, ctx: ParallelCtx = NO_MESH):
    """Top-k MoE FFN.  x (B, S, d) -> (out (B, S, d), aux) with the
    Switch-style load-balance loss ``aux``.  The router's softmax and the
    gates are fp32.  On a live mesh with ``moe_strategy == "a2a"`` the
    experts run through :func:`moe_forward_a2a`; otherwise locally (a
    mesh that would shard the experts over "model" is refused)."""
    B, S, d = x.shape
    adt = x.dtype
    E, k = cfg.n_experts, cfg.experts_per_token
    act = common.activation(cfg.act)
    x2d = x.reshape(B * S, d)
    logits = (x2d @ params["router"].to(adt)).float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    gates, idx, aux = _route(probs, cfg, ctx)
    if (ctx.mesh is not None and ctx.moe_strategy == "a2a"
            and E % max(ctx.data_size, 1) == 0):
        return moe_forward_a2a(params, x, cfg, ctx, gates, idx, aux)
    if ctx.model_size > 1:
        raise NotImplementedError("experts sharded over the model axis: "
                                  "sharded execution is not ported")
    capacity = _capacity(cfg, k, B * S, E)
    out2d = _moe_local(x2d, gates, idx, params["wi_gate"].to(adt),
                       params["wi_up"].to(adt), params["wo"].to(adt),
                       capacity, act)
    if "shared" in params:
        out2d = out2d + _shared_expert(params["shared"], x2d, act)
    return out2d.reshape(B, S, d), aux


def _place(dest, sel, capacity: int, n_dest: int):
    """Slot assignment into per-destination capacity buffers, in order:
    item i takes the next free slot of ``dest[i]`` (int64) when ``sel[i]``
    (every item where ``sel`` is None), a running count over the one-hot
    destinations; items past ``capacity`` are dropped.  -> (slot, keep),
    slot in [0, n_dest * capacity], the last value for a dropped item."""
    oh = torch.nn.functional.one_hot(dest, n_dest)
    if sel is not None:
        oh = oh * sel[:, None]
    pos_at = ((torch.cumsum(oh, dim=0) - oh) * oh).sum(dim=1)
    keep = pos_at < capacity
    if sel is not None:
        keep = keep & sel
    slot = torch.where(keep, dest * capacity + pos_at, n_dest * capacity)
    return slot, keep


def _sum_rows(rows, n: int, k: int):
    """(n * k, d) rows -> (n, d): each group of k summed in order, as a
    scatter-add into zeros adds them."""
    rows = rows.view(n, k, -1)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def _all_to_all(x, group):
    """Chunk i of dim 0 to rank i; chunk j of the result from rank j."""
    import torch.distributed as dist
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def moe_forward_a2a(params, x, cfg: ModelConfig, ctx: ParallelCtx,
                    gates, idx, aux):
    """Dispatch-by-all-to-all expert parallelism over the mesh's data
    group (``all_to_all_single``), JAX's ``moe_forward_a2a``: experts are
    owned by data ranks (E / n_data each); a token whose experts share an
    owner is sent to it once, with a gate vector over that owner's
    experts; the owner places the copies in its experts' buffers, runs
    them, weights each copy by its gates and sends it back; each token
    sums its copies.  Capacities are JAX's: lossless (``cap_send = T x
    fan``) up to 256 tokens a device, ``capacity_factor`` of the even
    share past it.  ``x`` is this rank's tokens; expert weights holding
    all E experts are sliced to this rank's.  Without a "model" axis the
    ff-sharded partial sum over it is the output itself."""
    B, S, d = x.shape
    adt = x.dtype
    E, k = cfg.n_experts, cfg.experts_per_token
    act = common.activation(cfg.act)
    group = ctx.mesh.group(ctx.data_axis)
    n_data = ctx.data_size
    rank = torch.distributed.get_group_rank(
        group, torch.distributed.get_rank()) if n_data > 1 else 0
    E_loc = E // n_data
    T = B * S
    fan = min(k, n_data)
    if cfg.route_group_limit:
        fan = min(fan, cfg.route_group_limit)
    if T <= 256:                                      # decode/smoke: lossless
        cap_send = T * fan
        cap_exp = n_data * cap_send
    else:
        cap_send = max(1, int(cfg.capacity_factor * fan * T / n_data))
        cap_exp = max(1, int(cfg.capacity_factor * k * T * n_data / E))

    def mine(w):
        w = w.to(adt)
        return w[rank * E_loc:(rank + 1) * E_loc] if w.shape[0] == E else w

    wig, wiu, wog = (mine(params[key]) for key in ("wi_gate", "wi_up", "wo"))
    x_l = x.reshape(T, d)
    dest = torch.div(idx, E_loc, rounding_mode="floor")       # (T, k)
    local_e = idx % E_loc
    first = torch.ones((T, k), dtype=torch.bool, device=x.device)
    for j in range(1, k):
        dup = torch.zeros((T,), dtype=torch.bool, device=x.device)
        for i in range(j):
            dup |= dest[:, j] == dest[:, i]
        first[:, j] = ~dup
    flat_dest = dest.reshape(-1)
    flat_first = first.reshape(-1)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    n_send = n_data * cap_send
    slot, keep = _place(flat_dest, flat_first, cap_send, n_data)
    kf = keep[:, None].to(adt)
    # every (token, k) pair maps to the slot of its (token, dest) copy
    slot_map = torch.full((T, n_data), n_send, dtype=torch.long,
                          device=x.device)
    slot_map.view(-1).scatter_reduce_(0, tok * n_data + flat_dest,
                                      torch.where(keep, slot, n_send),
                                      reduce="amin")
    pair_slot = slot_map[tok, flat_dest]
    pair_ok = pair_slot < n_send

    send_x = torch.zeros((n_send + 1, d), dtype=adt, device=x.device)
    send_x.index_copy_(0, slot, x_l[tok] * kf)
    send_g = torch.zeros((n_send + 1, E_loc), dtype=adt, device=x.device)
    send_g.index_put_((torch.where(pair_ok, pair_slot, n_send),
                       local_e.reshape(-1)),
                      gates.reshape(-1).to(adt) * pair_ok, accumulate=True)
    recv_x = _all_to_all(send_x[:n_send], group)
    recv_g = _all_to_all(send_g[:n_send], group)

    # dispatch the received copies into this rank's experts' buffers
    R = recv_x.shape[0]
    a_e = torch.arange(E_loc, device=x.device).repeat(R)
    a_copy = torch.arange(R, device=x.device).repeat_interleave(E_loc)
    a_gate = recv_g.reshape(-1)
    slot2, keep2 = _place(a_e, a_gate != 0, cap_exp, E_loc)
    buf = torch.zeros((E_loc * cap_exp + 1, d), dtype=adt, device=x.device)
    buf.index_copy_(0, slot2, recv_x[a_copy] * keep2[:, None].to(adt))
    buf = buf[:E_loc * cap_exp].view(E_loc, cap_exp, d)
    h = act(torch.bmm(buf, wig)) * torch.bmm(buf, wiu)
    out_buf = torch.bmm(h, wog).view(E_loc * cap_exp, d)

    # gate-weighted combine per copy, then the return trip
    got = out_buf[torch.where(keep2, slot2, 0)] \
        * (a_gate * keep2)[:, None].to(adt)
    back = _all_to_all(_sum_rows(got, R, E_loc), group)
    copy_out = back[torch.where(keep, slot, 0)] * kf
    out = _sum_rows(copy_out * flat_first[:, None].to(adt), T, k)
    if "shared" in params:
        out = out + _shared_expert(params["shared"], x_l, act)
    return out.reshape(B, S, d), aux
