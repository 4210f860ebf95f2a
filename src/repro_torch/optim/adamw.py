"""AdamW (decoupled weight decay) with optional global-norm clipping: the
counterpart of ``repro.optim.adamw`` on dicts of tensors.

Parameters, gradients and moments are nested dicts (and lists) of tensors
of the same structure; the update runs in place under ``torch.no_grad()``,
in the JAX package's order of operations (fp32 inside, one rounding to
each leaf's dtype), so that fp32 results match it to the last few ulps.
Moments are stored in ``moment_dtype`` (fp32 default; bf16 halves the
optimizer's memory).  No decay on leaves of ``ndim < 2`` (norms, biases).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import common
from repro_torch.models.common import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"            # adamw | adam | sgd
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0         # 0 = no clipping
    momentum: float = 0.9          # sgd
    moment_dtype: str = "float32"
    # schedule
    schedule: str = "cosine"       # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float) -> torch.Tensor:
    """A 0-d fp32 CPU tensor: it combines with a tensor on any device, in
    fp32 as JAX's weakly typed constants do."""
    return torch.tensor(x, dtype=torch.float32)


def make_schedule(cfg: OptimizerConfig):
    """step -> learning rate, a 0-d fp32 tensor on the step's device (the
    JAX schedule's fp32 arithmetic: warmup times decay)."""
    def lr_at(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1)), max=1.0)
        if cfg.schedule == "constant":
            decay = _f32(1.0)
        else:
            t = torch.clamp((step - _f32(cfg.warmup_steps))
                            / _f32(max(cfg.total_steps - cfg.warmup_steps,
                                       1)), 0.0, 1.0)
            if cfg.schedule == "cosine":
                decay = _f32(cfg.min_lr_ratio) + _f32(1 - cfg.min_lr_ratio) \
                    * _f32(0.5) * (1 + torch.cos(_f32(math.pi) * t))
            else:                     # linear
                decay = 1.0 - _f32(1.0 - cfg.min_lr_ratio) * t
        return _f32(cfg.learning_rate) * warm * decay
    return lr_at


def adamw_init(params: Any, cfg: OptimizerConfig) -> dict[str, Any]:
    mdt = common.dt(cfg.moment_dtype)
    zeros_like = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = tree_leaves(params)[0].device
    state: dict[str, Any] = {"count": torch.zeros((), dtype=torch.int32,
                                                  device=dev)}
    if cfg.kind in ("adamw", "adam"):
        state["mu"] = tree_map(zeros_like, params)
        state["nu"] = tree_map(zeros_like, params)
    elif cfg.kind == "sgd":
        state["mu"] = tree_map(zeros_like, params)
    else:
        raise ValueError(f"unknown optimizer {cfg.kind!r}")
    return state


def global_norm(tree: Any, specs: Any = None, mesh=None) -> torch.Tensor:
    """The l2 norm of every leaf of ``tree``.  Where ``tree`` holds this
    rank's shards of a sharded tree (``specs`` the tree of their specs on
    the live ``mesh``), each leaf's sum of squares is summed over the mesh
    axes its spec shards, so that each element counts once however many
    ranks replicate it, and the norm is the unsharded tree's on every
    rank."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if specs is None or mesh is None:
        return torch.sqrt(torch.sum(torch.stack(leaves)))
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime.sharding import named_axes
    by_axes: dict = {}
    for sq, spec in zip(leaves, tree_leaves_specs(tree, specs)):
        axes = tuple(sorted({a for a in named_axes(spec)
                             if mesh.shape[a] > 1}))
        by_axes.setdefault(axes, []).append(sq)
    total = []
    for axes, sqs in sorted(by_axes.items()):
        part = torch.sum(torch.stack(sqs))
        for a in axes:
            part = col._all_reduce(part, mesh.group(a))
        total.append(part)
    return torch.sqrt(torch.sum(torch.stack(total)))


def tree_leaves_specs(tree: Any, specs: Any) -> list:
    """The spec of each leaf of ``tree``, in ``tree_leaves`` order (a spec
    is a tuple, so the spec tree is walked beside ``tree``)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree)
                for s in tree_leaves_specs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [s for t, sp in zip(tree, specs)
                for s in tree_leaves_specs(t, sp)]
    return [] if tree is None else [specs]


@torch.no_grad()
def adamw_update(grads: Any, state: dict[str, Any], params: Any,
                 cfg: OptimizerConfig, specs: Any = None, mesh=None):
    """One optimizer step, in place: ``params`` and ``state``'s moments and
    count are overwritten.  Returns (params, state, metrics) with metrics
    ``{"lr", "grad_norm"}`` as 0-d fp32 tensors.  On a live ``mesh`` the
    leaves are this rank's shards (``specs``): the update is elementwise,
    and the clipping norm is the whole tree's (:func:`global_norm`)."""
    count = state["count"] + 1
    lr = make_schedule(cfg)(count)
    gnorm = global_norm(grads, specs, mesh)
    if cfg.clip_norm > 0:
        scale = torch.clamp(_f32(cfg.clip_norm)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)

    mdt = common.dt(cfg.moment_dtype)
    if cfg.kind in ("adamw", "adam"):
        b1, b2 = cfg.b1, cfg.b2
        c1 = 1 - _f32(b1) ** count.float()
        c2 = 1 - _f32(b2) ** count.float()

        def upd(p, m, v, g):
            g32 = g.float()
            m_new = (b1 * m.float() + (1 - b1) * g32).to(mdt)
            v_new = (b2 * v.float() + (1 - b2) * torch.square(g32)).to(mdt)
            mhat = m_new.float() / c1
            vhat = v_new.float() / c2
            step = mhat / (torch.sqrt(vhat) + cfg.eps)
            if cfg.kind == "adamw" and p.ndim >= 2:   # no decay on norms
                step = step + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
            m.copy_(m_new)
            v.copy_(v_new)

        tree_map(upd, params, state["mu"], state["nu"], grads)
    else:                              # sgd + momentum
        def upd_sgd(p, m, g):
            m.copy_((cfg.momentum * m.float() + g.float()).to(mdt))
            p.copy_(p.float() - lr * m.float())

        tree_map(upd_sgd, params, state["mu"], grads)
    state["count"] = count
    return params, state, {"lr": lr, "grad_norm": gnorm}


def opt_state_sharding(param_sharding: Any, state: dict[str, Any],
                       mesh=None) -> dict[str, Any]:
    """Optimizer-state specs mirror the params'; ``count`` replicated."""
    del mesh
    return {k: () if k == "count" else param_sharding for k in state}
