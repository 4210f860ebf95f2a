"""Sharding rules of the port: logical parameter / activation axes ->
mesh axes, the counterpart of ``repro.runtime.sharding``.

The scheme is the JAX package's (FSDP x TP x EP, pure DP across pods):
batch and tokens over ("pod", "data"); vocab, MLP hidden, experts and the
SSM inner dims over "model"; the d_model dims of weights over "data"
(FSDP storage); attention heads over "model" only when the head count
divides it; nothing over "pod" but the batch.  The table logic is JAX's,
pure Python over the mesh's axis sizes, so the rules of a production
mesh equal JAX's spec for spec (``tests/test_torch_mesh.py``).

A spec is the counterpart of a ``PartitionSpec``: a tuple with one entry
a tensor dimension, each a mesh-axis name, a tuple of names or ``None``.
:func:`placements` turns one into DTensor placements on a live mesh.

The port runs on one card: :meth:`ShardingRules.constrain` returns its
input when every mesh axis its spec names has size 1, and raises
otherwise — running sharded on several cards is not ported, and a
constraint is never quietly dropped.  One difference from JAX: an
entry naming a mesh axis the mesh lacks (the host mesh has no "model"
axis) resolves to replicated, where JAX's lookup would fail.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParallelCtx
from repro_torch.models.ssm import conv_dim

Spec = tuple


def _size(mesh, axes) -> int:
    """The product of the sizes of ``axes`` (a name, a tuple of names or
    None) on ``mesh``."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def named_axes(spec: Spec) -> tuple[str, ...]:
    """Every mesh-axis name a spec uses."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def _leaves_with_path(tree, path=()):
    """(path, leaf) of a tree of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved logical-axis table for one (cfg, mesh) pair."""
    mesh: Any
    table: dict[str, str | None]
    batch_axes: tuple[str, ...]
    sequence_shard: bool = False
    moe_strategy: str = "gather"

    # -- params ---------------------------------------------------------------
    def param_spec(self, axes: tuple[str | None, ...]) -> Spec:
        shape = self.mesh.shape
        return tuple(m if m in shape else None
                     for m in (self.table.get(a) if a else None
                               for a in axes))

    def param_sharding(self, axes_tree: Any) -> Any:
        """The spec of every leaf of a logical-axes tree."""
        return _map_with_path(lambda _, axes: self.param_spec(axes),
                              axes_tree)

    # -- activations ----------------------------------------------------------
    def act_spec(self, x, logical: tuple) -> Spec:
        """Shape-checked activation spec: 'batch' -> the DP axes of size
        > 1; named table entries -> their mesh axis; dims that do not
        divide -> replicated."""
        shape = self.mesh.shape
        spec: list = []
        for dim, name in enumerate(logical):
            if name == "batch":
                axes = tuple(a for a in self.batch_axes
                             if a in shape and shape[a] > 1)
                ok = axes and x.shape[dim] % _size(self.mesh, axes) == 0
                spec.append(axes if ok else None)
            elif name is None:
                spec.append(None)
            else:
                m = self.table.get(name)
                if m is not None and m in shape \
                        and x.shape[dim] % shape[m] == 0:
                    spec.append(m)
                else:
                    spec.append(None)
        if (self.sequence_shard and len(logical) >= 3
                and logical[0] == "batch" and logical[-1] == "embed_act"
                and spec[1] is None and "model" in shape
                and x.shape[1] % shape["model"] == 0):
            spec[1] = "model"
        return tuple(spec)

    def constrain(self, x, logical: tuple):
        """``x`` itself where its spec shards nothing (every axis it names
        has size 1); raises where it would shard: the port runs on one
        card."""
        spec = self.act_spec(x, logical)
        big = [a for a in named_axes(spec) if self.mesh.shape[a] > 1]
        if big:
            raise NotImplementedError(
                f"sharded execution is not ported: {logical} resolves to "
                f"{spec} on a mesh of {self.mesh.shape}")
        return x

    def parallel_ctx(self) -> ParallelCtx:
        return ParallelCtx(mesh=self.mesh, batch_axes=self.batch_axes,
                           moe_strategy=self.moe_strategy)


def build_rules(cfg: ModelConfig, mesh, *, fsdp_axis: str = "data",
                tp_axis: str = "model", sequence_shard: bool = False,
                fsdp: bool = True, moe_strategy: str = "gather") \
        -> ShardingRules:
    shape = mesh.shape
    tp = shape.get(tp_axis, 1)
    dpn = shape.get(fsdp_axis, 1)
    dp = fsdp_axis if (fsdp and fsdp_axis in shape) else None

    def tp_if(n: int) -> str | None:
        return tp_axis if (n and n % tp == 0) else None

    if moe_strategy == "a2a" and cfg.n_experts and cfg.n_experts % dpn == 0:
        expert_axes = {"experts": fsdp_axis, "expert_d": None,
                       "expert_ff": tp_if(cfg.resolved_moe_d_ff)}
    else:
        expert_axes = {"experts": tp_if(cfg.n_experts), "expert_d": dp,
                       "expert_ff": None}

    table: dict[str, str | None] = {
        "vocab": tp_axis,
        "embed": dp,
        "embed_out": tp_if(cfg.d_model),
        "mlp": tp_axis,
        "mlp_act": tp_axis,
        **expert_axes,
        "layers": None,
        "q_heads": tp_if(cfg.padded_q_heads),
        "kv_heads": tp_if(cfg.padded_kv_heads),
        "embed_act": None,
        "ssm_inner": tp_if(cfg.d_inner if cfg.uses_ssm else 0),
        "ssm_act": tp_if(cfg.d_inner if cfg.uses_ssm else 0),
        "ssm_heads": tp_if(cfg.resolved_ssm_heads if cfg.uses_ssm else 0),
        "conv_channels": tp_if(conv_dim(cfg) if cfg.uses_ssm else 0),
        "codebooks": None,
    }
    batch_axes = tuple(a for a in ("pod", "data") if a in shape)
    effective = ("a2a" if expert_axes["experts"] == fsdp_axis else "gather")
    return ShardingRules(mesh=mesh, table=table, batch_axes=batch_axes,
                         sequence_shard=sequence_shard,
                         moe_strategy=effective)


# --------------------------------------------------------------------------
# cache and batch specs
# --------------------------------------------------------------------------
def _dp(rules: ShardingRules) -> tuple[tuple[str, ...], int]:
    shape = rules.mesh.shape
    baxes = tuple(a for a in rules.batch_axes if shape[a] > 1)
    return baxes, (_size(rules.mesh, baxes) if baxes else 1)


def cache_sharding(rules: ShardingRules, cache: Any,
                   cfg: ModelConfig) -> Any:
    """The spec of every leaf of a ring decode cache (tensors or anything
    with ``.shape``), JAX's rule: the batch dim over the DP axes when it
    divides; then one head / channel / capacity dim over "model" (the kv
    heads, else the ring's capacity; the SSM heads; the conv channels; an
    MLA latent's capacity)."""
    del cfg
    baxes, bsize = _dp(rules)
    tp = rules.mesh.shape.get("model", 1)

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return ()
        names = [p for p in path if isinstance(p, str)]
        stacked = "units" in names or "shared" in names
        b_dim = 1 if stacked else 0
        spec: list = [None] * len(shape)
        if shape[b_dim] % bsize == 0 and bsize > 1:
            spec[b_dim] = baxes
        if "model" not in rules.mesh.shape:      # the host mesh
            return tuple(spec)
        kind = names[-1]
        if kind in ("k", "v"):
            if shape[-2] % tp == 0:
                spec[-2] = "model"
            elif shape[b_dim + 1] % tp == 0:
                spec[b_dim + 1] = "model"
        elif kind == "ssm" and shape[b_dim + 1] % tp == 0:
            spec[b_dim + 1] = "model"
        elif kind == "conv" and shape[-1] % tp == 0:
            spec[-1] = "model"
        elif kind == "lat" and len(shape) >= 3 \
                and shape[b_dim + 1] % tp == 0:
            spec[b_dim + 1] = "model"
        return tuple(spec)

    return _map_with_path(spec_for, cache)


def batch_sharding(rules: ShardingRules, batch: Any) -> Any:
    """Input batch: dim 0 over the DP axes (replicated if it does not
    divide); a one-entry spec, as JAX's ``P(baxes)``."""
    baxes, bsize = _dp(rules)

    def spec_for(path, leaf):
        if len(leaf.shape) == 0:
            return ()
        ok = baxes and leaf.shape[0] % bsize == 0
        return (baxes if ok else None,)

    return _map_with_path(spec_for, batch)


def per_device_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes one device holds of ``tree`` (tensors, meta included) under
    ``specs`` (the same tree of specs): each leaf's bytes divided by the
    product of the sizes of the mesh axes its spec names."""
    total = 0
    spec_leaves = dict(_leaves_with_path(specs))
    for path, leaf in _leaves_with_path(tree):
        shards = _size(mesh, named_axes(spec_leaves[path]))
        total += leaf.numel() * leaf.element_size() // shards
    return int(total)


def placements(spec: Spec, mesh) -> list:
    """A spec as DTensor placements on a live :class:`~repro_torch.launch.
    mesh.HostMesh`: one placement a mesh dim, ``Shard(d)`` where tensor
    dim d names that axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, entry in enumerate(spec) if entry is not None
                and axis in ((entry,) if isinstance(entry, str) else entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
