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

On a live mesh (``launch.mesh.HostMesh``) the port runs sharded,
Megatron style: each rank holds plain local tensors, cut by these specs
(:func:`shard_params`, :func:`shard_cache`), and the model code calls the
collectives of ``runtime.collectives`` at named points, where XLA's SPMD
pass inserts them in JAX.  :meth:`ShardingRules.constrain` lays an
activation out as its spec says, gathering or slicing where the layout
does not hold already; on an :class:`~repro_torch.launch.mesh.AbstractMesh`,
which has no ranks to run on, it returns its input where every axis its
spec names has size 1 and raises otherwise — a constraint is never
quietly dropped.  One difference from JAX: an entry naming a mesh axis
the mesh lacks (the host mesh has no "model" axis) resolves to
replicated, where JAX's lookup would fail.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

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


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (None: none), the first the
    slowest: a rank's shard index over them is row-major, so the shards
    are rebuilt by gathering the last axis first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def named_axes(spec: Spec) -> tuple[str, ...]:
    """Every mesh-axis name a spec uses."""
    return tuple(a for entry in spec for a in entry_axes(entry))


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

    def constrain(self, x, logical: tuple, held: Spec | None = None):
        """``x`` laid out as :meth:`act_spec` says.  ``x`` is this rank's
        local tensor and ``held`` the spec it is in now (default: each
        dim replicated); a dim named "batch" is the step's to lay out
        (the step slices the batch over the DP axes) and is never moved.
        Where a dim's layout holds, nothing runs; otherwise it is sliced
        (``collectives.split``) or gathered (``collectives.gather``) over
        its mesh axis.  On a mesh without ranks (``AbstractMesh``) it
        raises where the spec would shard."""
        if not hasattr(self.mesh, "group"):
            spec = self.act_spec(x, logical)
            big = [a for a in named_axes(spec) if self.mesh.shape[a] > 1]
            if big:
                raise NotImplementedError(
                    f"{logical} resolves to {spec} on a mesh of "
                    f"{self.mesh.shape}, an AbstractMesh with no ranks to "
                    f"run on")
            return x
        from repro_torch.runtime import collectives as col
        held = tuple(held) if held is not None else (None,) * x.ndim
        shape = list(x.shape)
        for d, axes in enumerate(held):
            shape[d] *= _size(self.mesh, axes)
        want = self.act_spec(torch.empty(shape, device="meta"), logical)
        for d, name in enumerate(logical):
            if name == "batch" or want[d] == held[d]:
                continue
            if held[d] is not None:
                x = col.gather(x, d, self._group(held[d]))
            if want[d] is not None:
                x = col.split(x, d, self._group(want[d]))
        return x

    def _group(self, axes):
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(names) != 1:
            raise NotImplementedError(f"a dim over several mesh axes "
                                      f"{names}")
        return self.mesh.group(names[0])

    def parallel_ctx(self) -> ParallelCtx:
        return ParallelCtx(mesh=self.mesh, batch_axes=self.batch_axes,
                           moe_strategy=self.moe_strategy,
                           table=self.table)


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


# --------------------------------------------------------------------------
# local shards of a live mesh
# --------------------------------------------------------------------------
def shard_index(mesh, axes) -> int:
    """This rank's index along the mesh axes ``axes`` (a name or a tuple,
    the first the slowest), as a spec entry over them orders the
    shards."""
    import torch.distributed as dist
    i = 0
    for a in entry_axes(axes):
        g = mesh.group(a)
        i = i * mesh.shape[a] + dist.get_group_rank(g, dist.get_rank())
    return i


def localize(t: torch.Tensor, global_shape, spec: Spec, mesh):
    """This rank's shard of ``t`` under ``spec``: a dim the spec shards is
    cut where ``t`` holds it whole (its size is ``global_shape``'s) and
    kept where ``t`` already holds this rank's shard of it."""
    for d, entry in enumerate(spec):
        n = _size(mesh, entry_axes(entry) or None)
        if n == 1:
            continue
        if t.shape[d] == global_shape[d]:
            w = t.shape[d] // n
            i = shard_index(mesh, entry)
            t = t.narrow(d, i * w, w)
        elif t.shape[d] * n != global_shape[d]:
            raise ValueError(f"dim {d} of {tuple(t.shape)} is neither "
                             f"whole nor a shard of {tuple(global_shape)} "
                             f"under {spec}")
    return t.contiguous()


def shard_params(params: Any, specs: Any, mesh) -> Any:
    """This rank's shards of a whole parameter (or moment) tree, each leaf
    cut by its spec (``rules.param_sharding(bridge.param_axes(cfg))``);
    a leaf that required grad still does."""
    spec_leaves = dict(_leaves_with_path(specs))

    def cut(path, leaf):
        out = localize(leaf.detach(), leaf.shape, spec_leaves[path], mesh)
        return out.requires_grad_(leaf.requires_grad)

    return _map_with_path(cut, params)


def gather_params(params: Any, specs: Any, mesh) -> Any:
    """The whole tree from every rank's shards (the inverse of
    :func:`shard_params`), on every rank: for the checks and the
    checkpoint."""
    from repro_torch.runtime import collectives as col
    spec_leaves = dict(_leaves_with_path(specs))

    def whole(path, leaf):
        t = leaf.detach()
        for d, entry in enumerate(spec_leaves[path]):
            for a in reversed(entry_axes(entry)):
                t = col._all_gather(t, d, mesh.group(a)) \
                    if mesh.shape[a] > 1 else t
        return t

    return _map_with_path(whole, params)


def shard_cache(cache: Any, rules: ShardingRules, cfg: ModelConfig, *,
                batch: int, max_len: int) -> Any:
    """This rank's part of a ring decode cache under
    :func:`cache_sharding`, the specs of the whole cache of ``batch`` rows
    and ``max_len`` (``transformer.init_cache``'s): each leaf is cut where
    it holds a sharded dim whole (the capacity, after a prefill of this
    rank's rows) and kept where it holds its shard already (the batch
    rows, the kv heads, the SSM heads).  The hybrid shared block's rings
    (``cache["shared"]``) are cut as the units' are.  A ring whose
    capacity is cut records ``(slot offset, ring length)`` under
    ``cache["shard"][sub]`` (``"shared"`` for the shared block's): the
    decode sweeps its slots into partials and merges them over "model".

    One leaf differs from JAX's layout: an SSM sub's conv state stays in
    the compute layout its prefill wrote (``models.ssm``: this rank's x
    channels, then all of B and C), where JAX's spec cuts the conv
    channels contiguously; ``cache_sharding`` keeps JAX's rule for the
    dry-run's bytes."""
    from repro_torch.models import transformer as tfm
    mesh = rules.mesh
    if cfg.use_mla or cfg.first_dense_layers:
        raise NotImplementedError(f"{cfg.name}: sharded decode of the MLA "
                                  "family is not ported")
    whole = tfm.init_cache(cfg, batch, max_len, dtype="float32",
                           device="meta")
    specs = cache_sharding(rules, whole, cfg)
    shard: dict = {}

    def cut(name, c, spec_group, whole_group):
        out = {}
        for key, t in c.items():
            spec, shape = spec_group[key], whole_group[key].shape
            if key == "conv":             # (n_units, B, W-1, c): kept
                spec, shape = spec[:-1] + (None,), (*shape[:-1],
                                                     t.shape[-1])
            out[key] = localize(t, shape, spec, mesh)
            if key in ("k", "v") and spec[2] is not None:
                C = shape[2]              # (n_units, B, C, Hkv, hd)
                n = _size(mesh, spec[2])
                shard[name] = (shard_index(mesh, spec[2]) * (C // n), C)
        return out

    out = {"pos": cache["pos"],
           "units": {name: cut(name, c, specs["units"][name],
                               whole["units"][name])
                     for name, c in cache["units"].items()}}
    if "shared" in cache:
        out["shared"] = cut("shared", cache["shared"], specs["shared"],
                            whole["shared"])
    if shard:
        out["shard"] = shard
    return out


def gather_cache(cache: Any, rules: ShardingRules, cfg: ModelConfig, *,
                 batch: int, max_len: int) -> Any:
    """The whole ring cache from every rank's part (:func:`shard_cache`'s),
    on every rank, in the one-rank layout: for the checks.  An SSM conv
    state's x channels are gathered over "model" and its B and C taken
    from this rank."""
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import collectives as col
    mesh = rules.mesh
    whole = tfm.init_cache(cfg, batch, max_len, dtype="float32",
                           device="meta")
    specs = cache_sharding(rules, whole, cfg)
    par = rules.parallel_ctx()

    def gather(t, spec, w):
        for d, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                if mesh.shape[a] > 1 and t.shape[d] != w.shape[d]:
                    t = col._all_gather(t, d, mesh.group(a))
        return t

    def group(c, spec_group, whole_group):
        out = {}
        for key, t in c.items():
            spec, w = spec_group[key], whole_group[key]
            if key == "conv" and t.shape[-1] != w.shape[-1]:
                di = cfg.d_inner // par.model_size
                xs = col._all_gather(t[..., :di].contiguous(), t.ndim - 1,
                                     par.model_group)
                t = torch.cat([xs, t[..., di:]], dim=-1)
                spec = spec[:-1] + (None,)
            out[key] = gather(t, spec, w)
        return out

    out = {"pos": cache["pos"],
           "units": {name: group(c, specs["units"][name],
                                 whole["units"][name])
                     for name, c in cache["units"].items()}}
    if "shared" in cache:
        out["shared"] = group(cache["shared"], specs["shared"],
                              whole["shared"])
    return out
