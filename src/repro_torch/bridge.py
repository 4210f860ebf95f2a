"""Weights carried across into the port.

  * ``params_from_numpy(tree, cfg, device)`` — the nested dict that
    ``jax.tree.map(np.asarray, params)`` yields for the JAX package's
    ``transformer.init_lm`` params, as the port's parameter dict.
  * ``load_step_dir(path)`` — one ``repro.checkpoint`` step directory
    (``manifest.json`` + ``arrays.npz`` keyed by ``/``-joined tree paths,
    a list index written ``[i]``), read with numpy alone.  bfloat16 leaves
    were saved as raw 2-byte void records: their bits are reinterpreted,
    never their values cast.
  * ``init_lm(cfg, generator, device)`` — random weights at full width from
    an explicit ``torch.Generator``, on the generator's device, with the
    JAX package's initialiser shapes and scales (not its numbers);
    ``master=True`` keeps every leaf in ``param_dtype`` (a train state's
    fp32 masters).
  * ``train_state_from_numpy(state, cfg, device)`` — the JAX package's
    ``runtime.steps.init_train_state`` state (``params``, ``opt`` with
    ``count`` / ``mu`` / ``nu``, ``step``; numpy leaves) as the port's
    train state: fp32 master params that require grad, the moments in
    their stored dtype.
  * ``cnn_params_from_numpy(name, tree, device)`` — the JAX package's
    params of the CNN zoo member ``name`` (numpy leaves), as the port's
    tree: conv weights transposed from HWIO to OIHW, every leaf requiring
    grad.
  * ``init_cnn(name, generator, device)`` — random weights for ``name``
    from an explicit ``torch.Generator``, with the JAX inits' shapes and
    scales (not their numbers), every leaf requiring grad.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import cnn, common, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _mamba_shapes(cfg: ModelConfig, nu: int) -> dict:
    """An SSM layer's parameter shapes (``repro.models.ssm.init_mamba``)."""
    d, di = cfg.d_model, cfg.d_inner
    H, GN = cfg.resolved_ssm_heads, cfg.ssm_groups * cfg.ssm_state
    cd = ssm.conv_dim(cfg)
    return {"pre_norm": (nu, d), "wz": (nu, d, di), "wx": (nu, d, di),
            "wB": (nu, d, GN), "wC": (nu, d, GN), "wdt": (nu, d, H),
            "conv_w": (nu, cfg.conv_width, cd), "conv_b": (nu, cd),
            "A_log": (nu, H), "D": (nu, H), "dt_bias": (nu, H),
            "norm_scale": (nu, di), "wout": (nu, di, d)}


def _mla_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    """An MLA attention's parameter shapes (``repro.models.attention.
    init_mla``), behind the leading axes ``lead``."""
    d, H = cfg.d_model, cfg.n_heads
    r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    out = {"wdkv": (*lead, d, r_kv + dr), "kv_norm": (*lead, r_kv),
           "wuk": (*lead, r_kv, H, dn), "wuv": (*lead, r_kv, H, dv),
           "wo": (*lead, H, dv, d)}
    if r_q:
        out.update(wdq=(*lead, d, r_q), q_norm=(*lead, r_q),
                   wuq=(*lead, r_q, H, dn + dr))
    else:
        out["wuq"] = (*lead, d, H, dn + dr)
    return out


def _moe_shapes(cfg: ModelConfig, lead: tuple) -> dict:
    """A MoE FFN's parameter shapes (``repro.models.layers.init_moe``):
    the router, the (E, d, ff) experts and the shared experts' hidden
    concatenated, behind ``lead``."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
    out = {"router": (*lead, d, E), "wi_gate": (*lead, E, d, ff),
           "wi_up": (*lead, E, d, ff), "wo": (*lead, E, ff, d)}
    if cfg.n_shared_experts:
        sff = cfg.resolved_shared_d_ff * cfg.n_shared_experts
        out["shared"] = {"wi_gate": (*lead, d, sff),
                         "wi_up": (*lead, d, sff), "wo": (*lead, sff, d)}
    return out


def _block_shapes(cfg: ModelConfig, lead: tuple, *, moe: bool,
                  d_ff: int) -> dict:
    """One attention block (``repro.models.transformer._init_block``):
    norms, GQA or MLA attention, MLP or MoE FFN, behind ``lead``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.padded_q_heads, cfg.padded_kv_heads
    if moe:
        ffn = _moe_shapes(cfg, lead)
    else:
        ffn = {"wi_up": (*lead, d, d_ff), "wo": (*lead, d_ff, d)}
        if cfg.gated_mlp:
            ffn["wi_gate"] = (*lead, d, d_ff)
    attn = _mla_shapes(cfg, lead) if cfg.use_mla else {
        "wq": (*lead, d, hq, hd), "wk": (*lead, d, hkv, hd),
        "wv": (*lead, d, hkv, hd), "wo": (*lead, hq, hd, d)}
    blk = {"norm1": (*lead, d), "norm2": (*lead, d), "attn": attn,
           "ffn": ffn}
    if cfg.post_norms:
        blk["post_attn_norm"] = (*lead, d)
        blk["post_ffn_norm"] = (*lead, d)
    return blk


def _shapes(cfg: ModelConfig) -> dict:
    """The parameter shapes of every family, nested as the JAX tree: the
    units stacked on a leading ``n_units`` axis, ``dense_layers`` a list
    of unstacked blocks, the hybrid family's ``shared_attn`` one unstacked
    block behind its (2d, d) input projection, a codebook model's embed
    (n_cb, Vp, d) and head (n_cb, d, Vp)."""
    d, Vp, n_cb = cfg.d_model, tfm.padded_vocab(cfg), cfg.n_codebooks
    nu = tfm.n_units(cfg)
    if cfg.uses_ssm:
        sub = _mamba_shapes(cfg, nu)
    else:
        sub = _block_shapes(cfg, (nu,), moe=cfg.uses_moe, d_ff=cfg.d_ff)
    out = {"embed": (n_cb, Vp, d) if n_cb else (Vp, d),
           "layers": {f"sub{i}": sub for i in range(tfm.unit_size(cfg))},
           "final_norm": (d,)}
    if cfg.first_dense_layers:
        out["dense_layers"] = [
            _block_shapes(cfg, (), moe=False,
                          d_ff=cfg.dense_d_ff or cfg.d_ff)
            for _ in range(cfg.first_dense_layers)]
    if tfm.is_hybrid(cfg):
        out["shared_attn"] = {"w_in": (2 * d, d),
                              "block": _block_shapes(cfg, (), moe=False,
                                                     d_ff=cfg.d_ff)}
    if n_cb:
        out["lm_head"] = (n_cb, d, Vp)
    elif not cfg.tie_embeddings:
        out["lm_head"] = (d, Vp)
    return out


def _block_axes(cfg: ModelConfig, lead: tuple, *, moe: bool) -> dict:
    """One attention block's logical axes, the ``ParamLeaf`` declarations
    of ``repro.models.attention``, ``layers`` and ``transformer``, behind
    ``lead``."""
    if cfg.use_mla:
        attn = {"wdkv": ("embed", None), "kv_norm": (None,),
                "wuk": (None, "q_heads", None),
                "wuv": (None, "q_heads", None),
                "wo": ("q_heads", None, "embed")}
        if cfg.q_lora_rank:
            attn.update(wdq=("embed", None), q_norm=(None,),
                        wuq=(None, "q_heads", None))
        else:
            attn["wuq"] = ("embed", "q_heads", None)
    else:
        attn = {"wq": ("embed", "q_heads", None),
                "wk": ("embed", "kv_heads", None),
                "wv": ("embed", "kv_heads", None),
                "wo": ("q_heads", None, "embed")}
    mlp = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
           "wo": ("mlp", "embed")}
    if moe:
        ffn = {"router": ("embed", None),
               "wi_gate": ("experts", "expert_d", "expert_ff"),
               "wi_up": ("experts", "expert_d", "expert_ff"),
               "wo": ("experts", "expert_ff", "expert_d")}
        if cfg.n_shared_experts:
            ffn["shared"] = mlp
    else:
        ffn = mlp if cfg.gated_mlp else {k: mlp[k] for k in ("wi_up", "wo")}
    blk = {"norm1": (None,), "norm2": (None,), "attn": attn, "ffn": ffn}
    if cfg.post_norms:
        blk["post_attn_norm"] = (None,)
        blk["post_ffn_norm"] = (None,)
    return _prefix(blk, lead)


_MAMBA_AXES = {"pre_norm": (None,), "wz": ("embed", "ssm_inner"),
               "wx": ("embed", "ssm_inner"), "wB": ("embed", None),
               "wC": ("embed", None), "wdt": ("embed", "ssm_heads"),
               "conv_w": (None, "conv_channels"),
               "conv_b": ("conv_channels",), "A_log": ("ssm_heads",),
               "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
               "norm_scale": ("ssm_inner",),
               "wout": ("ssm_inner", "embed")}


def _prefix(tree: dict, lead: tuple) -> dict:
    return {k: _prefix(v, lead) if isinstance(v, dict) else lead + v
            for k, v in tree.items()}


def param_axes(cfg: ModelConfig) -> dict:
    """The logical sharding axes of every parameter leaf, a tree keyed as
    :func:`_shapes` (the JAX package's ``init_lm`` axes tree): the units'
    leaves behind ``"layers"``, ``dense_layers`` a list of blocks, the
    hybrid family's ``shared_attn``, a codebook model's embed and head
    behind a ``None`` codebook axis."""
    cb = (None,) if cfg.n_codebooks else ()
    if cfg.uses_ssm:
        sub = _prefix(_MAMBA_AXES, ("layers",))
    else:
        sub = _block_axes(cfg, ("layers",), moe=cfg.uses_moe)
    out = {"embed": cb + ("vocab", "embed"),
           "layers": {f"sub{i}": sub for i in range(tfm.unit_size(cfg))},
           "final_norm": (None,)}
    if cfg.first_dense_layers:
        out["dense_layers"] = [_block_axes(cfg, (), moe=False)
                               for _ in range(cfg.first_dense_layers)]
    if tfm.is_hybrid(cfg):
        out["shared_attn"] = {"w_in": ("embed", "embed_out"),
                              "block": _block_axes(cfg, (), moe=False)}
    if cfg.n_codebooks or not cfg.tie_embeddings:
        out["lm_head"] = cb + ("embed", "vocab")
    return out


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """JAX-package params (numpy leaves, or tensors from
    :func:`load_step_dir`) -> the port's parameter dict on ``device``.
    Raises on a missing, extra or misshapen leaf."""
    tfm._require_ported(cfg)
    dev = _device.resolve(device)

    def walk(t, shapes, path):
        if set(t) != set(shapes):
            raise ValueError(f"params{path}: keys {sorted(t)} != expected "
                             f"{sorted(shapes)}")
        out = {}
        for key, want in shapes.items():
            if isinstance(want, dict):
                out[key] = walk(t[key], want, f"{path}/{key}")
                continue
            if isinstance(want, list):
                if len(t[key]) != len(want):
                    raise ValueError(f"params{path}/{key}: {len(t[key])} "
                                     f"layers != expected {len(want)}")
                out[key] = [walk(tj, wj, f"{path}/{key}/[{j}]")
                            for j, (tj, wj) in enumerate(zip(t[key], want))]
                continue
            leaf = _tensor(t[key])
            if tuple(leaf.shape) != want:
                raise ValueError(f"params{path}/{key}: shape "
                                 f"{tuple(leaf.shape)} != {want}")
            out[key] = leaf.to(dev)
        return out

    return walk(tree, _shapes(cfg), "")


def train_state_from_numpy(state, cfg: ModelConfig, device=None) -> dict:
    """A JAX train state (numpy leaves: ``jax.tree.map(np.asarray,
    state)``) -> the port's ``{"params", "opt", "step"}``.  The params are
    the masters (``param_dtype``, requiring grad; never through
    ``transformer.prepare_params``); ``opt`` holds ``count`` and the
    moments ``mu`` / ``nu`` (``nu`` absent for sgd) in the dtype they were
    stored in."""
    dev = _device.resolve(device)
    params = params_from_numpy(state["params"], cfg, dev)
    for p in common.tree_leaves(params):
        p.requires_grad_(True)
    opt = {"count": _tensor(state["opt"]["count"]).to(torch.int32).to(dev)}
    for key in ("mu", "nu"):
        if key in state["opt"]:
            opt[key] = params_from_numpy(state["opt"][key], cfg, dev)
    step = _tensor(state["step"]).to(torch.int32).to(dev)
    return {"params": params, "opt": opt, "step": step}


def load_step_dir(path) -> dict:
    """Read a ``repro.checkpoint`` step directory into a nested dict of CPU
    tensors (keys split on ``/``), dtypes as the manifest records them."""
    path = pathlib.Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    tree: dict = {}
    with np.load(path / "arrays.npz") as data:
        for key, meta in manifest.items():
            arr = data[key]
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(np.ascontiguousarray(arr).view(
                    np.uint16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.asarray(arr, dtype=meta["dtype"]))
            if list(t.shape) != list(meta["shape"]):
                raise ValueError(f"{key}: shape {list(t.shape)} != manifest "
                                 f"{meta['shape']}")
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return _lists(tree)


def _lists(tree):
    """Nodes keyed ``[0] .. [n-1]`` (a JAX list, such as ``dense_layers``)
    back into lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    idx = [f"[{i}]" for i in range(len(out))]
    if out and sorted(out) == sorted(idx):
        return [out[k] for k in idx]
    return out


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None, *,
            master: bool = False) -> dict:
    """Random weights for ``cfg`` from ``generator``, drawn on the
    generator's device (a CUDA generator draws a full-width model on the
    card, with no host copy; the numbers then differ from a CPU
    generator's): embeddings N(0, 0.02), matmul weights N(0, 1/fan_in)
    with fan_in the leading per-layer axis (as JAX's ``fan_in_init`` takes
    a leaf's first axis: the expert axis E of a MoE's (E, d, ff) weights),
    norm scales at 1 (0 for the gemma (1 + w) form).  The matmul weights
    are made in the compute dtype ``cfg.dtype``, to which
    ``transformer.prepare_params`` would cast them anyway, from fp32 draws
    of at most 2**27 values at a time (never the whole bf16 model in
    fp32 first), or in ``param_dtype`` with ``master``; the norm scales
    keep ``param_dtype``.  An SSM layer's other leaves follow the
    deterministic parts of ``repro.models.ssm.init_mamba``, in
    ``param_dtype``: ``A_log = log(linspace(1, 16, H))``, ``dt_bias`` the
    inverse softplus of a log-uniform draw in [1e-3, 1e-1], ``D`` at 1,
    ``conv_b`` at 0 and ``conv_w`` N(0, 0.1)."""
    dev = _device.resolve(device)
    gdev = generator.device
    pdt = common.dt(cfg.param_dtype)
    wdt = pdt if master else common.dt(cfg.dtype)

    def normal(shape, std, dtype=None):
        out = torch.empty(shape, dtype=dtype or wdt,
                          device=dev)
        flat = out.view(shape[0], -1)
        n = flat.shape[1]
        if n > 2 ** 27:          # a leading row too large to draw whole
            flat, n = out.view(-1, 1), 1
        step = max(1, 2 ** 27 // max(n, 1))
        for i in range(0, flat.shape[0], step):
            rows = flat[i:i + step]
            draw = torch.randn(rows.shape, generator=generator, device=gdev)
            rows.copy_(draw.mul_(std))
        return out

    def mamba_leaf(key, shape):
        nu, H = shape[0], shape[-1]
        if key == "A_log":
            row = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
            return row.expand(nu, H).to(pdt).contiguous()
        if key == "dt_bias":
            u = torch.rand(shape, generator=generator, device=gdev).to(dev)
            lo, hi = np.log(1e-3), np.log(0.1)
            target = torch.exp(u * (hi - lo) + lo)
            return torch.log(torch.expm1(target)).to(pdt)
        if key == "D":
            return torch.ones(shape, dtype=pdt, device=dev)
        if key == "conv_b":
            return torch.zeros(shape, dtype=pdt, device=dev)
        return normal(shape, 0.1, pdt)                    # conv_w

    def build(shapes, stacked=True):
        out = {}
        for key, shape in shapes.items():
            if isinstance(shape, dict):          # shared_attn: unstacked
                out[key] = build(shape, stacked and key != "shared_attn")
            elif isinstance(shape, list):      # unstacked: fan_in = axis 0
                out[key] = [build(s, stacked=False) for s in shape]
            elif key in ("A_log", "dt_bias", "D", "conv_b", "conv_w"):
                out[key] = mamba_leaf(key, shape)
            elif "norm" in key:
                fill = 0.0 if cfg.post_norms else 1.0
                out[key] = torch.full(shape, fill,
                                      dtype=common.dt(cfg.param_dtype),
                                      device=dev)
            elif key in ("embed", "lm_head"):
                out[key] = normal(shape, 0.02)
            else:                                  # stacked: fan_in = axis 1
                fan_in = shape[1] if stacked else shape[0]
                out[key] = normal(shape, 1.0 / np.sqrt(max(fan_in, 1)))
        return out

    return build(_shapes(cfg))


def _cnn_tree(name: str, draws: "cnn.Draws"):
    if name not in cnn.CNN_ZOO:
        raise ValueError(f"unknown CNN {name!r}: one of {list(cnn.CNN_ZOO)}")
    return cnn.CNN_ZOO[name][0](draws)


def _trained(tree):
    """``tree`` with every leaf requiring grad (the zoo's params are
    trained in place by ``optim.adamw_update``)."""
    return common.tree_map(lambda t: t.requires_grad_(True), tree)


def cnn_params_from_numpy(name: str, tree, device=None):
    """The JAX package's params of CNN zoo member ``name`` (numpy leaves:
    ``jax.tree.map(np.asarray, params)``) -> the port's tree on
    ``device``: the same keys, list positions, ``None`` slots and dtypes,
    conv weights (the 4-d leaves) transposed from HWIO to OIHW, every
    leaf requiring grad.  Raises on a missing, extra, misplaced or
    misshapen leaf."""
    dev = _device.resolve(device)

    def walk(t, want, path):
        if isinstance(want, dict):
            if not isinstance(t, dict) or set(t) != set(want):
                raise ValueError(f"params{path}: keys "
                                 f"{sorted(t) if isinstance(t, dict) else t}"
                                 f" != expected {sorted(want)}")
            return {k: walk(t[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(t, (list, tuple)) or len(t) != len(want):
                raise ValueError(f"params{path}: expected a list of "
                                 f"{len(want)}")
            return [walk(tj, wj, f"{path}/[{j}]")
                    for j, (tj, wj) in enumerate(zip(t, want))]
        if want is None:
            if t is not None:
                raise ValueError(f"params{path}: expected None")
            return None
        leaf = _tensor(t)
        if leaf.ndim == 4:                         # HWIO -> OIHW
            leaf = leaf.permute(3, 2, 0, 1)
        if tuple(leaf.shape) != tuple(want.shape):
            raise ValueError(f"params{path}: shape {tuple(leaf.shape)} "
                             f"!= {tuple(want.shape)}")
        return leaf.contiguous().to(dev)

    return _trained(walk(tree, _cnn_tree(name, cnn.Draws()), ""))


def init_cnn(name: str, generator: torch.Generator, device=None):
    """Random weights for CNN zoo member ``name`` from ``generator``,
    drawn on the generator's device and moved to ``device`` (the card by
    default; ``"cpu"`` for the CPU): conv N(0, 2 / fan_in) with fan_in =
    (cin / groups) k k, fc N(0, 1 / cin), zero biases, bn scales at 1 and
    shifts at 0, fp32, every leaf requiring grad."""
    dev = _device.resolve(device)
    return _trained(_cnn_tree(name, cnn.Draws(generator, dev)))
