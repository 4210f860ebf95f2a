"""Weights carried across into the port.

  * ``params_from_numpy(tree, cfg, device)`` — the nested dict that
    ``jax.tree.map(np.asarray, params)`` yields for the JAX package's
    ``transformer.init_lm`` params, as the port's parameter dict.
  * ``load_step_dir(path)`` — one ``repro.checkpoint`` step directory
    (``manifest.json`` + ``arrays.npz`` keyed by ``/``-joined tree paths),
    read with numpy alone.  bfloat16 leaves were saved as raw 2-byte void
    records: their bits are reinterpreted, never their values cast.
  * ``init_lm(cfg, generator, device)`` — random weights at full width from
    an explicit ``torch.Generator``, with the JAX package's initialiser
    shapes and scales (not its numbers).
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import common
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


def _shapes(cfg: ModelConfig) -> dict:
    """The dense family's parameter shapes, nested as the JAX tree."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    hq, hkv = cfg.padded_q_heads, cfg.padded_kv_heads
    nu = tfm.n_units(cfg)
    ffn = {"wi_up": (nu, d, ff), "wo": (nu, ff, d)}
    if cfg.gated_mlp:
        ffn["wi_gate"] = (nu, d, ff)
    sub = {"norm1": (nu, d), "norm2": (nu, d),
           "attn": {"wq": (nu, d, hq, hd), "wk": (nu, d, hkv, hd),
                    "wv": (nu, d, hkv, hd), "wo": (nu, hq, hd, d)},
           "ffn": ffn}
    if cfg.post_norms:
        sub["post_attn_norm"] = (nu, d)
        sub["post_ffn_norm"] = (nu, d)
    out = {"embed": (tfm.padded_vocab(cfg), d),
           "layers": {f"sub{i}": sub for i in range(tfm.unit_size(cfg))},
           "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, tfm.padded_vocab(cfg))
    return out


def params_from_numpy(tree, cfg: ModelConfig, device=None) -> dict:
    """JAX-package params (numpy leaves, or tensors from
    :func:`load_step_dir`) -> the port's parameter dict on ``device``.
    Raises on a missing, extra or misshapen leaf."""
    tfm._require_paged(cfg)
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
            leaf = _tensor(t[key])
            if tuple(leaf.shape) != want:
                raise ValueError(f"params{path}/{key}: shape "
                                 f"{tuple(leaf.shape)} != {want}")
            out[key] = leaf.to(dev)
        return out

    return walk(tree, _shapes(cfg), "")


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
    return tree


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights for ``cfg`` from ``generator`` (a CPU generator, so
    the numbers do not depend on the card): embeddings N(0, 0.02), matmul
    weights N(0, 1/fan_in) with fan_in the leading (per-layer) axis, norm
    scales at 1 (0 for the gemma (1 + w) form)."""
    dt = common.dt(cfg.param_dtype)
    dev = _device.resolve(device)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator) * std).to(dt).to(dev)

    def build(shapes):
        out = {}
        for key, shape in shapes.items():
            if isinstance(shape, dict):
                out[key] = build(shape)
            elif "norm" in key:
                fill = 0.0 if cfg.post_norms else 1.0
                out[key] = torch.full(shape, fill, dtype=dt, device=dev)
            elif key in ("embed", "lm_head"):
                out[key] = normal(shape, 0.02)
            else:                                  # stacked: fan_in = axis 1
                out[key] = normal(shape, 1.0 / np.sqrt(max(shape[1], 1)))
        return out

    return build(_shapes(cfg))
