"""Abstract input specs for the dry-run, the counterpart of
``repro.launch.specs``: every model input, state and cache as tensors on
``torch.device("meta")`` (JAX's ``ShapeDtypeStruct`` / ``eval_shape``
stand-ins) — shapes and dtypes, nothing allocated.  Parameter shapes come
from the bridge's shape tables, their logical axes from
``bridge.param_axes``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import bridge
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import Shape
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.steps import StepConfig

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (a name or a dtype)."""
    dt = common.dt(dtype) if isinstance(dtype, str) else dtype
    return torch.empty(tuple(shape), dtype=dt, device=META)


def train_batch_specs(cfg: ModelConfig, shape: Shape) -> dict[str, Any]:
    gb, S = shape.global_batch, shape.seq_len
    tok = (gb, S, cfg.n_codebooks) if cfg.n_codebooks else (gb, S)
    batch = {"inputs": sds(tok, torch.int32),
             "targets": sds(tok, torch.int32)}
    if cfg.vision_tokens:
        # the seq budget includes the vision prefix; text gets the rest
        text = S - cfg.vision_tokens
        batch["inputs"] = sds((gb, text), torch.int32)
        batch["targets"] = sds((gb, text), torch.int32)
        batch["image_embeds"] = sds((gb, cfg.vision_tokens, cfg.d_model),
                                    cfg.dtype)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: Shape) -> dict[str, Any]:
    gb, S = shape.global_batch, shape.seq_len
    tok = (gb, S, cfg.n_codebooks) if cfg.n_codebooks else (gb, S)
    batch = {"inputs": sds(tok, torch.int32)}
    if cfg.vision_tokens:
        batch["inputs"] = sds((gb, S - cfg.vision_tokens), torch.int32)
        batch["image_embeds"] = sds((gb, cfg.vision_tokens, cfg.d_model),
                                    cfg.dtype)
    return batch


def decode_token_specs(cfg: ModelConfig, shape: Shape) -> torch.Tensor:
    gb = shape.global_batch
    if cfg.n_codebooks:
        return sds((gb, 1, cfg.n_codebooks), torch.int32)
    return sds((gb, 1), torch.int32)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return tfm.init_cache(cfg, batch, max_len, dtype=cfg.dtype, device=META)


def abstract_params(cfg: ModelConfig):
    """(params as meta tensors in ``param_dtype``, logical-axes tree)."""
    pdt = common.dt(cfg.param_dtype)

    def build(shapes):
        if isinstance(shapes, dict):
            return {k: build(v) for k, v in shapes.items()}
        if isinstance(shapes, list):
            return [build(v) for v in shapes]
        return sds(shapes, pdt)

    return build(bridge._shapes(cfg)), bridge.param_axes(cfg)


def abstract_train_state(cfg: ModelConfig, step_cfg: StepConfig):
    """(state of meta tensors, logical-axes tree), as
    ``steps.init_train_state`` would build it: fp32 masters, the
    optimizer's ``count`` and moments, ``step``."""
    params, axes = abstract_params(cfg)
    opt_cfg = step_cfg.optimizer
    mdt = common.dt(opt_cfg.moment_dtype)
    moments = lambda: common.tree_map(lambda p: sds(p.shape, mdt), params)
    opt: dict[str, Any] = {"count": sds((), torch.int32), "mu": moments()}
    if opt_cfg.kind in ("adamw", "adam"):
        opt["nu"] = moments()
    return {"params": params, "opt": opt,
            "step": sds((), torch.int32)}, axes


def input_specs(spec: ArchSpec, shape: Shape, step_cfg: StepConfig):
    """Everything the dry-run plans for one (arch, shape) cell."""
    cfg = spec.config
    if shape.kind == "train":
        state, axes = abstract_train_state(cfg, step_cfg)
        return {"kind": "train", "state": state, "axes": axes,
                "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        params, axes = abstract_params(cfg)
        return {"kind": "prefill", "params": params, "axes": axes,
                "batch": prefill_batch_specs(cfg, shape),
                "max_len": shape.seq_len}
    # decode: one new token against a seq_len-deep cache
    params, axes = abstract_params(cfg)
    cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    return {"kind": "decode", "params": params, "axes": axes,
            "cache": cache, "tokens": decode_token_specs(cfg, shape)}
