"""Arch registry plumbing: ArchSpec + the generic smoke-config reducer."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.shapes import ALL_SHAPES, LONG_500K, Shape
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One assigned architecture: full config + reduced smoke variant +
    which input shapes apply (long_500k only for sub-quadratic archs)."""
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    source: str                      # [source; verified-tier] from the brief
    long_context_ok: bool = False    # may run long_500k
    notes: str = ""

    def shapes(self) -> tuple[Shape, ...]:
        out = []
        for s in ALL_SHAPES:
            if s is LONG_500K and not self.long_context_ok:
                continue
            out.append(s)
        return tuple(out)

    def skipped_shapes(self) -> tuple[Shape, ...]:
        return tuple(s for s in ALL_SHAPES if s not in self.shapes())


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Generic family-preserving reducer: tiny layers/width/vocab, same
    block pattern, runs a forward + train step on CPU in seconds."""
    changes: dict = dict(
        n_layers=max(2, 2 * _unit(cfg)),
        d_model=128,
        vocab_size=256,
        max_seq_len=64,
    )
    if cfg.n_heads:
        changes["n_heads"] = 4
        changes["n_kv_heads"] = max(1, int(round(4 * cfg.n_kv_heads / cfg.n_heads)))
        changes["head_dim"] = 32
    if cfg.d_ff:
        changes["d_ff"] = 256
    if cfg.use_mla:
        changes.update(kv_lora_rank=32, q_lora_rank=(24 if cfg.q_lora_rank else 0),
                       rope_head_dim=16, nope_head_dim=32, v_head_dim=32)
    if cfg.n_experts:
        changes.update(n_experts=8, experts_per_token=min(cfg.experts_per_token, 2),
                       moe_d_ff=64,
                       n_shared_experts=min(cfg.n_shared_experts, 1),
                       shared_d_ff=64)
    if cfg.first_dense_layers:
        changes.update(first_dense_layers=1, dense_d_ff=256,
                       n_layers=1 + 2 * _unit(cfg))
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.sliding_window:
        changes["sliding_window"] = 16
    if cfg.local_global:
        changes["local_window"] = 16
    if cfg.vision_tokens:
        changes["vision_tokens"] = 8
    changes.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)


def _unit(cfg: ModelConfig) -> int:
    if cfg.local_global:
        return 2
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        return cfg.hybrid_attn_every
    return 1
