"""Zamba2-1.2B — Mamba2 backbone + ONE shared attention block applied
every 2 mamba layers (single param copy).  [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, max_seq_len=4096,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=128, conv_width=4,
    hybrid_attn_every=2, tie_embeddings=True,
)

SPEC = ArchSpec(
    arch_id="zamba2-1.2b", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[arXiv:2411.15242; hf]",
    long_context_ok=True,
    notes="Shared block input is concat(hidden, embeddings) -> 2d->d "
          "projection (Zamba2's fused-input trick). The shared block's KV "
          "cache grows with context; at long_500k it is the dominant state "
          "(19 applications x 500k KV) — recorded in the roofline as the "
          "memory term. Pattern unit = 2 mamba layers + 1 shared-attn use.",
)
