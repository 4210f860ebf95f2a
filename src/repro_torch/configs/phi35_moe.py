"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2 routing.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab_size=32064, head_dim=128, max_seq_len=4096,
    n_experts=16, experts_per_token=2,
    rope_theta=10_000.0, tie_embeddings=False,
)

SPEC = ArchSpec(
    arch_id="phi3.5-moe-42b-a6.6b", config=CONFIG,
    smoke=reduce_for_smoke(CONFIG),
    source="[hf:microsoft/Phi-3.5-MoE-instruct; hf]",
    long_context_ok=False,
    notes="16 experts == 16-way model axis: exactly one expert per EP "
          "shard; MoE combine rides the same per-layer psum as TP.",
)
