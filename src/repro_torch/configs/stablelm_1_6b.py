"""StableLM-2-1.6B — dense LM with partial rotary embeddings (25%).
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, head_dim=64, max_seq_len=4096,
    rope_theta=10_000.0, rope_fraction=0.25, tie_embeddings=False,
)

SPEC = ArchSpec(
    arch_id="stablelm-1.6b", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]",
    long_context_ok=False,
    notes="LayerNorm-with-bias in the original is carried as RMSNorm here "
          "(identical roofline class; recorded in DESIGN.md Sec 8).",
)
