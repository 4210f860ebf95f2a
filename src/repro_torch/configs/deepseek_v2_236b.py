"""DeepSeek-V2 (236B total / 21B active) — MLA (kv_lora 512) + 160 routed
experts top-6 + 2 shared experts, first layer dense.
[arXiv:2405.04434; hf]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536,                     # brief lists the routed-expert hidden
    vocab_size=102400, max_seq_len=8192,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=160, experts_per_token=6, moe_d_ff=1536,
    route_group_limit=3,           # device-limited routing (paper Sec 2.1.2)
    n_shared_experts=2, shared_d_ff=1536,
    first_dense_layers=1, dense_d_ff=12288,
    rope_theta=10_000.0, tie_embeddings=False,
)

SPEC = ArchSpec(
    arch_id="deepseek-v2-236b", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[arXiv:2405.04434; hf]",
    long_context_ok=False,
    notes="MLA decode uses the absorbed-matmul path: the cache is the "
          "compressed (c_kv 512 + rope 64) latent per token, shared across "
          "all 128 heads. 160 experts / 16 EP shards = 10 experts/shard.",
)
