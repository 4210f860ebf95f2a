"""Mamba2-370M — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, max_seq_len=4096,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    ssm_chunk=128, conv_width=4, tie_embeddings=True,
)

SPEC = ArchSpec(
    arch_id="mamba2-370m", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[arXiv:2405.21060; unverified]",
    long_context_ok=True,
    notes="Constant-size decode state (48 layers x (B,32,64,128) fp32) => "
          "long_500k is O(1) per step. vocab 50280 padded to 50432 for the "
          "16-way TP vocab shard (Megatron-style padding).",
)
