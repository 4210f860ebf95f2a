"""Gemma2-27B — local/global alternating attention + logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab_size=256000, head_dim=128, max_seq_len=8192,
    local_global=True, local_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    # gemma2-27b: query_pre_attn_scalar = d_model / n_heads = 144
    query_scale=144.0 ** -0.5,
    post_norms=True, embed_scale=True,
    rope_theta=10_000.0, tie_embeddings=True, act="gelu",
)

SPEC = ArchSpec(
    arch_id="gemma2-27b", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[arXiv:2408.00118; hf]",
    long_context_ok=False,
    notes="Pattern-unit scan over (local, global) layer pairs keeps both "
          "programs distinct in HLO (honest FLOP count). Global layers are "
          "full attention => long_500k skipped.",
)
