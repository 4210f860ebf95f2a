"""LLaVA-NeXT-34B — Yi-34B-class decoder with an anyres vision prefix
(backbone only; the ViT frontend is a stub: input_specs provides
precomputed patch embeddings).  [hf:llava-hf/llava-v1.6-mistral-7b-hf
(arch recipe); unverified]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128, max_seq_len=4096,
    vision_tokens=2880,            # anyres: 4 tiles + base, 576 each
    rope_theta=5_000_000.0, tie_embeddings=False,
)

SPEC = ArchSpec(
    arch_id="llava-next-34b", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
    long_context_ok=False,
    notes="56 q-heads not divisible by 16 => batch-parallel attention with "
          "FSDP-gathered weights; MLP (20480) and vocab use TP. The 2880 "
          "vision tokens are a loss-masked prefix.",
)
