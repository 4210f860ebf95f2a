"""MusicGen-medium — decoder-only over 4 EnCodec codebooks (backbone only;
the EnCodec frontend is a stub: input_specs provides precomputed codes).
[arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, head_dim=64, max_seq_len=4096,
    n_codebooks=4, tie_embeddings=False, act="gelu", gated_mlp=False,
)

SPEC = ArchSpec(
    arch_id="musicgen-medium", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[arXiv:2306.05284; hf]",
    long_context_ok=False,
    notes="Backbone per the brief: per-codebook embeddings are summed, four "
          "parallel LM heads; the delay-pattern scheduler and text "
          "conditioning live in the (stubbed) frontend. Sinusoidal "
          "positions are carried as RoPE (DESIGN.md Sec 8). 24 heads not "
          "divisible by 16 => batch-parallel attention.",
)
