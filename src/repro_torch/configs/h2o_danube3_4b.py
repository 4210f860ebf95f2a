"""H2O-Danube-3-4B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, head_dim=120, max_seq_len=32768,
    sliding_window=4096,          # mistral-style SWA (window per the series)
    rope_theta=10_000.0, tie_embeddings=False,
)

SPEC = ArchSpec(
    arch_id="h2o-danube-3-4b", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[arXiv:2401.16818; unverified]",
    long_context_ok=True,
    notes="SWA on every layer clips the decode cache to the 4k window => "
          "sub-quadratic by construction; long_500k runs with a 4096-slot "
          "ring cache.",
)
