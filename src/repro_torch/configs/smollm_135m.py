"""SmolLM-135M — llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ArchSpec, reduce_for_smoke
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, head_dim=64, max_seq_len=4096,
    rope_theta=10_000.0, tie_embeddings=True,
)

SPEC = ArchSpec(
    arch_id="smollm-135m", config=CONFIG, smoke=reduce_for_smoke(CONFIG),
    source="[hf:HuggingFaceTB/SmolLM-135M; hf]",
    long_context_ok=False,
    notes="9 q-heads / 3 kv-heads are not divisible by the 16-way model "
          "axis: attention runs batch-parallel with FSDP-gathered weights "
          "(see runtime.sharding); MLP/vocab still use TP.",
)
