"""Data pipelines of the port: deterministic synthetic token corpora."""
from repro_torch.data.pipeline import DataConfig, TokenBatches

__all__ = ["DataConfig", "TokenBatches"]
