"""Data pipelines of the port: deterministic synthetic corpora."""
from repro_torch.data.pipeline import (CifarBatches, DataConfig, TokenBatches,
                                       make_batches)

__all__ = ["DataConfig", "TokenBatches", "CifarBatches", "make_batches"]
