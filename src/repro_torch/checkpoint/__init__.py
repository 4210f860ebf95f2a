"""Checkpointing: atomic, resumable, readable by the JAX package."""
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          restore_pytree, save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "latest_step"]
