"""Optimizers of the port: AdamW / Adam / SGD-momentum, LR schedules and
global-norm clipping, counterparts of ``repro.optim``."""
from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,
                                     adamw_update, global_norm,
                                     make_schedule, opt_state_sharding)

__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "global_norm",
           "make_schedule", "opt_state_sharding"]
