"""Feed-forward layers of the port: the dense (gated or plain) MLP,
counterpart of ``repro.models.layers.mlp_forward``.  MoE joins with its
own slice."""
from __future__ import annotations

from repro_torch.models import common
from repro_torch.models.config import ModelConfig


def mlp_forward(params, x, cfg: ModelConfig):
    """x (B, S, d) -> (B, S, d); weights {"wi_gate"?, "wi_up", "wo"}."""
    adt = x.dtype
    act = common.activation(cfg.act)
    if "wi_gate" in params:
        h = act(x @ params["wi_gate"].to(adt)) * (x @ params["wi_up"].to(adt))
    else:
        h = act(x @ params["wi_up"].to(adt))
    return h @ params["wo"].to(adt)
