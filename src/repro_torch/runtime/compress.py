"""Gradient compression for scarce links, the counterpart of
``repro.runtime.compress``, over ``torch.distributed``.

int8 uniform quantization with a per-tensor scale and error feedback: the
quantization residual is carried in the training state and added back
before the next step's quantization, so the compression bias telescopes
away.  ``compressed_psum`` runs its collectives over a process group —
even a group of one rank: gloo on the CPU, NCCL on the card.
"""
from __future__ import annotations

from typing import Any

import torch

# the int8 codec lives in repro_torch.quant (shared with the int8 KV
# pages); re-exported here as the JAX package does
from repro_torch.models.common import tree_map
from repro_torch.quant import dequantize_int8, quantize_int8

__all__ = ["quantize_int8", "dequantize_int8", "compress_residual",
           "compressed_psum", "init_error_state",
           "make_compressed_dp_allreduce"]


def compress_residual(x: torch.Tensor):
    """(q, scale, error) — error = x - dequant(q) for error feedback."""
    q, scale = quantize_int8(x)
    err = x.float() - dequantize_int8(q, scale)
    return q, scale, err


def compressed_psum(tree: Any, group, error_state: Any):
    """int8 all-reduce over the process ``group`` with error feedback.

    ``error_state`` mirrors ``tree`` (fp32).  Returns (the mean over the
    group, fp32, the new error state).  JAX's formula: a SUM all-reduce of
    the int8 values widened to int32 (int8 summands overflow int8), a MAX
    all-reduce of the scales, then ``q_sum * scale_max / n``.  Wire cost:
    the int32 values stand for the s8 -> s32 accumulating all-reduce of a
    deployment, 1 byte an element and one fp32 scale a tensor."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(g, e):
        q, scale, err = compress_residual(g.float() + e)
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        scale_max = scale.clone()
        dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
        return (q_sum.float() * scale_max) / n, err

    pairs = tree_map(one, tree, error_state)      # every rank, one order
    return (tree_map(lambda _, p: p[0], tree, pairs),
            tree_map(lambda _, p: p[1], tree, pairs))


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_compressed_dp_allreduce(group):
    """(grads, error_state) -> (int8 mean of the grads over ``group``, new
    error state): each rank holds its own gradients, as the JAX package's
    ``shard_map`` over the DP axis gives them."""
    def fn(grads, error_state):
        return compressed_psum(grads, group, error_state)
    return fn
