"""Shared model building blocks of the port: dtypes, RMSNorm, Mamba2's
gated RMSNorm, activations, soft-cap, RoPE, the LM losses and the tree
counts — counterparts of ``repro.models.common`` with the same shapes and
fp32 internals."""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "int32": torch.int32}


def dt(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}")
    return _DTYPES[name]


def rmsnorm(x, scale, eps: float = 1e-6, gemma_style: bool = False):
    """RMSNorm in fp32, cast back to x.dtype; ``gemma_style`` uses the
    (1 + scale) parameterisation."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = scale.float()
    if gemma_style:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def gated_rmsnorm(x, gate, scale, eps: float = 1e-6, group=None):
    """Mamba2's norm: RMSNorm(x * silu(gate)) in fp32, cast back to
    x.dtype.  With ``group`` (the "model" ranks over which the last dim
    is cut) each rank holds its channels of ``x``, ``gate`` and
    ``scale``: the squares are gathered whole over the group
    (``all_gather``, whose backward sums the ranks' gradients) and their
    mean taken as one process takes it, the same sum in the same order.
    An all-reduce of partial sums adds in another order, and its
    last-bit difference, scaling every channel of the row, moved a
    48-layer model's bf16 logits four times as far from the one-rank
    run's as all the other collectives together."""
    x32 = x.float() * torch.nn.functional.silu(gate.float())
    sq = x32 * x32
    if group is not None:
        from repro_torch.runtime import collectives as col
        sq = col.all_gather(sq, sq.ndim - 1, group)
    var = torch.mean(sq, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)


def activation(name: str):
    if name == "silu":
        return torch.nn.functional.silu
    if name == "gelu":
        return lambda x: torch.nn.functional.gelu(x, approximate="tanh")
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown activation {name!r}")


def softcap(x, cap: float):
    """cap * tanh(x / cap), computed in fp32.  The fp32 temporary is
    updated in place, so a call holds one fp32 copy of ``x`` at a time (the
    full-sequence logits of a long prefill are GBs)."""
    y = x.float()
    if y is x:
        y = y.clone()
    return y.div_(cap).tanh_().mul_(cap).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — llama convention.
    x: (..., seq, heads, head_dim); positions broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = torch.as_tensor(rope_frequencies(head_dim, theta),
                            dtype=torch.float32, device=x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope_partial(x, positions, theta: float, fraction: float = 1.0):
    """stablelm-style partial rotary: rotate only the first ``fraction`` of
    head dims, pass the rest through."""
    if fraction >= 1.0:
        return apply_rope(x, positions, theta)
    rd = int(x.shape[-1] * fraction)
    rd -= rd % 2
    rot = apply_rope(x[..., :rd], positions, theta)
    return torch.cat([rot, x[..., rd:]], dim=-1)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------
def cross_entropy(logits, labels, mask=None):
    """Mean token-level CE in fp32.  labels: int ids; mask: 1 = count."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def shift_labels(tokens, pad_id: int = 0):
    """Next-token prediction: inputs tokens[:, :-1] predict tokens[:, 1:]."""
    inputs = tokens[:, :-1]
    labels = tokens[:, 1:]
    mask = (labels != pad_id).float()
    return inputs, labels, mask


# --------------------------------------------------------------------------
# tree utilities
# --------------------------------------------------------------------------
# Parameter trees are nested dicts and lists of tensors (``dense_layers`` is
# a list); ``None`` is an empty subtree, as in JAX.
def tree_leaves(tree) -> list:
    """The leaves in the JAX package's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [] if tree is None else [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(head))]
    return None if head is None else fn(*trees)


def tree_size_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))
