"""Collectives over one mesh axis, the port's counterpart of what XLA's
SPMD pass inserts into the JAX package's sharded steps.

Each rank holds plain local tensors; the model code calls these at named
points (Megatron style).  Every differentiable collective is a
``torch.autograd.Function`` whose backward is its transpose:

  * :func:`all_gather` concatenates the group's shards along a dim: the
    FSDP gather of a weight; its backward reduce-scatters (sums the
    group's gradients and keeps this rank's chunk).
  * :func:`copy_to` (identity; all-reduce in the backward) and
    :func:`all_reduce` (sum; identity in the backward) are Megatron's f
    and g, the entry to and the exit from a tensor-parallel region over
    "model": after g the activation is replicated and every rank holds
    its whole gradient.  :func:`row_parallel` is a row-parallel product
    and its g, summed in fp32.
  * :func:`gather` (concatenate; take this rank's chunk in the backward)
    and :func:`split` (take this rank's chunk; concatenate in the
    backward) lay a replicated activation out as a sharded one and back.
  * :func:`psum` sums contributions that each rank's own loss term reads
    (a mean over the global batch across "data"): all-reduce both ways.

A group of one rank is the identity, with no call into
``torch.distributed``.  The group is ``HostMesh.group(axis)``.

**gloo on CUDA tensors.**  NCCL refuses two ranks on one device, so
several ranks on one card run over gloo.  ``tools/gloo_cuda_probe.py``
reads which collectives gloo takes on CUDA tensors: all three used here
(all-reduce, all-gather, reduce-scatter) on the H100 host's torch
2.11.0+cu128, so every collective calls ``torch.distributed`` directly
over either backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank inside ``group``."""
    return 0 if group is None else dist.get_group_rank(group,
                                                      dist.get_rank())


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM):
    """Sum (or ``op``) of ``t`` over ``group``, out of place."""
    if size(group) == 1:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(t: torch.Tensor, dim: int, group):
    """The group's shards of ``t`` concatenated along ``dim``, in rank
    order."""
    n = size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.movedim(0, dim).contiguous()


def _chunk(t: torch.Tensor, dim: int, group):
    """This rank's chunk of ``t`` along ``dim`` (a copy)."""
    n = size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    return t.chunk(n, dim=dim)[rank(group)].contiguous()


def _reduce_scatter(t: torch.Tensor, dim: int, group):
    """The sum of ``t`` over ``group``, this rank's chunk along ``dim``."""
    n = size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    src = t.movedim(dim, 0).contiguous()
    parts = [p.contiguous() for p in src.chunk(n, dim=0)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out.movedim(0, dim).contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.dim, ctx.group), None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _chunk(dy, ctx.dim, ctx.group), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.dim, ctx.group), None, None


def all_gather(x, dim: int, group):
    """FSDP gather: shards concatenated along ``dim``; the backward
    reduce-scatters (sums the ranks' gradients, keeps this rank's)."""
    return x if size(group) == 1 else _AllGather.apply(x, dim, group)


def copy_to(x, group):
    """Megatron's f: identity; the backward all-reduces the gradient."""
    return x if size(group) == 1 else _Copy.apply(x, group)


def all_reduce(x, group):
    """Megatron's g: the sum over ``group``; the backward is the
    identity."""
    return x if size(group) == 1 else _AllReduce.apply(x, group)


def row_parallel(x, w, group):
    """Megatron's row-parallel product: ``x @ w`` over this rank's rows of
    ``w``, summed over ``group`` (g).  The ranks' partial products are
    summed in fp32 and rounded once to ``x.dtype``, as one process's
    whole product rounds its fp32 accumulator once; partials rounded to
    bf16 before the sum would add a rounding a rank to every layer's
    output."""
    if size(group) == 1:
        return x @ w
    return all_reduce(x.float() @ w.float(), group).to(x.dtype)


def psum(x, group):
    """The sum over ``group`` where every rank's loss reads it: the
    backward all-reduces too."""
    return x if size(group) == 1 else _Psum.apply(x, group)


def gather(x, dim: int, group):
    """A sharded activation made replicated: shards concatenated along
    ``dim``; the backward keeps this rank's chunk."""
    return x if size(group) == 1 else _Gather.apply(x, dim, group)


def split(x, dim: int, group):
    """A replicated activation made sharded: this rank's chunk of
    ``dim``; the backward all-gathers."""
    return x if size(group) == 1 else _Split.apply(x, dim, group)


def all_max(x, group):
    """The elementwise max over ``group``, no gradient."""
    return _all_reduce(x.detach(), group, op=dist.ReduceOp.MAX)
