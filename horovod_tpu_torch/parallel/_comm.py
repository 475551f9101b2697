"""Differentiable communication along one axis of a process mesh (a
process group; None is the whole world): the ring's hop, the tiled
all-to-all, the split of a global sequence into blocks and back, and
Megatron's two conjugate operators of tensor parallelism. All of it goes
through ``runtime.executor._collective``; an axis of one rank communicates
nothing."""

from __future__ import annotations

import torch

from .. import basics
from ..runtime.executor import _collective, group_ranks


def axis(group=None):
    """(size of the axis, this rank's place on it)."""
    ranks = group_ranks(group)
    return len(ranks), ranks.index(basics.rank())


def _exchange(kind: str, x: torch.Tensor, group,
              shift: int = 1) -> torch.Tensor:
    n, _ = axis(group)
    if n == 1:
        return x.clone()
    return _collective(kind, x, basics.backend(), n, group=group, shift=shift)


class _PPermute(torch.autograd.Function):
    """Send to the next rank of the axis, receive from the previous; the
    gradient takes the reverse ring."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange("ppermute", x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange("ppermute", g, ctx.group, shift=-1), None


class _AllToAll(torch.autograd.Function):
    """Chunk j of dim 0 goes to the axis's rank j; what arrives from rank i
    is chunk i. Its own inverse, so also its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange("all_to_all", x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange("all_to_all", g, ctx.group), None


def gather_blocks(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The axis's blocks of ``x`` concatenated along ``dim`` in rank order."""
    parts = _exchange("all_gather", x.movedim(dim, 0), group)
    return parts.movedim(0, dim)


class _GatherSeq(torch.autograd.Function):
    """[B, T/n, ...] blocks -> [B, T, ...] on every rank. The gradient is
    this rank's block of the output's gradient, which every rank holds
    whole (each computes the same loss of the global output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.t = group, x.shape[1]
        return gather_blocks(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        _, i = axis(ctx.group)
        return g[:, i * ctx.t:(i + 1) * ctx.t], None


class _ShardSeq(torch.autograd.Function):
    """[B, T, ...] -> this rank's block [B, T/n, ...]; the gradient of the
    global input gathers every rank's block gradient."""

    @staticmethod
    def forward(ctx, x, group):
        n, i = axis(group)
        if x.shape[1] % n:
            raise ValueError(f"sequence length {x.shape[1]} is not a "
                             f"multiple of the {n} ranks of the axis")
        t = x.shape[1] // n
        ctx.group = group
        return x[:, i * t:(i + 1) * t].clone()

    @staticmethod
    def backward(ctx, g):
        return gather_blocks(g.contiguous(), ctx.group, 1), None


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis. At
    the input of a column-parallel layer: each rank's slice of the layer
    gives a partial gradient of the replicated input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _exchange("all_reduce", g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the axis forward; identity backward. At the output of a
    row-parallel layer: each rank's slice gives a partial product."""

    @staticmethod
    def forward(ctx, x, group):
        return _exchange("all_reduce", x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x, group=None):
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group=None):
    return _ReduceFromTP.apply(x, group)


def ppermute(x, group=None):
    return _PPermute.apply(x, group)


def all_to_all(x, group=None):
    return _AllToAll.apply(x, group)


def gather_seq(x, group=None):
    return _GatherSeq.apply(x, group)


def shard_seq(x, group=None):
    return _ShardSeq.apply(x, group)
