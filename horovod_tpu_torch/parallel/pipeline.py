"""Pipeline parallelism: the GPipe schedule over a pp axis of processes
(counterpart of ``horovod_tpu/parallel/pipeline.py``).

Rank s holds stage s. The schedule runs ``M + S - 1`` ticks: at tick t
stage 0 takes microbatch t (zeros once ``t >= M``), every other stage what
its predecessor sent at tick t - 1; each stage applies itself and sends
its output one rank on, ``i -> i + 1 mod S``, by the differentiable
``ppermute`` (the ring wraps: stage 0 ignores what it receives). The last
stage's outputs at ticks ``S - 1 .. S - 2 + M`` are the microbatches'
results; every rank gets them by a sum over pp whose gradient is the
identity (``reduce_from_tp``). The backward pipeline is autograd's
reverse of that schedule, bubbles included.

Where the reference's ``lax.scan`` transposes every tick, autograd runs
only what reaches the loss, and the hops' backward are collectives that
pair across ranks. So every tick's output and every received activation is
kept in the graph with a zero gradient where the reference's ``where``
gives one (:class:`_Pick`, :class:`_Collect`): each rank runs every tick's
backward (``M + S - 1`` a stage) and the same hops in the same order.

Only stage 0 reads the input, so only it has a gradient of ``x``; when
``x`` needs one (an embedding before the pipeline), it is summed over pp
(``copy_to_tp``), as JAX sums a replicated input's cotangent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import basics
from ._comm import copy_to_tp, ppermute, reduce_from_tp


@dataclass(frozen=True)
class PpMesh:
    """This rank's stage on the pp axis and the axis's group (None: every
    rank)."""
    pp: int
    pp_rank: int
    pp_group: Any


def make_pp_mesh(pp: int) -> PpMesh:
    """The pp axis over every rank, one stage a rank. Raises ``ValueError``
    when ``pp`` exceeds the ranks, or leaves some without a stage."""
    world = basics.size()
    if pp > world:
        raise ValueError(f"pp={pp} exceeds {world} devices")
    if pp != world:
        raise ValueError(f"pp={pp} must be the world size {world} (one "
                         f"stage a rank)")
    return PpMesh(pp, basics.rank(), None)  # the axis is every rank


def stack_stage_params(init_fn: Callable, seed: int, n_stages: int, sample):
    """One parameter dict a stage, ``init_fn(torch.Generator seeded seed +
    s, sample)`` for stage s, stacked into ``[S, ...]`` tensors."""
    trees = [init_fn(torch.Generator().manual_seed(seed + s), sample)
             for s in range(n_stages)]
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def shard_stage_params(stacked, mesh: PpMesh):
    """This rank's ``[S / pp, ...]`` block of the stacked stage parameters
    (one stage each when S equals pp), as copies that can be trained."""
    def one(name, leaf):
        if leaf.shape[0] % mesh.pp:
            raise ValueError(f"{name}: {leaf.shape[0]} stages do not split "
                             f"over pp={mesh.pp}")
        k = leaf.shape[0] // mesh.pp
        return leaf[mesh.pp_rank * k:(mesh.pp_rank + 1) * k].clone() \
            .requires_grad_(leaf.is_floating_point())

    return {k: one(k, v) for k, v in stacked.items()}


class _Pick(torch.autograd.Function):
    """``keep`` forward; the gradient goes to ``keep``, zeros to ``drop``
    (``where``'s rule), so ``drop`` stays in the graph."""

    @staticmethod
    def forward(ctx, keep, drop):
        return keep.view_as(keep)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _Collect(torch.autograd.Function):
    """The microbatch results of a rank: the ticks ``first .. first + M -
    1`` stacked on the last stage, zeros on the others; every tick's output
    gets its gradient (zeros outside the window and off the last stage)."""

    @staticmethod
    def forward(ctx, last: bool, first: int, m: int, *outs):
        ctx.last, ctx.first, ctx.n = last, first, len(outs)
        window = torch.stack(outs[first:first + m])
        return window if last else torch.zeros_like(window)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g[0])
        grads = [zero] * ctx.n
        if ctx.last:
            for i in range(g.shape[0]):
                grads[ctx.first + i] = g[i]
        return (None, None, None, *grads)


def make_pipeline_fn(stage_fn: Callable, mesh: PpMesh,
                     n_microbatches: int) -> Callable:
    """``f(stage_params, x) -> y``: the GPipe schedule of ``stage_fn(
    stage_params, activation) -> activation`` (the same shape) over the pp
    axis. ``stage_params`` is this rank's block of the stacked parameters
    (:func:`shard_stage_params`), one stage; ``x`` the GLOBAL batch ``[B,
    ...]``, the same on every rank, ``B % n_microbatches == 0``. Returns
    the S stages applied to every microbatch, on every rank."""
    S, M = mesh.pp, n_microbatches
    idx = mesh.pp_rank

    def pipe(stacked, x):
        lead = next(iter(stacked.values())).shape[0]
        if lead != 1:
            raise ValueError(
                f"stacked stage params have {lead * S} stages but the "
                f"mesh's pp size is {S}; each device must hold exactly one "
                "stage")
        p = {k: v[0] for k, v in stacked.items()}
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch size {B} is not divisible by "
                             f"n_microbatches={M}")
        if x.requires_grad:
            x = copy_to_tp(x, mesh.pp_group)
        xs = x.reshape((M, B // M) + tuple(x.shape[1:]))
        feeds = x.requires_grad or idx == 0
        act = torch.zeros_like(xs[0])
        outs = []
        for t in range(M + S - 1):
            if feeds:
                inject = xs[t] if t < M else torch.zeros_like(xs[0])
                inp = (_Pick.apply(inject, act) if idx == 0
                       else _Pick.apply(act, inject))
            else:
                inp = act
            out = stage_fn(p, inp)
            outs.append(out)
            act = ppermute(out, mesh.pp_group)
        ys = reduce_from_tp(_Collect.apply(idx == S - 1, S - 1, M, *outs),
                            mesh.pp_group)
        return ys.reshape((B,) + tuple(ys.shape[2:]))

    return pipe


def make_pp_train_step(stage_fn: Callable, loss_head: Callable, optimizer,
                       mesh: PpMesh, n_microbatches: int) -> Callable:
    """``step(stage_params, x, targets) -> loss``: the pipeline forward,
    ``loss_head(final_activations, targets)`` (the same on every rank), the
    backward through the reverse schedule and ``optimizer`` (over this
    rank's stage parameters) stepped. Each rank's gradients are its own
    stage's: no reduction."""
    pipe = make_pipeline_fn(stage_fn, mesh, n_microbatches)

    def step(stage_params, x, targets):
        optimizer.zero_grad()
        loss = loss_head(pipe(stage_params, x), targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
