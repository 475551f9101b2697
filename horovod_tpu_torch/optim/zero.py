"""ZeRO-1 optimizer-state sharding over the data-parallel ranks
(counterpart of ``horovod_tpu/optim/zero.py``).

The reference shards each state leaf with a sharding annotation and lets
GSPMD infer the reduce-scatter and all-gather. PyTorch has no such
annotation, so the port runs ZeRO-1 in flat space, as the reference's
quantized step does (``flat_zero1_state``): the flat gradient is
reduce-scattered, the optimizer runs on this rank's :func:`ring_chunk` of
the flattened parameters, and the update is all-gathered
(``spmd.make_train_step(zero1=True)``). That equals the replicated update
only for elementwise optimizers: SGD (with or without momentum), Adam,
AdamW and the fused AdamW (:data:`ELEMENTWISE`). Any other raises.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .fused import FusedAdamW

#: optimizers whose flat-space update equals their per-leaf update
ELEMENTWISE = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
               FusedAdamW)


def leaf_shard_dim(shape: Sequence[int], world: int):
    """The reference's leaf rule (``_leaf_spec``): the first dimension that
    ``world`` divides (a non-empty one) is partitioned; None (replicate)
    for scalars and leaves no dimension of which it divides."""
    for dim, size in enumerate(shape):
        if size % world == 0 and size > 0:
            return dim
    return None


def ring_chunk(total: int, world: int, block: int) -> int:
    """Per-rank chunk of the flattened parameter vector on the ring:
    ceil(total / world) rounded up to whole quantization blocks."""
    per_rank = -(-total // world)
    return -(-per_rank // block) * block


def shard_bounds(total: int, world: int, index: int,
                 block: int = 1) -> Tuple[int, int]:
    """``[lo, hi)`` element bounds of shard ``index`` of a ``total``-long
    flat vector: ``lo`` on a ``block`` boundary, ``hi`` clamped to
    ``total`` (the last shard takes the ragged tail)."""
    per = ring_chunk(total, world, block)
    lo = min(index * per, total)
    return lo, min(lo + per, total)


def check_elementwise(optimizer: torch.optim.Optimizer) -> None:
    """Raise unless ``optimizer`` is one of :data:`ELEMENTWISE` with one
    parameter group (flat space has one set of hyperparameters)."""
    if not isinstance(optimizer, ELEMENTWISE):
        raise ValueError(
            f"ZeRO-1 in flat space needs an elementwise optimizer (SGD, "
            f"Adam, AdamW, FusedAdamW); got {type(optimizer).__name__}")
    if len(optimizer.param_groups) != 1:
        raise ValueError(
            f"ZeRO-1 in flat space needs one parameter group; got "
            f"{len(optimizer.param_groups)}")


def flat_zero1_state(optimizer: torch.optim.Optimizer, total: int,
                     world: int, block: int, device=None):
    """The optimizer a rank runs for ZeRO-1: a new instance of
    ``optimizer``'s class, with its hyperparameters, over one f32
    parameter of this rank's :func:`ring_chunk` elements (its state, made at
    the first step, is that long: 1/``world`` of the padded flat vector).
    Returns ``(inner optimizer, chunk parameter)``."""
    check_elementwise(optimizer)
    group = optimizer.param_groups[0]
    if device is None:
        device = group["params"][0].device
    chunk = torch.nn.Parameter(torch.zeros(ring_chunk(total, world, block),
                                           dtype=torch.float32,
                                           device=device))
    inner = type(optimizer)([chunk])
    inner.param_groups[0].update(
        {k: v for k, v in group.items() if k != "params"})
    return inner, chunk


def state_numel(optimizer: torch.optim.Optimizer) -> int:
    """Elements of every non-scalar tensor of ``optimizer``'s state."""
    return sum(v.numel() for st in optimizer.state.values()
               for v in st.values()
               if isinstance(v, torch.Tensor) and v.dim() > 0)
