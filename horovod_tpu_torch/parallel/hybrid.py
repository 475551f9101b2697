"""3D hybrid parallelism: data x tensor x sequence in one grid of processes
(counterpart of ``horovod_tpu/parallel/hybrid.py``).

The reference puts ``("dp", "tp", "sp")`` in one mesh, dp and sp manual and
tp left to GSPMD. Here every axis is a set of process groups and the
collectives are written out:

* **dp**: the batch is sharded;
* **sp**: the sequence is sharded, and attention is ``ring_attention`` over
  the sp group on a rank's own heads (kernel K6 a hop forward, K7 a hop
  backward, on the card; the reference runs its jnp ring only because GSPMD
  cannot partition a custom call over the auto tp axis);
* **tp**: the Megatron column / row-parallel layers of ``tensor.py``.

Rank ``r`` sits at ``r = (d * tp + t) * sp + s``, the reference's
``reshape(dp, tp, sp)``. Three sets of groups: the sp rings (same d and t),
the tp groups (same d and s) and the gradient groups (same t: the dp x sp
ranks that hold the same tensor shard, over which the gradients average).

The step is the sequence-parallel one (``sp_training.make_sp_train_step``)
on this grid::

    mesh = make_dp_tp_sp_mesh(dp=2, tp=2, sp=2)      # at world size 8
    model = hybrid_model(TransformerLM, mesh, vocab_size=V, ...)
    shard_params_hybrid(model, mesh).to(device)
    step = make_hybrid_train_step(model, torch.optim.AdamW(...), mesh)
    loss = step(tokens, targets)      # the GLOBAL [B, T] batch on every rank
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Mapping

import torch

from .ring_attention import ring_attention
from .sp_training import _local_block, grid, make_sp_train_step
from .tensor import shard_params_tp, shard_tensor, tp_param_shardings


@dataclass(frozen=True)
class DpTpSpMesh:
    """This rank's place on the (dp, tp, sp) grid, its tp group and sp
    ring, and its gradient group (None at world size 1)."""
    dp: int
    tp: int
    sp: int
    dp_rank: int
    tp_rank: int
    sp_rank: int
    tp_group: Any
    sp_group: Any
    grad_group: Any


def make_dp_tp_sp_mesh(dp: int, tp: int, sp: int) -> DpTpSpMesh:
    """The (dp, tp, sp) grid over every rank, row-major (see
    ``sp_training.grid``). Raises ``ValueError`` unless ``dp * tp * sp`` is
    the world size."""
    (d, t, s), (sp_group, tp_group, grad_group) = grid(
        (dp, tp, sp), [(2,), (1,), (0, 2)])
    return DpTpSpMesh(dp, tp, sp, d, t, s, tp_group, sp_group, grad_group)


def hybrid_model(model_cls, mesh: DpTpSpMesh, **kwargs):
    """``model_cls(attn_fn=<causal ring attention over mesh's sp group>,
    **kwargs)``, e.g. a ``TransformerLM``; shard it with
    :func:`shard_params_hybrid`."""
    return model_cls(attn_fn=partial(ring_attention, group=mesh.sp_group,
                                     causal=True), **kwargs)


def shard_params_hybrid(model, mesh: DpTpSpMesh):
    """The Megatron column / row-parallel slices over tp, in place."""
    return shard_params_tp(model, mesh)


def shard_opt_state_hybrid(opt_state: Mapping, params: Mapping,
                           mesh: DpTpSpMesh) -> dict:
    """This rank's slice of a full optimizer ``state_dict``: each entry of
    a parameter's state shaped like that parameter (momentum, Adam's
    moments) is sliced by the parameter's tp spec; the rest (step counts)
    is kept. ``params``: the full model's parameters, ``{name: tensor}`` in
    the optimizer's order (``dict(model.named_parameters())`` before
    :func:`shard_params_hybrid`). The result loads into an optimizer built
    over the sharded model. (The reference places optax state with GSPMD; a
    torch optimizer built after sharding already holds sharded state, so
    what carries across is a full state.)"""
    specs = tp_param_shardings(params, mesh)
    shapes = [(n, p.shape) for n, p in params.items()]
    state = {}
    for idx, entry in opt_state["state"].items():
        name, shape = shapes[idx]
        state[idx] = {k: (shard_tensor(v, specs[name], mesh)
                          if isinstance(v, torch.Tensor) and v.shape == shape
                          else v)
                      for k, v in entry.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_data_hybrid(tokens, mesh: DpTpSpMesh) -> torch.Tensor:
    """Global ``[B, T]`` tokens -> this rank's block: batch over dp,
    sequence over sp (equal on the ranks of a tp group)."""
    return _local_block(tokens, mesh, torch.as_tensor(tokens).device)


def make_hybrid_train_step(model, optimizer, mesh: DpTpSpMesh):
    """``step(tokens, targets) -> loss`` on the GLOBAL ``[B, T]`` batch:
    ``make_sp_train_step`` on the 3D grid, whose gradients average over the
    ranks that hold the same tensor shard."""
    return make_sp_train_step(model, optimizer, mesh)
