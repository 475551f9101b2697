"""Tensor (model) parallelism for the transformer LM, Megatron-style
(counterpart of ``horovod_tpu/parallel/tensor.py``).

The reference gives its parameters ``PartitionSpec``s over a ``("dp",
"tp")`` mesh and lets GSPMD insert the collectives. PyTorch has no GSPMD, so
the collectives it inserts are written here:

* qkv and mlp_in are column-parallel: a rank holds a slice of the output
  features, and ``copy_to_tp`` at the input sums the input's gradient over
  tp in the backward;
* proj and mlp_out are row-parallel: a rank holds a slice of the input
  features, ``reduce_from_tp`` sums the partial outputs over tp, and the
  bias is added once, after the sum;
* LayerNorms, embeddings, positions and the tied head are replicated; the
  two operators keep their inputs, and so their gradients, equal on every
  tp rank;
* gradients are averaged over the dp group only: a rank's tensor shard is
  held by the ranks of its dp group and by no other.

Attention runs on a rank's own heads: the qkv columns are head-major ``[h]
[3][hd]``, so a contiguous column slice is whole heads. The torch ``Dense``
weight is ``[out, in]``, the transpose of Flax's kernel, so the reference's
``P(None, "tp")`` on a kernel splits the torch weight's dim 0 and ``P("tp",
None)`` its dim 1.

The grid: rank ``r`` sits at ``(dp, tp) = divmod(r, tp)``::

    mesh = make_dp_tp_mesh(dp=2, tp=2)               # at world size 4
    model = TransformerLM(...)                       # the full model, seeded
    shard_params_tp(model, mesh).to(device)          # this rank's slices
    step = make_tp_train_step(model, torch.optim.SGD(...), mesh)
    loss = step(tokens, targets)      # the GLOBAL [B, T] batch on every rank
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F

from ._comm import copy_to_tp, gather_blocks, reduce_from_tp
from .ring_attention import reference_attention
from .sp_training import grid, make_sp_train_step

#: Causal attention in plain torch (an f32 softmax), the reference's
#: ``plain_attention``; the port's default attention (K5/K7) also runs on a
#: rank's heads.
plain_attention = partial(reference_attention, causal=True)

_COLUMN = ("qkv", "mlp_in")
_ROW = ("proj", "mlp_out")


@dataclass(frozen=True)
class DpTpMesh:
    """This rank's place on the (dp, tp) grid and the groups of its two
    axes (None at world size 1). Its sequence axis has one rank."""
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: Any
    tp_group: Any
    sp = 1
    sp_rank = 0
    sp_group = None

    @property
    def grad_group(self):
        """The ranks that hold this rank's tensor shard: its dp group."""
        return self.dp_group


def make_2d_mesh(sizes: tuple) -> DpTpMesh:
    """The (dp, tp) grid of ``sizes`` over every rank, row-major. Raises
    ``ValueError`` unless the grid spans the world."""
    (dp_rank, tp_rank), (dp_group, tp_group) = grid(tuple(sizes),
                                                    [(0,), (1,)])
    return DpTpMesh(sizes[0], sizes[1], dp_rank, tp_rank, dp_group, tp_group)


def make_dp_tp_mesh(dp: int, tp: int) -> DpTpMesh:
    return make_2d_mesh((dp, tp))


def tp_param_spec(path_keys, leaf=None) -> tuple:
    """The reference's spec of one parameter of the Flax tree, by its path
    (``["block_0", "qkv", "kernel"]``), as a tuple: ``(None, "tp")`` for a
    column-parallel kernel, ``("tp",)`` for its bias, ``("tp", None)`` for a
    row-parallel kernel, ``()`` (replicated) for everything else, the
    row-parallel bias included (it is added after the sum)."""
    names = [str(k) for k in path_keys]
    owner = next((n for n in _COLUMN + _ROW if n in names), None)
    is_kernel = names[-1] == "kernel"
    if owner in _COLUMN:
        return (None, "tp") if is_kernel else ("tp",)
    if owner in _ROW:
        return ("tp", None) if is_kernel else ()
    return ()


def _flax_path(name: str) -> list:
    """A torch parameter name -> its path in the Flax tree
    (``blocks.0.qkv.weight`` -> ``[block_0, qkv, kernel]``)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"block_{parts[1]}"] + parts[2:]
    if parts[-1] == "weight":
        owner = parts[-2] if len(parts) > 1 else ""
        parts[-1] = ("scale" if owner.startswith("ln")
                     else "embedding" if owner == "tok_emb" else "kernel")
    return parts


def torch_param_spec(name: str) -> tuple:
    """:func:`tp_param_spec` of a torch parameter, in the torch layout (a
    Dense weight's spec reversed: it is the kernel's transpose)."""
    path = _flax_path(name)
    spec = tp_param_spec(path)
    return spec[::-1] if path[-1] == "kernel" else spec


def tp_param_shardings(params, mesh) -> dict:
    """``{name: torch-layout spec}`` for every parameter of ``params`` (an
    ``nn.Module`` or a ``state_dict``); raises ``ValueError`` when a sharded
    dim does not divide by ``mesh.tp``."""
    named = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    out = {}
    for name, t in named:
        spec = torch_param_spec(name)
        for dim, ax in enumerate(spec):
            if ax == "tp" and t.shape[dim] % mesh.tp:
                raise ValueError(f"parameter {name} dim {dim} "
                                 f"({t.shape[dim]}) not divisible by "
                                 f"tp={mesh.tp}")
        out[name] = spec
    return out


def shard_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of the full ``t`` under ``spec`` (a copy)."""
    for dim, ax in enumerate(spec):
        if ax == "tp":
            n = t.shape[dim] // mesh.tp
            return t.narrow(dim, mesh.tp_rank * n, n).clone()
    return t.clone()


class ColumnParallelDense(nn.Module):
    """This rank's output-feature slice of a ``Dense`` (weight ``[out/tp,
    in]``, bias ``[out/tp]``); the replicated input passes ``copy_to_tp``."""

    def __init__(self, dense, mesh):
        super().__init__()
        spec = (("tp", None), ("tp",))
        self.weight, self.bias = (
            nn.Parameter(shard_tensor(p.detach(), s, mesh))
            for p, s in zip((dense.weight, dense.bias), spec))
        self.dtype, self.group = dense.dtype, mesh.tp_group

    def forward(self, x):
        x = copy_to_tp(x, self.group)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class RowParallelDense(nn.Module):
    """This rank's input-feature slice of a ``Dense`` (weight ``[out,
    in/tp]``; the bias whole): the partial products are summed over tp by
    ``reduce_from_tp``, then the bias is added once."""

    def __init__(self, dense, mesh):
        super().__init__()
        self.weight = nn.Parameter(shard_tensor(dense.weight.detach(),
                                                (None, "tp"), mesh))
        self.bias = nn.Parameter(dense.bias.detach().clone())
        self.dtype, self.group = dense.dtype, mesh.tp_group

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return reduce_from_tp(y, self.group) + self.bias.to(self.dtype)


def shard_params_tp(model, mesh):
    """Replace, in place, each block's qkv and mlp_in with
    ``ColumnParallelDense`` and its proj and mlp_out with
    ``RowParallelDense``, each holding this rank's slice of the model's
    current (full) weights; returns ``model``. The parameter names stay, so
    ``shard_state_dict_tp`` of a full ``state_dict`` loads into it. At
    ``tp == 1`` the model is left as it is. Raises ``ValueError`` when a
    sharded dim, or the head count, does not divide by ``mesh.tp``."""
    tp_param_shardings(model, mesh)
    if mesh.tp == 1:
        return model
    for block in model.blocks:
        if block.num_heads % mesh.tp:
            raise ValueError(f"num_heads {block.num_heads} not divisible "
                             f"by tp={mesh.tp}")
        for name in _COLUMN:
            setattr(block, name, ColumnParallelDense(getattr(block, name),
                                                     mesh))
        for name in _ROW:
            setattr(block, name, RowParallelDense(getattr(block, name), mesh))
    return model



def shard_state_dict_tp(state_dict: dict, mesh) -> dict:
    """This rank's tensor-parallel slices of a full transformer
    ``state_dict`` (e.g. ``models.convert.transformer_state_dict_from_flax``
    of the reference's parameters), by :func:`torch_param_spec`; the result
    loads into a model after ``shard_params_tp``. Raises ``ValueError`` when
    a sharded dim does not divide by ``mesh.tp``."""
    specs = tp_param_shardings(state_dict, mesh)
    return {k: shard_tensor(v, specs[k], mesh) for k, v in state_dict.items()}

def make_tp_train_step(model, optimizer, mesh):
    """``step(tokens, targets) -> loss`` on the GLOBAL ``[B, T]`` batch, the
    same on every rank: this rank's dp rows, the model (its tensor shards
    and the row-parallel sums inside), the gradients averaged over the dp
    group, ``optimizer`` stepped; returns the loss averaged over dp. The
    step body is ``make_sp_train_step``'s, on a grid whose sequence axis
    has one rank."""
    return make_sp_train_step(model, optimizer, mesh)


def shard_batch_dp(batch, mesh):
    """This rank's dp rows of a global batch (a tensor, or a tuple or list
    of tensors with the batch first)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch_dp(b, mesh) for b in batch)
    b = batch.shape[0]
    if b % mesh.dp:
        raise ValueError(f"global batch {b} does not split over "
                         f"dp={mesh.dp}")
    n = b // mesh.dp
    return batch[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]


def full_state_dict_tp(model, mesh, grads: bool = False) -> dict:
    """The full (unsharded) parameters, or with ``grads`` their gradients,
    gathered over the tp group into every rank: ``{name: tensor}``."""
    out = {}
    for name, p in model.named_parameters():
        t = (p.grad if grads else p).detach()
        dim = next((d for d, ax in enumerate(torch_param_spec(name))
                    if ax == "tp"), None)
        out[name] = (t.clone() if dim is None or mesh.tp == 1
                     else gather_blocks(t.contiguous(), mesh.tp_group, dim))
    return out
