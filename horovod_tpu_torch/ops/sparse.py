"""Sparse (indexed-slices) gradient collectives (a port of
``horovod_tpu/ops/sparse.py``).

An allreduce of an :class:`IndexedSlices` is two allgathers through the
engine, of the values and of the indices: the dense tensor it represents is
summed by concatenating every rank's rows (Average divides the gathered
values by the world size). Rows from different ranks may share an index;
:func:`to_dense` adds duplicates. Per-rank row counts may differ (the
allgather is ragged). Adasum is refused, as in the reference.

A torch sparse COO gradient (``nn.Embedding(sparse=True)``) converts with
:func:`from_sparse_coo`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import basics
from ..basics import Adasum, Average, Sum
from . import collective_ops as _ops


class IndexedSlices(NamedTuple):
    """A sparse update: ``dense[indices[i]] += values[i]`` row by row.
    ``values`` is ``[k, ...]``, ``indices`` ``[k]``, ``dense_shape`` the
    represented tensor's shape (None when only the rows matter)."""

    values: torch.Tensor
    indices: torch.Tensor
    dense_shape: Optional[tuple] = None


def from_sparse_coo(t: torch.Tensor) -> IndexedSlices:
    """A sparse COO tensor whose sparse dimension is the first (an
    embedding's gradient) as :class:`IndexedSlices`."""
    t = t.coalesce()
    return IndexedSlices(t.values(), t.indices()[0], tuple(t.shape))


def allreduce_sparse_async(slices: IndexedSlices,
                           name: Optional[str] = None):
    """Start the two allgathers; returns a pair of handles."""
    name = name or _ops._auto_name("sparse_allreduce", None)
    hv = _ops.allgather_async(slices.values, name=f"{name}.values")
    hi = _ops.allgather_async(slices.indices, name=f"{name}.indices")
    return hv, hi


def gathered(values: torch.Tensor, indices: torch.Tensor, op: int,
             dense_shape=None) -> IndexedSlices:
    """The allreduce's result from the gathered rows: values divided by the
    world size on Average (floor division for integers)."""
    if op == Average:
        n = basics.size()
        values = (values / torch.tensor(n, dtype=values.dtype)
                  if values.dtype.is_floating_point
                  else torch.div(values, n, rounding_mode="floor"))
    return IndexedSlices(values, indices, dense_shape)


def synchronize_sparse(handles, op: int = Average,
                       dense_shape=None) -> IndexedSlices:
    hv, hi = handles
    return gathered(_ops.synchronize(hv), _ops.synchronize(hi), op,
                    dense_shape)


def allreduce_sparse(slices: IndexedSlices, name: Optional[str] = None,
                     op: int = Average) -> IndexedSlices:
    """Allreduce of the dense tensor ``slices`` represents, as two
    allgathers."""
    if op == Adasum:
        raise NotImplementedError(
            "The Adasum reduction does not currently support sparse "
            "tensors. As a workaround please pass sparse_as_dense=True to "
            "DistributedOptimizer")
    if op not in (Average, Sum):
        raise ValueError(f"unsupported op for sparse allreduce: {op}")
    return synchronize_sparse(allreduce_sparse_async(slices, name), op=op,
                              dense_shape=slices.dense_shape)


def to_dense(slices: IndexedSlices) -> torch.Tensor:
    """The dense tensor, duplicate indices added (a scatter-add)."""
    if slices.dense_shape is None:
        raise ValueError("IndexedSlices has no dense_shape; cannot densify")
    values = torch.as_tensor(slices.values)
    out = values.new_zeros(tuple(slices.dense_shape))
    return out.index_add_(0, torch.as_tensor(slices.indices,
                                             device=values.device).long(),
                          values)


def densify_tree(tree):
    """``tree`` (a tensor, :class:`IndexedSlices`, or a list, tuple or dict
    of them) with every :class:`IndexedSlices` replaced by
    :func:`to_dense`."""
    if isinstance(tree, IndexedSlices):
        return to_dense(tree)
    if isinstance(tree, dict):
        return {k: densify_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(densify_tree(v) for v in tree)
    return tree
