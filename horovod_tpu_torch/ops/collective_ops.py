"""Synchronous collectives over ``torch.distributed`` (the synchronous subset
of ``horovod_tpu/ops/collective_ops.py``; the async engine with fusion and
handles comes later).

Tensors stay on their device. At world size 1 every collective is the
identity (a copy).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import basics
from ..basics import Adasum, Average, Sum
from ..runtime.executor import _collective
from .compression import Compression


def allreduce(tensor: torch.Tensor, op: int = Average,
              name: Optional[str] = None,
              compression=Compression.none) -> torch.Tensor:
    """Sum (``op=Sum``) or average (``op=Average``) ``tensor`` over all
    ranks. ``compression``: a cast compressor changes the wire dtype; int8 /
    int4 quantize inside the executor. ``name`` labels the tensor (kept for
    the reference's surface; this synchronous path needs no negotiation)."""
    if op not in (Average, Sum):
        if op == Adasum:
            raise NotImplementedError(
                "op=Adasum is not ported yet (next slice)")
        raise ValueError(f"unknown reduce op {op!r}")
    comp, ctx = compression.compress(tensor)
    out = basics._executor().allreduce(comp, average=(op == Average),
                                       wire=compression.wire)
    return compression.decompress(out, ctx)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """``tensor`` from ``root_rank`` on every rank (a new tensor)."""
    st = basics._require_init()
    if not 0 <= root_rank < st.size:
        raise ValueError(f"broadcast: root_rank {root_rank} outside world "
                         f"size {st.size}")
    if st.size == 1:
        return tensor.clone()
    return _collective("broadcast", tensor.detach(), st.backend, st.size,
                       root=root_rank)


def allgather(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """Concatenation along dim 0 of every rank's ``tensor`` (equal shapes),
    in rank order."""
    st = basics._require_init()
    if st.size == 1:
        return tensor.clone()
    if tensor.dim() == 0:
        tensor = tensor.reshape(1)
    return _collective("all_gather", tensor.detach(), st.backend, st.size)
