"""In-step collective primitives over the default process group (the
``allreduce`` and ``adasum`` of ``horovod_tpu/spmd.py``, which run inside a
compiled step over the device mesh; the rest of that module --
``make_train_step``, the quantized rings, ZeRO -- comes later).

``adasum`` differs from the eager ``Executor.adasum`` in one rule, as its
reference does: the tree stays in f32 through every level and the result is
cast to the input dtype once, at the end.
"""

from __future__ import annotations

import torch

from . import basics
from .basics import Adasum, Average
from .ops import cuda_kernels as ck
from .runtime.executor import _collective


def allreduce(x: torch.Tensor, op: int = Average) -> torch.Tensor:
    """Sum (``op=Sum``), average (``op=Average``, integer tensors floor-
    divide) or Adasum-combine ``x`` across all ranks."""
    if op == Adasum:
        return adasum(x)
    st = basics._require_init()
    s = (x.clone() if st.size == 1
         else _collective("all_reduce", x, st.backend, st.size))
    if op == Average:
        s = s / st.size if s.dtype.is_floating_point else s // st.size
    return s


def adasum_tree(rows: torch.Tensor) -> torch.Tensor:
    """``[n, k]`` rows, ``n`` a power of 2 -> the ``[k]`` f32 root of the
    pairwise Adasum tree: level by level, pairs ``(2i, 2i+1)`` combine in
    one ``adasum_combine_pairs`` launch, in f32 throughout."""
    n = rows.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"Adasum requires a power-of-2 replica count; got {n}")
    buf = rows.float()
    while buf.shape[0] > 1:
        buf = ck.adasum_combine_pairs(buf[0::2], buf[1::2])
    return buf[0]


def adasum(x: torch.Tensor) -> torch.Tensor:
    """Adasum combine of ``x`` across all ranks: all-gather, then the local
    f32 tree (:func:`adasum_tree`), cast once to ``x``'s dtype."""
    st = basics._require_init()
    rows = x.reshape(1, -1)
    if st.size > 1:
        rows = _collective("all_gather", rows, st.backend, st.size)
    return adasum_tree(rows).reshape(x.shape).to(x.dtype)
