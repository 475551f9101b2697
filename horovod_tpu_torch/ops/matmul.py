"""Fused matmul + reduce-scatter (counterpart of the "fused matmul +
reduce-scatter" section of ``horovod_tpu/ops/pallas_kernels.py``).

The tail-linear / LM-head pattern: ``x [R, Kl]`` and ``w [Kl, N]`` are this
rank's shards of a contraction-sharded product, so the full product is the
sum over the ranks of ``x_j @ w_j``, and each rank needs only its own row
chunk of that sum: a matmul feeding a reduce-scatter. The fused form splits
the local product into per-chunk partial products (kernel K10,
``cuda_kernels.matmul_2d``, where the chunk tiles) and rotates an
accumulator around the ring. Each hop's transfer is posted before the chunk
product beside it is launched and waited for only before the add, so the
wire and the product can overlap.

Forward only: the TPU kernel has no VJP, so neither function may be
differentiated through (both raise when asked to record a gradient).
"""

from __future__ import annotations

import torch

from .. import basics
from ..parallel._comm import axis
from ..runtime.executor import _collective, start_ppermute
from . import cuda_kernels as ck


def _forward_only(x, w, what: str) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            f"{what} is forward only (the TPU kernel has no VJP); call it "
            "under torch.no_grad() or on tensors that need no gradient")


def _mm_chunk(xs, w):
    """One chunk's partial product: K10 where ``matmul_tiles`` takes the
    shape, ``torch.matmul`` (the same contraction) where it does not, as the
    reference's ``_mm_chunk`` chooses between ``matmul_2d`` and ``jnp.dot``."""
    mdim, kdim = xs.shape
    if ck.matmul_tiles(mdim, kdim, w.shape[1]) is not None:
        return ck.matmul_2d(xs, w)
    return torch.matmul(xs, w)


def matmul_reduce_scatter_reference(x, w, group=None):
    """Unfused: the full local product ``x @ w``, then a tiled
    reduce-scatter of it over ``group`` (a process group; None: every
    rank). Returns this rank's ``[R/m, N]`` row chunk of the sum."""
    _forward_only(x, w, "matmul_reduce_scatter_reference")
    m, _ = axis(group)
    y = torch.matmul(x, w)
    if m == 1:
        return y
    return _collective("reduce_scatter", y, basics.backend(), m, group=group)


def matmul_reduce_scatter(x, w, group=None):
    """``reduce_scatter(x @ w)`` over ``group`` as a compute/permute ring.

    ``x [R, Kl]`` and ``w [Kl, N]`` are this rank's contraction shards;
    returns its ``[R/m, N]`` row chunk of the cross-rank sum, in the
    product's dtype. Rank p seeds the accumulator with its partial of chunk
    (p - 1) mod m; hop k (1 <= k < m) adds the partial of chunk
    (p - k - 1) mod m to the accumulator received from rank p - 1 (and
    sends its own to p + 1), so after m - 1 hops rank p holds chunk p
    summed over every rank. The adds are in the product's dtype (bf16 adds
    for bf16), as in the reference. Takes the unfused reference only where
    the reference does: one rank, or R not a multiple of m. The result
    differs from the reference's by the order of the additions, as any
    ring reduce-scatter does."""
    _forward_only(x, w, "matmul_reduce_scatter")
    m, p = axis(group)
    rows = x.shape[0]
    if m == 1 or rows % m:
        return matmul_reduce_scatter_reference(x, w, group)
    c = rows // m
    backend = basics.backend()

    def partial_chunk(k):
        idx = (p - k - 1) % m
        return _mm_chunk(x[idx * c:(idx + 1) * c], w)

    acc = partial_chunk(0)
    for k in range(1, m):
        wait = start_ppermute(acc, backend, group)  # to p + 1, from p - 1
        part = partial_chunk(k)
        acc = wait() + part
    return acc
