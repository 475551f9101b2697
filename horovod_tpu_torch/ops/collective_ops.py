"""Synchronous collectives over ``torch.distributed`` (the synchronous subset
of ``horovod_tpu/ops/collective_ops.py``; the async engine with fusion and
handles comes later).

Tensors stay on their device. At world size 1 every collective is the
identity (a copy).

Before a collective runs, the ranks compare what they submitted: one small
all-gather of each call's signature (kind, name, shape, dtype, op and scale
factors, wire, root), and a mismatch raises ``HorovodInternalError`` with
the reference's message on every rank, before any data moves. This stands
in for the engine's negotiation until that is ported; a caller that issues
many collectives in a row (``DistributedOptimizer``) checks them all in one
gather with :func:`check_signatures` and runs the unchecked forms.

``allreduce``, ``allgather`` and ``broadcast`` are differentiable, with the
reference's gradients (``horovod_tpu/torch/__init__.py``): the same
reduction of the incoming gradient (a sum for Adasum), a sum-allreduce then
this rank's rows, and a sum-allreduce kept on the root and zero elsewhere.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import basics
from ..basics import Adasum, Average, Sum
from ..exceptions import HorovodInternalError
from ..runtime.executor import _collective
from .compression import Compression

_KINDS = {Average: "allreduce", Sum: "allreduce", Adasum: "adasum"}


def signature(kind: str, tensor: torch.Tensor, name: Optional[str] = None,
              op: Optional[int] = None, scales=(1.0, 1.0),
              wire: Optional[str] = None, root: Optional[int] = None):
    """What the ranks must agree on for one collective."""
    return (kind, name, tuple(tensor.shape), str(tensor.dtype), op,
            tuple(scales), wire, root)


def _mismatch(per_rank: List[list]) -> Optional[str]:
    """The reference's error for the first collective the ranks disagree
    on (``runtime/pycontroller.py:_validate``), with every rank's value;
    None when they agree."""
    counts = [len(s) for s in per_rank]
    if len(set(counts)) > 1:
        return ("Mismatched number of collectives submitted together: "
                + ", ".join(f"rank {r} {n}" for r, n in enumerate(counts)))
    for sigs in zip(*per_rank):
        kind, name, shape, dtype, op, scales, wire, root = sigs[0]
        label = name if name is not None else "<unnamed>"

        def differ(field, shown=None):
            values = [shown(s) if shown else s[field] for s in sigs]
            if len(set(values)) == 1:
                return ""
            return ": " + ", ".join(f"rank {r} {v}"
                                    for r, v in enumerate(values))

        checks = (
            (0, None, f"Mismatched collective operations for tensor "
                      f"'{label}'"),
            (1, None, "Mismatched tensor names"),
            (3, None, f"Mismatched data types for tensor '{label}'"),
            (None, lambda s: (s[4], s[5]), f"Mismatched reduction op/scale "
                                           f"factors for tensor '{label}'"),
            (6, None, f"Mismatched compression for tensor '{label}': set "
                      "HOROVOD_COMPRESSION identically on every rank"),
            (None, (lambda s: s[2][1:]) if kind == "allgather"
             else (lambda s: s[2]),
             f"Mismatched allgather tensor shapes beyond first dimension for "
             f"'{label}'" if kind == "allgather"
             else f"Mismatched tensor shapes for '{label}'"),
            (7, None, f"Mismatched root ranks for broadcast '{label}'"))
        for field, shown, message in checks:
            detail = differ(field, shown)
            if detail:
                return message + detail
    return None


def check_signatures(sigs: Sequence[tuple]) -> List[list]:
    """All-gather this rank's ``sigs`` (see :func:`signature`) and raise
    ``HorovodInternalError`` on every rank if the ranks disagree; returns
    every rank's list. At world size 1 nothing is exchanged."""
    st = basics._require_init()
    if st.size == 1:
        return [list(sigs)]
    per_rank: List[list] = [None] * st.size
    dist.all_gather_object(per_rank, list(sigs))
    err = _mismatch(per_rank)
    if err:
        raise HorovodInternalError(err)
    return per_rank


def _check_op(op: int, prescale_factor: float,
              postscale_factor: float) -> None:
    if op == Adasum:
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "prescale_factor/postscale_factor are not supported with "
                "op=Adasum (the combine rule is scale-invariant).")
    elif op not in (Average, Sum):
        raise ValueError(f"unknown reduce op {op!r}")


def allreduce_unchecked(tensor: torch.Tensor, op: int = Average,
                        wire: Optional[str] = None, prescale: float = 1.0,
                        postscale: float = 1.0) -> torch.Tensor:
    """The reduction of the wire tensor itself, with no signature check and
    no gradient (the caller checked; see :func:`check_signatures`)."""
    if op == Adasum:
        return basics._executor().adasum(tensor)
    return basics._executor().allreduce(tensor, average=(op == Average),
                                        wire=wire, prescale=prescale,
                                        postscale=postscale)


class _Allreduce(torch.autograd.Function):
    """The adjoint of a sum or average over ranks is the same reduction of
    the incoming gradient, scale factors included (each rank's output
    feeds every rank's loss); Adasum takes the reference's sum-allreduce."""

    @staticmethod
    def forward(ctx, x, op, wire, prescale, postscale):
        ctx.op = op if op in (Sum, Average) else Sum
        ctx.scales = (prescale, postscale) if op != Adasum else (1.0, 1.0)
        return allreduce_unchecked(x, op, wire, prescale, postscale)

    @staticmethod
    def backward(ctx, dy):
        return (allreduce(dy, op=ctx.op, prescale_factor=ctx.scales[0],
                          postscale_factor=ctx.scales[1]),
                None, None, None, None)


def allreduce(tensor: torch.Tensor, op: int = Average,
              name: Optional[str] = None,
              compression=Compression.none, prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Sum (``op=Sum``), average (``op=Average``) or Adasum-combine
    (``op=Adasum``, a power-of-2 world) ``tensor`` over all ranks.

    ``compression``: a cast compressor (fp16/bf16) changes the wire dtype,
    and under Adasum the cast tensor is what gets combined; int8 / int4
    quantize inside the executor for Sum and Average, and Adasum bypasses
    them (exact wire). ``prescale_factor`` / ``postscale_factor`` scale
    each contribution before and the result after a Sum or Average; Adasum,
    whose rule is scale-invariant, refuses them. ``name`` labels the tensor
    in the cross-rank check. Differentiable (see the module's docstring);
    the casts of a compressor are torch operations, so the gradient flows
    through them too."""
    _check_op(op, prescale_factor, postscale_factor)
    comp, ctx = compression.compress(tensor)
    wire = None if op == Adasum else compression.wire
    check_signatures([signature(_KINDS[op], comp, name, op,
                                (prescale_factor, postscale_factor), wire)])
    out = _Allreduce.apply(comp, op, wire, prescale_factor, postscale_factor)
    return compression.decompress(out, ctx)


class _Broadcast(torch.autograd.Function):
    """Every rank's output is the root's input, so the root's gradient is
    the sum of every rank's incoming gradient, and the others' zero."""

    @staticmethod
    def forward(ctx, x, root):
        st = basics._require_init()
        ctx.root = root
        return _collective("broadcast", x.detach(), st.backend, st.size,
                           root=root)

    @staticmethod
    def backward(ctx, dy):
        g = allreduce(dy, op=Sum)
        if basics.rank() != ctx.root:
            g = torch.zeros_like(g)
        return g, None


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """``tensor`` from ``root_rank`` on every rank (a new tensor);
    differentiable."""
    st = basics._require_init()
    if not 0 <= root_rank < st.size:
        raise ValueError(f"broadcast: root_rank {root_rank} outside world "
                         f"size {st.size}")
    if st.size == 1:
        return tensor.clone()
    check_signatures([signature("broadcast", tensor, name, root=root_rank)])
    return _Broadcast.apply(tensor, root_rank)


def broadcast_unchecked(tensor: torch.Tensor,
                        root_rank: int = 0) -> torch.Tensor:
    """:func:`broadcast` with no signature check and no gradient."""
    st = basics._require_init()
    if st.size == 1:
        return tensor.clone()
    return _collective("broadcast", tensor.detach(), st.backend, st.size,
                       root=root_rank)


class _Allgather(torch.autograd.Function):
    """Rank-order concatenation of ragged dim-0 blocks; the adjoint is a
    sum-allreduce of the incoming gradient, then this rank's rows."""

    @staticmethod
    def forward(ctx, x, sizes):
        st = basics._require_init()
        top = max(sizes)
        padded = x.detach()
        if x.shape[0] < top:  # every rank sends the same number of rows
            padded = torch.cat([padded, padded.new_zeros(
                (top - x.shape[0],) + tuple(x.shape[1:]))])
        parts = _collective("all_gather", padded, st.backend, st.size)
        ctx.rows = (sum(sizes[:st.rank]), x.shape[0])
        return torch.cat([parts[r * top:r * top + n]
                          for r, n in enumerate(sizes)])

    @staticmethod
    def backward(ctx, dy):
        return allreduce(dy, op=Sum).narrow(0, *ctx.rows), None


def allgather(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """Concatenation along dim 0 of every rank's ``tensor``, in rank order;
    the first dimension may differ between ranks, the others may not.
    Differentiable."""
    if tensor.dim() == 0:
        raise ValueError(
            "hvd.allgather requires a tensor with at least one dimension (got "
            "a 0-dim scalar); reshape with tensor.reshape(1) first")
    st = basics._require_init()
    if st.size == 1:
        return tensor.clone()
    per_rank = check_signatures([signature("allgather", tensor, name)])
    sizes = [sigs[0][2][0] for sigs in per_rank]
    return _Allgather.apply(tensor, sizes)
