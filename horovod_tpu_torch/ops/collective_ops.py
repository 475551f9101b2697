"""Eager named collectives through the engine: allreduce, allgather,
broadcast, alltoall and their async and in-place forms, ``poll``,
``synchronize`` and ``join`` (the torch-native port of
``horovod_tpu/ops/collective_ops.py`` and of the torch front end,
``horovod_tpu/torch/__init__.py``).

Every collective names its tensor (``<op>.noname.<n>`` when the caller
gives no name: ranks that make the same calls in the same order name them
alike) and is enqueued to the engine (``runtime/engine.py``); an async form
returns a handle for ``poll`` / ``synchronize``, and the synchronous form is
``synchronize(<op>_async(...))``. The ranks' requests are checked against
each other before any data moves, and a mismatch raises
``HorovodInternalError`` with the reference's message on every rank.

Tensors stay on their device. At world size 1 every collective is the
identity (a copy), with only an allreduce's scale factors applied.

``allreduce``, ``allgather``, ``broadcast`` and ``alltoall`` are
differentiable, with the reference's gradients: the same reduction of the
incoming gradient (a sum for Adasum), a sum-allreduce then this rank's rows,
a sum-allreduce kept on the root and zero elsewhere, and the exchange run
backwards.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import basics
from ..basics import Adasum, Average, Sum
from ..exceptions import HorovodError
from ..runtime.messages import AlltoallvResult, RequestType, TensorTableEntry
from .compression import Compression


def _enqueue(request_type: RequestType, tensor: torch.Tensor, name: str, *,
             root_rank: int = -1, average: bool = False,
             prescale: float = 1.0, postscale: float = 1.0, callback=None,
             splits=None, wire: str = "", fusable: bool = True, parts=None,
             inplace: Optional[torch.Tensor] = None) -> int:
    entry = TensorTableEntry(
        tensor_name=name, rank=basics.rank(), request_type=request_type,
        array=tensor.detach(), root_rank=root_rank, average=average,
        prescale_factor=prescale, postscale_factor=postscale,
        callback=callback, splits=splits, compression=wire, fusable=fusable,
        parts=parts)
    return basics._engine().enqueue(entry, inplace=inplace)


def _auto_name(prefix: str, name: Optional[str]) -> str:
    return basics._engine().auto_name(prefix, name)


def enqueue_together():
    """A context manager: the collectives enqueued inside reach the engine
    in one tick, and a run of Adasum requests among them is combined in
    one launch a tree level. Every rank must enqueue the same requests
    inside it."""
    return basics._engine().batch()


def _inplace_callback(tensor: torch.Tensor):
    """Completion callback writing the result into ``tensor`` (on the
    engine's stream on the card)."""
    def cb(ok, result):
        if ok:
            with torch.no_grad():
                tensor.copy_(result)
    return cb


def _check_op(op: int, prescale_factor: float,
              postscale_factor: float) -> None:
    if op == Adasum:
        if prescale_factor != 1.0 or postscale_factor != 1.0:
            raise ValueError(
                "prescale_factor/postscale_factor are not supported with "
                "op=Adasum (the combine rule is scale-invariant).")
    elif op not in (Average, Sum):
        raise ValueError(f"unknown reduce op {op!r}")


def _check_gather(tensor: torch.Tensor) -> None:
    if tensor.dim() == 0:
        raise ValueError(
            "hvd.allgather requires a tensor with at least one dimension (got "
            "a 0-dim scalar); reshape with tensor.reshape(1) first")


# ----------------------------------------------------------------- allreduce
def _allreduce(tensor, name, op, prescale_factor, postscale_factor,
               callback, compression, fusable=True, parts=None,
               inplace=None) -> int:
    _check_op(op, prescale_factor, postscale_factor)
    name = _auto_name("allreduce", name)
    if op == Adasum:
        return _enqueue(RequestType.ADASUM, tensor, name, callback=callback,
                        fusable=fusable, parts=parts, inplace=inplace)
    # the adaptive wire enqueues this name's current decision,
    # "adaptive:<mode>", for negotiation to arbitrate
    wire_for = getattr(compression, "wire_for", None)
    wire = wire_for(name) if wire_for is not None else compression.wire or ""
    return _enqueue(RequestType.ALLREDUCE, tensor, name,
                    average=(op == Average), prescale=prescale_factor,
                    postscale=postscale_factor, callback=callback,
                    wire=wire, fusable=fusable, inplace=inplace)


def allreduce_async(tensor: torch.Tensor, name: Optional[str] = None,
                    op: int = Average, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0, callback=None,
                    compression=Compression.none, fusable: bool = True,
                    parts=None) -> int:
    """Asynchronous allreduce; returns a handle. ``callback(ok,
    result_or_error)`` runs on the engine thread at completion, before
    ``synchronize`` returns. ``compression`` is the wire: int8, int8-dcn,
    int4 and adaptive run inside the executor (Sum and Average; Adasum
    rides the exact wire); a cast compressor belongs on :func:`allreduce`,
    which owns the decompress side. ``fusable=False`` marks a client-built
    bucket that the controller must not merge with others; ``parts``
    (Adasum) are its members' element counts, each combined with its own
    coefficients."""
    return _allreduce(tensor, name, op, prescale_factor, postscale_factor,
                      callback, compression, fusable, parts)


def allreduce_async_(tensor: torch.Tensor, name: Optional[str] = None,
                     op: int = Average, prescale_factor: float = 1.0,
                     postscale_factor: float = 1.0,
                     compression=Compression.none) -> int:
    """In-place async allreduce: the completion callback writes the result
    into ``tensor`` before the handle completes, and ``synchronize``
    returns ``tensor``."""
    return _allreduce(tensor, name, op, prescale_factor, postscale_factor,
                      _inplace_callback(tensor), compression,
                      inplace=tensor)


def allreduce_(tensor: torch.Tensor, name: Optional[str] = None,
               op: int = Average, prescale_factor: float = 1.0,
               postscale_factor: float = 1.0,
               compression=Compression.none) -> torch.Tensor:
    """In-place allreduce; returns ``tensor``."""
    return synchronize(allreduce_async_(
        tensor, name=name, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, compression=compression))


class _Allreduce(torch.autograd.Function):
    """The adjoint of a sum or average over ranks is the same reduction of
    the incoming gradient, scale factors included (each rank's output
    feeds every rank's loss); Adasum takes the reference's sum-allreduce."""

    @staticmethod
    def forward(ctx, x, op, name, compression, prescale, postscale):
        ctx.op = op if op in (Sum, Average) else Sum
        ctx.scales = (prescale, postscale) if op != Adasum else (1.0, 1.0)
        return synchronize(allreduce_async(
            x, name=name, op=op, prescale_factor=prescale,
            postscale_factor=postscale, compression=compression))

    @staticmethod
    def backward(ctx, dy):
        return (allreduce(dy, op=ctx.op, prescale_factor=ctx.scales[0],
                          postscale_factor=ctx.scales[1]),
                None, None, None, None, None)


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
    whose rule is scale-invariant, refuses them. Differentiable (see the
    module's docstring); the casts of a compressor are torch operations, so
    the gradient flows through them too."""
    _check_op(op, prescale_factor, postscale_factor)
    comp, ctx = compression.compress(tensor)
    out = _Allreduce.apply(comp, op, name, compression, prescale_factor,
                           postscale_factor)
    return compression.decompress(out, ctx)


# ----------------------------------------------------------------- broadcast
def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: Optional[str] = None, callback=None) -> int:
    return _enqueue(RequestType.BROADCAST, tensor,
                    _auto_name("broadcast", name), root_rank=root_rank,
                    callback=callback)


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> int:
    """In-place async broadcast; ``synchronize`` returns ``tensor``."""
    return _enqueue(RequestType.BROADCAST, tensor,
                    _auto_name("broadcast", name), root_rank=root_rank,
                    callback=_inplace_callback(tensor), inplace=tensor)


def broadcast_(tensor: torch.Tensor, root_rank: int,
               name: Optional[str] = None) -> torch.Tensor:
    """In-place broadcast; returns ``tensor``."""
    return synchronize(broadcast_async_(tensor, root_rank, name=name))


class _Broadcast(torch.autograd.Function):
    """Every rank's output is the root's input, so the root's gradient is
    the sum of every rank's incoming gradient, and the others' zero."""

    @staticmethod
    def forward(ctx, x, root, name):
        ctx.root = root
        return synchronize(broadcast_async(x, root, name=name))

    @staticmethod
    def backward(ctx, dy):
        g = allreduce(dy, op=Sum)
        if basics.rank() != ctx.root:
            g = torch.zeros_like(g)
        return g, None, None


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              name: Optional[str] = None) -> torch.Tensor:
    """``tensor`` from ``root_rank`` on every rank (a new tensor);
    differentiable."""
    return _Broadcast.apply(tensor, root_rank, name)


# ----------------------------------------------------------------- allgather
def allgather_async(tensor: torch.Tensor, name: Optional[str] = None) -> int:
    _check_gather(tensor)
    return _enqueue(RequestType.ALLGATHER, tensor,
                    _auto_name("allgather", name))


class _Allgather(torch.autograd.Function):
    """Rank-order concatenation of ragged dim-0 blocks; the adjoint is a
    sum-allreduce of the incoming gradient, then this rank's rows, at the
    offset given by an allgather of every rank's dim 0."""

    @staticmethod
    def forward(ctx, x, name):
        ctx.dim0 = x.shape[0]
        return synchronize(allgather_async(x, name=name))

    @staticmethod
    def backward(ctx, dy):
        g = allreduce(dy, op=Sum)
        dims = allgather(torch.tensor([ctx.dim0], dtype=torch.int64,
                                      device=dy.device))
        offset = int(dims[:basics.rank()].sum())
        return g.narrow(0, offset, ctx.dim0), None


def allgather(tensor: torch.Tensor, name: Optional[str] = None) -> torch.Tensor:
    """Concatenation along dim 0 of every rank's ``tensor``, in rank order;
    the first dimension may differ between ranks, the others may not.
    Differentiable."""
    _check_gather(tensor)
    return _Allgather.apply(tensor, name)


# ------------------------------------------------------------------ alltoall
def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: Optional[str] = None) -> int:
    """Without ``splits``: dim 0 splits into ``size()`` equal blocks and
    block r goes to rank r. With ``splits`` (one non-negative count a rank,
    summing to dim 0): rank r gets ``splits[r]`` rows; the output
    concatenates what every rank sent, in source order."""
    if splits is not None:
        splits = tuple(int(s) for s in splits)
        world = basics.size()
        if len(splits) != world:
            raise ValueError(
                f"alltoall splits must have one entry per rank "
                f"({world}); got {len(splits)}")
        if any(s < 0 for s in splits):
            raise ValueError("alltoall splits must be non-negative")
        d0 = tensor.shape[0] if tensor.dim() else 0
        if sum(splits) != d0:
            raise ValueError(
                f"alltoall splits sum to {sum(splits)} but tensor dim 0 "
                f"is {d0}")
    return _enqueue(RequestType.ALLTOALL, tensor,
                    _auto_name("alltoall", name), splits=splits)


class _Alltoall(torch.autograd.Function):
    """The equal exchange is a permutation of blocks, its own adjoint; the
    ragged form's adjoint exchanges the gradient with the forward's
    received counts as its splits."""

    @staticmethod
    def forward(ctx, x, splits, name):
        res = synchronize(alltoall_async(x, splits=splits, name=name))
        if isinstance(res, AlltoallvResult):
            ctx.recv = res.received_splits
            rs = torch.tensor(ctx.recv, dtype=torch.int32)
            ctx.mark_non_differentiable(rs)
            return res.output, rs
        ctx.recv = None
        return res

    @staticmethod
    def backward(ctx, dy, *unused):
        if ctx.recv is not None:
            return alltoall(dy, splits=ctx.recv)[0], None, None
        return alltoall(dy), None, None


def alltoall(tensor: torch.Tensor, splits=None, name: Optional[str] = None):
    """Without ``splits``: the exchanged tensor. With ``splits``: ``(output,
    received_splits)``, ``received_splits[src]`` the rows that came from
    rank ``src`` (int32). Differentiable."""
    if splits is not None:
        splits = tuple(int(s) for s in splits)
    return _Alltoall.apply(tensor, splits, name)


# ------------------------------------------------------------- join / handles
def join() -> int:
    """Signal that this rank is out of data; blocks until every rank has
    joined and returns the last rank to join. Multiprocess mode needs the
    cross-process control plane for it, which is not ported."""
    st = basics._require_init()
    if st.mode == "multiprocess" and st.size > 1:
        raise NotImplementedError(
            "join() in multiprocess mode requires the cross-process control "
            "plane (launch via hvdrun / horovod_tpu.run so ranks share a "
            "coordinator address channel).")
    eng = basics._engine()
    return eng.synchronize(eng.join(st.rank))


def poll(handle: int) -> bool:
    """True once the collective of ``handle`` has completed."""
    return basics._engine().poll(handle)


def synchronize(handle: int):
    """Block until the collective of ``handle`` completes and return its
    result (an in-place form returns its tensor); raises
    ``HorovodInternalError`` on a negotiation or execution failure."""
    return basics._engine().synchronize(handle)


def synchronize_all(handles) -> list:
    """:func:`synchronize` of every handle, in order; the first error is
    raised once all have completed, so none is left pending."""
    results, error = [], None
    for h in handles:
        try:
            results.append(synchronize(h))
        except HorovodError as exc:
            results.append(None)
            error = error or exc
    if error is not None:
        raise error
    return results
