"""Data-plane programs of the engine (subset of
``horovod_tpu/runtime/executor.py``): :meth:`Executor.execute` runs one
negotiated response -- the allreduce on the exact wire or the
block-quantized int8 / int4 wire (with its bypass rules and byte
accounting) over the response's tensors packed into one flat buffer, the
Adasum combine tree, the ragged allgather, broadcast and alltoall(v) --
over ``torch.distributed``.

The quantized allreduce is the reference's ``_allreduce_q_fn``: pad the f32
row to ``world`` chunks of whole blocks, quantize, all-to-all (the
reduce-scatter hop), dequantize and sum in f32 over ranks in rank order,
requantize, all-gather, dequantize, then divide by the world size for an
average. The send side runs the CUDA kernels (`ops/cuda_kernels.py`); the
receive side (unpack, dequantize, sum) is plain torch, as it is jnp in the
reference.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..exceptions import HorovodInternalError
from ..ops import compression as comp
from ..ops import cuda_kernels as ck
from .messages import AlltoallvResult, ResponseType


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` rounded to ``like``'s dtype, as a 0-d CPU tensor: a scale
    factor multiplies in the tensor's own dtype, as ``np.asarray(value,
    dtype)`` does in the reference."""
    return torch.tensor(value, dtype=like.dtype)


def group_ranks(group=None) -> list:
    """Global ranks of ``group`` (None: the whole world) in group-rank
    order; ``[0]`` when no process group exists (standalone)."""
    if not dist.is_initialized():
        return [0]
    return dist.get_process_group_ranks(
        dist.group.WORLD if group is None else group)


def _collective(kind: str, t: torch.Tensor, backend: Optional[str],
                world: int, root: int = 0, group=None,
                shift: int = 1) -> torch.Tensor:
    """The one place that issues a collective; returns a new tensor on
    ``t``'s device. ``kind`` is ``all_to_all`` (tiled along dim 0),
    ``all_gather`` (tiled along dim 0), ``all_reduce`` (sum),
    ``reduce_scatter`` (sum, tiled along dim 0: group rank i gets the i-th
    of ``world`` row chunks), ``broadcast`` (from global rank ``root``) or
    ``ppermute`` (send to the rank ``shift`` places on in the group, receive
    from the one ``shift`` places back: the ring's hop). ``world`` is the
    size of ``group`` (None: every rank). Under gloo a CUDA tensor is
    staged through host memory here: gloo's all-to-all, all-gather,
    reduce-scatter and point-to-point take CPU tensors, and the staging copy
    is the wire, not a fallback of a kernel."""
    if kind == "ppermute":
        return start_ppermute(t, backend, group, shift)()
    dev = t.device
    t = _staged(t, backend)
    if kind == "broadcast":
        out = t.clone()
        dist.broadcast(out, src=root, group=group)
    elif kind == "all_to_all":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
    elif kind == "all_gather":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts)
    elif kind == "all_reduce":
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    elif kind == "reduce_scatter":
        if t.shape[0] % world:
            raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not "
                             f"split into {world} chunks")
        out = t.new_empty((t.shape[0] // world,) + tuple(t.shape[1:]))
        # the newer name of reduce_scatter_tensor, where torch has it
        rs = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        rs(out, t, op=dist.ReduceOp.SUM, group=group)
    else:
        raise ValueError(f"unknown collective {kind!r}")
    return out.to(dev)


def _staged(t: torch.Tensor, backend: Optional[str]) -> torch.Tensor:
    """``t`` as the backend takes it: contiguous, on the host under gloo."""
    if backend == "gloo" and t.device.type == "cuda":
        t = t.cpu()
    return t.contiguous()


def start_ppermute(t: torch.Tensor, backend: Optional[str], group=None,
                   shift: int = 1) -> Callable[[], torch.Tensor]:
    """Post the ring's hop of ``t`` (send to the rank ``shift`` places on
    in ``group``, receive from the one ``shift`` places back) and return
    ``wait()``, which blocks until both are done and returns the received
    tensor on ``t``'s device. Work issued between the two overlaps the
    transfer."""
    dev = t.device
    t = _staged(t, backend)
    ranks = group_ranks(group)
    n, i = len(ranks), ranks.index(dist.get_rank())
    out = torch.empty_like(t)
    # both posted before either waits: a blocking send first would leave
    # every rank of the ring waiting on its neighbour
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, ranks[(i + shift) % n], group),
        dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)])

    def wait(_sent=t) -> torch.Tensor:  # holds the staged send until done
        for work in works:
            work.wait()
        return out.to(dev)

    return wait


def _pack(entries) -> torch.Tensor:
    """One rank's entries as one flat buffer, in response order (the
    reference's ``_pack``, MemcpyInFusionBuffer); a single entry is a
    view."""
    parts = [e.array.reshape(-1) for e in entries]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _unpack(flat: torch.Tensor, entries) -> list:
    """``flat`` split back into views of the entries' shapes."""
    outs, off = [], 0
    for e in entries:
        n = e.array.numel()
        outs.append(flat[off:off + n].reshape(e.array.shape))
        off += n
    return outs


class Executor:
    """Per-process executor over the process ``group`` (None: every rank).
    ``last_wire_mode`` / ``last_wire_bytes`` record what the last allreduce
    put on the wire (as ``_record_wire`` does in the reference)."""

    def __init__(self, world: int, backend: Optional[str], group=None):
        self._world = world
        self._backend = backend
        self._group = group
        self.last_wire_mode = ""
        self.last_wire_bytes = 0

    def _collective(self, kind: str, t: torch.Tensor,
                    root: int = 0) -> torch.Tensor:
        return _collective(kind, t, self._backend, self._world, root=root,
                           group=self._group)

    # ------------------------------------------------------------ execute
    def execute(self, response, entries_by_rank) -> dict:
        """Run one negotiated response over this process's entries
        (``{rank: [entries in response order]}``); returns ``{rank:
        [results]}``, each on its entry's device. Allreduce packs the
        entries into one flat buffer and splits the result back; Adasum
        combines each tensor with its own coefficients
        (:meth:`execute_adasum`); allgather takes the dim-0 sizes that
        negotiation put in ``response.tensor_sizes`` (every rank's, per
        tensor), and a ragged alltoall its send matrix, flattened by
        source."""
        (rank, entries), = entries_by_rank.items()
        rt = response.response_type
        self.last_wire_mode = ""
        self.last_wire_bytes = 0
        if rt == ResponseType.ALLREDUCE:
            outs = self._exec_allreduce(response, entries)
        elif rt == ResponseType.ADASUM:
            outs = self.execute_adasum([entries])[0]
        elif rt == ResponseType.ALLGATHER:
            outs = self._exec_allgather(response, entries)
        elif rt == ResponseType.BROADCAST:
            outs = [self._collective("broadcast", e.array,
                                     root=response.root_rank)
                    if self._world > 1 else e.array.clone()
                    for e in entries]
        elif rt == ResponseType.ALLTOALL:
            outs = [self._exec_alltoall(response, e, rank) for e in entries]
        else:
            raise ValueError(f"unsupported response type {rt}")
        return {rank: outs}

    def _exec_allreduce(self, response, entries) -> list:
        e0 = entries[0]
        kw = dict(average=response.average,
                  wire=response.compression or None,
                  prescale=e0.prescale_factor, postscale=e0.postscale_factor)
        if self._world == 1:  # each tensor, with only its scale factors
            return [self.allreduce(e.array, **kw) for e in entries]
        return _unpack(self.allreduce(_pack(entries), **kw), entries)

    def execute_adasum(self, groups) -> list:
        """The Adasum results of several responses' entries (``groups``, a
        list of entry lists): every entry gathered on its own, in order,
        then one :meth:`adasum_many` call for all of them, so one kernel
        launch a tree level (and dtype) on the card. A bucket entry
        (``parts``) is combined member by member. Returns the results
        grouped as ``groups``."""
        entries = [e for es in groups for e in es]
        tensors = [e.array for e in entries]
        if any(e.parts is not None for e in entries):
            outs = self.adasum_many(tensors, [e.parts for e in entries])
        else:
            outs = self.adasum_many(tensors)
        res, k = [], 0
        for es in groups:
            res.append(outs[k:k + len(es)])
            k += len(es)
        return res

    def _exec_allgather(self, response, entries) -> list:
        if self._world == 1:
            return [e.array.clone() for e in entries]
        outs = []
        for e, sizes in zip(entries, response.tensor_sizes):
            x = e.array
            top = max(sizes)
            if x.shape[0] < top:  # every rank sends the same number of rows
                x = torch.cat([x, x.new_zeros((top - x.shape[0],)
                                              + tuple(x.shape[1:]))])
            parts = self._collective("all_gather", x)
            outs.append(torch.cat([parts[r * top:r * top + n]
                                   for r, n in enumerate(sizes)]))
        return outs

    def _exec_alltoall(self, response, e, rank: int):
        """Equal split (dim 0 in ``world`` blocks, block r to rank r), or
        with ``e.splits`` the ragged form: rank r gets ``splits[r]`` rows
        from every rank, in source order, and the received counts come
        back beside the output."""
        if e.splits is None:
            if self._world == 1:
                return e.array.clone()
            return self._collective("all_to_all", e.array)
        if self._world == 1:
            return AlltoallvResult(e.array.clone(), (int(e.array.shape[0]),))
        w = self._world
        flat = response.tensor_sizes[0]
        matrix = [flat[r * w:(r + 1) * w] for r in range(w)]
        recv = tuple(int(matrix[src][rank]) for src in range(w))
        dev = e.array.device
        t = _staged(e.array, self._backend)
        out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, t, output_split_sizes=list(recv),
                               input_split_sizes=list(e.splits),
                               group=self._group)
        return AlltoallvResult(out.to(dev), recv)

    @staticmethod
    def quantized_wire_layout(length: int, world: int,
                              block: Optional[int] = None,
                              bits: int = 8) -> Dict[str, int]:
        """Byte accounting of the quantized wire for ``length`` f32 elements
        over ``world`` ranks: each row is padded to ``world`` chunks of whole
        blocks; ``wire_bytes`` is the per-rank total of payload + scales for
        one reduce + gather round."""
        block = block or comp.block_size()
        chunk = -(-length // world)
        chunk = -(-chunk // block) * block
        padded = chunk * world
        payload = padded // 2 if bits == 4 else padded
        scales = (padded // block) * 4
        return {"block": block, "chunk": chunk, "padded": padded,
                "bits": bits,
                "payload_bytes": payload, "scale_bytes": scales,
                "wire_bytes": 2 * (payload + scales)}

    def effective_wire(self, wire: Optional[str], dtype: torch.dtype,
                       length: int) -> str:
        """The wire mode a tensor actually uses: quantized only for a float
        tensor of at least ``HOROVOD_COMPRESSION_MIN_SIZE`` (1024) elements
        at world >= 2; int4 downgrades to int8 for an odd block."""
        if wire not in ("int8", "int4"):
            return ""
        if self._world == 1:
            return ""
        if not dtype.is_floating_point:
            return ""  # integer/bool tensors ride the exact wire
        floor = int(os.environ.get("HOROVOD_COMPRESSION_MIN_SIZE", 1024))
        if length < floor:
            return ""  # small tensors: scale overhead beats the savings
        if wire == "int4" and comp.block_size() % 2:
            return "int8"  # nibble packing needs an even block
        return wire

    def _record_wire(self, wire: str, length: int, dtype: torch.dtype) -> None:
        self.last_wire_mode = wire
        if wire:
            self.last_wire_bytes = self.quantized_wire_layout(
                length, self._world,
                bits=4 if wire == "int4" else 8)["wire_bytes"]
        else:
            self.last_wire_bytes = 2 * length * dtype.itemsize

    def allreduce(self, tensor: torch.Tensor, average: bool,
                  wire: Optional[str] = None, prescale: float = 1.0,
                  postscale: float = 1.0) -> torch.Tensor:
        """Sum (or average) ``tensor`` over all ranks; the result has the
        input's shape, dtype and device. ``prescale`` multiplies each rank's
        contribution before the sum, ``postscale`` the result after the
        average: in the tensor's dtype on the exact wire, in f32 on the
        quantized one, as the reference's programs do."""
        length = tensor.numel()
        mode = self.effective_wire(wire, tensor.dtype, length)
        self._record_wire(mode, length, tensor.dtype)
        if self._world == 1:
            f = prescale * postscale
            return tensor.clone() if f == 1.0 else tensor * _scalar(f, tensor)
        flat = tensor.reshape(-1)
        if mode:
            x = flat.float()
            if prescale != 1.0:
                x = x * _scalar(prescale, x)
            out = self._quantized_sum(x, bits=4 if mode == "int4" else 8)
            if average:
                out = out / self._world
        else:
            if prescale != 1.0:
                flat = flat * _scalar(prescale, flat)
            out = self._collective("all_reduce", flat)
            if average:
                out = (out // self._world if not out.dtype.is_floating_point
                       else out / self._world)
        if postscale != 1.0:
            out = out * _scalar(postscale, out)
        return out.to(tensor.dtype).reshape(tensor.shape)

    def _adasum_world(self) -> int:
        world = self._world
        if world & (world - 1):
            raise HorovodInternalError(
                f"Adasum requires a power-of-2 number of ranks; got {world}.")
        return world

    def adasum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Adasum combine of ``tensor`` (f32, bf16 or f16) over all ranks,
        the reference's ``_adasum_fn``: all-gather the flat rows into
        ``[world, n]``, then combine pairs ``(2i, 2i+1)`` level by level, one
        ``adasum_combine_pairs`` launch per level, each level cast back to
        the input dtype. Every rank gets the root. The wire is the exact
        one (quantized wires are bypassed)."""
        world = self._adasum_world()
        length = tensor.numel()
        self._record_wire("", length, tensor.dtype)
        if world == 1:
            return tensor.clone()
        buf = self._collective("all_gather", tensor.reshape(1, -1))
        while buf.shape[0] > 1:
            buf = ck.adasum_combine_pairs(buf[0::2], buf[1::2])
        return buf[0].reshape(tensor.shape)

    def adasum_many(self, tensors: Sequence[torch.Tensor],
                    parts: Optional[Sequence] = None) -> list:
        """:meth:`adasum` of each of ``tensors``, with the same bits: each
        tensor all-gathered on its own, in order, as :meth:`adasum` does;
        then each tree level of every tensor in one
        ``adasum_combine_pairs_many`` call (a launch per dtype on the card),
        coefficients per tensor, each level cast back to its tensor's
        dtype. ``parts[i]`` (None: the whole tensor) cuts tensor i's flat
        elements into members that combine each with its own coefficients
        (a bucket of the delta flow, gathered as one buffer); its result is
        the members' results in order, in tensor i's shape."""
        tensors = list(tensors)
        parts = list(parts) if parts is not None else [None] * len(tensors)
        world = self._adasum_world()
        for t in tensors:
            self._record_wire("", t.numel(), t.dtype)
        if world == 1:
            return [t.clone() for t in tensors]
        bufs, owner = [], []  # one [world, n] row set a member
        for i, t in enumerate(tensors):
            g = self._collective("all_gather", t.reshape(1, -1))
            off = 0
            for n in parts[i] or (t.numel(),):
                bufs.append(g[:, off:off + n])
                owner.append(i)
                off += n
        for _ in range(world.bit_length() - 1):
            bufs = ck.adasum_combine_pairs_many(
                [(buf[0::2], buf[1::2]) for buf in bufs])
        outs = [[] for _ in tensors]
        for i, buf in zip(owner, bufs):
            outs[i].append(buf[0])
        return [(o[0] if len(o) == 1 else torch.cat(o)).reshape(t.shape)
                for o, t in zip(outs, tensors)]

    def _quantized_sum(self, x: torch.Tensor, bits: int) -> torch.Tensor:
        """Quantized allreduce (sum) of the flat f32 ``x``: the reference's
        ``q_hop``, packed (int4 always, int8 under HOROVOD_PACKED_WIRE) or
        unpacked."""
        m = self._world
        block = comp.block_size()
        packed = bits == 4 or os.environ.get(
            "HOROVOD_PACKED_WIRE", "").lower() in ("1", "on", "true")
        ln = x.numel()
        chunk = -(-ln // m)
        chunk = -(-chunk // block) * block
        padded = chunk * m
        if padded != ln:
            x = torch.nn.functional.pad(x, (0, padded - ln))
        nb = chunk // block
        if packed:
            if bits == 4:
                quant_pack, unpack = ck.int4_quantize_pack_2d, ck.int4_unpack
            else:
                quant_pack, unpack = ck.int8_quantize_pack_2d, ck.int8_unpack
            p = quant_pack(x.reshape(padded // block, block))
            wt = self._collective("all_to_all", p)
            q2, s2 = unpack(wt)
            red = self._dequant_sum(q2.reshape(m, nb, block),
                                    s2.reshape(m, nb, 1)).reshape(chunk)
            rp = quant_pack(red.reshape(nb, block))
            gp = self._collective("all_gather", rp)
            rq, rs = unpack(gp)
            out = (rq.float() * rs).reshape(padded)
        else:
            q, s = comp.quantize_blocks(x, block)
            qt = self._collective("all_to_all", q.reshape(m, chunk))
            st = self._collective("all_to_all", s.reshape(m, nb))
            red = self._dequant_sum(qt.reshape(m, nb, block),
                                    st[..., None]).reshape(chunk)
            rq, rs = comp.quantize_blocks(red, block)
            out = comp.dequantize_blocks(
                self._collective("all_gather", rq),
                self._collective("all_gather", rs), block=block)
        return out[:ln] if padded != ln else out

    @staticmethod
    def _dequant_sum(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """``sum_j f32(q[j]) * s[j]`` over dim 0 (the ranks) in rank order,
        each product fused into the running f32 sum as one FMA,
        ``acc = fma(q[j], s[j], acc)``: the reference program's bits, where
        XLA fuses the dequantize into the reduce. The FMA is taken in
        float64, where ``q[j] * s[j]`` (8 x 24 significant bits) is exact;
        its one f64 rounding can only matter when it lands exactly on an
        f32 rounding tie."""
        acc = q[0].float() * s[0]
        for j in range(1, q.shape[0]):
            acc = (acc.double() + q[j].double() * s[j].double()).float()
        return acc
