"""Data-plane programs of the allreduce (subset of
``horovod_tpu/runtime/executor.py``): the exact wire, and the block-quantized
int8 / int4 wire with its bypass rules and byte accounting.

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
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..ops import compression as comp
from ..ops import cuda_kernels as ck


def _collective(kind: str, t: torch.Tensor, backend: Optional[str],
                world: int, root: int = 0) -> torch.Tensor:
    """The one place that issues a collective; returns a new tensor on
    ``t``'s device. ``kind`` is ``all_to_all`` (tiled along dim 0),
    ``all_gather`` (tiled along dim 0), ``all_reduce`` (sum) or
    ``broadcast`` (from ``root``). Under gloo a CUDA tensor is staged
    through host memory here: gloo's all-to-all and all-gather take CPU
    tensors, and the staging copy is the wire, not a fallback of a
    kernel."""
    dev = t.device
    if backend == "gloo" and dev.type == "cuda":
        t = t.cpu()
    t = t.contiguous()
    if kind == "broadcast":
        out = t.clone()
        dist.broadcast(out, src=root)
    elif kind == "all_to_all":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
    elif kind == "all_gather":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out = torch.cat(parts)
    elif kind == "all_reduce":
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
    else:
        raise ValueError(f"unknown collective {kind!r}")
    return out.to(dev)


class Executor:
    """Per-process allreduce executor. ``last_wire_mode`` /
    ``last_wire_bytes`` record what the last allreduce put on the wire
    (as ``_record_wire`` does in the reference)."""

    def __init__(self, world: int, backend: Optional[str]):
        self._world = world
        self._backend = backend
        self.last_wire_mode = ""
        self.last_wire_bytes = 0

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
                  wire: Optional[str] = None) -> torch.Tensor:
        """Sum (or average) ``tensor`` over all ranks; the result has the
        input's shape, dtype and device."""
        length = tensor.numel()
        mode = self.effective_wire(wire, tensor.dtype, length)
        self._record_wire(mode, length, tensor.dtype)
        if self._world == 1:
            return tensor.clone()
        flat = tensor.reshape(-1)
        if mode:
            out = self._quantized_sum(flat.float(), bits=4 if mode == "int4"
                                      else 8)
            if average:
                out = out / self._world
        else:
            out = _collective("all_reduce", flat, self._backend, self._world)
            if average:
                out = (out // self._world if not out.dtype.is_floating_point
                       else out / self._world)
        return out.to(tensor.dtype).reshape(tensor.shape)

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
            wt = _collective("all_to_all", p, self._backend, m)
            q2, s2 = unpack(wt)
            red = self._dequant_sum(q2.reshape(m, nb, block),
                                    s2.reshape(m, nb, 1)).reshape(chunk)
            rp = quant_pack(red.reshape(nb, block))
            gp = _collective("all_gather", rp, self._backend, m)
            rq, rs = unpack(gp)
            out = (rq.float() * rs).reshape(padded)
        else:
            q, s = comp.quantize_blocks(x, block)
            qt = _collective("all_to_all", q.reshape(m, chunk),
                             self._backend, m)
            st = _collective("all_to_all", s.reshape(m, nb), self._backend, m)
            red = self._dequant_sum(qt.reshape(m, nb, block),
                                    st[..., None]).reshape(chunk)
            rq, rs = comp.quantize_blocks(red, block)
            out = comp.dequantize_blocks(
                _collective("all_gather", rq, self._backend, m),
                _collective("all_gather", rs, self._backend, m), block=block)
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
