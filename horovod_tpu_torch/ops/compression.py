"""Gradient compression for collectives (counterpart of
``horovod_tpu/ops/compression.py``).

The cast compressors (fp16/bf16) change the dtype before the wire. The
block-quantized modes (int8, int4) are *wire markers*: ``compress`` is the
identity and the executor (`runtime/executor.py`) quantizes inside the
allreduce, because per-rank scales do not commute with the sum. The numerics
live here -- ``quantize_blocks`` / ``dequantize_blocks`` /
``quantize_roundtrip`` -- so error feedback, the executor and the tests share
one definition.

Per block of ``HOROVOD_INT8_BLOCK`` (default 256) elements: ``scale =
absmax / qmax`` (qmax 127 or 7), ``q = round_half_even(x / scale)``. Unlike
the reference, which takes its Pallas kernel only for shapes the TPU tiles,
int8 quantize and dequantize take the CUDA kernel for every CUDA tensor; the
formula is the same, so the bits are the same.

Job-wide default: ``HOROVOD_COMPRESSION={none,fp16,bf16,int8,int4}``
(:func:`from_env`).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import cuda_kernels as ck

DEFAULT_BLOCK = 256


def block_size() -> int:
    """Quantization block length (``HOROVOD_INT8_BLOCK``, default 256)."""
    b = int(os.environ.get("HOROVOD_INT8_BLOCK", DEFAULT_BLOCK))
    if b <= 0:
        raise ValueError(f"HOROVOD_INT8_BLOCK={b}: must be positive")
    return b


def quantize_blocks(x: torch.Tensor, block: int | None = None, bits: int = 8):
    """Block-quantize a float tensor to ``(int8 payload, f32 scales)``.

    ``x`` is flattened; its length must be a multiple of ``block`` (callers
    pad). Returns ``q`` (int8, ``x.numel()`` elements) and ``scales`` (f32,
    one per block). ``bits=4`` returns the 4-bit grid unpacked, one int8 per
    value; packing is the wire's business (``cuda_kernels``).
    """
    if bits not in (4, 8):
        raise ValueError(f"quantize_blocks: bits must be 4 or 8, got {bits}")
    block = block or block_size()
    flat = x.reshape(-1)
    if flat.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        flat = flat.float()
    if flat.numel() % block:
        raise ValueError(
            f"quantize_blocks: size {flat.numel()} not a multiple of "
            f"block {block}")
    x2 = flat.contiguous().reshape(-1, block)
    if bits == 8:
        q2, s2 = ck.int8_quantize_2d(x2)
    else:
        # the reference has no 4-bit unpacked kernel either: its jnp formula
        q2, s2 = ck.quant_rows(x2, ck.INT4_QMAX)
    return q2.reshape(-1), s2[:, 0]


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor,
                      dtype=torch.float32, block: int | None = None):
    """Inverse of :func:`quantize_blocks`: int8 payload x per-block scale."""
    block = block or block_size()
    q2 = q.reshape(-1, block).contiguous()
    s2 = scales.reshape(-1).float().contiguous()[:, None]
    return ck.int8_dequantize_2d(q2, s2).reshape(-1).to(dtype)


def quantize_roundtrip(x: torch.Tensor, block: int | None = None,
                       bits: int = 8):
    """Quantize then dequantize ``x`` (any shape, float dtype), padding with
    zeros to whole blocks: the value the quantized wire delivers for one
    rank's hop. Error feedback uses it to measure what the wire dropped."""
    block = block or block_size()
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    q, s = quantize_blocks(flat, block, bits=bits)
    y = dequantize_blocks(q, s, dtype=x.dtype, block=block)
    return y[:n].reshape(x.shape)


def wire_footprint(num_elements: int, mode: str,
                   block: int | None = None) -> int:
    """Bytes a fused bucket of ``num_elements`` f32 elements moves over the
    wire for one reduce-scatter + allgather round in ``mode``."""
    per_elem = {"none": 4, "fp32": 4, "fp16": 2, "bf16": 2}.get(mode)
    if per_elem is not None:
        return 2 * num_elements * per_elem
    if mode == "int8":
        block = block or block_size()
        blocks = -(-num_elements // block)
        return 2 * (num_elements + 4 * blocks)
    if mode == "int4":
        # packed nibbles plus one f32 scale per block
        block = block or block_size()
        blocks = -(-num_elements // block)
        return 2 * (-(-num_elements // 2) + 4 * blocks)
    raise ValueError(f"unknown compression mode {mode!r}")


class Compressor:
    """Compress before the collective, decompress after. ``wire`` names a
    quantized wire format the executor applies (None: the wire carries what
    ``compress`` produced)."""

    wire: str | None = None

    @staticmethod
    def compress(tensor):
        """Returns (compressed_tensor, context_for_decompress)."""
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError

    @classmethod
    def roundtrip(cls, tensor):
        """The value the wire delivers for this compressor (its lossy part;
        error feedback measures what the wire dropped with it)."""
        comp, ctx = cls.compress(tensor)
        return cls.decompress(comp, ctx)


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        if torch.is_floating_point(tensor):
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class _WireCompressor(NoneCompressor):
    """Marker: identity at the framework level, quantized in the executor.
    Integer tensors and tensors under the executor's size floor ride the
    exact wire."""

    #: quantization grid the wire applies (4 or 8)
    bits = 8

    @classmethod
    def roundtrip(cls, tensor):
        if not torch.is_floating_point(tensor):
            return tensor
        return quantize_roundtrip(tensor, bits=cls.bits)


class Int8Compressor(_WireCompressor):
    wire = "int8"


class Int4Compressor(_WireCompressor):
    """int4 packed wire: two values per byte, scale = absmax/7 per block.
    Pair with ``error_feedback=True``."""

    wire = "int4"
    bits = 4


class Compression:
    """The reference's Compression namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor


_BY_NAME = {
    "": NoneCompressor,
    "none": NoneCompressor,
    "fp16": FP16Compressor,
    "bf16": BF16Compressor,
    "int8": Int8Compressor,
    "int4": Int4Compressor,
}


def by_name(name: str):
    """Resolve a compression mode name (the HOROVOD_COMPRESSION values)."""
    try:
        return _BY_NAME[str(name).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown compression {name!r}; expected one of "
            "none/fp16/bf16/int8/int4") from None


def from_env(default=NoneCompressor):
    """Job-wide default compressor from ``HOROVOD_COMPRESSION``."""
    name = os.environ.get("HOROVOD_COMPRESSION")
    return by_name(name) if name else default
