"""Gradient compression for collectives (counterpart of
``horovod_tpu/ops/compression.py``).

The cast compressors (fp16/bf16) change the dtype before the wire. The
block-quantized modes (int8, int4) are *wire markers*: ``compress`` is the
identity and the executor (`runtime/executor.py`) quantizes inside the
allreduce, because per-rank scales do not commute with the sum. The numerics
live here -- ``quantize_blocks`` / ``dequantize_blocks`` /
``quantize_roundtrip`` and its many-leaf form ``quantize_roundtrip_many`` --
so error feedback, the executor and the tests share one definition.

Per block of ``HOROVOD_INT8_BLOCK`` (default 256) elements: ``scale =
absmax / qmax`` (qmax 127 or 7), ``q = round_half_even(x / scale)``. Unlike
the reference, which takes its Pallas kernel only for shapes the TPU tiles,
int8 quantize and dequantize take the CUDA kernel for every CUDA tensor; the
formula is the same, so the bits are the same.

``int8-dcn`` quantizes only the hop across hosts, its hops within a host
carry bf16; ``adaptive`` asks the per-bucket selector (``ops/adaptive.py``)
for int4, int8 or bf16 a bucket.

Job-wide default: ``HOROVOD_COMPRESSION={none,fp16,bf16,int8,int8-dcn,
int4,adaptive}`` (:func:`from_env`).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import adaptive
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


def quantize_roundtrip_many(tensors, block: int | None = None,
                            bits: int = 8):
    """:func:`quantize_roundtrip` of each tensor, bit for bit. For
    ``bits=8`` every leaf goes through one grouped quantize (one launch per
    dtype on the card, ``cuda_kernels.int8_quantize_2d_many``, which reads
    each leaf where it lies and pads nothing) and one dequantize over all
    their rows; each result is a view cut back to its leaf's shape and
    dtype. ``bits=4`` keeps the per-leaf formula (no unpacked 4-bit kernel,
    as in the reference)."""
    block = block or block_size()
    tensors = list(tensors)
    if bits != 8:
        return [quantize_roundtrip(t, block, bits=bits) for t in tensors]
    q, s = ck.int8_quantize_2d_many(
        [t.contiguous() if t.dtype in ck._FLOATS else t.float().contiguous()
         for t in tensors], block)
    y = ck.int8_dequantize_2d(q, s).reshape(-1)
    out, start = [], 0
    for t in tensors:
        n = t.numel()
        piece = y[start:start + n].view(t.shape)
        out.append(piece if t.dtype == torch.float32 else piece.to(t.dtype))
        start += -(-n // block) * block
    return out


def wire_footprint(num_elements: int, mode: str,
                   block: int | None = None) -> int:
    """Bytes a fused bucket of ``num_elements`` f32 elements moves over the
    wire for one reduce-scatter + allgather round in ``mode`` (``int8-dcn``
    counts its quantized hop; ``adaptive:<mode>`` the negotiated grid, bare
    ``adaptive`` the int8 it starts on)."""
    per_elem = {"none": 4, "fp32": 4, "fp16": 2, "bf16": 2}.get(mode)
    if per_elem is not None:
        return 2 * num_elements * per_elem
    if mode in ("int8", "int8-dcn", "int8_dcn"):
        block = block or block_size()
        blocks = -(-num_elements // block)
        return 2 * (num_elements + 4 * blocks)
    if mode == "int4":
        # packed nibbles plus one f32 scale per block
        block = block or block_size()
        blocks = -(-num_elements // block)
        return 2 * (-(-num_elements // 2) + 4 * blocks)
    if mode == "adaptive" or mode.startswith("adaptive:"):
        concrete = mode.split(":", 1)[1] if ":" in mode else "int8"
        return wire_footprint(num_elements, concrete, block)
    raise ValueError(f"unknown compression mode {mode!r}")


# ------------------------------------------- the compiled plane's catalogs
def _gspmd_seg_bytes(elems: int, mode: str, block: int | None) -> int:
    """Bytes one exchanged segment of ``elems`` f32 elements costs on the
    compiled plane's wire: packed rows for int8 / int4, raw elements
    otherwise."""
    per_elem = {"none": 4, "fp32": 4, "fp16": 2, "bf16": 2}.get(mode)
    if per_elem is not None:
        return elems * per_elem
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown GSPMD wire mode {mode!r}")
    block = block or block_size()
    rows = -(-elems // block)
    row_bytes = (block if mode == "int8" else block // 2) + 4
    return rows * row_bytes


def gspmd_wire_footprint(num_elements: int, mode: str, world: int,
                         block: int | None = None,
                         algorithm: str = "ring",
                         hosts: int | None = None) -> int:
    """Bytes ONE rank puts on the wire for one allreduce of the compiled
    plane (``spmd.quantized_allreduce`` and its algorithms).

    Quantized modes move packed rows (``[block | 4 scale bytes]`` for int8,
    ``[block/2 | 4]`` for int4) over chunks rounded up to whole blocks;
    ``none`` / ``fp32`` (``bf16`` / ``fp16``) count the same schedule with
    raw 4-byte (2-byte) elements. World 1 moves nothing.

    * ``ring``: reduce-scatter + all-gather, ``world - 1`` hops of one
      per-rank chunk each (the ZeRO-1 step moves the same).
    * ``tree``: ``2 * log2(world)`` exchanges of a payload half, as the
      reference counts it; a non-power-of-2 world rides the ring.
    * ``hier``: intra-host reduce-scatter + all-gather over ``world //
      hosts`` chips plus the cross-host phase on the owned chunk; ``hosts``
      must be a proper divisor of ``world`` or the ring row applies.
    """
    if world <= 1:
        return 0
    if algorithm == "tree" and world & (world - 1) == 0:
        half = -(-num_elements // 2)
        rounds = world.bit_length() - 1
        return 2 * rounds * _gspmd_seg_bytes(half, mode, block)
    if (algorithm == "hier" and hosts and 1 < hosts < world
            and world % hosts == 0):
        chips = world // hosts
        chunk = -(-num_elements // chips)
        sub = -(-chunk // hosts)
        intra = 2 * (chips - 1) * _gspmd_seg_bytes(chunk, mode, block)
        cross = 2 * (hosts - 1) * _gspmd_seg_bytes(sub, mode, block)
        return intra + cross
    return (2 * (world - 1)
            * _gspmd_seg_bytes(-(-num_elements // world), mode, block))


def gspmd_cross_host_footprint(num_elements: int, mode: str, world: int,
                               hosts: int, block: int | None = None,
                               algorithm: str = "ring") -> int:
    """Bytes crossing a host boundary, summed over all ranks, for one
    allreduce under a host-major ``(hosts, chips)`` layout. ``ring``: the
    flat ring's ``hosts`` boundary edges each carry ``world - 1`` chunk
    segments a phase; ``hier``: only the cross-host phase's rows; ``tree``:
    the exchanges at distances ``>= chips``."""
    if world <= 1 or hosts <= 1 or world % hosts:
        return 0
    chips = world // hosts
    if algorithm == "hier":
        chunk = -(-num_elements // chips)
        sub = -(-chunk // hosts)
        return (2 * (hosts - 1) * chips * hosts
                * _gspmd_seg_bytes(sub, mode, block))
    if algorithm == "tree" and world & (world - 1) == 0:
        total = 0
        seg = -(-num_elements // 2)
        d = world >> 1
        while d >= 1:
            if d >= chips:  # partner p ^ d sits on another host
                total += 2 * world * _gspmd_seg_bytes(seg, mode, block)
            seg = -(-seg // 2)
            d >>= 1
        return total
    chunk = -(-num_elements // world)
    return 2 * (world - 1) * hosts * _gspmd_seg_bytes(chunk, mode, block)


def moe_wire_footprint(per_peer_elements: int, mode: str, world: int,
                       block: int | None = None) -> int:
    """Bytes ONE device puts on the wire for one capacity-dispatch MoE
    round: the dispatch and the combine all_to_all, each moving ``world -
    1`` remote payloads of ``per_peer_elements`` f32 elements, each padded
    to whole blocks on a quantized wire. World 1 moves nothing."""
    if world <= 1:
        return 0
    per_elem = {"none": 4, "fp32": 4, "fp16": 2, "bf16": 2}.get(mode)
    if per_elem is not None:
        return 2 * (world - 1) * per_peer_elements * per_elem
    if mode not in ("int8", "int4"):
        raise ValueError(f"unknown MoE wire mode {mode!r}")
    block = block or block_size()
    rows = -(-per_peer_elements // block)
    row_bytes = (block if mode == "int8" else block // 2) + 4
    return 2 * (world - 1) * rows * row_bytes


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

    @classmethod
    def roundtrip_many(cls, tensors):
        """:meth:`roundtrip` of each tensor (a compressor may take them all
        in fewer kernel launches, with the same values)."""
        return [cls.roundtrip(t) for t in tensors]


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
    def _bits(cls) -> int:
        """The grid error feedback measures against (16: the bf16 cast)."""
        return cls.bits

    @classmethod
    def roundtrip(cls, tensor):
        if not torch.is_floating_point(tensor):
            return tensor
        bits = cls._bits()
        if bits >= 16:
            return tensor.to(torch.bfloat16).to(tensor.dtype)
        return quantize_roundtrip(tensor, bits=bits)

    @classmethod
    def roundtrip_many(cls, tensors):
        """The float tensors through one :func:`quantize_roundtrip_many`
        call (the bf16 cast at 16 bits); the others pass unchanged."""
        bits = cls._bits()
        out = list(tensors)
        idx = [i for i, t in enumerate(out) if torch.is_floating_point(t)]
        if bits >= 16:
            ys = [out[i].to(torch.bfloat16).to(out[i].dtype) for i in idx]
        else:
            ys = quantize_roundtrip_many([out[i] for i in idx], bits=bits)
        for i, y in zip(idx, ys):
            out[i] = y
        return out


class Int8Compressor(_WireCompressor):
    wire = "int8"


class Int8DcnCompressor(_WireCompressor):
    """int8 on the hop across hosts only; the hops within a host carry bf16
    (the two-level program, without two levels the flat int8 one)."""

    wire = "int8-dcn"


class Int4Compressor(_WireCompressor):
    """int4 packed wire: two values per byte, scale = absmax/7 per block.
    Pair with ``error_feedback=True``."""

    wire = "int4"
    bits = 4


class AdaptiveCompressor(_WireCompressor):
    """Mixed-bitwidth wire (``HOROVOD_COMPRESSION=adaptive``): a bucket is
    enqueued as ``adaptive:<mode>``, the mode its name's selector
    (``ops/adaptive.BitwidthSelector``) decided from the reduced buckets
    :meth:`observe` fed it; negotiation resolves ranks that race a decision
    to the least aggressive grid. One selector a process, class-level;
    :meth:`reset` drops it."""

    wire = "adaptive:int8"  # before any statistics exist
    _selector = None

    @classmethod
    def selector(cls):
        if cls._selector is None:
            cls._selector = adaptive.BitwidthSelector()
        return cls._selector

    @classmethod
    def reset(cls):
        cls._selector = None

    @classmethod
    def wire_for(cls, name: str) -> str:
        return "adaptive:" + cls.selector().decide(name)

    @classmethod
    def observe(cls, name: str, flat) -> None:
        cls.selector().observe(name, flat)

    @classmethod
    def _bits(cls) -> int:
        """The most aggressive grid any bucket rides: one residual serves
        every bucket (a bucket on a finer grid over-corrects a little,
        which the next step's residual takes back)."""
        return cls.selector().min_active_bits()


class Compression:
    """The reference's Compression namespace."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int8_dcn = Int8DcnCompressor
    int4 = Int4Compressor
    adaptive = AdaptiveCompressor


_BY_NAME = {
    "": NoneCompressor,
    "none": NoneCompressor,
    "fp16": FP16Compressor,
    "bf16": BF16Compressor,
    "int8": Int8Compressor,
    "int8-dcn": Int8DcnCompressor,
    "int8_dcn": Int8DcnCompressor,
    "int4": Int4Compressor,
    "adaptive": AdaptiveCompressor,
}

#: wire name -> compressor
BY_WIRE = {"int8": Int8Compressor, "int8-dcn": Int8DcnCompressor,
           "int4": Int4Compressor}


def by_name(name: str):
    """Resolve a compression mode name (the HOROVOD_COMPRESSION values)."""
    try:
        return _BY_NAME[str(name).strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown compression {name!r}; expected one of "
            "none/fp16/bf16/int8/int8-dcn/int4/adaptive") from None


def from_env(default=NoneCompressor):
    """Job-wide default compressor from ``HOROVOD_COMPRESSION``."""
    name = os.environ.get("HOROVOD_COMPRESSION")
    return by_name(name) if name else default
