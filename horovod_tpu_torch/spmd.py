"""The compiled data-parallel plane (counterpart of ``horovod_tpu/spmd.py``).

The reference runs its hot loop as one jitted program over the device mesh:
forward, backward, gradient reduction and optimizer update. The port's
counterpart is :func:`make_train_step`: a step over a model's parameters and
a torch optimizer that, at world 1 on the card, runs as one CUDA graph
(captured once, replayed every step), and at world > 1 runs its collectives
explicitly over ``torch.distributed`` (gloo staging through host memory is
not capturable, so that step is eager). It bypasses the eager engine and
``DistributedOptimizer``'s hooks, as the reference's compiled plane does.

Per-process forms of the reference's in-step primitives, over every rank:
``allreduce`` / ``pmean`` / ``allgather`` / ``alltoall`` / ``broadcast`` /
``reduce_scatter`` / ``adasum``; the reference's mesh axis is the world and
``axis_index`` this process's rank. :func:`quantized_all_to_all` (the MoE
token exchange) takes a process group where the reference takes an axis.

The quantized wire (``HOROVOD_GSPMD_WIRE`` or ``compression=``): the ring
reduce-scatter and all-gather whose every hop ships rows packed by #3
(``int8_quantize_pack_2d``) or #4 (``int4_quantize_pack_2d``), the
recursive halving / doubling tree and the two-level (host, chip) schedule
(``HOROVOD_GSPMD_ALGO``, ``HOROVOD_MESH_HOSTS``), with the reference's
fallbacks. A hop is a send to one rank and a receive from another, both
posted before either waits (``runtime/executor``). A gather forwards the
owner's packed bytes unchanged, so every rank decodes the same bytes and
the result is bit-identical on every rank. A hop's dequantize-and-add is
one fused multiply-add a element, as XLA makes it of the reference's
``q * scale + local``: one f32 ``addcmul`` on the card; on the CPU taken in
float64, where the product is exact, then rounded once to f32.

The quantized step carries the reference's error-feedback residual, one
f32 row of ``total_params`` a rank; ``zero1=True`` runs the optimizer on
this rank's ring chunk of the flat parameters (``optim/zero.py``).
:func:`gspmd_bytes` and :func:`gspmd_algorithms` keep the byte and algorithm
accounting the reference feeds its metrics with; :func:`hop_bytes` counts
the bytes this process's hops really sent.

``adasum`` differs from the eager ``Executor.adasum`` in one rule, as its
reference does: the tree stays in f32 through every level and the result is
cast to the input dtype once, at the end.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import basics
from .basics import Adasum, Average
from .ops import adaptive
from .ops import compression as comp
from .ops import cuda_kernels as ck
from .optim import zero
from .optim.fused import FusedAdamW
from .runtime.executor import _collective, _staged, group_ranks


def _world() -> tuple:
    st = basics._require_init()
    return st.size, st.rank, st.backend


# ------------------------------------------------------- in-step primitives
def allreduce(x: torch.Tensor, op: int = Average) -> torch.Tensor:
    """Sum (``op=Sum``), average (``op=Average``, integer tensors floor-
    divide) or Adasum-combine ``x`` across all ranks."""
    if op == Adasum:
        return adasum(x)
    size, _, backend = _world()
    s = (x.clone() if size == 1
         else _collective("all_reduce", x, backend, size))
    if op == Average:
        s = s / size if s.dtype.is_floating_point else s // size
    return s


def pmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over all ranks (floating point)."""
    size, _, backend = _world()
    if size == 1:
        return x.clone()
    return _collective("all_reduce", x, backend, size) / size


def allgather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order."""
    size, _, backend = _world()
    if size == 1:
        return x.clone()
    return _collective("all_gather", x, backend, size)


def alltoall(x: torch.Tensor, split_axis: int = 0,
             concat_axis: int = 0) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into ``size`` blocks along
    ``split_axis``, block r to rank r; the received blocks concatenated
    along ``concat_axis`` in source order."""
    size, _, backend = _world()
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all dim {split_axis} ({x.shape[split_axis]}"
                         f") not divisible by the world size {size}")
    if size == 1:
        return x.clone()
    send = torch.stack(x.chunk(size, dim=split_axis))  # [size, ...]
    got = _collective("all_to_all", send, backend, size)
    return torch.cat(list(got.unbind(0)), dim=concat_axis)


def broadcast(x: torch.Tensor, root_rank: int) -> torch.Tensor:
    """Every rank receives rank ``root_rank``'s ``x``."""
    size, _, backend = _world()
    if size == 1:
        return x.clone()
    return _collective("broadcast", x, backend, size, root=root_rank)


def reduce_scatter(x: torch.Tensor, scatter_axis: int = 0) -> torch.Tensor:
    """The sum over ranks of ``x``, cut into ``size`` blocks along
    ``scatter_axis``; rank r keeps block r."""
    size, _, backend = _world()
    if x.shape[scatter_axis] % size:
        raise ValueError(f"reduce_scatter dim {scatter_axis} "
                         f"({x.shape[scatter_axis]}) not divisible by the "
                         f"world size {size}")
    if size == 1:
        return x.clone()
    moved = x.movedim(scatter_axis, 0)
    out = _collective("reduce_scatter", moved, backend, size)
    return out.movedim(0, scatter_axis)


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
    size, _, backend = _world()
    rows = x.reshape(1, -1)
    if size > 1:
        rows = _collective("all_gather", rows, backend, size)
    return adasum_tree(rows).reshape(x.shape).to(x.dtype)


# ------------------------------------------------------------- the hops
_hops = {"bytes": 0, "sent": 0}


def hop_bytes() -> int:
    """Bytes this process's hops have sent since :func:`reset_hop_bytes`."""
    return _hops["bytes"]


def hops_sent() -> int:
    """Hops this process has sent since :func:`reset_hop_bytes`."""
    return _hops["sent"]


def reset_hop_bytes() -> None:
    _hops["bytes"] = 0
    _hops["sent"] = 0


def _exchange(t: torch.Tensor, to_rank: int, from_rank: int,
              group=None) -> torch.Tensor:
    """One hop: send ``t`` to global rank ``to_rank`` and receive a tensor
    of its shape and dtype from ``from_rank``, both posted before either
    waits, on ``group`` (None: the default group); the result on ``t``'s
    device."""
    _, _, backend = _world()
    dev = t.device
    send = _staged(t, backend)
    _hops["sent"] += 1
    _hops["bytes"] += send.numel() * send.element_size()
    out = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to_rank, group),
        dist.P2POp(dist.irecv, out, from_rank, group)])
    for w in works:
        w.wait()
    return out.to(dev)


def _ring_hop(t: torch.Tensor, ring, pos: int) -> torch.Tensor:
    """The ring's hop: to the next member of ``ring`` (global ranks), from
    the one before."""
    n = len(ring)
    return _exchange(t, ring[(pos + 1) % n], ring[(pos - 1) % n])


# ------------------------------------------------- the compiled plane's knobs
_GSPMD_WIRES = ("int8", "int4")


def gspmd_wire(value: Optional[str] = None) -> str:
    """The compiled plane's wire (``HOROVOD_GSPMD_WIRE``; ``value``, the
    ``make_train_step(compression=...)`` argument, overrides it): ``""``
    (off: the exact wire), ``"int8"`` or ``"int4"``. int4 must pass the
    convergence gate (``ops/adaptive.admit_wire``), else it is int8."""
    v = os.environ.get("HOROVOD_GSPMD_WIRE", "") if value is None else value
    v = (v or "").strip().lower()
    if v in ("", "0", "off", "none"):
        return ""
    if v not in _GSPMD_WIRES:
        raise ValueError(
            f"HOROVOD_GSPMD_WIRE must be int8|int4|off, got {v!r}")
    return adaptive.admit_wire(v)


def _wire_block(block: Optional[int]) -> int:
    return int(block or comp.block_size())


def _pack_fns(wire: str):
    if wire == "int4":
        return ck.int4_quantize_pack_2d, ck.int4_unpack
    return ck.int8_quantize_pack_2d, ck.int8_unpack


def _ring_chunk(num_elements: int, world: int, block: int) -> int:
    """Per-rank chunk: ceil(n / world) rounded up to whole blocks, so every
    hop's packed rows have no ragged tail."""
    return zero.ring_chunk(num_elements, world, block)


def _wire_eligible(num_elements: int, dtype, wire: str, block: int) -> bool:
    """The quantized path takes a float payload of at least one block (an
    even block for int4's nibbles)."""
    return (wire in _GSPMD_WIRES
            and dtype.is_floating_point
            and num_elements >= block
            and not (wire == "int4" and block % 2))


_GSPMD_ALGOS = ("ring", "tree", "hier", "auto")

#: payloads of at most this many f32 elements (256 KB) ride the tree under
#: "auto" on a power-of-2 world
_TREE_AUTO_MAX = 1 << 16


def gspmd_algo(value: Optional[str] = None) -> str:
    """The compiled plane's allreduce algorithm (``HOROVOD_GSPMD_ALGO``;
    ``value`` overrides it): ``"ring"`` (the default), ``"tree"``,
    ``"hier"`` or ``"auto"``."""
    v = os.environ.get("HOROVOD_GSPMD_ALGO", "") if value is None else value
    v = (v or "").strip().lower()
    if v in ("", "0", "off", "none"):
        return "ring"
    if v not in _GSPMD_ALGOS:
        raise ValueError(
            f"HOROVOD_GSPMD_ALGO must be ring|tree|hier|auto, got {v!r}")
    return v


def mesh_hosts(world: int) -> int:
    """Hosts of the ``(host, chip)`` factorization the hierarchical
    allreduce uses: ``HOROVOD_MESH_HOSTS`` (it must divide the world; ranks
    are host-major, rank = host * chips + chip), else the largest divisor
    of ``world`` at most sqrt(world) (1 for a prime world)."""
    v = os.environ.get("HOROVOD_MESH_HOSTS", "").strip()
    if v:
        hosts = int(v)
        if hosts < 1 or world % hosts:
            raise ValueError(
                f"HOROVOD_MESH_HOSTS={hosts} does not divide the world "
                f"size {world} (host-major rank numbering needs "
                f"world = hosts * chips)")
        return hosts
    hosts, d = 1, 2
    while d * d <= world:
        if world % d == 0:
            hosts = d
        d += 1
    return hosts


def resolve_algorithm(total: int, world: int,
                      algorithm: Optional[str] = None) -> str:
    """The algorithm for one payload of ``total`` f32 elements: an explicit
    choice as given; ``"auto"`` the tuned one if a tuner set it
    (``ops/adaptive.set_autotuned_algorithm``), else the tree for small
    payloads on a power-of-2 world, the hierarchical schedule where the
    world factorizes, the ring otherwise."""
    a = gspmd_algo(algorithm)
    if a != "auto":
        return a
    tuned = adaptive.autotuned_algorithm()
    if tuned:
        return tuned
    if total <= _TREE_AUTO_MAX and world & (world - 1) == 0 and world > 1:
        return "tree"
    if mesh_hosts(world) > 1:
        return "hier"
    return "ring"


# ------------------------------------------------------ the quantized ring
def _dequant_add(q: torch.Tensor, scales: torch.Tensor,
                 local: torch.Tensor) -> torch.Tensor:
    """``q * scale + local`` a element, rounded once (the fused
    multiply-add XLA makes of the reference's hop). On the card one f32
    ``addcmul``; on the CPU, where the tests hold the bits against XLA's,
    float64, in which the product of an int8 and an f32 is exact, so the
    one rounding is the sum's."""
    if q.is_cuda:
        return torch.addcmul(local.reshape(q.shape), q, scales).reshape(-1)
    return (q.double() * scales.double()).reshape(-1).add_(
        local.double()).float()


def _decode(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Unpacked rows as f32 values, flat: ``q * scale`` (#2 on the card)."""
    return ck.int8_dequantize_2d(q.contiguous(), scales.contiguous()) \
        .reshape(-1)


def _mean(flat: torch.Tensor, m: int) -> torch.Tensor:
    """``flat / m`` as XLA compiles the reference's division by the world
    size: a multiply by the f32 reciprocal."""
    return flat * (1.0 / m)


def _pad_to(flat: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(flat, (0, n - flat.numel())) if n > flat.numel() else flat


def _ring_reduce_scatter(flat: torch.Tensor, wire: str, block: int,
                         ring) -> torch.Tensor:
    """Ring reduce-scatter of the padded f32 ``flat`` over the members
    ``ring`` (global ranks; this rank among them): member ``pos`` seeds its
    sum with local chunk ``pos - 1`` and ends with chunk ``pos`` summed
    over the ring. Quantized hops ship packed rows; other wires raw f32."""
    size = len(ring)
    if size == 1:
        return flat
    pos = ring.index(_world()[1])
    chunk = flat.numel() // size

    def local_chunk(k):
        idx = (pos - k - 1) % size
        return flat[idx * chunk:(idx + 1) * chunk]

    acc = local_chunk(0)
    if wire not in _GSPMD_WIRES:
        for k in range(1, size):
            acc = _ring_hop(acc, ring, pos) + local_chunk(k)
        return acc
    pack, unpack = _pack_fns(wire)
    for k in range(1, size):
        wired = _ring_hop(pack(acc.reshape(-1, block)), ring, pos)
        q, scales = unpack(wired)
        acc = _dequant_add(q, scales, local_chunk(k))
    return acc


def _ring_all_gather(chunk: torch.Tensor, wire: str, block: int,
                     ring) -> torch.Tensor:
    """Ring all-gather of each member's 1-D f32 ``chunk`` over ``ring``:
    the owner packs its chunk once and the packed rows (raw f32 on an exact
    wire) make ``size - 1`` hops unchanged, so every member decodes each
    chunk from the same bytes. Returns ``[size * chunk]`` in ring order."""
    size = len(ring)
    if size == 1:
        return chunk
    pos = ring.index(_world()[1])
    num = chunk.numel()
    out = chunk.new_zeros(size * num)
    quant = wire in _GSPMD_WIRES
    if quant:
        pack, unpack = _pack_fns(wire)
        cur = pack(_pad_to(chunk, -(-num // block) * block)
                   .reshape(-1, block))
    else:
        cur = chunk
    for k in range(size):
        val = _decode(*unpack(cur))[:num] if quant else cur
        idx = (pos - k) % size
        out[idx * num:(idx + 1) * num] = val
        if k + 1 < size:
            cur = _ring_hop(cur, ring, pos)
    return out


def quantized_reduce_scatter(x: torch.Tensor, wire: str = "int8",
                             block: Optional[int] = None) -> torch.Tensor:
    """Ring reduce-scatter with a quantized wire over every rank: ``x``
    flattened to f32 and zero-padded to ``world * chunk`` (``chunk`` whole
    blocks on a quantized wire); returns the 1-D f32 chunk of the sum this
    rank owns (chunk ``rank``). At world 1, the padded vector unquantized.
    A ``wire`` other than int8 / int4 runs the same ring with raw f32
    hops."""
    m = _world()[0]
    block = _wire_block(block)
    flat = x.reshape(-1).float()
    num = flat.numel()
    chunk = (_ring_chunk(num, m, block) if wire in _GSPMD_WIRES
             else -(-num // m))
    flat = _pad_to(flat, m * chunk)
    if m == 1:
        return flat
    return _ring_reduce_scatter(flat, wire, block, list(range(m)))


def quantized_all_gather(chunk: torch.Tensor, wire: str = "int8",
                         block: Optional[int] = None) -> torch.Tensor:
    """Ring all-gather of every rank's 1-D ``chunk`` with a quantized wire
    (each rank, the owner too, decodes each chunk from the owner's packed
    bytes, so the ``[world * chunk]`` result is bit-identical on every
    rank); another ``wire`` gathers the raw f32 values."""
    m = _world()[0]
    flat = chunk.reshape(-1).float()
    if m == 1:
        return flat
    return _ring_all_gather(flat, wire, _wire_block(block), list(range(m)))


def _no_adasum(op: int, what: str) -> None:
    if op == Adasum:
        raise NotImplementedError(
            f"the GSPMD {what} does not support Adasum; use spmd.adasum "
            "(exact) instead")


def quantized_allreduce(x: torch.Tensor, op: int = Average,
                        wire: Optional[str] = None,
                        block: Optional[int] = None) -> torch.Tensor:
    """Allreduce on the quantized ring: :func:`quantized_reduce_scatter`
    then :func:`quantized_all_gather`, every hop packed rows; the result is
    bit-identical on every rank. The exact :func:`allreduce` when the wire
    is off, the payload is not floating point or is under one block.
    ``wire=None`` resolves ``HOROVOD_GSPMD_WIRE`` (:func:`gspmd_wire`)."""
    wire = gspmd_wire(wire)
    if op == Adasum:
        raise NotImplementedError(
            "the quantized GSPMD wire does not support Adasum; use "
            "spmd.adasum (exact) instead")
    block = _wire_block(block)
    if not _wire_eligible(x.numel(), x.dtype, wire, block):
        return allreduce(x, op)
    m = _world()[0]
    chunk = quantized_reduce_scatter(x, wire, block)
    flat = quantized_all_gather(chunk, wire, block)[:x.numel()]
    if op == Average:
        flat = _mean(flat, m)
    return flat.reshape(x.shape).to(x.dtype)


def quantized_allreduce_tree(x: torch.Tensor, op: int = Average,
                             wire: Optional[str] = None,
                             block: Optional[int] = None,
                             group=None) -> torch.Tensor:
    """Recursive halving / doubling allreduce: ``log2(world)`` exchanges
    with the partner ``rank ^ d`` at distances ``world/2, ..., 1``, each
    shipping the half of the window the partner keeps (packed rows on a
    quantized wire, raw f32 otherwise) and adding; then ``log2(world)``
    doubling exchanges forward the owners' packed bytes verbatim, so the
    result is bit-identical on every rank. The ring on a non-power-of-2
    world; the exact :func:`allreduce` for payloads the wire cannot carry
    or non-float ones.

    ``group`` (the engine's tree runs on its own group) takes the exact
    wire, a float payload and a power-of-2 group of at least 2; its
    exchanges go to the members' global ranks."""
    wire = gspmd_wire(wire)
    _no_adasum(op, "tree allreduce")
    block = _wire_block(block)
    if group is None:
        m, p, _ = _world()
        ranks = range(m)
    else:
        ranks = group_ranks(group)
        m, p = len(ranks), ranks.index(dist.get_rank())
        if (m & (m - 1) or m == 1 or wire
                or not x.dtype.is_floating_point):
            raise ValueError(
                f"the tree over a group takes the exact wire, a float "
                f"payload and a power-of-2 group of at least 2; got wire "
                f"{wire!r}, {x.dtype}, {m} ranks")
    if m & (m - 1) or m == 1:
        return quantized_allreduce(x, op, wire, block)
    if wire in _GSPMD_WIRES and not _wire_eligible(x.numel(), x.dtype, wire,
                                                   block):
        return allreduce(x, op)
    if not x.dtype.is_floating_point:
        return allreduce(x, op)
    num = x.numel()
    quant = wire in _GSPMD_WIRES
    chunk = _ring_chunk(num, m, block) if quant else -(-num // m)
    flat = _pad_to(x.reshape(-1).float(), m * chunk)
    rounds = m.bit_length() - 1
    if quant:
        pack, unpack = _pack_fns(wire)
    win = flat
    for k in range(rounds):  # halving: each half is whole chunks (blocks)
        d = m >> (k + 1)
        half = win.numel() // 2
        lower, upper = win[:half], win[half:]
        keep, send = (upper, lower) if (p // d) % 2 else (lower, upper)
        peer = ranks[p ^ d]
        if quant:
            q, scales = unpack(_exchange(pack(send.reshape(-1, block)),
                                         peer, peer, group))
            win = _dequant_add(q, scales, keep)
        else:
            win = keep + _exchange(send.contiguous(), peer, peer, group)
    if quant:  # doubling: the owners' packed rows, forwarded verbatim
        rows = chunk // block
        packed = pack(win.reshape(-1, block))
        buf = packed.new_zeros((m * rows, packed.shape[1]))
        unit = rows
    else:
        packed = win
        buf = win.new_zeros(m * chunk)
        unit = chunk
    buf[p * unit:(p + 1) * unit] = packed
    for k in range(rounds):
        d = 1 << k
        lo = (p // d) * d
        seg = buf[lo * unit:(lo + d) * unit]
        other = lo ^ d
        peer = ranks[p ^ d]
        buf[other * unit:(other + d) * unit] = _exchange(seg.contiguous(),
                                                         peer, peer, group)
    out = _decode(*unpack(buf))[:num] if quant else buf[:num]
    if op == Average:
        out = _mean(out, m)
    return out.reshape(x.shape).to(x.dtype)


def quantized_allreduce_hier(x: torch.Tensor, op: int = Average,
                             wire: Optional[str] = None,
                             block: Optional[int] = None,
                             hosts: Optional[int] = None) -> torch.Tensor:
    """Two-level allreduce over a host-major ``(host, chip)`` factorization
    of the ranks (rank = host * chips + chip): an intra-host ring
    reduce-scatter, then a ring reduce-scatter and all-gather of each owned
    chunk among the chips of one index on every host (the only phase whose
    bytes cross hosts), then an intra-host ring all-gather; bit-identical
    on every rank. ``hosts`` defaults to :func:`mesh_hosts`. The flat ring
    when the factorization is degenerate; the exact :func:`allreduce` for
    payloads the wire cannot carry."""
    wire = gspmd_wire(wire)
    _no_adasum(op, "hierarchical allreduce")
    block = _wire_block(block)
    m, p, _ = _world()
    h = mesh_hosts(m) if hosts is None else int(hosts)
    if h <= 1 or h >= m or m % h:
        return quantized_allreduce(x, op, wire, block)
    if wire in _GSPMD_WIRES and not _wire_eligible(x.numel(), x.dtype, wire,
                                                   block):
        return allreduce(x, op)
    if not x.dtype.is_floating_point:
        return allreduce(x, op)
    num = x.numel()
    c = m // h  # chips a host
    quant = wire in _GSPMD_WIRES
    chunk = _ring_chunk(num, c, block) if quant else -(-num // c)
    flat = _pad_to(x.reshape(-1).float(), c * chunk)
    hp, l = p // c, p % c
    intra = [hp * c + j for j in range(c)]
    inter = [j * c + l for j in range(h)]
    chunk_l = _ring_reduce_scatter(flat, wire, block, intra)
    sub = _ring_chunk(chunk, h, block) if quant else -(-chunk // h)
    owned = _ring_reduce_scatter(_pad_to(chunk_l, h * sub), wire, block,
                                 inter)
    chunk_g = _ring_all_gather(owned, wire, block, inter)[:chunk]
    out = _ring_all_gather(chunk_g, wire, block, intra)[:num]
    if op == Average:
        out = _mean(out, m)
    return out.reshape(x.shape).to(x.dtype)


_ALLREDUCE = {"ring": quantized_allreduce, "tree": quantized_allreduce_tree,
              "hier": quantized_allreduce_hier}


def _wire_roundtrip(flat: torch.Tensor, wire: str, block: int) -> torch.Tensor:
    """The value one quantized hop delivers for ``flat`` (the error-feedback
    numerator): zero-padded to whole blocks, quantized and dequantized by
    ``ops/compression`` (#1 and #2 on the card for int8)."""
    num = flat.numel()
    padded = _pad_to(flat, -(-num // block) * block)
    q, scales = comp.quantize_blocks(padded, block,
                                     bits=4 if wire == "int4" else 8)
    return comp.dequantize_blocks(q, scales, torch.float32, block)[:num]


# --------------------------------------------------- quantized all_to_all
def _a2a_roundtrip(flat: torch.Tensor, wire: str, block: int) -> torch.Tensor:
    """The error-feedback numerator of one quantized all_to_all: what the
    packed wire delivers for this rank's ``[m, per]`` payload, each peer's
    segment padded to whole blocks on its own (as the pack does, so no
    block mixes two peers), through ``ops/compression`` (#1 and #2 on the
    card for int8; int4 quantizes in plain torch, then #2)."""
    m, per = flat.shape
    pad = (-per) % block
    padded = F.pad(flat, (0, pad)) if pad else flat
    q, scales = comp.quantize_blocks(padded.reshape(-1), block,
                                     bits=4 if wire == "int4" else 8)
    out = comp.dequantize_blocks(q, scales, torch.float32, block)
    return out.reshape(m, per + pad)[:, :per]


def _a2a_packed(packed: torch.Tensor, group, m: int) -> torch.Tensor:
    """The tiled all_to_all of packed rows (row group j to peer j, what
    arrives concatenated by source); the rows sent to the other ``m - 1``
    peers count as hops (:func:`hop_bytes`)."""
    sent = packed.numel() * packed.element_size() * (m - 1) // m
    _hops["sent"] += m - 1
    _hops["bytes"] += sent
    return _collective("all_to_all", packed, _world()[2], m, group=group)


def _a2a_wired(x: torch.Tensor, group, wire: str, block: int) -> torch.Tensor:
    """One quantized all_to_all, forward value only: each destination
    peer's payload padded to whole blocks, all ``m * rows`` rows packed by
    one #3 (int8) or #4 (int4) launch, the packed int8 rows exchanged,
    unpacked and decoded as ``q * scale`` (one f32 product a value, as the
    reference's ``q.astype(f32) * scales``)."""
    m = len(group_ranks(group))
    per = x.numel() // m
    flat = x.reshape(m, per).float()
    pad = (-per) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    pack, unpack = _pack_fns(wire)
    wired = _a2a_packed(pack(flat.reshape(-1, block).contiguous()), group, m)
    q, scales = unpack(wired)
    vals = (q.float() * scales).reshape(m, per + pad)[:, :per]
    return vals.reshape(x.shape)


class _StAllToAll(torch.autograd.Function):
    """The quantized exchange with a straight-through gradient: the
    quantizer has no gradient, so the cotangent rides the exact all_to_all,
    which (tiled on dim 0) is its own adjoint."""

    @staticmethod
    def forward(ctx, x, group, wire, block):
        ctx.group = group
        return _a2a_wired(x, group, wire, block)

    @staticmethod
    def backward(ctx, g):
        from .parallel._comm import _exchange

        return _exchange("all_to_all", g.contiguous(), ctx.group), \
            None, None, None


def quantized_all_to_all(x: torch.Tensor, group=None, wire: str = "int8",
                         block: Optional[int] = None, ef=None):
    """all_to_all over ``group`` (a process group; None: every rank) whose
    payload rides the packed wire: the MoE token exchange.

    ``x`` is the local ``[L, ...]`` operand, dim 0 split into ``m`` row
    groups, group j to the axis's rank j; what arrives is concatenated by
    source (the reference's ``all_to_all(tiled=True)`` on dim 0). Each
    peer's payload pads to whole blocks on its own and packs into
    ``[payload | 4 f32-scale bytes]`` rows; only those bytes cross the
    wire. An axis of one rank, a non-float payload, a per-peer payload
    under one block, or an odd block under int4 takes the exact
    all_to_all. The gradient is straight-through (:class:`_StAllToAll`).

    ``ef`` (f32, ``x``'s shape) turns on error feedback: it is added to
    ``x`` before the exchange, and the return is ``(y, new_ef)`` with
    ``new_ef = corrected - roundtrip(corrected)``, outside the graph."""
    from .parallel._comm import all_to_all  # parallel imports this module

    m = len(group_ranks(group))
    if x.shape[0] % m:
        raise ValueError(f"all_to_all dim 0 ({x.shape[0]}) not divisible by "
                         f"axis size {m}")
    block = _wire_block(block)
    per = x.numel() // m
    if m == 1 or not _wire_eligible(per, x.dtype, wire, block):
        y = all_to_all(x, group)
        if ef is None:
            return y
        return y, torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    corrected = x.float()
    if ef is not None:
        corrected = corrected + ef.detach().float()
    y = _StAllToAll.apply(corrected, group, wire, block).to(x.dtype)
    if ef is None:
        return y
    with torch.no_grad():
        flat = corrected.detach().reshape(m, per)
        new_ef = (flat - _a2a_roundtrip(flat, wire, block)).reshape(x.shape)
    return y, new_ef


# ------------------------------------------------------- byte accounting
#: (wire, exact) bytes of the compiled plane's quantized rounds so far
_gspmd_bytes = {"wire": 0, "exact": 0}
#: the last algorithm recorded a payload-size class
_algo_last: dict = {}


def gspmd_bytes() -> dict:
    """``{"wire": ..., "exact": ...}``: bytes one rank put on the wire for
    the quantized steps so far, and what the exact wire would have moved
    on the same schedules (``ops/compression.gspmd_wire_footprint``)."""
    return dict(_gspmd_bytes)


def gspmd_algorithms() -> dict:
    """The last algorithm a quantized step or an engine allreduce used, by
    payload-size class (``ops/adaptive.size_class`` of its f32 bytes)."""
    return dict(_algo_last)


def reset_accounting() -> None:
    _gspmd_bytes.update(wire=0, exact=0)
    _algo_last.clear()


def _note_algorithm(algorithm: str, total: int) -> None:
    """Record ``algorithm`` as the last one of the payload-size class of
    ``total`` f32 elements (the compiled plane's rounds and the engine's
    allreduces alike)."""
    _algo_last[adaptive.size_class(total * 4)] = algorithm


def _record_gspmd_wire(total: int, wire: str, world: int, block: int,
                       algorithm: str = "ring") -> None:
    hosts = mesh_hosts(world) if algorithm == "hier" else None
    _gspmd_bytes["wire"] += comp.gspmd_wire_footprint(
        total, wire, world, block, algorithm=algorithm, hosts=hosts)
    _gspmd_bytes["exact"] += comp.gspmd_wire_footprint(
        total, "none", world, block, algorithm=algorithm, hosts=hosts)
    _note_algorithm(algorithm, total)


# ------------------------------------------------------------ the step
def _flat_f32(tensors) -> torch.Tensor:
    parts = [t.reshape(-1).float() for t in tensors]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _write_split(flat: torch.Tensor, targets, add: bool = False) -> None:
    """``flat``'s elements into ``targets`` in order (``add``: added to
    them), each cast to its target's dtype."""
    off = 0
    for t in targets:
        n = t.numel()
        piece = flat[off:off + n].view(t.shape).to(t.dtype)
        t.add_(piece) if add else t.copy_(piece)
        off += n


def quantized_opt_state(optimizer: torch.optim.Optimizer, params,
                        zero1: bool = False, block: Optional[int] = None):
    """``(inner, ef)`` for the quantized step: ``ef`` the error-feedback
    residual, one f32 row of ``total_params`` for this rank, zeros; and
    ``inner`` the optimizer the step runs: ``optimizer`` itself, or with
    ``zero1=True`` a new one of its class over this rank's ring chunk of
    the flattened parameters (``optim/zero.flat_zero1_state``), for
    elementwise optimizers only."""
    params = list(params)
    size = _world()[0]
    total = sum(p.numel() for p in params)
    dev = params[0].device
    ef = torch.zeros(total, dtype=torch.float32, device=dev)
    if zero1:
        inner, _ = zero.flat_zero1_state(optimizer, total, size,
                                         _wire_block(block), device=dev)
    else:
        inner = optimizer
    return inner, ef


class _Step:
    """The body of one data-parallel step (the reference's ``step`` and
    ``_make_quantized_step.local_step``), eager: run per call, or once
    under a CUDA-graph capture."""

    def __init__(self, loss_fn, optimizer, params, zero1, wire, algorithm,
                 block):
        self.loss_fn, self.optimizer = loss_fn, optimizer
        self.params = params
        self.zero1, self.wire, self.block = zero1, wire, block
        self.algorithm = algorithm
        self.world, self.rank, self.backend = _world()
        self.total = sum(p.numel() for p in params)
        self.ef = None
        self.inner = optimizer
        if wire or zero1:
            self.inner, ef = quantized_opt_state(optimizer, params, zero1,
                                                 block)
            if wire:
                self.ef = ef
        self.chunk_param = (self.inner.param_groups[0]["params"][0]
                            if zero1 else None)
        self.resolved: dict = {}

    def sync_hyper(self) -> None:
        """ZeRO-1: the user's hyperparameters (an lr schedule) onto the
        flat optimizer, whose device lr tensor, if any, stays in place."""
        if not self.zero1:
            return
        dst = self.inner.param_groups[0]
        for k, v in self.optimizer.param_groups[0].items():
            if k == "params" or (k == "lr" and isinstance(dst.get(k),
                                                         torch.Tensor)):
                continue
            dst[k] = v

    def run(self, batch) -> torch.Tensor:
        for p in self.params:
            p.grad = None
        loss = self.loss_fn(*batch)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.zero1:
            self._zero1(grads)
        elif self.wire:
            self._quantized(grads)
        else:
            if self.world > 1:
                reduced = allreduce(_flat_f32(grads), Average)
                _write_split(reduced, grads)
            for p, g in zip(self.params, grads):
                p.grad = g
            self.optimizer.step()
        return pmean(loss.detach().float())

    def _corrected(self, grads):
        """(corrected gradient, new residual) of the quantized step."""
        corrected = _flat_f32(grads) + self.ef
        if self.zero1 or _wire_eligible(self.total, corrected.dtype,
                                        self.wire, self.block):
            new_ef = corrected - _wire_roundtrip(corrected, self.wire,
                                                 self.block)
        else:
            new_ef = torch.zeros_like(self.ef)
        return corrected, new_ef

    def _resolved(self) -> str:
        """The algorithm of this payload, resolved once (``"auto"`` may
        follow a tuner's later broadcast; the step and its accounting keep
        the first answer), the ring under ZeRO-1 (its chunks are the
        state's shards)."""
        return self.resolved.setdefault(
            self.total, "ring" if self.zero1 else resolve_algorithm(
                self.total, self.world, self.algorithm))

    def _quantized(self, grads) -> None:
        corrected, new_ef = self._corrected(grads)
        reduced = _ALLREDUCE[self._resolved()](corrected, Average, self.wire,
                                               self.block)
        _write_split(reduced, grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        self.ef.copy_(new_ef)

    def _zero1(self, grads) -> None:
        n, block = self.world, self.block
        if self.wire:
            corrected, new_ef = self._corrected(grads)
            g_chunk = _mean(quantized_reduce_scatter(corrected, self.wire,
                                                     block), n)
        else:
            chunk = zero.ring_chunk(self.total, n, block)
            flat = _pad_to(_flat_f32(grads), n * chunk)
            g_chunk = (reduce_scatter(flat) / n if n > 1 else flat)
        chunk = g_chunk.numel()
        p_flat = _pad_to(_flat_f32(self.params), n * chunk)
        p_chunk = p_flat[self.rank * chunk:(self.rank + 1) * chunk]
        shadow = self.chunk_param
        with torch.no_grad():
            shadow.copy_(p_chunk)
        shadow.grad = g_chunk
        self.inner.step()
        with torch.no_grad():
            if self.wire:  # the update rides the quantized ring
                upd = quantized_all_gather(shadow - p_chunk, self.wire,
                                           block)[:self.total]
                _write_split(upd, [p.data for p in self.params], add=True)
                self.ef.copy_(new_ef)
            else:  # the new parameters, gathered exactly
                new = allgather(shadow.detach()) if n > 1 else shadow
                _write_split(new[:self.total], [p.data for p in self.params])

    def account(self) -> None:
        """The quantized step's byte and algorithm accounting (on the host,
        after each step)."""
        if self.wire:
            _record_gspmd_wire(self.total, self.wire, self.world, self.block,
                               self._resolved())


#: eager steps a capture runs first: the first makes the lazily made state
#: (momentum, moments), the second takes the steady-state path a replay takes
_CAPTURE_WARMUP = 2


class TrainStep:
    """``step(*batch) -> loss``: :func:`make_train_step`'s result.
    ``graphed`` says whether it runs as a CUDA graph; ``ef`` is the
    error-feedback residual (None on the exact wire); ``inner`` the
    optimizer the step runs (the flat chunk's under ZeRO-1);
    ``launches_per_replay`` the kernel launches one replay makes."""

    def __init__(self, core: _Step, graph: bool, module):
        self.core, self.graphed = core, graph
        self.module = module
        self.graph = None
        self.launches_per_replay: dict = {}
        self._static = None
        self._loss = None
        self._lr = {}        # group index -> device lr tensor
        self._frozen = None  # hyperparameters a capture froze
        self._storage = None

    @property
    def ef(self):
        return self.core.ef

    @property
    def inner(self):
        return self.core.inner

    def zero1_state_numel(self) -> int:
        """Elements of the ZeRO-1 optimizer's state on this rank."""
        return zero.state_numel(self.core.inner)

    def __call__(self, *batch) -> torch.Tensor:
        if not self.graphed:
            self.core.sync_hyper()
            loss = self.core.run(batch)
            self.core.account()
            return loss
        if self.graph is None:
            self._capture(batch)
        else:
            if (len(batch) != len(self._static) or any(
                    b.shape != s.shape or b.dtype != s.dtype
                    for b, s in zip(batch, self._static))):
                raise ValueError(
                    "the graphed step takes the shapes and dtypes it was "
                    "captured with: "
                    f"{[(tuple(s.shape), s.dtype) for s in self._static]}")
            for s, b in zip(self._static, batch):
                s.copy_(b, non_blocking=True)
        self._check_storage()
        self._before_replay()
        self.graph.replay()
        ck.add_launches(self.launches_per_replay)
        self.core.account()
        return self._loss.clone()

    # ------------------------------------------------------------ capture
    def _hyper(self):
        return [{k: v for k, v in g.items()
                 if k != "params" and not isinstance(v, torch.Tensor)}
                for g in self.core.inner.param_groups]

    def _install_lr(self) -> None:
        """A device lr tensor for each group whose optimizer reads one on
        the card (``capturable`` or ``fused`` torch optimizers), so a
        replay takes the lr set before it."""
        opt = self.core.inner
        if isinstance(opt, FusedAdamW):
            return  # stages its own scalars (prepare_replay)
        for i, g in enumerate(opt.param_groups):
            if g.get("capturable") or g.get("fused"):
                dev = g["params"][0].device
                t = torch.tensor(float(g["lr"]), dtype=torch.float32,
                                 device=dev)
                self._lr[i] = t
                g["lr"] = t

    def _before_replay(self) -> None:
        """The lr of the step a replay takes, and a check that nothing the
        capture froze has changed."""
        self.core.sync_hyper()
        opt = self.core.inner
        src = self.core.optimizer.param_groups
        for i, t in self._lr.items():
            want = src[i if not self.core.zero1 else 0]["lr"]
            if want is not t:
                t.fill_(float(want))
                opt.param_groups[i]["lr"] = t
                if not self.core.zero1:
                    src[i]["lr"] = t
        live = isinstance(opt, FusedAdamW)  # its lr reaches each replay
        now = self._hyper()
        for i, (a, b) in enumerate(zip(self._frozen, now)):
            changed = sorted(k for k in a if a[k] != b.get(k)
                             and not (k == "lr" and (live or i in self._lr)))
            if changed:
                raise RuntimeError(
                    f"the graphed step froze {changed} of parameter group "
                    f"{i} at capture; build the step again (an lr that "
                    "changes needs a capturable or fused optimizer)")
        if isinstance(opt, FusedAdamW):
            opt.prepare_replay()

    def _state_tensors(self):
        out = []
        for opt in {id(o): o for o in (self.core.optimizer,
                                       self.core.inner)}.values():
            for st in opt.state.values():
                out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return out

    def _pointers(self):
        ts = list(self.core.params) + self._state_tensors()
        if self.core.ef is not None:
            ts.append(self.core.ef)
        return [t.data_ptr() for t in ts]

    def _check_storage(self) -> None:
        if self._pointers() != self._storage:
            raise RuntimeError(
                "the graphed step's parameters or optimizer state changed "
                "storage since capture (a replay would use stale "
                "addresses); build the step again")

    def _snapshot(self):
        """Copies of what the warm-up steps change: parameters, the
        module's buffers, the optimizers' state and the residual."""
        tensors = list(self.core.params)
        if self.module is not None:
            tensors += list(self.module.buffers())
        if self.core.ef is not None:
            tensors.append(self.core.ef)
        saved = [(t, t.detach().clone()) for t in tensors]
        states = {}
        for opt in (self.core.optimizer, self.core.inner):
            for p, st in opt.state.items():
                states[(id(opt), p)] = {
                    k: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in st.items()}
        return saved, states

    def _restore(self, snap) -> None:
        """Back to the snapshot, in place; state the warm-up made is set to
        the zeros it starts from (a fresh optimizer's state)."""
        saved, states = snap
        with torch.no_grad():
            for t, v in saved:
                t.copy_(v)
            for opt in (self.core.optimizer, self.core.inner):
                for p, st in opt.state.items():
                    old = states.get((id(opt), p))
                    for k, v in list(st.items()):
                        if old is not None and k in old:
                            if isinstance(v, torch.Tensor):
                                v.copy_(old[k])
                            else:
                                st[k] = old[k]
                        elif isinstance(v, torch.Tensor):
                            v.zero_()
                        elif isinstance(v, (int, float)):
                            st[k] = type(v)(0)

    def _capture(self, batch) -> None:
        dev = self.core.params[0].device
        if any(not isinstance(b, torch.Tensor) or b.device != dev
               for b in batch):
            raise ValueError(f"the graphed step takes tensors on {dev}")
        self._static = [b.clone() for b in batch]
        opt = self.core.inner
        if isinstance(opt, FusedAdamW) and not all(
                g.get("capturable") for g in opt.param_groups):
            raise ValueError("a graphed step needs "
                             "FusedAdamW(capturable=True)")
        if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)) and not all(
                g.get("capturable") for g in opt.param_groups):
            raise ValueError(f"a graphed step needs torch.optim."
                             f"{type(opt).__name__}(capturable=True)")
        self._install_lr()
        snap = self._snapshot()
        # warm-up on a side stream, as PyTorch's whole-network capture
        # does: every launcher binds its thread's context and encodes its
        # tensor maps here, and lazily made state (momentum, moments, the
        # scalar buffers) exists before the capture
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_CAPTURE_WARMUP):
                self.core.sync_hyper()
                self.core.run(self._static)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self._restore(snap)
        del snap
        self._frozen = self._hyper()
        for p in self.core.params:  # gradients made in the graph's pool
            p.grad = None
        before = ck.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._loss = self.core.run(self._static)
        except Exception as e:
            raise RuntimeError(f"capturing the train step as a CUDA graph "
                               f"failed: {e}") from e
        after = ck.launch_counts()
        self.launches_per_replay = {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}
        # the capture launched nothing; each replay adds its launches
        ck.add_launches({k: -v for k, v in self.launches_per_replay.items()})
        self.graph = graph
        self._storage = self._pointers()


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                    params=None, *, zero1: bool = False,
                    compression: Optional[str] = None,
                    algorithm: Optional[str] = None,
                    graph: Optional[bool] = None) -> TrainStep:
    """The data-parallel train step (the reference's bench hot loop).

    ``loss_fn(*batch) -> scalar loss`` on this rank's batch, computed with
    ``params`` (an ``nn.Module``, whose buffers a capture's warm-up also
    restores, or a list of parameters; default: the optimizer's).
    ``optimizer`` a torch optimizer over them. Returns ``step(*batch) ->
    loss`` (the mean over ranks); each call zeroes the gradients, runs the
    forward and backward, averages the gradients over the ranks and steps
    the optimizer.

    ``compression``: the wire (``"int8"`` / ``"int4"``; None reads
    ``HOROVOD_GSPMD_WIRE``, ``"off"`` the exact wire). On a quantized wire
    the flat f32 gradient plus this rank's error-feedback residual rides
    the quantized allreduce of ``algorithm`` (``"ring"`` / ``"tree"`` /
    ``"hier"`` / ``"auto"``; None reads ``HOROVOD_GSPMD_ALGO``), and the
    residual becomes ``corrected - roundtrip(corrected)``, as in the
    reference (at world 1 too, where the wire is not crossed and the
    residual is carried all the same).

    ``zero1=True``: the flat gradient is reduce-scattered (quantized ring,
    or exact), the optimizer (SGD, Adam, AdamW or FusedAdamW; others
    raise) runs on this rank's ring chunk with 1/N of the state, and the
    update is all-gathered: quantized deltas on a wire, the new parameters
    exactly otherwise.

    ``graph``: None runs as a CUDA graph at world 1 on the card and eagerly
    otherwise; True demands the graph and raises on the CPU and at world >
    1 (gloo's host staging is not capturable); False is eager. The first
    call captures: two eager steps on a side stream (the launchers
    bind their contexts, lazily made state appears), the parameters,
    buffers, optimizer state and residual restored, then the capture; a
    failure raises, and nothing falls back to the eager step. Under the
    graph: Adam / AdamW need ``capturable=True`` and FusedAdamW
    ``capturable=True``; an lr set on the optimizer between calls reaches
    the replay for those and for ``fused`` optimizers, while a change to
    anything else the capture froze raises, as does a parameter or state
    tensor that changed storage. Use autocast with ``cache_enabled=False``
    in ``loss_fn``.
    """
    size, _, _ = _world()
    wire = gspmd_wire(compression)
    algo = gspmd_algo(algorithm)
    blk = _wire_block(None)
    module = params if isinstance(params, torch.nn.Module) else None
    if module is not None:
        plist = [p for p in module.parameters() if p.requires_grad]
    elif params is not None:
        plist = list(params)
    else:
        plist = [p for g in optimizer.param_groups for p in g["params"]]
    if not plist:
        raise ValueError("make_train_step: no parameters")
    if zero1:
        zero.check_elementwise(optimizer)
    dev = plist[0].device
    if graph is None:
        graph = dev.type == "cuda" and size == 1
    elif graph:
        if dev.type != "cuda":
            raise ValueError("make_train_step(graph=True) needs the "
                             f"parameters on a CUDA device, not {dev}")
        if size > 1:
            raise ValueError(
                f"make_train_step(graph=True) captures at world 1 only; at "
                f"world {size} the collectives ({basics.backend()}) run "
                "eagerly")
    core = _Step(loss_fn, optimizer, plist, zero1, wire, algo, blk)
    return TrainStep(core, bool(graph), module)
