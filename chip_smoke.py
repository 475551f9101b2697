#!/usr/bin/env python3
"""Drive horovod_tpu_torch on one NVIDIA GPU (an H100) and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels of ``horovod_tpu_torch/csrc`` (``wire_quant.cu``, ``adasum.cu``,
``flash_attention.cu``, ``flash_attention_sm90.cu``, ``layer_norm.cu``,
``adamw.cu`` and ``matmul.cu``, one ``nvcc`` each, all at once, into
``build/torch_kernels/``), then:

1. holds each wire kernel against its plain-PyTorch twin on the card, byte
   for byte, at the main-path shape (the flat ResNet-50 gradient as
   ``[rows, 256]``) and at ragged shapes, and the int8 quantize's many-leaf
   launch (``int8_quantize_2d_many``) over ResNet-50's 161 leaves and five
   edge leaves (a ragged one, an all-zero one, one with a NaN, a bf16
   pair) against its twin and against the quantize of each leaf; times
   kernel and twin, with each kernel's device time, and the many-leaf
   launch against the 161 per-leaf launches;
1b. holds the Adasum combine kernel against its twin on the card, to the
   stated tolerance (the two reduce in different orders), at the largest
   ResNet-50 leaf ``[1, 2359296]`` and a world-8 tree level
   ``[4, 2359296]`` (f32), a ragged row, bf16, f16, a zero row and a NaN
   row; checks that two launches on the same inputs are byte-equal; and
   times kernel and twin (device times also with L2 flushed before each
   call); then the grouped combine (``adasum_combine_pairs_many``) over
   ResNet-50's 161 leaves as world-2 tree levels: one launch, each leaf's
   bits equal to its own single-pair call, within the tolerance of the
   twin, two launches byte-equal; timed against 161 single-pair calls;
2. trains ResNet-50 at full width (batch 256, 224x224, bf16 autocast) at
   world size 1 through ``DistributedOptimizer(int8, error_feedback=True)``,
   whose error-feedback roundtrip runs the int8 quantize over every
   gradient leaf in one launch, and the dequantize once, each step (the
   check: at least one and at most a leaf table's worth of launches of
   each a step); measures the same step without compression and profiles
   two steps (the wire kernels' device time); and checks a small model
   against the same training on the CPU;
2d. trains ResNet-50 at world size 1 (phase 2's batch) through the
   compiled plane, ``spmd.make_train_step``, as a CUDA graph and eagerly,
   on the exact and the int8 wire (the error-feedback roundtrip: one #1
   and one #2 a replay), beside phases 2 / 2c's engine-plane images/s,
   holds the graphed losses to the eager ones, and profiles two graphed
   steps (the card's busy share);
3. trains ResNet-50 at world size 2 (two gloo processes sharing the card) on
   the packed int8 wire and then the int4 wire, and checks that the
   parameters are bit-identical on both ranks;
3c. runs the compiled plane's allreduces (the quantized ring, the tree and
   the two-level schedule, on 2 hosts at world 4) over ResNet-50's flat
   gradient (25,557,032 f32 values a rank, seeded) at world size 2 and 4
   (gloo, one card) on the int8, int4 and exact wires: bit-identical ranks,
   the error against the exact mean within the reference's bounds, the
   bytes the hops sent equal to ``gspmd_wire_footprint``'s;
3d. trains ResNet-50 at world size 2 (batch 32 a rank, 1 + 2 steps)
   through ``make_train_step(compression="int8")`` with and without ZeRO-1:
   parameters bit-identical across ranks, the ZeRO-1 state 1/2 a rank,
   losses and final parameters within stated tolerances of each other;
3b. drives the collective engine: at world size 1 (before phase 3, in
   the script's process) ResNet-50's 161 gradient-shaped tensors, written
   after a long spin of the current stream, go through ``allreduce_async_``
   (a poll at once, the responses the engine fuses them into, the values
   after ``synchronize``); then ResNet-50 at world size 2 (batch 32 per
   rank, 224x224, 1 warm-up and 2 steps, cuDNN deterministic) through the
   backward hooks, per tensor and with 25 MiB buckets
   (``HOROVOD_BUCKET_MB``): (a) the exact wire, bit-identical across ranks
   and between the two; (b) int8 with error feedback, ranks bit-identical
   and at most one grouped #1 plus two a bucket a step; (c) Adasum, ranks
   and the two bit-identical, K4 once a step per tensor (one batch) and at
   most once a bucket bucketed; each with host ms and responses a step;
3e. drives the engine's other programs at world size 4 (gloo, one card),
   grouped 2 hosts x 2 (``HVD_UNIFORM_LOCAL_SIZE=2``): ResNet-50 (batch 32
   a rank, 224x224, 1 warm-up and 2 steps) through the hooks in 25 MiB
   buckets under (a) ``HOROVOD_HIERARCHICAL_ALLREDUCE=1``, (b)
   ``HOROVOD_GSPMD_ALGO=tree``, (c) ``Compression.int8_dcn`` and (d)
   ``Compression.adaptive`` (``HOROVOD_ADAPTIVE_INTERVAL=1``), both with
   error feedback: parameters bit-identical on the four ranks, the
   configured algorithm and wire (under (d) each rank's sequence of wire
   modes, the same on all), the last request's bytes equal to the
   reference's accounting, and the wire kernels launched where the path
   quantizes (under (c) the quantized sums run on the cross-host group
   only); then ResNet-50's flat gradient (25,557,032 f32 values a rank,
   seeded) through the two-level, tree, bf16, int8-dcn and adaptive int4
   programs: ranks bit-identical, the error against the exact mean within
   the reference's bounds, the bytes as accounted;
4. trains ResNet-50 at world size 2 (batch 32 per rank, 224x224) for 2
   steps through ``DistributedOptimizer(op=Adasum)`` -- each step's 161
   deltas enqueued in one batch of the engine and combined in one grouped
   launch of the Adasum kernel -- and checks bit-identical parameters,
   exactly one launch a step and finite losses; then runs the Adasum dry
   run (257 f32 values per rank, plain and through fp16) against the numpy
   oracle; 4c times one step's combine alone, eager (one allreduce a leaf)
   and as the delta flow runs it (one batch, one grouped launch);
4b. trains a ResNet-18 of width 8 at world size 4 (32x32, batch 4 per
   rank, 2 steps of Adasum: a two-level tree, one grouped launch a level)
   and checks bit-identical parameters on all four ranks and exactly two
   launches a step;
5. checks that the SASS of the wgmma / TMA attention kernels (K5, the
   ring step K6 and K7 for bf16 at D = 64, ``flash_attention_sm90.cu``)
   holds HGMMA and UTMALDG and prints its HGMMA, UTMALDG and UTMASTG
   counts; holds the LM kernels against
   their twins on the card, to the stated tolerances: flash attention
   forward K5 and backward K7 (bf16 and f32, causal or not, head dims
   32/64/128, T = 1000, BH = 1, offsets, the strided q/k/v views of the
   model's qkv projection; K7 also with f32
   outputs, and two K7 launches byte-equal), LayerNorm K8 ([8192, 1024]
   bf16, the register pass's other widths and the general loop's ragged
   and wide ones) and AdamW K9 (the 292 leaves of GPT-2-medium and odd lengths, mu
   in bf16 and f32, steps 1 and 10); and times kernel, twin and the one
   PyTorch call that computes the same function (K7 also as the autograd
   function calls it, making D = rowsum(dO * O) in its dq kernel, against
   SDPA's backward, which makes its own; K8 also as ``fused_layer_norm``
   calls it, against ``F.layer_norm`` with gamma and beta already in x's
   dtype);
5b. trains GPT-2-medium (24 layers, d_model 1024, 16 heads, vocab 32768,
   seq 1024, batch 8, bf16) at world size 1 for 2 warm-up and 5 timed
   steps, in the default configuration (K5, K7) and with the fused
   LayerNorm and AdamW (K5, K7, K8, K9), checks the launches per step, and
   profiles two steps;
5e. trains GPT-2-medium at world size 1 through the compiled plane as a
   CUDA graph, default (K5, K7) and fused (K8 x49 and K9 x1 a replay, K9
   reading its scalars from the card), beside 5b's tokens/s and MFU;
   checks the graphed step against the eager one for 3 steps with the lr
   changing each step, and profiles two graphed steps; phase 5 also times
   K8 and K5 replayed in a CUDA graph of their own call;
5c. checks a 2-layer LM trained on the card against the same training on
   the CPU;
5d. trains the medium widths at 2 layers on world size 2 (two gloo
   processes sharing the card) and checks bit-identical parameters;
6. holds the ring-attention kernels against their twins on the card: K6
   (``flash_attention_step``) and K7 with f32 outputs at hop offsets, on
   the three hops of a causal ring (below the diagonal, on it, and above it,
   where K6 leaves the carry bit for bit and K7 gives exact zeros) at the
   long-context hop shape ``[1, 4096, 16, 64]`` bf16 and in f32 at D = 128
   and a ragged T; K6 with 16384 keys and K7 at 17408 rows at BH = 1; K5
   and K7 (bf16 outputs) at Ulysses's shape ``[1, 16384, 4, 64]``; and
   times K6 and K7 against their bounds;
6b. runs ring and Ulysses attention on world size 4 (gloo, one card) over a
   ``[1, 16384, 16, 64]`` bf16 sequence, forward and backward, against
   K5/K7 on the whole sequence, with the launches per rank;
6c. trains GPT-2-medium widths at 2 layers on a dp=1 x sp=4 grid over a
   16384-token sequence for 2 steps through ``make_sp_train_step`` (8 K6
   and 8 K7 launches a step a rank) and checks bit-identical parameters
   and agreement with one world-1 step on the whole sequence, whose
   attention is PyTorch's own; times a ring hop, the gradient allreduce
   and the step's gradient mean per tensor and in 25 MiB buckets;
6d. does the same at medium widths, 2 layers, on a dp=2 x sp=2 grid with a
   global batch of 2 x 4096;
7. checks that the SASS of K10's bf16 kernels (``matmul.cu``) holds
   HGMMA, UTMALDG and UTMASTG (wgmma, TMA loads and stores); holds the
   matmul kernel K10 (``matmul_2d``) against its twin on the
   card, to the stated tolerance: the fused matmul + reduce-scatter ring's
   chunks at GPT-2-medium widths and tp = 4 (the row-parallel MLP
   ``[2048, 1024] @ [1024, 1024]`` and the LM head ``[2048, 256] @ [256,
   32768]``, bf16), f32, shapes of several tiles in M, K and N, M = 8, and
   M = 520 on each of the bf16 kernel's two schedules (B resident, or A
   and B streamed);
   checks two launches byte-equal; times kernel, twin and ``torch.matmul``
   (run right after phase 5, early in the process);
7b. runs ``matmul_reduce_scatter`` on world size 4 (gloo, one card) at
   those chunks' full operands, ``x [8192, 1024] @ w [1024, 1024]`` and
   ``x [8192, 256] @ w [256, 32768]`` bf16, different on every rank: rank
   p's chunk against the f64 dense sum, the unfused reference (two faulted
   rings, one missing a partial and one adding in float8, must fail the
   same bound), 4 K10 launches a call a rank, and the time of a call;
7c. trains GPT-2-medium widths at 2 layers on a dp=1 x tp=4 grid, global
   batch 8 x 1024, for 2 steps through ``make_tp_train_step`` (2 K5 and 2
   K7 launches a step a rank, on a rank's 4 heads) and checks replicated
   parameters bit-identical on all ranks and agreement with one world-1
   step, whose attention is PyTorch's own; peak memory a rank;
7d. does the same for the 3D hybrid on a dp=2 x tp=2 x sp=2 grid (8
   processes), medium widths, 2 layers, global batch 2 x 4096, through
   ``make_hybrid_train_step`` (ring attention: K6 / K7), each tensor shard
   bit-identical on the ranks that hold it.

8a. trains lm_bench's Switch-MoE block (``train.synthetic_moe_train``:
   embed, top-1 routed expert MLP, tied head; d_model 1024, 4x hidden,
   vocab 32768, 8 experts, 65,536 tokens a step, f32, Adam) at world size 1,
   exact dispatch and capacity at CF 8, 2 + 3 steps each (the exchange is
   the exact all_to_all at ep = 1), the first step's MoE output and loss
   of the two held to each other;
8b. runs the same block on a dp=2 x ep=2 grid (4 gloo processes sharing
   the card): the quantized all_to_all at the step's ``[E, C, d]`` payload
   against the exact exchange and its packed rows (#3, #4) against the
   twin's; exact, capacity, capacity-int8 and capacity-int4 dispatch (CF
   1.25), 1 + 2 steps each, and capacity at CF 8 for one step: replicated
   parameters bit-identical on all ranks and each expert shard on its dp
   replicas, the error-feedback residual nonzero both ways, the hops'
   bytes a step equal to ``moe_wire_footprint``, the wire kernels' launches
   a step a rank (counters and a traced step), the CF-8 loss against exact
   and 8a's;
8c. trains GPT-2-medium's 24 blocks as a GPipe pipeline of 4 stages of 6
   on pp = 4 (gloo, one card), batch 8 x 1024, bf16, 8 microbatches, 2
   AdamW steps (66 K5 and 66 K7 launches a step a rank), the embedding and
   tied head on every rank; the first step's loss and every gradient held
   to the 24 blocks run in sequence in one process.
Phases 8a-8c run first, while the script's own process holds almost
nothing on the card.

9a. trains VGG-16 (138,357,544 parameters; its first dense kernel holds
   102.76M) at world size 1, batch 128, 224x224, bf16 autocast,
   channels_last, through ``DistributedOptimizer`` with int8 and error
   feedback (2 warm-up and 5 timed steps, one grouped #1 and one #2 a step
   over its 32 leaves), then without compression: images/s, ms a step,
   peak memory; one more step's error-feedback residual of every leaf held
   bit for bit to the plain roundtrip, and #1 / #2 to their twins at the
   102.76M-element leaf;
9b. does the same for Inception V3 (batch 128, 299x299, 284 leaves: two
   #1 launches a step, one #2), and takes one graphed step of the
   compiled plane against the eager first step's loss;
9c. holds VGG (a short cfg at 64x64), Inception V3 (139x139, in f64) and
   MNISTConvNet (28x28) trained 3 steps with int8 error feedback on the
   card against the same training on the CPU, TF32 off;
9d. trains GPT-2-medium (5b's widths, fused LayerNorm and AdamW) under
   ``remat`` none, full and dots: ms a step, tokens/s, peak memory, the
   launches a step (K5 24 or 48, K7 24, K8 49 or 97, K9 1), dots' first
   loss and gradients bit-equal to none's, peak memory full < dots < none;
9e. writes an image folder (4 classes, 512 uint8 ``.npy`` images at
   224x224, and 8 PNGs where PIL is installed) and trains ResNet-50 on it
   at world size 2 (two gloo processes on the card) through
   ``ShardedImageFolder`` (batch 32 a rank, 2 epochs), ``DistributedOptimizer``
   on the packed int8 wire with error feedback, and the broadcast, warmup
   and metric-average callbacks: disjoint shards covering each epoch,
   reshuffled by ``set_epoch``, parameters bit-identical after each epoch,
   the averaged metric equal on both ranks, the reference's warmup lr at
   every batch.

``--fault skip-hop`` or ``--fault shift-k-off`` breaks ring attention on
purpose and runs phases 6c and 6d only; ``--fault drop-tp-reduce`` makes
block 0's row-parallel mlp_out skip its sum over tp and runs phases 7c and
7d only; ``--fault flip-byte`` flips one byte of one hop of every case of
phase 3c and runs that phase only; ``--fault zero1`` runs phase 3d's
ZeRO-1 step with its gradient not averaged, then with its optimizer step
skipped; ``--fault moe-skip-dp-sum`` (expert gradients not summed over
dp) and ``--fault a2a-swap-peers`` (the packed exchange delivers two
peers' rows swapped) run phase 8b only, ``--fault pipe-skip-stage``
(stage 0's output skips stage 1) phase 8c only. Each shows that the
phases' agreement
checks fail a wrong program: it exits 0 when every phase (or case) fails
them. ``--fault dots-save-none`` (``remat="dots"`` keeps no product) runs
phase 9d only and ``--fault shard-overlap`` (both ranks read rank 0's
shard) phase 9e only; there the phase's failed check exits non-zero.

Exits non-zero, with no result line, when a phase fails or no CUDA device
is present. The last line of standard output is
``{"ok": true, "device": {...}}``; before it come the card's name and power
limit and a ``{"kernels": [...]}`` line. ``--report PATH`` also writes
the full report (every phase's numbers) to PATH as JSON.
"""

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import get_context

import torch

BLOCK = 256
LIBRARIES = ("wire_quant", "adasum", "flash_attention", "flash_attention_sm90",
             "layer_norm", "adamw", "matmul")
SOURCE = "horovod_tpu_torch/csrc/wire_quant.cu"
ADASUM_SOURCE = "horovod_tpu_torch/csrc/adasum.cu"
REPLACES = {
    "int8_quantize_2d": "horovod_tpu/ops/pallas_kernels.py:1578",
    "int8_dequantize_2d": "horovod_tpu/ops/pallas_kernels.py:1596",
    "int8_quantize_pack_2d": "horovod_tpu/ops/pallas_kernels.py:1637",
    "int4_quantize_pack_2d": "horovod_tpu/ops/pallas_kernels.py:1728",
    "adasum_combine_pairs": "horovod_tpu/ops/pallas_kernels.py:1366",
    "flash_attention_fwd": "horovod_tpu/ops/pallas_kernels.py:339",
    "flash_attention_bwd": "horovod_tpu/ops/pallas_kernels.py:923, "
                           "horovod_tpu/ops/pallas_kernels.py:986, "
                           "horovod_tpu/ops/pallas_kernels.py:1084",
    "flash_attention_step": "horovod_tpu/ops/pallas_kernels.py:497, "
                            "horovod_tpu/ops/pallas_kernels.py:457",
    "layer_norm_fwd": "horovod_tpu/ops/pallas_kernels.py:1489",
    "adamw_update": "horovod_tpu/optim/fused.py:86",
    "matmul_2d": "horovod_tpu/ops/pallas_kernels.py:1819",
}
WIRE = ("int8_quantize_2d", "int8_dequantize_2d", "int8_quantize_pack_2d",
        "int4_quantize_pack_2d")
# profiler names of #1's kernels: the register path's tile kernel (which
# #3 shares) and the general loop
WIRE_Q = ("int8_quant_tiles", "int8_quant_rows")
LM_SOURCES = {  # the source of the kernels the main path launches
    "flash_attention_fwd": "horovod_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_bwd": "horovod_tpu_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_step": "horovod_tpu_torch/csrc/flash_attention_sm90.cu",
    "layer_norm_fwd": "horovod_tpu_torch/csrc/layer_norm.cu",
    "adamw_update": "horovod_tpu_torch/csrc/adamw.cu",
}
RESNET50_LEAVES = 161  # gradient leaves of ResNet-50
ADASUM_N = 2359296     # the largest ResNet-50 leaf (a layer4 3x3 conv)
# Adasum kernel against its twin: |kernel - twin| <= ADASUM_RTOL * the
# pair's scale max_j |ac a_j| + |bc b_j|, plus one unit in the last place
# of the element for bf16 / f16 outputs (a rounding the reduction order
# can flip)
ADASUM_RTOL = 4e-6
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
# Device memory rate by card name (NVIDIA data sheets), bytes/s.
MEMORY_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
               ("H100", 3.35e12))
F32_RATE = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
CARD = ""  # the nvidia-smi name and power limit line, set by main()
T0 = time.perf_counter()  # the log's clock: seconds since this process began


def log(*a):
    print(f"[{time.perf_counter() - T0:7.1f} s]", *a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median time of one call, each timed by its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():  # compare bits: NaN == NaN, -0 != 0
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return bool(torch.equal(a, b))


def resnet50_gradient_rows() -> int:
    """Rows of the flat ResNet-50 gradient as [rows, 256], each leaf padded
    to whole blocks as the error-feedback roundtrip pads it."""
    from horovod_tpu_torch.models import resnet

    net = resnet.ResNet50()
    return sum(-(-p.numel() // BLOCK) for p in net.parameters())


def gradient_like(rows: int, block: int, gen: torch.Generator,
                  dtype=torch.float32) -> torch.Tensor:
    """Normal rows with per-row magnitudes spread over six decades, one
    all-zero row and one row of exact .5 ties (absmax 127 gives scale 1)."""
    x = torch.randn(rows, block, generator=gen, device="cuda")
    mag = torch.pow(10.0, torch.rand(rows, 1, generator=gen, device="cuda")
                    * 6 - 4)
    x = x * mag
    x[0] = 0
    if rows > 1 and block >= 8:
        x[1] = 0
        x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -127.0])
    return x.to(dtype).contiguous()


def resnet50_leaves(gen: torch.Generator) -> list:
    """Seeded normal values in the shape of each ResNet-50 gradient leaf,
    f32 on the card."""
    from horovod_tpu_torch.models import resnet

    return [torch.randn(p.shape, generator=gen, device="cuda")
            for p in resnet.ResNet50().parameters()]


def wire_edge_leaves(gen: torch.Generator) -> list:
    """Leaves that a step's gradients do not show at the main shape: one
    that is not a whole number of blocks, an all-zero one, one with a NaN
    (f32), and a bf16 group (one of them a whole block), the first bf16
    leaf between f32 ones (rows the f32 launch does not own)."""
    ragged = torch.randn(4 * BLOCK + 77, generator=gen, device="cuda")
    zero = torch.zeros(3 * BLOCK + 17, device="cuda")
    nan = torch.randn(700, generator=gen, device="cuda")
    nan[333] = float("nan")
    bf16 = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
            for n in (2 * BLOCK + 1, BLOCK)]
    return [ragged, bf16[0], zero, nan, bf16[1]]


def check_grouped_quantize(ck, leaves) -> tuple:
    """The grouped #1 over ``leaves`` against its twin (every scale bit for
    bit, and every q byte of the rows whose scale is not NaN: the twin's
    int8 of NaN is undefined) and against #1 on each leaf padded by hand
    (every byte); and its launches (one per dtype and table-full). Returns
    (ok, max |q - twin|, launches)."""
    import torch.nn.functional as F

    before = ck.launch_counts()["int8_quantize_2d"]
    q, s = ck.int8_quantize_2d_many(leaves, BLOCK)
    launches = ck.launch_counts()["int8_quantize_2d"] - before
    qt, st = ck.int8_quantize_2d_many_plain(leaves, BLOCK)
    keep = ~torch.isnan(st[:, 0])
    ok = bits_equal(s, st) and bool(torch.equal(q[keep], qt[keep]))
    err = float((q[keep].int() - qt[keep].int()).abs().max())
    row = 0
    for t in leaves:
        rows = -(-t.numel() // BLOCK)
        qi, si = ck.int8_quantize_2d(F.pad(
            t.reshape(-1), (0, rows * BLOCK - t.numel())).reshape(rows, BLOCK))
        ok = (ok and bits_equal(q[row:row + rows], qi)
              and bits_equal(s[row:row + rows], si))
        row += rows
    per_table = ck._kernel("hvd_int8_table_leaves")[1]()
    want = sum(-(-sum(1 for t in leaves if t.dtype == dt) // per_table)
               for dt in {t.dtype for t in leaves})
    return ok and row == q.shape[0] and launches == want, err, launches


# --------------------------------------------------------------- phase 1
def phase_kernels(rate: float) -> dict:
    from horovod_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = resnet50_gradient_rows()
    shapes = [(rows, BLOCK, torch.float32), (1, BLOCK, torch.float32),
              (5, 100, torch.float32), (64, BLOCK, torch.bfloat16)]
    checks = {name: [] for name in WIRE}
    for r, b, dt in shapes:
        x = gradient_like(r, b, gen, dt)
        q, s = ck.int8_quantize_2d(x)
        qp, sp = ck.int8_quantize_2d_plain(x)
        checks["int8_quantize_2d"].append(
            ((r, b, str(dt)), bits_equal(q, qp) and bits_equal(s, sp),
             float((q.int() - qp.int()).abs().max())))
        y = ck.int8_dequantize_2d(qp, sp)
        yp = ck.int8_dequantize_2d_plain(qp, sp)
        checks["int8_dequantize_2d"].append(
            ((r, b, str(dt)), bits_equal(y, yp), float((y - yp).abs().max())))
        p = ck.int8_quantize_pack_2d(x)
        pp = ck.int8_quantize_pack_2d_plain(x)
        checks["int8_quantize_pack_2d"].append(
            ((r, b, str(dt)), bits_equal(p, pp),
             float((p.int() - pp.int()).abs().max())))
        p4 = ck.int4_quantize_pack_2d(x)
        pp4 = ck.int4_quantize_pack_2d_plain(x)
        checks["int4_quantize_pack_2d"].append(
            ((r, b, str(dt)), bits_equal(p4, pp4),
             float((p4.int() - pp4.int()).abs().max())))
    # a NaN row: only the scale is pinned (NaN), as in the reference
    xn = gradient_like(4, BLOCK, gen)
    xn[2, 17] = float("nan")
    _, sn = ck.int8_quantize_2d(xn)
    nan_ok = bool(torch.isnan(sn[2]).item()) and bits_equal(
        sn[[0, 1, 3]], ck.int8_quantize_2d_plain(xn)[1][[0, 1, 3]])
    # the grouped #1 over a step's leaves and the edge leaves
    leaves = resnet50_leaves(gen)
    grouped_ok, grouped_err, grouped_launches = check_grouped_quantize(
        ck, leaves + wire_edge_leaves(gen))
    checks["int8_quantize_2d"].append(
        (("many", len(leaves) + 5, BLOCK), grouped_ok, grouped_err))
    torch.cuda.synchronize()
    failed = [(k, shape) for k, cs in checks.items() for shape, ok, _ in cs
              if not ok]
    log(f"phase 1: kernel == plain on the card: {not failed} "
        f"(nan row scale pinned: {nan_ok}; grouped #1 over {len(leaves)} "
        f"ResNet-50 leaves + 5 edge leaves in {grouped_launches} launches "
        f"== twin and per-leaf #1: {grouped_ok})")
    if failed or not nan_ok:
        raise AssertionError(f"kernel differs from its plain twin: {failed}")

    x = gradient_like(rows, BLOCK, gen)
    q, s = ck.int8_quantize_2d_plain(x)
    n = rows * BLOCK
    # name: (kernel call, plain call, one PyTorch call computing the same
    # function or None, bytes, operations). Only the dequantize has such a
    # call (int8 * f32 promotes inside one multiply); no PyTorch call takes
    # a per-block absmax scale.
    work = {
        "int8_quantize_2d": (lambda: ck.int8_quantize_2d(x),
                             lambda: ck.int8_quantize_2d_plain(x), None,
                             4 * n + n + 4 * rows, 6 * n),
        "int8_dequantize_2d": (lambda: ck.int8_dequantize_2d(q, s),
                               lambda: ck.int8_dequantize_2d_plain(q, s),
                               lambda: torch.mul(q, s),
                               n + 4 * rows + 4 * n, n),
        "int8_quantize_pack_2d": (lambda: ck.int8_quantize_pack_2d(x),
                                  lambda: ck.int8_quantize_pack_2d_plain(x),
                                  None, 4 * n + rows * (BLOCK + 4), 6 * n),
        "int4_quantize_pack_2d": (lambda: ck.int4_quantize_pack_2d(x),
                                  lambda: ck.int4_quantize_pack_2d_plain(x),
                                  None, 4 * n + rows * (BLOCK // 2 + 4),
                                  6 * n),
    }
    if not bits_equal(torch.mul(q, s), ck.int8_dequantize_2d(q, s)):
        raise AssertionError("torch.mul(q, s) is not the dequantize")
    # each call launches one kernel: #1 and #3 share the register path's
    # tile kernel and have a general loop each
    match = {"int8_quantize_2d": WIRE_Q,
             "int8_dequantize_2d": ("int8_dequant",),
             "int8_quantize_pack_2d": ("int8_quant_tiles", "int8_quant_pack"),
             "int4_quantize_pack_2d": ("int4_quant_pack",)}
    out = {}
    for name, (kern, plain, library, nbytes, ops) in work.items():
        ms = cuda_ms(kern, 50)
        dev_ms = device_ms(kern, 20, match[name])
        plain_ms = cuda_ms(plain, 10)
        library_ms = cuda_ms(library, 10) if library else None
        bytes_ms = nbytes / rate * 1e3
        ops_ms = ops / F32_RATE * 1e3
        out[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": 0,
            "max_abs_err": max(e for _, _, e in checks[name]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "shape": [rows, BLOCK], "bytes": nbytes,
            "GBps": nbytes / ms / 1e6, "device_ms": dev_ms,
        }
        lib = f", library {library_ms:.4f} ms" if library else ""
        log(f"  {name}: [{rows}, {BLOCK}] f32 kernel {ms:.4f} ms (device "
            f"{dev_ms} ms), plain {plain_ms:.4f} ms{lib}, {nbytes} bytes, "
            f"bound {bytes_ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s) on {CARD}")
    # the grouped #1 against #1 on each leaf padded beforehand, at the 161
    # leaves of a ResNet-50 step
    padded = [torch.nn.functional.pad(t.reshape(-1), (0, -t.numel() % BLOCK))
              .reshape(-1, BLOCK) for t in leaves]
    grouped = {
        "leaves": len(leaves), "launches": grouped_launches,
        "ms": cuda_ms(lambda: ck.int8_quantize_2d_many(leaves, BLOCK), 30),
        "device_ms": device_ms(lambda: ck.int8_quantize_2d_many(
            leaves, BLOCK), 10, match["int8_quantize_2d"]),
        "per_leaf_ms": cuda_ms(
            lambda: [ck.int8_quantize_2d(t) for t in padded], 10),
        "per_leaf_device_ms": device_ms(
            lambda: [ck.int8_quantize_2d(t) for t in padded], 5,
            match["int8_quantize_2d"]),
    }
    out["int8_quantize_2d"]["grouped"] = grouped
    log(f"  int8_quantize_2d_many over the {len(leaves)} ResNet-50 leaves: "
        f"{grouped['ms']:.4f} ms a call (device {grouped['device_ms']} ms); "
        f"{len(leaves)} per-leaf calls {grouped['per_leaf_ms']:.4f} ms "
        f"(device {grouped['per_leaf_device_ms']} ms) on {CARD}")
    return out


# -------------------------------------------------------------- phase 1b
def adasum_pairs(m: int, n: int, gen: torch.Generator, dtype=torch.float32):
    """Correlated pairs (dot far from 0) with per-pair magnitudes spread
    over four decades, as two [m, n] tensors on the card."""
    a = torch.randn(m, n, generator=gen, device="cuda")
    a = a * torch.pow(10.0, torch.rand(m, 1, generator=gen, device="cuda")
                      * 4 - 2)
    c = torch.rand(m, 1, generator=gen, device="cuda") * 4 - 2
    b = 0.7 * c * a + torch.randn(m, n, generator=gen, device="cuda")
    return a.to(dtype), b.to(dtype)


def adasum_error(k: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor):
    """(max |k - p|, max of |k - p| over its bound) on finite outputs; the
    bound is ADASUM_RTOL times the pair's scale, with f64 coefficients,
    plus one ulp of the element for bf16 / f16."""
    ad, bd = a.double(), b.double()
    dot = (ad * bd).sum(1, keepdim=True)
    na = (ad * ad).sum(1, keepdim=True)
    nb = (bd * bd).sum(1, keepdim=True)
    ac = torch.where(na == 0, 1.0, 1 - dot / (2 * na.clamp_min(1e-300)))
    bc = torch.where(nb == 0, 1.0, 1 - dot / (2 * nb.clamp_min(1e-300)))
    scale = (ac.abs() * ad.abs() + bc.abs() * bd.abs()).amax(1, keepdim=True)
    diff = (k.double() - p.double()).abs()
    bound = ADASUM_RTOL * scale + ULP.get(k.dtype, 0.0) * p.double().abs()
    finite = torch.isfinite(diff) & torch.isfinite(bound)
    diff = torch.where(finite, diff, 0.0)
    ratio = torch.where(finite, diff / bound.clamp_min(1e-300), 0.0)
    return float(diff.max()), float(ratio.max())


def phase_adasum_kernel(rate: float) -> dict:
    """The Adasum combine kernel against its twin on the card, its
    determinism, and its time at the main-path shapes."""
    from horovod_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {}
    for m, n, dt in ((1, ADASUM_N, torch.float32),
                     (4, ADASUM_N, torch.float32),
                     (1, 257, torch.float32), (2, 1024, torch.bfloat16),
                     (2, 1024, torch.float16)):
        a, b = adasum_pairs(m, n, gen, dt)
        cases[(m, n, str(dt))] = (a, b)
    a, b = adasum_pairs(3, 4096, gen)
    a[0] = 0          # (0, b) -> b
    b[1] = 0          # (a, 0) -> a
    a[2] = b[2] = 0   # (0, 0) -> 0
    cases["zero rows"] = (a, b)
    a, b = adasum_pairs(2, 4096, gen)
    a[1, 17] = float("nan")
    cases["nan row"] = (a, b)
    # strided rows of one tree level, the executor's buf[0::2] and
    # buf[1::2]; an odd row length takes the kernel's scalar path
    level = torch.stack(adasum_pairs(4, 999, gen), 1).reshape(8, 999)
    cases["strided level"] = (level[0::2], level[1::2])

    checks, worst, max_err = [], 0.0, 0.0
    for key, (a, b) in cases.items():
        k = ck.adasum_combine_pairs(a, b)
        k2 = ck.adasum_combine_pairs(a, b)
        p = ck.adasum_combine_pairs_plain(a, b)
        same = bits_equal(k, k2)
        err, ratio = adasum_error(k, p, a, b)
        nan_ok = bool(torch.equal(torch.isnan(k), torch.isnan(p)))
        if key == "zero rows":
            ok = (bits_equal(k[0], b[0]) and bits_equal(k[1], a[1])
                  and not k[2].any())
        elif key == "nan row":
            ok = bool(torch.isnan(k[1]).all() and torch.isfinite(k[0]).all())
        else:
            ok = bool(torch.isfinite(k).all())
        ok = ok and same and nan_ok and ratio <= 1.0 and k.dtype == a.dtype
        checks.append((str(key), ok, err, ratio))
        worst = max(worst, ratio)
        max_err = max(max_err, err)
        log(f"  adasum {key}: max |kernel - twin| {err:.3e} = {ratio:.3f} "
            f"of its bound; two launches byte-equal {same}: ok={ok}")
    torch.cuda.synchronize()
    failed = [c for c in checks if not c[1]]
    log(f"phase 1b: adasum kernel against its twin within {ADASUM_RTOL:g} "
        f"of the pair scale (+1 ulp bf16/f16), launches byte-equal: "
        f"{not failed} (worst {worst:.3f} of the bound)")
    if failed:
        raise AssertionError(f"adasum kernel disagrees with its twin: "
                             f"{failed}")

    timed = {}
    for m in (1, 4):
        a, b = cases[(m, ADASUM_N, str(torch.float32))]
        nbytes = 3 * m * ADASUM_N * 4
        bound_ms, bound_by = adasum_bound(m * ADASUM_N, rate)
        timed[m] = {
            "shape": [m, ADASUM_N], "bytes": nbytes,
            "ms": cuda_ms(lambda: ck.adasum_combine_pairs(a, b), 50),
            "plain_ms": cuda_ms(lambda: ck.adasum_combine_pairs_plain(a, b),
                                10),
            "device_ms": adasum_device_ms(
                lambda: ck.adasum_combine_pairs(a, b), 20),
            "device_ms_cold": adasum_device_ms(
                lambda: ck.adasum_combine_pairs(a, b), 20, cold=True),
            "bound_ms": bound_ms, "bound_by": bound_by}
        t = timed[m]
        log(f"  adasum_combine_pairs: [{m}, {ADASUM_N}] f32 kernel "
            f"{t['ms']:.4f} ms (device time {t['device_ms']}, L2 flushed "
            f"{t['device_ms_cold']}), plain {t['plain_ms']:.4f} ms, "
            f"{nbytes} bytes, bound {t['bound_ms']:.4f} ms "
            f"({nbytes / t['ms'] / 1e6:.0f} GB/s) on {CARD}")
    t0 = time.perf_counter()
    grouped = check_grouped_adasum(ck, gen, rate)
    grouped["seconds"] = time.perf_counter() - t0
    if not grouped["ok"]:
        raise AssertionError(f"grouped adasum failed its checks: {grouped}")
    main = timed[1]
    return {"name": "adasum_combine_pairs", "route": "cuda",
            "source": ADASUM_SOURCE,
            "replaces": REPLACES["adasum_combine_pairs"], "launches": 0,
            "max_abs_err": max(max_err, grouped["max_abs_err"]),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": main["shape"], "bytes": main["bytes"],
            "GBps": main["bytes"] / main["ms"] / 1e6, "timed": timed,
            "grouped": grouped, "checks": checks, "rtol": ADASUM_RTOL}


def adasum_bound(elements: int, rate: float):
    """(bound ms, what bounds it) of combining pairs of ``elements`` f32
    elements in all: a and b read once, out written once; 9 flops an
    element (the reduce's 3 fma, the apply's 2 mul + 1 add)."""
    bytes_ms = 3 * elements * 4 / rate * 1e3
    ops_ms = 9 * elements / F32_RATE * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def adasum_level_pairs(leaves, gen: torch.Generator) -> list:
    """Each leaf as a world-2 tree level: a gathered [2, n] buffer (the
    leaf and a correlated row), as the pair (buf[0::2], buf[1::2])."""
    pairs = []
    for t in leaves:
        x = t.reshape(-1)
        y = 0.5 * x + torch.randn(x.numel(), generator=gen, device="cuda")
        buf = torch.stack([x, y])
        pairs.append((buf[0::2], buf[1::2]))
    return pairs


def check_grouped_adasum(ck, gen: torch.Generator, rate: float) -> dict:
    """The grouped combine over ResNet-50's 161 leaves as world-2 levels:
    one launch, each leaf's bits equal to its own single-pair call and
    within the stated tolerance of the twin, two launches byte-equal; and
    its times beside 161 single-pair calls."""
    pairs = adasum_level_pairs(resnet50_leaves(gen), gen)
    before = ck.launch_counts()["adasum_combine_pairs"]
    outs = ck.adasum_combine_pairs_many(pairs)
    launches = ck.launch_counts()["adasum_combine_pairs"] - before
    again = ck.adasum_combine_pairs_many(pairs)
    single = [ck.adasum_combine_pairs(a, b) for a, b in pairs]
    torch.cuda.synchronize()
    same = all(bits_equal(o, s) and bits_equal(o, g)
               for o, s, g in zip(outs, single, again))
    worst, max_err = 0.0, 0.0
    for o, (a, b) in zip(outs, pairs):
        err, ratio = adasum_error(o, ck.adasum_combine_pairs_plain(a, b), a,
                                  b)
        worst, max_err = max(worst, ratio), max(max_err, err)
    elements = sum(a.numel() for a, _ in pairs)
    bound_ms, bound_by = adasum_bound(elements, rate)

    def grouped():
        ck.adasum_combine_pairs_many(pairs)

    def per_leaf():
        for a, b in pairs:
            ck.adasum_combine_pairs(a, b)

    res = {"leaves": len(pairs), "elements": elements, "launches": launches,
           "bits_equal_per_leaf": same, "worst_of_bound": worst,
           "max_abs_err": max_err, "bound_ms": bound_ms,
           "bound_by": bound_by, "ms": cuda_ms(grouped, 20),
           "device_ms": adasum_device_ms(grouped, 10),
           "device_ms_cold": adasum_device_ms(grouped, 10, cold=True),
           "per_leaf_ms": cuda_ms(per_leaf, 10),
           "per_leaf_device_ms": adasum_device_ms(per_leaf, 5)}
    res["ok"] = same and launches == 1 and worst <= 1.0
    log(f"  adasum_combine_pairs_many over the {len(pairs)} ResNet-50 leaves "
        f"(world-2 levels, {elements} elements): {launches} launch, bits == "
        f"per-leaf calls and two launches {same}, worst {worst:.3f} of the "
        f"twin bound; {res['ms']:.4f} ms a call (device {res['device_ms']}, "
        f"L2 flushed {res['device_ms_cold']}, bound {bound_ms:.4f}); "
        f"{len(pairs)} single-pair calls {res['per_leaf_ms']:.4f} ms (device "
        f"{res['per_leaf_device_ms']}) on {CARD}")
    return res


def adasum_device_ms(fn, iters: int, cold: bool = False):
    """Device time of the combine kernel in one ``fn()``, ms, from
    torch.profiler over ``iters`` calls; with ``cold``, 256 MB are written
    before each call, so that its inputs come from HBM and not from L2.
    None if the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 * 2 ** 20, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    dev = _device_ms(prof)
    total = sum(v for k, v in dev.items() if "adasum_" in k)
    return total / iters if total else None


# --------------------------------------------------------------- phase 5
# Tolerances of the LM kernels against their twins on the card, and why.
# Kernel and twin sum in different orders, and the attention kernel takes
# exp2 of base-2 logits where the twin takes exp; p rounds to bf16 against
# a running maximum in the kernel and against the row's in the twin.
# * K5 out: |k - t| <= ATTN_OUT_TOL[dtype] * the largest |k| or |t| of the
#   (b, t, h) row: the machine epsilon for bf16 (one unit in the last place
#   at the row's largest magnitude, at least: the f32 results differ by a
#   fraction of a unit, and their two roundings to bf16 by one), 1e-5 for
#   f32 (order of ~1000-term f32 sums).
# * K5 lse: |k - t| <= 1e-5 (|t| + 1).
# * K7 dq, dk, dv: |k - t| <= ATTN_GRAD_TOL[dtype] * max |t| of the tensor:
#   2^-6 in bf16 (dS rounds to bf16 before two products), 1e-4 in f32.
# * K8 y: |k - t| <= eps(dtype) max(|k|, |t|) + 1e-6 max |t| of the row
#   (one unit in the last place of y, plus the order of the two f32 sums);
#   mean:
#   |k - t| <= 2e-6 max |x| of the row; rstd: 4e-6 relative (1 / sqrt
#   against the twin's rsqrt, and the order of the squared-deviation sum).
# * K9 p', mu', nu': at most one unit in the last place of their dtype (the
#   kernel rounds every operation as the twin's separate operations do).
ATTN_OUT_TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
ATTN_LSE_TOL = 1e-5
ATTN_GRAD_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
LN_EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
          torch.float32: 2.0 ** -23}
LN_MEAN_TOL, LN_RSTD_TOL = 2e-6, 4e-6
BF16_RATE = 989.4e12  # H100 SXM dense bf16 tensor-core peak, FLOP/s
MEDIUM = dict(vocab=32768, layers=24, d=1024, heads=16, seq=1024, batch=8)


def lm_leaf_shapes(vocab, layers, d, seq):
    """Parameter shapes of the transformer LM, in the model's order."""
    shapes = [(vocab, d), (seq, d)]
    for _ in range(layers):
        shapes += [(d,), (d,), (3 * d, d), (3 * d,), (d, d), (d,), (d,),
                   (d,), (4 * d, d), (4 * d,), (d, 4 * d), (d,)]
    return shapes + [(d,), (d,)]


def causal_pairs(tq, tk, q_off, k_off, causal):
    """(query, key) pairs the mask leaves visible."""
    if not causal:
        return tq * tk
    return sum(max(0, min(tk, q_off + i - k_off + 1)) for i in range(tq))


def ratio_rows(k, t, rel, dim=-1):
    """(max |k - t|, max of |k - t| / (rel * the largest |k| or |t| over
    ``dim``, or over the whole tensor for None))."""
    kd, td = k.double(), t.double()
    diff = (kd - td).abs()
    mag = torch.maximum(kd.abs(), td.abs())
    scale = mag.amax(dim, keepdim=True) if dim is not None else mag.max()
    return float(diff.max()), float((diff / (rel * scale + 1e-300)).max())


def ulp_distance(a, b) -> int:
    """Largest distance in units of the last place between a and b."""
    bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
    top = 1 << (8 * a.element_size() - 1)

    def key(x):
        i = x.contiguous().view(bits).long()
        return torch.where(i < 0, -(i + top), i)

    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def device_ms(fn, iters: int, match) -> float:
    """Device time of one call (ms): torch.profiler over ``iters`` calls,
    kernels whose name contains any of ``match``. Two traced calls before
    them are discarded: late in a long process, a trace that starts cold
    loses its first kernels. None when the trace holds no such kernel, or a
    number of them that ``iters`` does not divide (some were lost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    warmup = 2
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=iters,
                                   repeat=1)) as prof:
        for _ in range(warmup + iters):
            fn()
            torch.cuda.synchronize()
            prof.step()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA and evt.self_device_time_total
                and any(m in evt.key for m in match)):
            total += evt.self_device_time_total / 1e3
            count += evt.count
    return total / iters if count and count % iters == 0 else None


def attention_cases(gen):
    """(name, q, k, v, dout, causal, q_off, k_off) on the card."""
    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    b, t, h = MEDIUM["batch"], MEDIUM["seq"], MEDIUM["heads"]
    hd = MEDIUM["d"] // h
    qkv = rnd(b, t, h, 3, hd)  # the views the model's qkv projection gives
    cases = [("main [8,1024,16,64] bf16 causal, qkv views", qkv[..., 0, :],
              qkv[..., 1, :], qkv[..., 2, :], rnd(b, t, h, hd), True, 0, 0)]
    for name, shape, dt, causal in (
            ("non-causal bf16", (2, 512, 4, 64), torch.bfloat16, False),
            ("f32 causal", (2, 256, 2, 64), torch.float32, True),
            ("f32 D=128 non-causal", (1, 384, 2, 128), torch.float32, False),
            ("bf16 D=128 causal", (2, 256, 2, 128), torch.bfloat16, True),
            ("T=1000 bf16 causal", (2, 1000, 2, 64), torch.bfloat16, True),
            ("T=1000 f32 non-causal", (1, 1000, 2, 64), torch.float32,
             False),
            ("BH=1 f32 causal", (1, 512, 1, 64), torch.float32, True),
            ("D=32 bf16 causal", (2, 192, 2, 32), torch.bfloat16, True)):
        cases.append((name, rnd(*shape, dtype=dt), rnd(*shape, dtype=dt),
                      rnd(*shape, dtype=dt), rnd(*shape, dtype=dt), causal,
                      0, 0))
    # offsets (the ring's hops): q rows 256.. against keys 0..511, and keys
    # that start past the first q rows (fully masked rows: out 0, lse 0),
    # on both paths (f32: CUDA cores; bf16: tensor cores)
    for dt in (torch.float32, torch.bfloat16):
        q, kk = rnd(1, 256, 2, 64, dtype=dt), rnd(1, 512, 2, 64, dtype=dt)
        cases.append((f"offsets q_off=256 {dt}", q, kk, kk.flip(1),
                      q.flip(2), True, 256, 0))
        cases.append((f"offsets k_off=128, masked rows {dt}", q, kk,
                      kk.flip(1), q.flip(2), True, 0, 128))
    return cases


SM90_KERNELS = ("flash_fwd_sm90", "flash_fwd_step_sm90", "flash_bwd_dq_sm90",
                "flash_bwd_dkv_sm90")


SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")  # wgmma, TMA load, TMA store


def sass_counts(library: str) -> dict:
    """HGMMA (wgmma), UTMALDG (TMA load) and UTMASTG (TMA store)
    instructions in each kernel of the built ``csrc/<library>.cu``, by
    mangled kernel name, from ``cuobjdump -sass``."""
    from horovod_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(library))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    return counts


def phase_lm_kernels(rate: float) -> dict:
    """K5, K7, K8 and K9 against their twins on the card, at the main-path
    shapes and at ragged ones; two K7 launches byte-equal; times. First,
    the SASS of the wgmma / TMA attention kernels (K5, K6, K7) must hold
    HGMMA and UTMALDG."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import cuda_kernels as ck

    sass = {short: c for fn, c in sass_counts("flash_attention_sm90").items()
            for short in SM90_KERNELS if f"{short}_kernel" in fn}
    log(f"phase 5: HGMMA / UTMALDG / UTMASTG instructions in the SASS of "
        f"flash_attention_sm90.cu: {sass}")
    if (sorted(sass) != sorted(SM90_KERNELS)
            or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                   for c in sass.values())):
        raise AssertionError(f"K5 / K6 / K7 kernels without wgmma or TMA: "
                             f"{sass}")
    gen = torch.Generator(device="cuda").manual_seed(5)
    checks, worst = [], {}

    def note(kernel, what, ok, err, ratio):
        checks.append((kernel, what, ok, err, ratio))
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        log(f"  {kernel} {what}: max |kernel - twin| {err:.3e} = "
            f"{ratio:.3f} of its bound: ok={ok}")

    # ---- K5 / K7
    for name, q, k, v, do, causal, qo, ko in attention_cases(gen):
        kw = dict(causal=causal, scale=q.shape[-1] ** -0.5, q_off=qo,
                  k_off=ko)
        out, lse = ck.flash_attention_fwd(q, k, v, **kw)
        out_t, lse_t = ck.flash_attention_fwd_plain(q, k, v, **kw)
        e1, r1 = ratio_rows(out, out_t, ATTN_OUT_TOL[q.dtype])
        e2 = float((lse - lse_t).abs().max())
        r2 = float(((lse - lse_t).abs()
                    / (ATTN_LSE_TOL * (lse_t.abs() + 1))).max())
        ok = (r1 <= 1 and r2 <= 1 and out.dtype == q.dtype
              and bool(torch.isfinite(out).all()))
        if ko > qo:  # rows that see no key: out 0 and lse 0
            hidden = ko - qo
            ok = ok and not out[:, :hidden].any() and not lse[..., :hidden].any()
        note("flash_attention_fwd", f"{name} out/lse", ok, max(e1, e2),
             max(r1, r2))
        dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        for out_dtype in ((q.dtype, torch.float32)
                          if q.dtype != torch.float32 else (q.dtype,)):
            g = ck.flash_attention_bwd(q, k, v, do, lse, dd,
                                       out_dtype=out_dtype, **kw)
            g2 = ck.flash_attention_bwd(q, k, v, do, lse, dd,
                                        out_dtype=out_dtype, **kw)
            gt = ck.flash_attention_bwd_plain(q, k, v, do, lse, dd,
                                              out_dtype=out_dtype, **kw)
            same = all(bits_equal(a, b) for a, b in zip(g, g2))
            er = [ratio_rows(a, b, ATTN_GRAD_TOL[q.dtype], dim=None)
                  for a, b in zip(g, gt)]
            ok = (same and all(r <= 1 for _, r in er)
                  and all(a.dtype == out_dtype for a in g))
            note("flash_attention_bwd", f"{name} out {out_dtype} dq/dk/dv "
                 f"(two launches byte-equal {same})", ok,
                 max(e for e, _ in er), max(r for _, r in er))
        if ck._hopper_route(q.dtype, q.shape[3]):  # D made from out
            g = ck.flash_attention_bwd(q, k, v, do, lse, out=out, **kw)
            gt = ck.flash_attention_bwd_plain(q, k, v, do, lse, dd, **kw)
            er = [ratio_rows(a, b, ATTN_GRAD_TOL[q.dtype], dim=None)
                  for a, b in zip(g, gt)]
            note("flash_attention_bwd", f"{name} dq/dk/dv with D made in "
                 f"the kernel", all(r <= 1 for _, r in er),
                 max(e for e, _ in er), max(r for _, r in er))
    torch.cuda.synchronize()

    # ---- K8
    for shape, dt in (((8192, 1024), torch.bfloat16),
                      ((8192, 1000), torch.bfloat16),
                      ((513, 1001), torch.float32),
                      ((300, 768), torch.float16), ((4, 77), torch.bfloat16),
                      ((64, 2048), torch.bfloat16),
                      ((100, 1280), torch.float16),
                      ((256, 4096), torch.bfloat16),
                      ((300, 1024), torch.float32),
                      ((64, 512), torch.bfloat16)):
        n, d = shape
        x = (torch.randn(n, d, generator=gen, device="cuda") * 3
             + torch.rand(n, 1, generator=gen, device="cuda")).to(dt)
        gm = torch.randn(d, generator=gen, device="cuda")
        bt = torch.randn(d, generator=gen, device="cuda")
        y, mu, rs = ck.layer_norm_fwd(x, gm, bt, 1e-6)
        yt, mut, rst = ck.layer_norm_fwd_plain(x, gm, bt, 1e-6)
        y2 = ck.layer_norm_fwd(x, gm, bt, 1e-6)[0]
        yd, ytd = y.double(), yt.double()
        bound = (LN_EPS[dt] * torch.maximum(yd.abs(), ytd.abs())
                 + 1e-6 * ytd.abs().amax(1, keepdim=True))
        ry = float(((yd - ytd).abs() / bound).max())
        xmax = x.float().abs().amax(1)
        rm = float(((mu - mut).abs() / (LN_MEAN_TOL * xmax)).max())
        rr = float(((rs - rst).abs() / (LN_RSTD_TOL * rst.abs())).max())
        ok = (max(ry, rm, rr) <= 1 and bits_equal(y, y2)
              and y.dtype == dt)
        note("layer_norm_fwd", f"[{n}, {d}] {dt}", ok,
             float((yd - ytd).abs().max()), max(ry, rm, rr))

    # ---- K9
    shapes = lm_leaf_shapes(MEDIUM["vocab"], MEDIUM["layers"], MEDIUM["d"],
                            MEDIUM["seq"])
    adamw_timing = None
    for leaves, label in ((shapes, f"{len(shapes)} medium leaves"),
                          ([(1000003,), (3,)], "odd lengths")):
        for mu_dtype in (torch.bfloat16, torch.float32):
            for t in (1, 10):
                ps = [torch.randn(s, generator=gen, device="cuda")
                      for s in leaves]
                gs = [torch.randn(s, generator=gen, device="cuda")
                      for s in leaves]
                mus = [(0.1 * torch.randn(s, generator=gen, device="cuda")
                        ).to(mu_dtype) for s in leaves]
                nus = [0.01 * torch.rand(s, generator=gen, device="cuda")
                       for s in leaves]
                b1, b2 = 0.9, 0.999
                sc = dict(lr=float(torch.tensor(3e-4)),
                          ibc1=float(1 / (1 - torch.tensor(b1) ** t)),
                          ibc2=float(1 / (1 - torch.tensor(b2) ** t)),
                          b1=b1, b2=b2, eps=1e-8)
                twin = [[x.clone() for x in xs] for xs in (ps, mus, nus)]
                ck.adamw_update(ps, gs, mus, nus, weight_decay=0.01, **sc)
                for p, g, mu, nu in zip(*twin[:1], gs, *twin[1:]):
                    ck.adamw_update_plain(p, g, mu, nu, wd=0.01, **sc)
                d_ulp = max(max(ulp_distance(a, b) for a, b in zip(x, y))
                            for x, y in zip((ps, mus, nus), twin))
                err = max(float((a.float() - b.float()).abs().max())
                          for x, y in zip((ps, mus, nus), twin)
                          for a, b in zip(x, y))
                note("adamw_update", f"{label} mu {mu_dtype} step {t} "
                     f"(max {d_ulp} ulp)", d_ulp <= 1, err, float(d_ulp))
                if (len(leaves) > 2 and mu_dtype == torch.bfloat16
                        and t == 10):
                    adamw_timing = (ps, gs, mus, nus, sc)
                del ps, gs, mus, nus, twin
    torch.cuda.synchronize()
    failed = [c for c in checks if not c[2]]
    log(f"phase 5: LM kernels against their twins on the card: "
        f"{not failed} ({len(checks)} checks)")
    if failed:
        raise AssertionError(f"LM kernels disagree with their twins: "
                             f"{failed}")

    # ---- times at the main-path shapes
    out = {}
    name, q, k, v, do, causal, _, _ = attention_cases(gen)[0]
    bsz, t, h, d = q.shape
    pairs = causal_pairs(t, t, 0, 0, True) * bsz * h
    attn = dict(causal=True, scale=d ** -0.5)
    o, lse = ck.flash_attention_fwd(q, k, v, **attn)
    dd = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sd = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    dos = do.transpose(1, 2)
    n_el = bsz * t * h * d
    timed = {
        "flash_attention_fwd": (
            lambda: ck.flash_attention_fwd(q, k, v, **attn),
            lambda: ck.flash_attention_fwd_plain(q, k, v, **attn),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=True),
            4 * n_el * 2 + bsz * h * t * 4, 4 * d * pairs, BF16_RATE,
            ("flash_fwd",), "F.scaled_dot_product_attention(is_causal=True)"),
        "flash_attention_bwd": (
            lambda: ck.flash_attention_bwd(q, k, v, do, lse, dd, **attn),
            lambda: ck.flash_attention_bwd_plain(q, k, v, do, lse, dd,
                                                 **attn),
            lambda: torch.autograd.grad(sd, (qs, ks, vs), dos,
                                        retain_graph=True),
            7 * n_el * 2 + 2 * bsz * h * t * 4, 10 * d * pairs, BF16_RATE,
            ("flash_bwd",), "SDPA backward through autograd"),
    }
    x = torch.randn(8192, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    gm = torch.randn(1024, generator=gen, device="cuda")
    bt = torch.randn(1024, generator=gen, device="cuda")
    # F.layer_norm takes gamma and beta in x's dtype: cast once, outside
    # the timed call, so that the yardstick is the one call alone
    g16, b16 = gm.to(x.dtype), bt.to(x.dtype)
    timed["layer_norm_fwd"] = (
        lambda: ck.layer_norm_fwd(x, gm, bt, 1e-6),
        lambda: ck.layer_norm_fwd_plain(x, gm, bt, 1e-6),
        lambda: F.layer_norm(x, (1024,), g16, b16, 1e-6),
        2 * x.numel() * 2 + 2 * 1024 * 4 + 2 * 8192 * 4, 8 * x.numel(),
        F32_RATE, ("ln_fwd",), "F.layer_norm")
    ps, gs, mus, nus, sc = adamw_timing
    n_par = sum(p.numel() for p in ps)
    lib_ps = [p.clone() for p in ps]
    for p, g in zip(lib_ps, gs):
        p.grad = g
    lib = torch.optim.AdamW(lib_ps, lr=3e-4, weight_decay=0.01, fused=True)

    def twin_step():
        for p, g, mu, nu in zip(ps, gs, mus, nus):
            ck.adamw_update_plain(p, g, mu, nu, wd=0.01, **sc)

    timed["adamw_update"] = (
        lambda: ck.adamw_update(ps, gs, mus, nus, weight_decay=0.01, **sc),
        twin_step, lib.step, 24 * n_par, 12 * n_par, F32_RATE, ("adamw",),
        "torch.optim.AdamW(fused=True).step(), f32 exp_avg: 26 B/element "
        "against the kernel's 24")
    for kname, (kern, plain, library, nbytes, ops, peak, match,
                lib_name) in timed.items():
        ms = cuda_ms(kern, 20)
        bytes_ms = nbytes / rate * 1e3
        ops_ms = ops / peak * 1e3
        out[kname] = {
            "name": kname, "route": "cuda", "source": LM_SOURCES[kname],
            "replaces": REPLACES[kname], "launches": 0,
            "max_abs_err": worst[kname], "ms": ms,
            "plain_ms": cuda_ms(plain, 5, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": cuda_ms(library, 10), "library": lib_name,
            "device_ms": device_ms(kern, 10, match), "bytes": nbytes,
            "operations": ops}
        r = out[kname]
        log(f"  {kname}: kernel {ms:.4f} ms (device {r['device_ms']}), "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
            f"ms ({lib_name}), bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({nbytes} bytes, {ops} operations) on {CARD}")
    # row #11's contract: the same backward with f32 outputs (not on the
    # main path; no PyTorch call returns f32 gradients of bf16 attention)
    nbytes = 4 * n_el * 2 + 2 * bsz * h * t * 4 + 3 * n_el * 4
    ops = 10 * d * pairs

    def f32_out():
        return ck.flash_attention_bwd(q, k, v, do, lse, dd,
                                      out_dtype=torch.float32, **attn)

    r = out["flash_attention_bwd"]["f32_out"] = {
        "ms": cuda_ms(f32_out, 20),
        "device_ms": device_ms(f32_out, 10, ("flash_bwd",)),
        "plain_ms": cuda_ms(lambda: ck.flash_attention_bwd_plain(
            q, k, v, do, lse, dd, out_dtype=torch.float32, **attn), 5,
            warmup=1),
        "bound_ms": max(nbytes / rate, ops / BF16_RATE) * 1e3,
        "bound_by": "bytes" if nbytes / rate >= ops / BF16_RATE
        else "operations", "bytes": nbytes}
    log(f"  flash_attention_bwd with f32 outputs: kernel {r['ms']:.4f} ms "
        f"(device {r['device_ms']}), plain {r['plain_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} on {CARD}")

    # K7 as _FlashAttention.backward calls it: from out, D = rowsum(dO * O)
    # made by its dq kernel, as SDPA's backward makes its own (cuDNN's
    # dot_do_o kernel)
    def k7_as_called():
        return ck.flash_attention_bwd(q, k, v, do, lse, out=o, **attn)

    r = out["flash_attention_bwd"]["with_d"] = {
        "ms": cuda_ms(k7_as_called, 20),
        "device_ms": device_ms(k7_as_called, 10, ("flash_bwd",))}
    r["vs_library"] = r["ms"] / out["flash_attention_bwd"]["library_ms"]
    log(f"  flash_attention_bwd making D from out (as the autograd "
        f"function calls it): {r['ms']:.4f} ms (device {r['device_ms']}) "
        f"against SDPA backward's "
        f"{out['flash_attention_bwd']['library_ms']:.4f} ms: "
        f"{r['vs_library']:.3f}x; K5 against SDPA: "
        f"{out['flash_attention_fwd']['ms'] / out['flash_attention_fwd']['library_ms']:.3f}x"
        f" on {CARD}")

    # K8 as the model calls it: fused_layer_norm with autograd recording
    # (the reshape, _FusedLayerNorm.apply, the saved statistics)
    from horovod_tpu_torch.ops.layer_norm import fused_layer_norm

    t0 = time.perf_counter()
    xg = x.detach().requires_grad_()
    gp, bp = (t.detach().requires_grad_() for t in (gm, bt))

    def k8_as_called():
        return fused_layer_norm(xg, gp, bp, eps=1e-6)

    ln = out["layer_norm_fwd"]
    r = ln["as_called"] = {
        "ms": cuda_ms(k8_as_called, 20),
        "device_ms": device_ms(k8_as_called, 10, ("ln_fwd",))}
    r["vs_library"] = r["ms"] / ln["library_ms"]
    r["seconds"] = time.perf_counter() - t0
    log(f"  layer_norm_fwd as fused_layer_norm calls it (autograd on): "
        f"{r['ms']:.4f} ms (device {r['device_ms']}) against F.layer_norm's "
        f"{ln['library_ms']:.4f} ms: {r['vs_library']:.3f}x; the wrapper "
        f"alone {ln['ms'] / ln['library_ms']:.3f}x on {CARD} (timed in "
        f"{r['seconds']:.2f} s)")
    # K8 and K5 as a CUDA graph of their own call replays them: the call
    # without its host part (R2; the compiled step replays them so)
    for kname in ("layer_norm_fwd", "flash_attention_fwd"):
        r = out[kname]["graph_replay"] = {
            "ms": graph_replay_ms(timed[kname][0], 20)}
        log(f"  {kname} replayed in a CUDA graph of its own call: "
            f"{r['ms']:.4f} ms against the call's {out[kname]['ms']:.4f} ms "
            f"(device {out[kname]['device_ms']}) on {CARD}")
    out["sass"] = sass
    out["checks"] = checks
    return out


# -------------------------------------------------------- phases 5b-5d
def lm_per_step(fused: bool, layers: int) -> dict:
    """Kernel launches one training step of the LM makes: K5 and K7 once a
    layer; with the fused path K8 twice a layer plus ln_f, and K9 once (one
    multi-tensor launch over every leaf)."""
    return {"flash_attention_fwd": layers, "flash_attention_bwd": layers,
            "layer_norm_fwd": (2 * layers + 1) if fused else 0,
            "adamw_update": 1 if fused else 0}


def phase_lm_world1() -> dict:
    """GPT-2-medium (24 layers, d_model 1024, 16 heads, vocab 32768, seq
    1024, batch 8) at world 1, 2 warm-up and 5 timed steps, in the default
    configuration (K5, K7) and with fused_ln and fused_opt (all four)."""
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import synthetic_lm_train

    steps, warmup = 5, 2
    runs = {}
    for label, fused in (("default", False), ("fused_ln+fused_opt", True)):
        ck.reset_launch_counts()
        res = synthetic_lm_train("medium", steps=steps, warmup=warmup,
                                 fused_ln=fused, fused_opt=fused,
                                 device="cuda:0")
        counts = ck.launch_counts()
        want = {k: (steps + warmup) * n
                for k, n in lm_per_step(fused, MEDIUM["layers"]).items()}
        ok = (all(math.isfinite(v) for v in res["losses"])
              and res["gradient_leaves"] == len(lm_leaf_shapes(
                  MEDIUM["vocab"], MEDIUM["layers"], MEDIUM["d"],
                  MEDIUM["seq"]))
              and all(counts[k] == n for k, n in want.items())
              and res["chunked"] is False)
        log(f"phase 5b: GPT-2-medium world 1 ({label}): "
            f"{res['tokens_per_sec']:.1f} tokens/s, {res['step_ms']:.2f} ms "
            f"per step, MFU {res['mfu_pct']:.2f}% of "
            f"{res['peak_flops'] / 1e12:.1f} TFLOP/s, peak memory "
            f"{res['peak_memory_bytes'] / 2**30:.2f} GiB, launches per step "
            f"{ {k: counts[k] / (steps + warmup) for k in want} } "
            f"(want {lm_per_step(fused, MEDIUM['layers'])}), losses "
            f"{[round(v, 4) for v in res['losses']]}, "
            f"{res['n_params']} parameters ({res['n_nonemb_params']} "
            f"non-embedding), on {CARD}: ok={ok}")
        if not ok:
            raise AssertionError(f"GPT-2-medium world-1 run ({label}) "
                                 f"failed its checks: {counts}")
        res["counts"] = counts
        runs[label] = res
    return runs


def phase_lm_profile() -> dict:
    """Two profiled steps of GPT-2-medium on the fused path, after one warm
    step: device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.train import LMTrainer

    tr = LMTrainer("medium", fused_ln=True, fused_opt=True, device="cuda:0")
    tr.step()
    tr.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.step()
        tr.step()
        tr.sync()
        wall = (time.perf_counter() - t0) * 1e3
    dev = _device_ms(prof)
    total = sum(dev.values())
    ours = {k: v for k, v in dev.items()
            if any(m in k for m in ("flash_fwd", "flash_bwd", "ln_fwd",
                                    "adamw_kernel"))}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:12]
    attention = sum(v for k, v in ours.items()
                    if "flash_fwd" in k or "flash_bwd" in k) / 2
    log(f"phase 5b': 2 profiled GPT-2-medium steps (fused path): "
        f"{wall:.1f} ms wall (profiler on), device time {total:.1f} ms "
        f"({100 * total / wall:.1f}% busy), of it the port's kernels "
        f"{sum(ours.values()):.1f} ms, attention (K5 + K7) "
        f"{attention:.2f} ms a step; top device kernels (ms) "
        f"{[(k[:70], round(v, 2)) for k, v in top]}; on {CARD}")
    return {"wall_ms": wall, "device_ms_total": total,
            "port_kernels_ms": ours, "attention_ms_per_step": attention,
            "top": top}


def phase_lm_small_agreement() -> dict:
    """A 2-layer, d_model 128 LM trained 3 steps (fused LayerNorm, fused
    AdamW with a bf16 mu) in f32 on the card (kernels) and on the CPU
    (plain twins), from the same weights and tokens, TF32 off. The
    tolerance of the CPU tests against the reference: losses to 1e-5
    relative, 99.9% of the parameter elements to 2e-6, all to 1e-4 (Adam
    turns a last-bit gradient difference on an element as small as eps into
    a visible share of that element's step)."""
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.optim.fused import FusedAdamW
    from horovod_tpu_torch.train import synthetic_lm_tokens

    toks = torch.from_numpy(synthetic_lm_tokens(4, 128, 512, 0, 1))
    runs = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            net = TransformerLM(512, num_layers=2, num_heads=2, d_model=128,
                                max_seq_len=128, dtype=torch.float32,
                                fused_ln=True, seed=3).to(dev)
            opt = FusedAdamW(net.parameters(), lr=3e-4, weight_decay=0.01,
                             mu_dtype="bf16")
            x, y = toks[:, :-1].to(dev), toks[:, 1:].to(dev)
            losses = []
            for _ in range(3):
                opt.zero_grad()
                loss = lm_loss(net(x), y)
                loss.backward()
                opt.step()
                losses.append(loss.item())
            runs[dev] = (losses, {k: p.detach().cpu() for k, p in
                                  net.named_parameters()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    diffs = torch.cat([(pc[k] - pg[k]).abs().flatten() for k in pc])
    worst, share = float(diffs.max()), float((diffs <= 2e-6).float().mean())
    ok = loss_rel <= 1e-5 and worst <= 1e-4 and share >= 0.999
    log(f"phase 5c: 2-layer LM card vs CPU, 3 steps fused LN + fused AdamW "
        f"in f32: loss rel diff {loss_rel:.3e} (<= 1e-5), params max diff "
        f"{worst:.3e} (<= 1e-4), share within 2e-6 {share:.6f} (>= 0.999): "
        f"ok={ok}")
    if not ok:
        raise AssertionError("card and CPU disagree on the small LM")
    return {"loss_rel": loss_rel, "param_max": worst, "share": share}


def lm_world2_worker() -> dict:
    """One rank of the world-2 LM run: medium widths at 2 layers, seq 1024,
    batch 2 per rank, 2 steps, fused LayerNorm and fused AdamW; launches
    counted from 0 just before the run."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import synthetic_lm_train

    ck.reset_launch_counts()
    res = synthetic_lm_train("medium", num_layers=2, batch=2, steps=2,
                             warmup=0, fused_ln=True, fused_opt=True)
    res["counts"] = ck.launch_counts()
    res["backend"] = hvd.backend()
    return res


def phase_lm_world2() -> dict:
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    ranks = testing.run_cluster(lm_world2_worker, np=2, device="cuda",
                                timeout=600)
    want = {k: 2 * n for k, n in lm_per_step(True, 2).items()}
    same = ranks[0]["params_sha256"] == ranks[1]["params_sha256"]
    launched = all(r["counts"][k] == n for r in ranks for k, n in
                   want.items())
    ok = (same and launched
          and all(r["backend"] == "gloo" and r["device"].startswith("cuda")
                  and all(math.isfinite(v) for v in r["losses"])
                  for r in ranks))
    log(f"phase 5d: world 2 (gloo, one card) LM medium widths, 2 layers, seq "
        f"1024, batch 2/rank, 2 steps fused: params bit-identical {same}, "
        f"launches {[{k: r['counts'][k] for k in want} for r in ranks]} "
        f"(want {want} each), losses "
        f"{[[round(v, 4) for v in r['losses']] for r in ranks]}: ok={ok}")
    if not ok:
        raise AssertionError("world-2 LM run failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------- phase 2
def phase_world1() -> dict:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import synthetic_train

    steps, warmup = 5, 2
    batch = 256
    while True:
        ck.reset_launch_counts()
        try:
            res = synthetic_train("ResNet50", batch=batch, image=224,
                                  steps=steps, warmup=warmup,
                                  compression="int8", error_feedback=True,
                                  device="cuda:0")
            break
        except torch.cuda.OutOfMemoryError:
            if batch <= 32:
                raise
            log(f"  batch {batch} does not fit in device memory; "
                f"retrying at {batch // 2}")
            batch //= 2
            torch.cuda.empty_cache()
    counts = ck.launch_counts()
    leaves = res["gradient_leaves"]
    # error feedback measures every leaf of a step in one grouped #1 (one
    # launch per table-full of leaves) and one #2, on the card: at least one
    # launch of each a step, and at most what the leaf tables need
    per_step = -(-leaves // ck._kernel("hvd_int8_table_leaves")[1]())
    ran = steps + warmup
    ok = (all(math.isfinite(v) for v in res["losses"])
          and res["device"].startswith("cuda")
          and hvd.device().type == "cuda"
          and ran <= counts["int8_quantize_2d"] <= ran * per_step
          and ran <= counts["int8_dequantize_2d"] <= ran * per_step)
    log(f"phase 2: ResNet-50 world 1 batch {batch} 224x224 int8+EF: "
        f"{res['images_per_sec']:.1f} images/s, peak memory "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
        f"{[round(v, 4) for v in res['losses']]}, launches {counts}, "
        f"{leaves} gradient leaves ({per_step} #1 and #2 launches a step at "
        f"most), on {CARD}: ok={ok}")
    if not ok:
        raise AssertionError("world-1 main path failed its checks")
    res.update(batch=batch, counts=counts)
    return res


def _device_ms(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run: the
    kernel rows only (operator rows repeat their kernels' time)."""
    from torch.autograd import DeviceType

    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # a range such as Optimizer.step: its kernels count
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            out[evt.key] = out.get(evt.key, 0.0) + \
                evt.self_device_time_total / 1e3
    return out


def phase_breakdown(batch: int) -> dict:
    """Where the world-1 step's time goes: the same training without
    compression (the error-feedback roundtrip's end-to-end cost) and a
    profiled run of 2 int8+EF steps (the wire kernels' device time)."""
    from torch.profiler import ProfilerActivity, profile

    from horovod_tpu_torch.train import synthetic_train

    plain = synthetic_train("ResNet50", batch=batch, image=224, steps=5,
                            warmup=1, compression="none",
                            error_feedback=False, device="cuda:0")
    steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        synthetic_train("ResNet50", batch=batch, image=224, steps=steps,
                        warmup=0, compression="int8", error_feedback=True,
                        device="cuda:0")
    dev = _device_ms(prof)
    total = sum(dev.values())
    wire = {k: v for k, v in dev.items()
            if any(m in k for m in WIRE_Q + ("int8_dequant_kernel",))}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    res = {"plain_images_per_sec": plain["images_per_sec"],
           "profiled_steps": steps, "device_ms_total": total,
           "wire_kernel_ms": sum(wire.values()), "wire_kernels": wire,
           "top_kernels": top}
    share = (f"{100 * res['wire_kernel_ms'] / total:.2f}% of {total:.1f} ms "
             f"device time" if total else "profiler recorded no device time")
    log(f"phase 2c: world 1 without compression {plain['images_per_sec']:.1f}"
        f" images/s; 2 profiled int8+EF steps: wire kernels "
        f"{res['wire_kernel_ms']:.4f} ms = {share} ({wire}); on {CARD}")
    if not all(math.isfinite(v) for v in plain["losses"]):
        raise AssertionError("uncompressed world-1 run lost finiteness")
    return res


def phase_small_agreement() -> dict:
    """A reduced ResNet-50 trained 3 steps with int8 error feedback on the
    CPU (plain twins) and on the card (kernels), in f32 with TF32 off."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.optim.distributed import DistributedOptimizer
    from horovod_tpu_torch.train import synthetic_batch

    images, labels = synthetic_batch(8, 32, 10, 0, 1)
    runs = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            net = resnet.ResNet50(num_classes=10, num_filters=8).to(dev)
            opt = DistributedOptimizer(
                torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9),
                named_parameters=net.named_parameters(),
                compression=Compression.int8, error_feedback=True)
            x = torch.from_numpy(images).to(dev)
            y = torch.from_numpy(labels).to(dev)
            losses = []
            for _ in range(3):
                opt.zero_grad()
                loss = torch.nn.functional.cross_entropy(net(x), y)
                loss.backward()
                opt.step()
                losses.append(loss.item())
            runs[dev] = (losses, {k: v.detach().cpu() for k, v in
                                  net.named_parameters()})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (lc, pc), (lg, pg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    param_abs = max(float((pc[k] - pg[k]).abs().max()) for k in pc)
    # conv sums run in another order on oneDNN and cuDNN (~1e-6 relative);
    # one flipped int8 rounding moves a residual, and so the next step's
    # gradient, by one scale step of its block
    ok = loss_rel < 1e-4 and param_abs < 2e-4
    log(f"phase 2b: small ResNet-50 CPU vs card, 3 steps int8+EF: loss rel "
        f"diff {loss_rel:.3e} (< 1e-4), param abs diff {param_abs:.3e} "
        f"(< 2e-4): ok={ok}")
    if not ok:
        raise AssertionError("card and CPU disagree on the small model")
    return {"loss_rel": loss_rel, "param_abs": param_abs}


# ---------------------------------------- the compiled plane (phases 2d-3d)
# the compiled plane's step against the eager step: losses to COMPILED_LOSS
# relative; 99.9% of the parameter elements within COMPILED_PARAM and every
# one within 2 * sum(lr) (what updates of opposite sign could open where an
# atomic sum's order flips a gradient's last bit)
COMPILED_LOSS = 1e-4
COMPILED_PARAM = 1e-6
LM_LRS = (3e-4, 1e-4, 5e-4)  # the lr of each of the agreement's steps
# phase 3c: the error of the mean of N(0, 1) rows, the reference's bounds
# (tests/test_algo.py:114); the exact wire within ALGO_EXACT_TOL
ALGO_TOL = {"int8": 0.05, "int4": 0.6}
ALGO_EXACT_TOL = 1e-5
# phase 3d: ZeRO-1's losses against the replicated int8 step's, relative;
# its final parameters against the replicated step's, the largest |diff|
# over the largest |update| the replicated step made (the two quantize
# different values on the wire: the gradient, or ZeRO-1's update)
ZERO1_LOSS_REL = 1e-4
ZERO1_PARAM_GAP = 0.1
ZERO1_FAULTS = ("unaveraged", "no-step")
# phase 2d's graphed ResNet-50 losses against its eager ones (bf16 autocast;
# cuDNN may pick other algorithms for the two)
RESNET_GRAPH_LOSS = 1e-3


def release() -> None:
    """Free the card's memory of dropped trainers: a compiled step and its
    trainer refer to each other (the loss function is a bound method), so
    their CUDA graph's pool goes only when the cycle is collected."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  released: {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
        f"reserved, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        "allocated")


def busy_share(step, n: int = 2) -> dict:
    """Device time over the wall of ``n`` profiled steps (after one warm
    step): the share of the profiled wall the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = _device_ms(prof)
    total = sum(dev.values())
    return {"wall_ms": wall, "device_ms": total,
            "busy_pct": 100 * total / wall if wall else None,
            "top": sorted(dev.items(), key=lambda kv: -kv[1])[:6]}


def timed_steps(tr, warmup: int, steps: int):
    """(losses, seconds of the timed steps) of a trainer's steps."""
    losses = [tr.step() for _ in range(warmup)]
    tr.sync()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(steps)]
    tr.sync()
    return [float(v) for v in losses], time.perf_counter() - t0


def phase_compiled_resnet(batch: int, engine: dict) -> dict:
    """Phase 2d: ResNet-50 at world 1 (phase 2's batch, 224x224, bf16
    autocast, channels_last, SGD 0.01 momentum 0.9) through
    ``make_train_step``, graphed and eager, on the exact and the int8 wire
    (the error-feedback roundtrip: one #1 and one #2 a replay), against
    phases 2 / 2c's ``synthetic_train`` on the engine's plane in this call;
    the card's busy share over two profiled graphed steps."""
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import ImageTrainer

    steps, warmup = 5, 2
    want = {"none": {}, "int8": {"int8_quantize_2d": 1,
                                 "int8_dequantize_2d": 1}}
    out, ok = {}, True
    t0 = time.perf_counter()
    for wire in ("none", "int8"):
        for graph in (True, False):
            ck.reset_launch_counts()
            tr = ImageTrainer("ResNet50", batch=batch, image=224,
                               compression=wire, device="cuda:0",
                               plane="compiled", graph=graph)
            losses, secs = timed_steps(tr, warmup, steps)
            ts = tr.train_step
            r = {"losses": losses, "images_per_sec": batch * steps / secs,
                 "graphed": ts.graphed, "counts": ck.launch_counts(),
                 "launches_per_replay": ts.launches_per_replay}
            if graph:
                r["profile"] = busy_share(tr.step)
            label = f"{wire} {'graphed' if graph else 'eager'}"
            out[label] = r
            good = (all(math.isfinite(v) for v in losses)
                    and ts.graphed == graph
                    and (not graph
                         or ts.launches_per_replay == want[wire]))
            if wire == "int8":  # ran on the card: a launch of each a step
                good = good and all(
                    r["counts"][k] == warmup + steps + (2 if graph else 0)
                    for k in want["int8"])
            ok = ok and good
            log(f"phase 2d: ResNet-50 world 1 batch {batch} compiled plane "
                f"({label}): {r['images_per_sec']:.1f} images/s (the "
                f"engine's plane in this call: "
                f"{engine[wire]:.1f}), per replay "
                f"{ts.launches_per_replay}, launches {({k: v for k, v in r['counts'].items() if v})}"
                f", losses {[round(v, 4) for v in losses]}"
                + (f", busy {r['profile']['busy_pct']:.1f}% of "
                   f"{r['profile']['wall_ms']:.1f} ms over 2 profiled "
                   f"steps" if graph else "") + f" on {CARD}: ok={good}")
            del tr
            release()
        lg, le = (out[f"{wire} {m}"]["losses"] for m in ("graphed", "eager"))
        rel = max(abs(a - b) / abs(b) for a, b in zip(lg, le))
        out[f"{wire} loss_rel"] = rel
        ok = ok and rel <= RESNET_GRAPH_LOSS
        log(f"phase 2d: {wire}: graphed against eager losses, rel {rel:.3e} "
            f"(<= {RESNET_GRAPH_LOSS})")
    out["engine_images_per_sec"] = engine
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 2d took {out['seconds']:.1f} s")
    if not ok:
        raise AssertionError("phase 2d, the compiled ResNet-50 step, failed "
                             "its checks")
    return out


def lm_agreement(fused: bool) -> dict:
    """GPT-2-medium's compiled step, graphed against eager, 3 steps from
    the same weights with the lr set before each (``LM_LRS``)."""
    from horovod_tpu_torch.train import LMTrainer

    runs = {}
    for graph in (False, True):
        tr = LMTrainer("medium", fused_ln=fused, fused_opt=fused,
                       device="cuda:0", compiled=True, graph=graph)
        losses = []
        for lr in LM_LRS:
            tr.opt.param_groups[0]["lr"] = lr
            losses.append(float(tr.step()))
        tr.sync()
        runs[graph] = (losses, [p.detach().float().clone()
                                for p in tr.net.parameters()])
        if graph:
            graphed = tr
        else:
            del tr
            release()
    (le, pe), (lg, pg) = runs[False], runs[True]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(le, lg))
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pe, pg)])
    share = float((diffs <= COMPILED_PARAM).float().mean())
    worst = float(diffs.max())
    bits = all(torch.equal(a, b) for a, b in zip(pe, pg))
    ok = (loss_rel <= COMPILED_LOSS and share >= 0.999
          and worst <= 2 * sum(LM_LRS))
    return {"graphed_trainer": graphed, "loss_rel": loss_rel,
            "share": share, "param_max": worst, "bit_equal": bits,
            "losses": {"eager": le, "graphed": lg}, "ok": ok}


def phase_compiled_lm(engine: dict) -> dict:
    """Phase 5e: GPT-2-medium at world 1 through ``make_train_step`` as a
    CUDA graph, default (K5, K7; AdamW fused and capturable) and
    fused_ln + fused_opt (K8 x49 and K9 x1 a replay, K9 from device
    scalars), against phase 5b's engine-plane numbers of this call;
    graphed against eager for 3 steps with the lr changing each step
    (fused path); the busy share of two profiled graphed steps."""
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import LMTrainer, peak_bf16_flops

    steps, warmup = 5, 2
    peak = peak_bf16_flops(torch.cuda.get_device_name(0))
    out, ok = {}, True
    for label, fused in (("fused_ln+fused_opt", True), ("default", False)):
        t0 = time.perf_counter()
        ck.reset_launch_counts()
        if fused:
            agree = lm_agreement(True)
            tr = agree.pop("graphed_trainer")
        else:
            agree = None
            tr = LMTrainer("medium", device="cuda:0", compiled=True,
                           graph=True)
        losses, secs = timed_steps(tr, warmup, steps)
        ts = tr.train_step
        tok = tr.batch * tr.seq * steps / secs
        r = {"losses": losses, "tokens_per_sec": tok,
             "step_ms": 1e3 * secs / steps,
             "mfu_pct": 100 * 6 * tr.n_nonemb * tok / peak,
             "launches_per_replay": ts.launches_per_replay,
             "counts": ck.launch_counts(), "agreement": agree,
             "graphed": ts.graphed}
        if fused:
            r["profile"] = busy_share(tr.step)
        want = {k: v for k, v in lm_per_step(fused, MEDIUM["layers"]).items()
                if v}
        good = (ts.graphed and ts.launches_per_replay == want
                and all(math.isfinite(v) for v in losses)
                and (agree is None or agree["ok"]))
        ok = ok and good
        r["seconds"] = time.perf_counter() - t0
        log(f"phase 5e: GPT-2-medium world 1 compiled plane, graphed "
            f"({label}): {tok:.1f} tokens/s, {r['step_ms']:.2f} ms a step, "
            f"MFU {r['mfu_pct']:.2f}% (the engine's plane in this call: "
            f"{engine[label]['tokens_per_sec']:.1f} tokens/s, "
            f"{engine[label]['step_ms']:.2f} ms, MFU "
            f"{engine[label]['mfu_pct']:.2f}%), per replay "
            f"{ts.launches_per_replay} (want {want})"
            + (f", busy {r['profile']['busy_pct']:.1f}% of "
               f"{r['profile']['wall_ms']:.1f} ms over 2 profiled steps"
               if fused else "")
            + (f"; graphed vs eager, 3 steps at lr {LM_LRS}: loss rel "
               f"{agree['loss_rel']:.3e} (<= {COMPILED_LOSS}), params within "
               f"{COMPILED_PARAM} {agree['share']:.6f} (>= 0.999), max "
               f"{agree['param_max']:.3e} (<= {2 * sum(LM_LRS):.1e}), bit-"
               f"equal {agree['bit_equal']}" if agree else "")
            + f"; {r['seconds']:.1f} s on {CARD}: ok={good}")
        out[label] = r
        del tr, ts  # the step holds its graph's memory pool
        release()
    if not ok:
        raise AssertionError("phase 5e, the compiled LM step, failed its "
                             "checks")
    return out


def graph_replay_ms(fn, iters: int = 20) -> float:
    """The time of one call of ``fn`` replayed as a CUDA graph of its own
    (warmed on a side stream first): what is left of a call once the
    host's part is gone. The capture's launch ticks are taken back."""
    from horovod_tpu_torch.ops import cuda_kernels as ck

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = ck.launch_counts()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    after = ck.launch_counts()
    ck.add_launches({k: before[k] - after[k] for k in after})
    return cuda_ms(g.replay, iters)


def resnet50_total() -> int:
    from horovod_tpu_torch.models import resnet

    return sum(p.numel() for p in resnet.ResNet50().parameters())


def flip_hop(spmd, index: int) -> None:
    """Make the ``index``-th hop this process sends from now carry one
    byte flipped (byte 3: an int8 payload value, or an f32's sign and
    exponent): a wrong wire on purpose."""
    exchange = spmd._exchange
    seen = [0]

    def faulty(t, to_rank, from_rank, group=None):
        if seen[0] == index:
            t = t.contiguous().clone()
            b = t.view(-1).view(torch.uint8)
            b[min(3, b.numel() - 1)] ^= 0xFF
        seen[0] += 1
        return exchange(t, to_rank, from_rank, group)

    spmd._exchange = faulty


def algo_card_worker(total: int, fault: bool) -> dict:
    """One rank of phase 3c: ResNet-50's flat gradient (``total`` f32
    values from N(0, 1), seeded by rank) through the three allreduces on
    int8, int4 and the exact wire (the exact ring as the ring's raw hops);
    each result's digest, its error against the f64 mean of every rank's
    row, and the bytes this rank's hops sent. ``fault``: each case again
    with one byte of this rank's last hop flipped (rank 0)."""
    import hashlib

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.ops import cuda_kernels as ck

    dev, r, world = hvd.device(), hvd.rank(), hvd.size()

    def row(k):
        gen = torch.Generator(dev).manual_seed(1000 + k)
        return torch.randn(total, generator=gen, device=dev)

    exact = sum(row(k).double() for k in range(world)) / world
    x = row(r)
    fns = {"ring": spmd.quantized_allreduce,
           "tree": spmd.quantized_allreduce_tree,
           "hier": spmd.quantized_allreduce_hier}
    ck.reset_launch_counts()

    def run(algo, wire):
        if algo == "ring" and wire == "off":
            c = spmd.quantized_reduce_scatter(x, "off", BLOCK)
            return spmd.quantized_all_gather(c, "off", BLOCK)[:total] / world
        return fns[algo](x, hvd.Average, wire, BLOCK)

    if world < 4:  # no (host, chip) factorization: hier is the ring
        del fns["hier"]
    exchange = spmd._exchange
    out = {"cases": {}, "backend": hvd.backend()}
    for algo in fns:
        for wire in ("int8", "int4", "off"):
            t0 = time.perf_counter()
            spmd.reset_hop_bytes()
            y = run(algo, wire)
            torch.cuda.synchronize(dev)
            case = {"seconds": time.perf_counter() - t0,
                    "bytes": spmd.hop_bytes(),
                    "digest": hashlib.sha256(
                        y.cpu().numpy().tobytes()).hexdigest(),
                    "err": float((y.double() - exact).abs().max())}
            if fault:
                hops = spmd.hops_sent()
                if r == 0:
                    flip_hop(spmd, hops - 1)
                y = run(algo, wire)
                spmd._exchange = exchange
                case.update(
                    fault_digest=hashlib.sha256(
                        y.cpu().numpy().tobytes()).hexdigest(),
                    fault_err=float((y.double() - exact).abs().max()))
            out["cases"][f"{algo}/{wire}"] = case
    out["counts"] = ck.launch_counts()
    return out


def algo_checks(world: int, ranks: list, total: int, faulted: bool) -> dict:
    """Phase 3c's verdicts a case: ranks bit-identical, the error within
    the bound, the hops' bytes the catalog's (the tree at world 4: the
    ring's row, 3/4 of the catalog's tree row)."""
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.ops import compression as comp

    verdicts = {}
    for case in ranks[0]["cases"]:
        algo, wire = case.split("/")
        mode = "none" if wire == "off" else wire
        cs = [r["cases"][case] for r in ranks]
        pre = "fault_" if faulted else ""
        same = len({c[pre + "digest"] for c in cs}) == 1
        bound = ALGO_TOL.get(wire, ALGO_EXACT_TOL)
        accurate = max(c[pre + "err"] for c in cs) <= bound
        hosts = spmd.mesh_hosts(world) if algo == "hier" else None
        row = comp.gspmd_wire_footprint(total, mode, world, BLOCK,
                                        algorithm=algo, hosts=hosts)
        if algo == "tree" and world > 2:
            row = comp.gspmd_wire_footprint(total, mode, world, BLOCK)
        sent = {c["bytes"] for c in cs}
        verdicts[case] = {"same": same, "accurate": accurate,
                          "bytes": sent == {row}, "sent": sorted(sent),
                          "catalog": row,
                          "err": max(c[pre + "err"] for c in cs),
                          "seconds": max(c["seconds"] for c in cs)}
    return verdicts


def phase_algorithms(fault: bool = False) -> dict:
    """Phase 3c: the compiled plane's allreduces at world 2 (the ring and
    the tree) and 4 (and hier on 2 hosts), gloo processes sharing the
    card, over
    ResNet-50's flat gradient on int8, int4 and the exact wire:
    bit-identical ranks, the error against the exact mean within the
    reference's bounds, the bytes the hops sent equal to the catalog's.
    ``fault``: with a byte of one hop flipped, every case's checks must
    fail."""
    from horovod_tpu_torch import testing

    total = resnet50_total()
    out, ok = {}, True
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = testing.run_cluster(algo_card_worker, np=world,
                                    device="cuda", args=(total, fault),
                                    timeout=900)
        v = algo_checks(world, ranks, total, False)
        good = (all(x["same"] and x["accurate"] and x["bytes"]
                    for x in v.values())
                and all(r["backend"] == "gloo" for r in ranks))
        res = {"verdicts": v, "seconds": time.perf_counter() - t0,
               "counts": [r["counts"] for r in ranks]}
        if fault:
            res["fault_verdicts"] = fv = algo_checks(world, ranks, total,
                                                     True)
            res["caught"] = {k: not (x["same"] and x["accurate"])
                             for k, x in fv.items()}
        ok = ok and good
        out[world] = res
        log(f"phase 3c: world {world} (gloo, one card), {total} f32 values "
            f"a rank: " + "; ".join(
                f"{k}: same {x['same']}, err {x['err']:.3e}, bytes "
                f"{x['sent']} / catalog {x['catalog']}, {x['seconds']:.2f} s"
                for k, x in v.items())
            + f"; {res['seconds']:.1f} s: ok={good}")
    if not ok and not fault:
        raise AssertionError("phase 3c, the compiled plane's allreduces, "
                             "failed its checks")
    return out


def flat_params(net) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float()
                      for p in net.parameters()])


def plant_zero1_fault(tr, fault: str):
    """A wrong ZeRO-1 step on purpose, one every rank makes alike (so the
    ranks stay bit-identical): the reduce-scattered gradient not averaged
    over the ranks (``unaveraged``) or the inner optimizer's step skipped
    (``no-step``). Returns the function that undoes it."""
    from horovod_tpu_torch import spmd

    if fault == "unaveraged":
        mean = spmd._mean
        spmd._mean = lambda flat, m: flat

        def undo():
            spmd._mean = mean
    else:
        tr.train_step.inner.step = lambda *a, **k: None

        def undo():
            del tr.train_step.inner.step
    return undo


def zero1_card_worker(batch: int, steps: int, faults=()) -> dict:
    """One rank of phase 3d: ResNet-50 through ``make_train_step`` on the
    int8 wire, replicated and with ZeRO-1 (with ``faults``: a ZeRO-1 run
    with each planted fault instead), 1 + ``steps`` steps each; each
    run's final parameters against the replicated run's: the largest
    |difference| over the largest |update| the replicated run made."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import ImageTrainer, params_sha256

    out = {"backend": hvd.backend()}
    runs = [("replicated", False, None)] + (
        [(f, True, f) for f in faults] if faults else [("zero1", True, None)])
    ref = update = None
    for label, z, fault in runs:
        ck.reset_launch_counts()
        tr = ImageTrainer("ResNet50", batch=batch, image=224,
                           compression="int8", plane="compiled", zero1=z)
        start = flat_params(tr.net)
        undo = plant_zero1_fault(tr, fault) if fault else None
        losses, secs = timed_steps(tr, 1, steps)
        if undo:
            undo()
        end = flat_params(tr.net)
        if ref is None:
            ref, update = end, float((end - start).abs().max())
        step = tr.train_step
        out[label] = {"losses": losses, "seconds": secs,
                      "sha": params_sha256(tr.net), "graphed": step.graphed,
                      "state": step.zero1_state_numel() if z else None,
                      "total": sum(p.numel() for p in tr.net.parameters()),
                      "gap": float((end - ref).abs().max()) / update,
                      "update": update, "counts": ck.launch_counts()}
        del tr, step, start, end
        release()
    return out


def phase_zero1(faults=()) -> dict:
    """Phase 3d: the quantized step at world 2 (two gloo processes sharing
    the card), ResNet-50 batch 32 a rank, 1 + 2 steps, with and without
    ZeRO-1: parameters bit-identical across ranks, the ZeRO-1 state 1/2 a
    rank, losses finite and within ZERO1_LOSS_REL of the replicated
    step's, final parameters within ZERO1_PARAM_GAP of the replicated
    step's update. ``faults``: ZeRO-1 runs with those planted faults
    instead; each must fail the agreement (losses or parameters)."""
    from horovod_tpu_torch import testing
    from horovod_tpu_torch.optim import zero

    t0 = time.perf_counter()
    ranks = testing.run_cluster(zero1_card_worker, np=2, device="cuda",
                                args=(32, 2, tuple(faults)), timeout=900)
    labels = list(faults) or ["zero1"]
    total = ranks[0]["replicated"]["total"]
    chunk = zero.ring_chunk(total, 2, BLOCK)
    rep = ranks[0]["replicated"]["losses"]
    res = {"ranks": ranks, "chunk": chunk, "total": total, "runs": {}}
    ok = (ranks[0]["replicated"]["sha"] == ranks[1]["replicated"]["sha"]
          and all(r["backend"] == "gloo" for r in ranks)
          and not any(r["replicated"]["graphed"] for r in ranks))
    for label in labels:
        rel = max(abs(a - b) / abs(a)
                  for a, b in zip(rep, ranks[0][label]["losses"]))
        gap = max(r[label]["gap"] for r in ranks)
        v = {"same": ranks[0][label]["sha"] == ranks[1][label]["sha"],
             "state": all(r[label]["state"] == chunk for r in ranks),
             "finite": all(math.isfinite(x) for r in ranks for z in
                           ("replicated", label) for x in r[z]["losses"]),
             "eager": not any(r[label]["graphed"] for r in ranks),
             "losses": rel <= ZERO1_LOSS_REL,
             "parameters": gap <= ZERO1_PARAM_GAP,
             "loss_rel": rel, "gap": gap}
        v["caught"] = not (v["losses"] and v["parameters"])
        res["runs"][label] = v
        ok = ok and all(v[k] for k in ("same", "state", "finite", "eager",
                                       "losses", "parameters"))
        log(f"phase 3d{f' with fault {label}' if faults else ''}: world 2 "
            f"(gloo, one card) ResNet-50 batch 32/rank int8 compiled step: "
            f"params bit-identical (replicated, ZeRO-1) "
            f"{ranks[0]['replicated']['sha'] == ranks[1]['replicated']['sha']}"
            f", {v['same']}; ZeRO-1 state {ranks[0][label]['state']} "
            f"elements a rank of {total} parameters (chunk {chunk}); losses "
            f"{[round(x, 4) for x in rep]} / "
            f"{[round(x, 4) for x in ranks[0][label]['losses']]}, rel "
            f"{rel:.3e} (<= {ZERO1_LOSS_REL:g}); final parameters against "
            f"the replicated run's, max |diff| over its max |update| "
            f"{ranks[0]['replicated']['update']:.4e}: {gap:.3e} (<= "
            f"{ZERO1_PARAM_GAP:g}); ok={ok}")
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 3d took {res['seconds']:.1f} s")
    if not ok and not faults:
        raise AssertionError("phase 3d, the quantized ZeRO-1 step, failed "
                             "its checks")
    return res


def zero1_fault_check() -> int:
    """``--fault zero1``: phase 3d with each planted ZeRO-1 fault; 0 when
    every one fails the agreement with the replicated step."""
    out = phase_zero1(ZERO1_FAULTS)
    caught = {k: v["caught"] for k, v in out["runs"].items()}
    print(json.dumps({"fault": "zero1", "caught": caught}), flush=True)
    return 0 if all(caught.values()) else 1


def algo_fault_check() -> int:
    """``--fault flip-byte``: phase 3c with one byte of one hop flipped a
    case; 0 when every case's agreement check fails."""
    out = phase_algorithms(fault=True)
    caught = {f"{w}/{k}": v for w, r in out.items()
              for k, v in r["caught"].items()}
    print(json.dumps({"fault": "flip-byte", "caught": caught}), flush=True)
    return 0 if all(caught.values()) else 1


# --------------------------------------------------------------- phase 3
def world2_worker(batch: int, image: int, steps: int) -> dict:
    """One rank of the world-2 run: int8 on the packed wire, then int4."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.runtime.executor import Executor
    from horovod_tpu_torch.train import synthetic_train

    os.environ["HOROVOD_PACKED_WIRE"] = "1"
    out = {"backend": hvd.backend(), "rank": hvd.rank()}
    for mode in ("int8", "int4"):
        ck.reset_launch_counts()
        res = synthetic_train("ResNet50", batch=batch, image=image,
                              steps=steps, warmup=0, compression=mode,
                              error_feedback=True)
        counts = ck.launch_counts()
        # the last quantized tensor: a ResNet-50 fc-weight-sized gradient
        g = torch.randn(1000, 2048, device=hvd.device(),
                        generator=torch.Generator(hvd.device()).manual_seed(
                            hvd.rank()))
        hvd.allreduce(g, compression=getattr(hvd.Compression, mode))
        ex = basics._executor()
        res.update(
            counts=counts, wire_mode=ex.last_wire_mode,
            wire_bytes=ex.last_wire_bytes,
            layout_bytes=Executor.quantized_wire_layout(
                g.numel(), hvd.size(), bits=4 if mode == "int4" else 8)
            ["wire_bytes"])
        out[mode] = res
    return out


def phase_world2() -> dict:
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    ranks = testing.run_cluster(world2_worker, np=2, device="cuda",
                                args=(32, 224, 2), timeout=900)
    ok = all(r["backend"] == "gloo" for r in ranks)
    for mode, kernel in (("int8", "int8_quantize_pack_2d"),
                         ("int4", "int4_quantize_pack_2d")):
        rs = [r[mode] for r in ranks]
        same = rs[0]["params_sha256"] == rs[1]["params_sha256"]
        launched = all(r["counts"][kernel] > 0 for r in rs)
        wire = all(r["wire_mode"] == mode
                   and r["wire_bytes"] == r["layout_bytes"] for r in rs)
        finite = all(math.isfinite(v) for r in rs for v in r["losses"])
        log(f"phase 3: world 2 (gloo, one card) ResNet-50 batch 32/rank "
            f"{mode} packed wire: params bit-identical {same}, {kernel} "
            f"launches {[r['counts'][kernel] for r in rs]}, last wire bytes "
            f"{rs[0]['wire_bytes']} == layout {rs[0]['layout_bytes']}: "
            f"{wire}, losses {[[round(v, 4) for v in r['losses']] for r in rs]}"
            f", {rs[0]['images_per_sec']:.1f} images/s/rank")
        ok = ok and same and launched and wire and finite
    if not ok:
        raise AssertionError("world-2 main path failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


# -------------------------------------------------------------- phase 3b
# ResNet-50 at world 2 through the engine: the backward hooks enqueue each
# gradient (or bucket, HOROVOD_BUCKET_MB) as an async request. Buckets of
# 25 MiB, the default bucket size of PyTorch's DistributedDataParallel.
ENGINE_BUCKET_MB = "25"
ENGINE_CASES = (("exact", dict(compression="none", error_feedback=False)),
                ("int8", dict(compression="int8", error_feedback=True)),
                ("adasum", dict(op="adasum")))


def engine_worker(batch: int, image: int, warmup: int, steps: int) -> dict:
    """One rank of phase 3b: each case of ``ENGINE_CASES`` trained per
    tensor and then with buckets (``synthetic_train``, launches counted
    from 0 just before each run), with cuDNN held to deterministic
    algorithms so that two runs can be compared bit for bit. Responses a
    step leave out the model's ``broadcast_parameters``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.optim.distributed import gradient_units
    from horovod_tpu_torch.train import synthetic_train

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ.pop("HOROVOD_PACKED_WIRE", None)  # #1 on the int8 wire
    eng = hvd.basics._engine()
    model = resnet.ResNet50()
    broadcasts = len(model.state_dict())
    out = {"backend": hvd.backend(), "runs": {}}
    try:
        for label, kw in ENGINE_CASES:
            for mb in ("", ENGINE_BUCKET_MB):
                os.environ["HOROVOD_BUCKET_MB"] = mb
                units, _ = gradient_units(model.named_parameters(),
                                          hvd.Compression.none)
                ck.reset_launch_counts()
                before = eng.responses_performed
                res = synthetic_train("ResNet50", batch=batch, image=image,
                                      steps=steps, warmup=warmup, **kw)
                res["counts"] = ck.launch_counts()
                res["responses_per_step"] = (
                    eng.responses_performed - before - broadcasts) / (
                        warmup + steps)
                res["host_ms_per_step"] = batch / res["images_per_sec"] * 1e3
                res["units"] = len(units)
                out["runs"][f"{label}{'_bucketed' if mb else ''}"] = res
    finally:
        os.environ.pop("HOROVOD_BUCKET_MB", None)
    return out


def phase_engine_world2() -> dict:
    """Phase 3b (a)-(c): per tensor against bucketed, on two gloo ranks
    sharing the card."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    warmup, steps = 1, 2
    ran = warmup + steps
    ranks = testing.run_cluster(engine_worker, np=2, device="cuda",
                                args=(32, 224, warmup, steps), timeout=900)
    runs = [r["runs"] for r in ranks]
    ok = all(r["backend"] == "gloo" for r in ranks)
    for label, _ in ENGINE_CASES:
        per, buck = (f"{label}{s}" for s in ("", "_bucketed"))
        same_ranks = all(len({r[k]["params_sha256"] for r in runs}) == 1
                         for k in (per, buck))
        same_paths = runs[0][per]["params_sha256"] == \
            runs[0][buck]["params_sha256"]
        finite = all(math.isfinite(v) for r in runs for k in (per, buck)
                     for v in r[k]["losses"])
        leaves = runs[0][per]["gradient_leaves"]
        buckets = runs[0][buck]["units"]
        resp = [runs[0][k]["responses_per_step"] for k in (per, buck)]
        ms = [[round(r[k]["host_ms_per_step"], 1) for r in runs]
              for k in (per, buck)]
        counts = [runs[0][k]["counts"] for k in (per, buck)]
        detail = ""
        if label == "int8":
            # error feedback: one grouped #1 a step; the wire: a quantize
            # of each bucket and a requantize of its reduced chunk
            q = [c["int8_quantize_2d"] / ran for c in counts]
            ok_launch = 1 <= q[1] <= 1 + 2 * buckets
            detail = (f"int8_quantize_2d launches a step per tensor {q[0]} "
                      f"(error feedback's grouped one + 2 a quantized "
                      f"tensor), bucketed {q[1]} (<= 1 + 2 x {buckets} "
                      f"buckets: {ok_launch}); ")
            same_paths = True  # a bucket's blocks span leaves: other bits
        elif label == "adasum":
            k4 = [c["adasum_combine_pairs"] / ran for c in counts]
            ok_launch = k4[0] == 1 and 1 <= k4[1] <= buckets
            detail = (f"adasum_combine_pairs launches a step per tensor "
                      f"{k4[0]} (one batch: 1), bucketed {k4[1]} (<= "
                      f"{buckets} buckets): {ok_launch}; ")
        else:
            ok_launch = resp == [leaves, buckets]
        case_ok = same_ranks and same_paths and finite and ok_launch
        log(f"phase 3b ({'abc'[[c for c, _ in ENGINE_CASES].index(label)]}):"
            f" world 2 (gloo, one card) ResNet-50 batch 32/rank 224x224 "
            f"{label} through the engine, {ran} steps ({warmup} warm-up): "
            f"ranks bit-identical {same_ranks}, per tensor == bucketed "
            f"({ENGINE_BUCKET_MB} MiB) bits "
            f"{runs[0][per]['params_sha256'] == runs[0][buck]['params_sha256']}"
            f"; {leaves} tensors vs {buckets} buckets, responses a step "
            f"{resp}; {detail}host ms a step per rank per tensor {ms[0]}, "
            f"bucketed {ms[1]}; losses "
            f"{[round(v, 4) for v in runs[0][per]['losses']]}: ok={case_ok}")
        ok = ok and case_ok
    if not ok:
        raise AssertionError("phase 3b (engine, world 2) failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


def phase_engine_world1() -> dict:
    """Phase 3b (d): the async API at world 1 on the card. ResNet-50's
    gradient-shaped tensors, seeded, then rewritten after a long spin of
    the current stream, are each enqueued with ``allreduce_async_``; a
    poll made at once, the responses the engine formed (fused under
    ``HOROVOD_FUSION_THRESHOLD``), and the values after ``synchronize``
    (an average over one rank: the inputs, so a read that did not wait for
    the rewrite would show)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    dev = hvd.device()
    eng = hvd.basics._engine()
    gen = torch.Generator(dev).manual_seed(3)
    base = [torch.randn(p.shape, device=dev, generator=gen)
            for p in resnet.ResNet50().parameters()]
    ts = [b.clone() for b in base]
    torch.cuda.synchronize(dev)
    res = {}
    for rep in range(2):  # the first pays the engine stream's first use
        for b in base:
            b.add_(1.0)
        torch.cuda._sleep(50_000_000)
        for t in ts:
            t.add_(1.0)
        before = eng.responses_performed
        t0 = time.perf_counter()
        hs = [hvd.allreduce_async_(t, name=f"grad.{i}")
              for i, t in enumerate(ts)]
        polled = hvd.poll(hs[-1])
        outs = [hvd.synchronize(h) for h in hs]
        same = all(o is t and torch.equal(o, b)
                   for o, t, b in zip(outs, ts, base))
        torch.cuda.synchronize(dev)
        res[rep] = {"host_ms": (time.perf_counter() - t0) * 1e3,
                    "poll": polled, "same": same,
                    "responses": eng.responses_performed - before}
    same = all(r["same"] for r in res.values())
    ok = same and not res[0]["poll"] and res[1]["responses"] < len(ts)
    log(f"phase 3b (d): world 1 async API on the card, {len(ts)} "
        f"ResNet-50 gradient tensors through allreduce_async_: poll at "
        f"once {[res[k]['poll'] for k in res]}, responses "
        f"{[res[k]['responses'] for k in res]} (fusion threshold "
        f"{eng.controller.fusion_threshold()} bytes), values after "
        f"synchronize equal the inputs written after a spin of the stream "
        f"{same}, host ms {[round(res[k]['host_ms'], 1) for k in res]}: "
        f"ok={ok}")
    if not ok:
        raise AssertionError("phase 3b (d), the async API at world 1, "
                             "failed its checks")
    return res


# -------------------------------------------------------------- phase 3e
# The engine's programs at world 4 on one card, 2 hosts x 2. Cluster A
# starts with HOROVOD_HIERARCHICAL_ALLREDUCE=1 (read at init), cluster B
# with HOROVOD_GSPMD_ALGO=tree (the two-level knob would take precedence).
# label: (cluster, compression, error feedback, algorithm, wire)
PROGRAM_RUNS = {"a": ("A", "none", False, "hier", ""),
                "b": ("B", "none", False, "tree", ""),
                "c": ("A", "int8-dcn", True, "ring", "int8-dcn"),
                "d": ("A", "adaptive", True, "ring", None)}
# the flat gradient: label: (cluster, compression, algorithm, wire)
PROGRAM_FLAT = {"hier": ("A", "none", "hier", ""),
                "int8-dcn": ("A", "int8_dcn", "ring", "int8-dcn"),
                "bf16": ("A", "bf16 wire", "ring", "bf16"),
                "adaptive": ("A", "adaptive", "ring", "int4"),
                "tree": ("B", "none", "tree", "")}
PROGRAM_ENV = {"A": {"HOROVOD_HIERARCHICAL_ALLREDUCE": "1"},
               "B": {"HOROVOD_GSPMD_ALGO": "tree"}}
# error bounds against the exact mean of N(0, 1) rows: the exact programs
# ALGO_EXACT_TOL absolute, int4 ALGO_TOL's; relative to the largest |mean|:
# int8-dcn 3e-2 (tests/test_allreduce.py's bound for its bf16 + int8 hops),
# bf16 2^-7 (two roundings to bf16: the parts and their sum)
PROGRAM_REL_TOL = {"int8-dcn": 3e-2, "bf16": 2 ** -7}
WIRE_KERNELS = ("int8_quantize_2d", "int8_quantize_pack_2d",
                "int8_dequantize_2d", "int4_quantize_pack_2d")


def wire_bytes(mode: str, n: int, world: int) -> int:
    """The reference's accounting of one allreduce of ``n`` f32 values:
    ``2 * n * 2`` on the bf16 wire, the quantized layout's on int8 /
    int8-dcn / int4, ``2 * n * 4`` exact."""
    from horovod_tpu_torch.runtime.executor import Executor

    if mode == "bf16":
        return 2 * n * 2
    if mode:
        return Executor.quantized_wire_layout(
            n, world, bits=4 if mode == "int4" else 8)["wire_bytes"]
    return 2 * n * 4


def program_worker(cluster: str, batch: int, image: int, warmup: int,
                   steps: int, total: int) -> dict:
    """One rank of phase 3e's cluster ``cluster``: its training runs, then
    its flat-gradient cases. The quantized sums are recorded with the group
    they run on (the engine's whole group, or the cross-host one)."""
    import hashlib

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import adaptive
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.optim.distributed import gradient_units
    from horovod_tpu_torch.runtime.executor import Executor, group_ranks
    from horovod_tpu_torch.train import ImageTrainer, params_sha256

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["HOROVOD_BUCKET_MB"] = ENGINE_BUCKET_MB
    os.environ["HOROVOD_ADAPTIVE_INTERVAL"] = "1"
    dev, r, world = hvd.device(), hvd.rank(), hvd.size()
    ex = basics._executor()
    sums = []
    quantized_sum = Executor._quantized_sum

    def recorded(self, x, bits, group=None, m=None):
        sums.append(group_ranks(group if m else self._group))
        return quantized_sum(self, x, bits, group, m)

    Executor._quantized_sum = recorded
    observe = hvd.Compression.adaptive.observe
    observed = []  # host seconds of each observation (sample copy + stats)

    def timed(name, flat):
        t0 = time.perf_counter()
        observe(name, flat)
        observed.append(time.perf_counter() - t0)

    hvd.Compression.adaptive.observe = staticmethod(timed)
    out = {"backend": hvd.backend(), "runs": {}, "flat": {}}
    for label, (cl, compression, ef, _, _) in PROGRAM_RUNS.items():
        if cl != cluster:
            continue
        hvd.Compression.adaptive.reset()
        adaptive.reset()
        tr = ImageTrainer("ResNet50", batch=batch, image=image,
                           compression=compression, error_feedback=ef)
        units, _ = gradient_units(tr.net.named_parameters(),
                                  hvd.Compression.none)
        tr.sync()
        ck.reset_launch_counts()
        sums.clear()
        t0 = time.perf_counter()
        res = {"losses": [], "modes": [], "algorithms": [], "bytes": [],
               "decisions": [], "observe_ms": []}
        for _ in range(warmup + steps):
            observed.clear()
            res["losses"].append(float(tr.step()))
            res["modes"].append(ex.last_wire_mode)
            res["algorithms"].append(ex.last_algorithm)
            res["bytes"].append(ex.last_wire_bytes)
            res["decisions"].append(
                hvd.Compression.adaptive.selector().decisions())
            res["observe_ms"].append(sum(observed) * 1e3)
        tr.sync()
        res.update(seconds=time.perf_counter() - t0,
                   counts=ck.launch_counts(),
                   sums=[list(g) for g in {tuple(g) for g in sums}],
                   params_sha256=params_sha256(tr.net), buckets=len(units),
                   last_n=sum(p.numel() for _, p in units[-1]),
                   record=adaptive.bitwidth_decisions())
        out["runs"][label] = res
        del tr
        torch.cuda.empty_cache()

    def row(k):
        gen = torch.Generator(dev).manual_seed(1000 + k)
        return torch.randn(total, generator=gen, device=dev)

    class Bf16Wire(hvd.Compression.none):
        wire = "adaptive:bf16"  # the bf16 program, as negotiated

    exact = sum(row(k).double() for k in range(world)) / world
    x = row(r)
    for label, (cl, compression, _, _) in PROGRAM_FLAT.items():
        if cl != cluster:
            continue
        comp = (Bf16Wire if compression == "bf16 wire"
                else getattr(hvd.Compression, compression))
        name = f"flat.{label}"
        if compression == "adaptive":  # one Gaussian observation: int4
            hvd.Compression.adaptive.reset()
            hvd.Compression.adaptive.observe(name, row(99)[:4096])
        ck.reset_launch_counts()
        sums.clear()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = hvd.allreduce(x, op=hvd.Average, name=name, compression=comp)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        err = (y.double() - exact).abs().max()
        out["flat"][label] = {
            "seconds": seconds, "mode": ex.last_wire_mode,
            "algorithm": ex.last_algorithm, "bytes": ex.last_wire_bytes,
            "digest": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest(),
            "err": float(err),
            "rel": float(err / exact.abs().max()),
            "counts": ck.launch_counts(),
            "sums": [list(g) for g in {tuple(g) for g in sums}]}
        del y
    Executor._quantized_sum = quantized_sum
    hvd.Compression.adaptive.observe = observe
    return out


def program_checks(label: str, runs: list, warmup: int, steps: int) -> tuple:
    """Phase 3e's verdict on one training configuration: ``(ok, line)``."""
    _, compression, _, algo, wire = PROGRAM_RUNS[label]
    ran = warmup + steps
    same = len({r["params_sha256"] for r in runs}) == 1
    finite = all(math.isfinite(v) for r in runs for v in r["losses"])
    r0 = runs[0]
    algos = all(set(r["algorithms"]) == {algo} for r in runs)
    if wire is None:  # adaptive: each rank's sequence, the same on all
        modes = (all(r["modes"] == r0["modes"]
                     and r["decisions"] == r0["decisions"] for r in runs)
                 and r0["modes"][0] == "int8" and bool(r0["decisions"][0]))
    else:
        modes = all(set(r["modes"]) == {wire} for r in runs)
    nbytes = all(r["bytes"][-1] == wire_bytes(r["modes"][-1], r0["last_n"],
                                              4) for r in runs)
    c = r0["counts"]
    if label in ("a", "b"):  # exact: no wire kernel
        launched = all(r["counts"][k] == 0 for r in runs
                       for k in WIRE_KERNELS) and not r0["sums"]
    elif label == "c":  # error feedback's #1 / #2; the wire's on the
        # cross-host groups ([0, 2], [1, 3]) only
        launched = (c["int8_quantize_2d"] >= ran
                    and c["int8_dequantize_2d"] >= ran
                    and all(len(g) == 2 and g[1] - g[0] == 2
                            for r in runs for g in r["sums"]))
    else:
        launched = (c["int8_quantize_2d"] + c["int4_quantize_pack_2d"]
                    >= 1 and c["int8_dequantize_2d"] >= 1)
    ok = same and finite and algos and modes and nbytes and launched
    line = (f"phase 3e ({label}): world 4 (gloo, one card, 2 x 2) ResNet-50 "
            f"batch 32/rank {compression}, {PROGRAM_RUNS[label][3]}, "
            f"{ran} steps ({warmup} warm-up) through the hooks in "
            f"{ENGINE_BUCKET_MB} MiB buckets ({r0['buckets']}): params "
            f"bit-identical {same}; algorithms {r0['algorithms']}: {algos}; "
            f"wire modes {[r['modes'] for r in runs]}"
            + (f", decisions {r0['decisions'][-1]}, host ms a step in "
               f"observe {[round(v, 2) for v in r0['observe_ms']]}"
               if wire is None else "")
            + f": {modes}; last bytes {r0['bytes'][-1]} == accounting "
            f"{wire_bytes(r0['modes'][-1], r0['last_n'], 4)} of "
            f"{r0['last_n']} values: {nbytes}; launches "
            f"{ {k: c[k] for k in WIRE_KERNELS} }, quantized sums on "
            f"groups {r0['sums']}: {launched}; losses "
            f"{[round(v, 4) for v in r0['losses']]}, "
            f"{r0['seconds']:.1f} s: ok={ok}")
    return ok, line


def flat_checks(label: str, cases: list, total: int) -> tuple:
    """Phase 3e's verdict on one flat-gradient program: ``(ok, line)``."""
    _, _, algo, wire = PROGRAM_FLAT[label]
    c0 = cases[0]
    same = len({c["digest"] for c in cases}) == 1
    if wire in PROGRAM_REL_TOL:
        accurate = max(c["rel"] for c in cases) <= PROGRAM_REL_TOL[wire]
    else:
        accurate = max(c["err"] for c in cases) <= ALGO_TOL.get(
            wire, ALGO_EXACT_TOL)
    how = all((c["mode"], c["algorithm"]) == (wire, algo) for c in cases)
    nbytes = all(c["bytes"] == wire_bytes(wire, total, 4) for c in cases)
    k = c0["counts"]
    if wire == "int8-dcn":
        launched = (k["int8_quantize_2d"] > 0
                    and all(len(g) == 2 and g[1] - g[0] == 2
                            for c in cases for g in c["sums"]))
    elif wire == "int4":
        launched = k["int4_quantize_pack_2d"] > 0
    else:
        launched = all(k[n] == 0 for n in WIRE_KERNELS)
    ok = same and accurate and how and nbytes and launched
    line = (f"phase 3e flat gradient {label}: {total} f32 values a rank, "
            f"{c0['algorithm']} / {c0['mode'] or 'exact'}: ranks "
            f"bit-identical {same}, err {max(c['err'] for c in cases):.3e} "
            f"(rel {max(c['rel'] for c in cases):.3e}): {accurate}; "
            f"program {how}; bytes {c0['bytes']}: {nbytes}; launches "
            f"{ {n: k[n] for n in WIRE_KERNELS} }: {launched}; "
            f"{max(c['seconds'] for c in cases):.2f} s: ok={ok}")
    return ok, line


def phase_programs() -> dict:
    """Phase 3e: the engine's two-level, tree, int8-dcn, bf16 and adaptive
    programs at world 4 on one card, 2 hosts x 2."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    warmup, steps = 1, 2
    total = resnet50_total()
    out, ok = {"clusters": {}}, True
    for cluster, env in PROGRAM_ENV.items():
        env = dict(env, HVD_UNIFORM_LOCAL_SIZE="2")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            ranks = testing.run_cluster(
                program_worker, np=4, device="cuda", timeout=600,
                args=(cluster, 32, 224, warmup, steps, total))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out["clusters"][cluster] = ranks
        ok = ok and all(r["backend"] == "gloo" for r in ranks)
        for label in ranks[0]["runs"]:
            good, line = program_checks(
                label, [r["runs"][label] for r in ranks], warmup, steps)
            log(line)
            ok = ok and good
        for label in ranks[0]["flat"]:
            good, line = flat_checks(
                label, [r["flat"][label] for r in ranks], total)
            log(line)
            ok = ok and good
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 3e: {out['seconds']:.1f} s: ok={ok}")
    if not ok:
        raise AssertionError("phase 3e, the engine's programs at world 4, "
                             "failed its checks")
    return out


# --------------------------------------------------------------- phase 4
def adasum_worker(model: str, batch: int, image: int, steps: int,
                  num_filters: int, dryrun: bool) -> dict:
    """One rank of an Adasum run: the training (launches counted from 0
    just before it and read just after), then, if asked, the dry run and
    the in-step primitive against the eager allreduce."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd, testing
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import synthetic_train

    ck.reset_launch_counts()
    res = synthetic_train(model, batch=batch, image=image, steps=steps,
                          warmup=0, op="adasum", num_filters=num_filters)
    res["counts"] = ck.launch_counts()
    res["backend"] = hvd.backend()
    if dryrun:
        res["dryrun"] = testing.adasum_dryrun_worker()
        g = torch.randn(1000, 2048, device=hvd.device(),
                        generator=torch.Generator(hvd.device()).manual_seed(
                            hvd.rank()))
        res["spmd_equal"] = bits_equal(spmd.allreduce(g, op=hvd.Adasum),
                                       hvd.allreduce(g, op=hvd.Adasum))
        res["allreduce_breakdown"] = adasum_allreduce_breakdown(model)
    return res


def adasum_allreduce_breakdown(model: str) -> dict:
    """The communication of one Adasum step alone, over a seeded tensor of
    each of ``model``'s parameter shapes, warm: an eager Adasum allreduce
    of each in order, then (``flow_``) what the delta flow's step runs:
    every tensor enqueued in one batch, so that the engine gathers each and
    combines them all in one grouped launch. Each: host-clock ms, then a
    profiled run: combine launches, the combine kernel's device time, all
    device time, and the host operations that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.ops import collective_ops as ops
    from horovod_tpu_torch.ops import cuda_kernels as ck

    dev = hvd.device()
    gen = torch.Generator(dev).manual_seed(100 + hvd.rank())
    grads = [torch.randn(p.shape, device=dev, generator=gen)
             for p in getattr(resnet, model)().parameters()]

    def loop():
        for g in grads:
            hvd.allreduce(g, op=hvd.Adasum)
        torch.cuda.synchronize(dev)

    def flow():  # what the delta flow's step runs: every delta in one batch
        with ops.enqueue_together():
            hs = [ops.allreduce_async(g, name=f"adasum.{i}", op=hvd.Adasum)
                  for i, g in enumerate(grads)]
        ops.synchronize_all(hs)
        torch.cuda.synchronize(dev)

    res = {"leaves": len(grads), "elements": sum(g.numel() for g in grads)}
    for label, fn in (("", loop), ("flow_", flow)):
        fn()
        t0 = time.perf_counter()
        fn()
        res[f"{label}host_ms"] = (time.perf_counter() - t0) * 1e3
        before = ck.launch_counts()["adasum_combine_pairs"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        res[f"{label}launches"] = (ck.launch_counts()["adasum_combine_pairs"]
                                   - before)
        device = _device_ms(prof)
        res[f"{label}combine_device_ms"] = sum(
            v for k, v in device.items() if "adasum_" in k)
        res[f"{label}device_ms"] = sum(device.values())
        res[f"{label}top_host_ops_ms"] = sorted(
            ((e.key, e.self_cpu_time_total / 1e3)
             for e in prof.key_averages()), key=lambda kv: -kv[1])[:6]
    return res


def phase_adasum_world2() -> dict:
    import numpy as np

    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    steps = 2
    ranks = testing.run_cluster(adasum_worker, np=2, device="cuda",
                                args=("ResNet50", 32, 224, steps, 64, True),
                                timeout=900)
    launches = [r["counts"]["adasum_combine_pairs"] for r in ranks]
    same = ranks[0]["params_sha256"] == ranks[1]["params_sha256"]
    finite = all(math.isfinite(v) for r in ranks for v in r["losses"])
    # the step's 161 leaves in one grouped launch (one tree level)
    enough = launches == [steps] * 2 and all(
        r["gradient_leaves"] == RESNET50_LEAVES for r in ranks)
    xs = [np.asarray(r["dryrun"][1], np.float64) for r in ranks]
    want = testing.numpy_adasum(xs)
    want16 = testing.numpy_adasum([x.astype(np.float16).astype(np.float64)
                                   for x in xs])
    dry = (all(np.allclose(r["dryrun"][2], want, rtol=1e-5, atol=1e-6)
               and np.allclose(r["dryrun"][3], want16, rtol=5e-3, atol=5e-3)
               for r in ranks)
           and ranks[0]["dryrun"][2:] == ranks[1]["dryrun"][2:])
    spmd_ok = all(r["spmd_equal"] for r in ranks)
    br = ranks[0]["allreduce_breakdown"]
    ok = same and finite and enough and dry and spmd_ok and all(
        r["backend"] == "gloo" and r["device"].startswith("cuda")
        for r in ranks)
    log(f"phase 4: world 2 (gloo, one card) ResNet-50 batch 32/rank 224x224 "
        f"Adasum: params bit-identical {same}, adasum_combine_pairs "
        f"launches {launches} (one a step over its {RESNET50_LEAVES} "
        f"leaves: {steps}), losses "
        f"{[[round(v, 4) for v in r['losses']] for r in ranks]}, "
        f"{ranks[0]['images_per_sec']:.1f} images/s/rank; dry run vs numpy "
        f"oracle (f32 rtol 1e-5, fp16 5e-3) and equal on both ranks {dry}; "
        f"spmd.adasum == allreduce(op=Adasum) bits {spmd_ok}: ok={ok}")
    log(f"phase 4c: the Adasum allreduce of one ResNet-50 step alone "
        f"({br['leaves']} leaves, {br['elements']} elements), rank 0: "
        f"{br['host_ms']:.1f} ms host clock; profiled: combine kernel "
        f"{br['combine_device_ms']:.3f} ms of {br['device_ms']:.3f} ms "
        f"device time in {br['launches']} launches; top host ops (self ms) "
        f"{[(k, round(v, 2)) for k, v in br['top_host_ops_ms']]}; the delta "
        f"flow's combine of the same leaves {br['flow_host_ms']:.1f} ms host "
        f"clock, combine kernel {br['flow_combine_device_ms']:.3f} ms of "
        f"{br['flow_device_ms']:.3f} ms device time in "
        f"{br['flow_launches']} launch; top host ops "
        f"{[(k, round(v, 2)) for k, v in br['flow_top_host_ops_ms']]}; on "
        f"{CARD}")
    ok = ok and br["flow_launches"] == 1
    if not ok:
        raise AssertionError("world-2 Adasum path failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


def phase_adasum_world4() -> dict:
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    steps = 2
    ranks = testing.run_cluster(adasum_worker, np=4, device="cuda",
                                args=("ResNet18", 4, 32, steps, 8, False),
                                timeout=600)
    launches = [r["counts"]["adasum_combine_pairs"] for r in ranks]
    same = len({r["params_sha256"] for r in ranks}) == 1
    finite = all(math.isfinite(v) for r in ranks for v in r["losses"])
    # two tree levels a step, each one grouped launch over every leaf
    enough = launches == [2 * steps] * 4
    ok = same and finite and enough
    log(f"phase 4b: world 4 (gloo, one card) ResNet-18 width 8 batch 4/rank "
        f"32x32 Adasum: params bit-identical on all 4 ranks {same}, "
        f"adasum_combine_pairs launches {launches} (two a step over its "
        f"{ranks[0]['gradient_leaves']} leaves: {2 * steps}), losses "
        f"{[[round(v, 4) for v in r['losses']] for r in ranks]}: ok={ok}")
    if not ok:
        raise AssertionError("world-4 Adasum path failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------- phase 6
# Sequence parallelism at the long-context configuration: GPT-2-medium
# attention widths (16 heads of 64, bf16), a 16384-token sequence over sp = 4
# ranks, so a ring hop is q, k, v [1, 4096, 16, 64].
RING = dict(seq=16384, sp=4)
# K6 against its twin: m to RING_M_TOL (1 + |m|) (both convert to base 2 and
# back the same way; their logits differ in the order of the D-term sums),
# l to RING_L_TOL of its value (both sum the unrounded p in f32, in other
# orders), o as K5's out: ATTN_OUT_TOL[dtype] of the largest |o| of its
# (b, t, h) row (bf16: p rounds to bf16 against another running maximum). A
# fully masked hop leaves the carry bit for bit. K7 with f32 outputs at the
# hop offsets: ATTN_GRAD_TOL[dtype] of each gradient's largest |value|, and
# exact zeros above the diagonal.
RING_M_TOL, RING_L_TOL = 1e-5, 1e-5
SP_LR = 3e-4


def step_agreement(got, want, dtype):
    """(ok, max abs error, max ratio to its bound) of K6's carry against
    the twin's."""
    (m, l, o), (mt, lt, ot) = got, want
    fin = torch.isfinite(mt)
    dm = (m - mt).abs()[fin]
    rm = float((dm / (RING_M_TOL * (1 + mt.abs()[fin]))).max()) if \
        fin.any() else 0.0
    dl = (l - lt).abs()
    rl = float((dl / (RING_L_TOL * lt.abs() + 1e-30)).max())
    eo, ro = ratio_rows(o, ot, ATTN_OUT_TOL[dtype])
    err = max(float(dm.max()) if fin.any() else 0.0, float(dl.max()), eo)
    ratio = max(rm, rl, ro)
    ok = bool(torch.equal(torch.isinf(m), torch.isinf(mt))) and ratio <= 1
    return ok, err, ratio


def hop_bytes_ops(b, tq, tk, h, d, q_off, k_off, kernel):
    """(bytes, operations) of one K6 hop (q, k, v read; m, l and the f32 o
    read and written) or one K7 hop with f32 outputs (q, k, v, dO, lse, D
    read; dq, dk, dv written in f32), bf16 operands, causal."""
    pairs = b * h * causal_pairs(tq, tk, q_off, k_off, True)
    nq, nk = b * tq * h * d, b * tk * h * d
    if kernel == "step":
        return nq * 2 + 2 * nk * 2 + 4 * b * h * tq * 4 + 2 * nq * 4, \
            4 * d * pairs
    return (2 * nq + 2 * nk) * 2 + 2 * b * h * tq * 4 + (nq + 2 * nk) * 4, \
        10 * d * pairs


def fresh_carry(b, t, h, d):
    """K6's carry before the first hop: m = -inf, l = 0, o = 0."""
    return [torch.full((b, h, t), float("-inf"), device="cuda"),
            torch.zeros(b, h, t, device="cuda"),
            torch.zeros(b, t, h, d, device="cuda")]


def ring_hop_inputs(ck, gen, b, t, h, d, dt):
    """The three hops of rank 2 of a causal ring of RING["sp"] = 4 ranks
    over a seeded ``[b, 4 t, h, d]`` sequence in ``dt``, as phase 6 checks
    and times them:
    ({"below" | "diagonal" | "above": (q, k, v, dO, lse, D, kwargs)},
    carry). The carry is that of the hop over block 0 (the twin's), and lse
    and D = rowsum(dO * O) are those of q's rows over the whole sequence
    (K5's), which the ring's backward hops take. ``ck`` is the
    ``cuda_kernels`` module of the checkout that runs."""
    def rnd():
        return torch.randn(b, RING["sp"] * t, h, d, generator=gen,
                           device="cuda").to(dt)

    q, k, v, do = (rnd() for _ in range(4))
    scale, my = d ** -0.5, 2
    qb, dob = q[:, my * t:(my + 1) * t], do[:, my * t:(my + 1) * t]
    carry = ck.flash_attention_step_plain(
        qb, k[:, :t], v[:, :t], *fresh_carry(b, t, h, d), causal=True,
        scale=scale, q_off=my * t, k_off=0)
    out, lse = ck.flash_attention_fwd(qb, k, v, causal=True, scale=scale,
                                      q_off=my * t, k_off=0)
    dd = (dob.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    hops = {}
    for hop, src in (("below", my - 1), ("diagonal", my), ("above", my + 1)):
        kb, vb = k[:, src * t:(src + 1) * t], v[:, src * t:(src + 1) * t]
        kw = dict(causal=True, scale=scale, q_off=my * t, k_off=src * t)
        hops[hop] = (qb, kb, vb, dob, lse, dd, kw)
    return hops, carry


def phase_ring_kernels(rate: float) -> dict:
    """K6 (flash_attention_step) and K7 with f32 outputs at hop offsets
    against their twins on the card: the three hops of rank 2 of a 4-rank
    causal ring (below the diagonal, on it, above it) from a carried (m, l,
    o), at the long-context hop shape and in f32 at D = 128 and a ragged T;
    K6 with Tk = 16384 at BH = 1 and K7 at Tq = Tk = 17408, BH = 1; K5 and
    K7 (bf16 outputs) at Ulysses's shape; then times at the hop shape."""
    from horovod_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(6)
    checks, worst = [], {}

    def note(kernel, what, ok, err, ratio):
        checks.append((kernel, what, ok, err, ratio))
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        log(f"  {kernel} {what}: max |kernel - twin| {err:.3e} = "
            f"{ratio:.3f} of its bound: ok={ok}")

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def check_hop(what, q, k, v, do, carry, lse, dd, kw, hidden=False):
        dt = q.dtype
        got = [c.clone() for c in carry]
        ck.flash_attention_step(q, k, v, *got, **kw)
        want = ck.flash_attention_step_plain(q, k, v, *carry, **kw)
        ok, err, ratio = step_agreement(got, want, dt)
        if hidden:
            ok = ok and all(bits_equal(a, c) for a, c in zip(got, carry))
        note("flash_attention_step", f"{what} m/l/o", ok, err, ratio)
        if do is None:
            return
        g = ck.flash_attention_bwd(q, k, v, do, lse, dd,
                                   out_dtype=torch.float32, **kw)
        gt = ck.flash_attention_bwd_plain(q, k, v, do, lse, dd,
                                          out_dtype=torch.float32, **kw)
        er = [ratio_rows(a, c, ATTN_GRAD_TOL[dt], dim=None)
              for a, c in zip(g, gt)]
        ok = (all(r <= 1 for _, r in er)
              and all(a.dtype == torch.float32 for a in g))
        if hidden:
            ok = ok and not any(a.any() for a in g)
        note("flash_attention_bwd", f"{what} f32 dq/dk/dv"
             + (" (exact zeros)" if hidden else ""), ok,
             max(e for e, _ in er), max(r for _, r in er))

    main = None
    for name, b, t, h, d, dt in (
            ("[1,4096,16,64] bf16", 1, RING["seq"] // RING["sp"], 16, 64,
             torch.bfloat16),
            ("[2,1000,2,128] f32", 2, 1000, 2, 128, torch.float32)):
        hops, carry = ring_hop_inputs(ck, gen, b, t, h, d, dt)
        for hop, (qb, kb, vb, dob, lse, dd, kw) in hops.items():
            check_hop(f"{name} {hop} hop", qb, kb, vb, dob, carry, lse, dd,
                      kw, hidden=hop == "above")
        if main is None:
            main = (hops, carry, (b, t, h, d))
        del hops, carry
    # long shards: k/v of 16384 rows at BH = 1 (where the TPU streams them,
    # _flash_step_call_streaming), and the backward at Tq = Tk = 17408 (past
    # the TPU's fused dq cap: the streaming branch of _flash_bwd_hm)
    q, k, v = rnd(1, 4096, 1, 64), rnd(1, 16384, 1, 64), rnd(1, 16384, 1, 64)
    check_hop("Tq 4096, Tk 16384, BH 1 bf16", q, k, v, None,
              fresh_carry(1, 4096, 1, 64), None, None,
              dict(causal=True, scale=0.125, q_off=12288, k_off=0))
    t = 17408
    q, k, v, do = (rnd(1, t, 1, 64) for _ in range(4))
    kw = dict(causal=True, scale=0.125, q_off=t, k_off=t)
    out, lse = ck.flash_attention_fwd(q, k, v, **kw)
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    check_hop(f"Tq = Tk = {t}, BH 1 bf16", q, k, v, do,
              fresh_carry(1, t, 1, 64), lse, dd, kw)
    del q, k, v, do, out
    # Ulysses's shape: K5 and K7 (bf16 outputs) on the whole sequence and a
    # sp-th of the heads, against the twins taken head by head
    t, h = RING["seq"], 16 // RING["sp"]
    q, k, v, do = (rnd(1, t, h, 64) for _ in range(4))
    kw = dict(causal=True, scale=0.125)
    out, lse = ck.flash_attention_fwd(q, k, v, **kw)
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    g = ck.flash_attention_bwd(q, k, v, do, lse, dd, **kw)
    heads = [[x[:, :, j:j + 1] for x in (q, k, v, do)] for j in range(h)]
    fwd_t = [ck.flash_attention_fwd_plain(*x[:3], **kw) for x in heads]
    out_t = torch.cat([o for o, _ in fwd_t], 2)
    lse_t = torch.cat([s for _, s in fwd_t], 1)
    e1, r1 = ratio_rows(out, out_t, ATTN_OUT_TOL[q.dtype])
    e2 = float((lse - lse_t).abs().max())
    r2 = float(((lse - lse_t).abs() / (ATTN_LSE_TOL * (lse_t.abs() + 1))).max())
    note("flash_attention_fwd", f"Ulysses [1,{t},{h},64] bf16 out/lse",
         max(r1, r2) <= 1, max(e1, e2), max(r1, r2))
    gt = [torch.cat(parts, 2) for parts in zip(*(
        ck.flash_attention_bwd_plain(*x, lse[:, j:j + 1], dd[:, j:j + 1], **kw)
        for j, x in enumerate(heads)))]
    er = [ratio_rows(a, c, ATTN_GRAD_TOL[q.dtype], dim=None)
          for a, c in zip(g, gt)]
    note("flash_attention_bwd", f"Ulysses [1,{t},{h},64] bf16 dq/dk/dv",
         all(r <= 1 for _, r in er) and all(a.dtype == q.dtype for a in g),
         max(e for e, _ in er), max(r for _, r in er))
    del q, k, v, do, out, g, gt, heads, fwd_t
    torch.cuda.synchronize()
    failed = [c for c in checks if not c[2]]
    log(f"phase 6: K6 and K7 (f32, hop offsets) against their twins on the "
        f"card: {not failed} ({len(checks)} checks)")
    if failed:
        raise AssertionError(f"ring kernels disagree with their twins: "
                             f"{failed}")

    # ---- times at the hop shape: a fully visible hop and the diagonal one
    hops, carry, (b, t, h, d) = main
    timed = {}
    for hop in ("below", "diagonal"):
        qb, kb, vb, dob, lse, dd, kw = hops[hop]
        scratch = [c.clone() for c in carry]
        for kernel, fn, plain, match in (
                ("step", lambda: ck.flash_attention_step(qb, kb, vb,
                                                         *scratch, **kw),
                 lambda: ck.flash_attention_step_plain(qb, kb, vb, *carry,
                                                       **kw), ("flash_fwd",)),
                ("bwd_f32", lambda: ck.flash_attention_bwd(
                    qb, kb, vb, dob, lse, dd, out_dtype=torch.float32, **kw),
                 lambda: ck.flash_attention_bwd_plain(
                     qb, kb, vb, dob, lse, dd, out_dtype=torch.float32,
                     **kw), ("flash_bwd",))):
            nbytes, ops = hop_bytes_ops(b, t, t, h, d, kw["q_off"],
                                        kw["k_off"], kernel)
            bytes_ms, ops_ms = nbytes / rate * 1e3, ops / BF16_RATE * 1e3
            r = timed[(kernel, hop)] = {
                "ms": cuda_ms(fn, 20), "device_ms": device_ms(fn, 10, match),
                "plain_ms": cuda_ms(plain, 3, warmup=1),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "operations": ops}
            log(f"  {'K6' if kernel == 'step' else 'K7 f32'} {hop} hop "
                f"[{b},{t},{h},{d}] bf16: kernel {r['ms']:.4f} ms (device "
                f"{r['device_ms']}), plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes} bytes, "
                f"{ops} operations), library none, on {CARD}")
    full = timed[("step", "below")]
    kernel = {
        "name": "flash_attention_step", "route": "cuda",
        "source": LM_SOURCES["flash_attention_step"],
        "replaces": REPLACES["flash_attention_step"], "launches": 0,
        "max_abs_err": worst["flash_attention_step"], "ms": full["ms"],
        "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"], "library_ms": None,
        "library": "none: no PyTorch call carries (m, l, o) between calls",
        "device_ms": full["device_ms"], "bytes": full["bytes"],
        "operations": full["operations"],
        "hops": {f"{k} {hop}": v for (k, hop), v in timed.items()}}
    return {"kernel": kernel, "checks": checks,
            "fwd_max_abs_err": worst["flash_attention_fwd"],
            "bwd_max_abs_err": worst["flash_attention_bwd"]}


def ring_kernels_child(rate: float, card: str) -> dict:
    """``phase_ring_kernels`` in a spawned process (``main`` sets CARD in
    its own)."""
    global CARD
    CARD = card
    return phase_ring_kernels(rate)


def sp_attention_worker() -> dict:
    """One rank of phase 6b: ring and Ulysses attention on this rank's
    4096-token block of a seeded [1, 16384, 16, 64] bf16 sequence, forward
    and backward, against K5/K7 on the whole sequence; launches counted
    from 0 around each."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops.attention import flash_attention
    from horovod_tpu_torch.parallel import ring_attention, ulysses_attention

    dev = hvd.device()
    gen = torch.Generator(device=dev).manual_seed(66)
    q, k, v, do = (torch.randn(1, RING["seq"], 16, 64, generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(4))
    t = RING["seq"] // hvd.size()
    blk = slice(hvd.rank() * t, (hvd.rank() + 1) * t)
    full = [x.clone().requires_grad_() for x in (q, k, v)]
    out_full = flash_attention(*full, causal=True)
    g_full = torch.autograd.grad(out_full, full, do)
    out_full = out_full.detach()
    res = {"backend": hvd.backend()}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        xs = [x[:, blk].clone().requires_grad_() for x in (q, k, v)]
        torch.cuda.synchronize(dev)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn(*xs, causal=True)
        grads = torch.autograd.grad(out, xs, do[:, blk])
        out = out.detach()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = ck.launch_counts()
        err = [ratio_rows(out, out_full[:, blk], ATTN_OUT_TOL[torch.bfloat16])]
        err += [ratio_rows(a, b[:, blk], ATTN_GRAD_TOL[torch.bfloat16],
                           dim=None) for a, b in zip(grads, g_full)]
        res[name] = {"ms": ms, "counts": counts, "errors": err,
                     "finite": all(bool(torch.isfinite(x).all())
                                   for x in (out, *grads))}
    return res


def phase_sp_attention() -> dict:
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    ranks = testing.run_cluster(sp_attention_worker, np=RING["sp"],
                                device="cuda", timeout=600)
    want = {"ring": {"flash_attention_step": RING["sp"],
                     "flash_attention_bwd": RING["sp"]},
            "ulysses": {"flash_attention_fwd": 1, "flash_attention_bwd": 1}}
    ok = all(r["backend"] == "gloo" for r in ranks)
    for name, counts in want.items():
        rs = [r[name] for r in ranks]
        launched = all(all(r["counts"][k] == counts.get(k, 0)
                           for k in r["counts"]) for r in rs)
        close = all(ratio <= 1 for r in rs for _, ratio in r["errors"])
        good = launched and close and all(r["finite"] for r in rs)
        seen = [{k: v for k, v in r["counts"].items() if v} for r in rs]
        log(f"phase 6b: {name} attention, world {RING['sp']} (gloo, one "
            f"card), [1, {RING['seq']}, 16, 64] bf16 causal, against K5/K7 on "
            f"the whole sequence (out {ATTN_OUT_TOL[torch.bfloat16]:g} of the "
            f"row's largest, grads {ATTN_GRAD_TOL[torch.bfloat16]:g} of the "
            f"tensor's): worst ratio "
            f"{max(ratio for r in rs for _, ratio in r['errors']):.3f}, max "
            f"abs error {max(e for r in rs for e, _ in r['errors']):.3e}; "
            f"launches per rank {seen} "
            f"(want {counts}); fwd+bwd "
            f"{[round(r['ms'], 1) for r in rs]} ms (host clock, 4 ranks on "
            f"one card): ok={good}")
        ok = ok and good
    if not ok:
        raise AssertionError("ring / Ulysses attention failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


def sdpa_attention(q, k, v):
    """Causal attention over ``[B, T, H, D]`` by PyTorch's own flash kernel
    (no other backend), the world-1 reference's attention: independent of
    the port's kernels."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True).transpose(1, 2)


def world1_agreement(cfg, x, y, snapshot, loss_sp, settled_rel) -> dict:
    """One world-1 step of the same model on the whole global batch, on the
    card with PyTorch's attention (``sdpa_attention``), against the
    sequence-parallel step's loss, its world-averaged gradients and its
    parameters after its first step (``snapshot``: name -> (parameter,
    gradient) on the host). Elements whose world-1 gradient exceeds
    ``settled_rel`` of its tensor's largest |g| count as settled."""
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss

    dev = torch.device("cuda", torch.cuda.current_device())
    net = TransformerLM(attn_fn=sdpa_attention, **cfg).to(dev)
    opt = torch.optim.AdamW(net.parameters(), lr=SP_LR, weight_decay=0.01,
                            fused=True)
    loss = lm_loss(net(x.to(dev)), y.to(dev))
    loss.backward()
    grad_rel, settled = {}, {}
    for n, p in net.named_parameters():
        g = p.grad.float()
        top = g.abs().max().clamp_min(1e-30)
        grad_rel[n] = float((g - snapshot[n][1].to(dev).float()).abs().max()
                            / top)
        # elements whose gradient's sign the tolerance cannot flip
        settled[n] = (g.abs() > settled_rel * top).cpu()
    opt.step()
    loss = loss.item()
    diffs = {n: (p.detach().cpu() - snapshot[n][0]).abs()
             for n, p in net.named_parameters()}
    flat = torch.cat([d.flatten() for d in diffs.values()])
    worst = max(grad_rel, key=grad_rel.get)
    rels = sorted(grad_rel.values())
    return {"loss": loss, "loss_rel": abs(loss - loss_sp) / abs(loss),
            "grad_rel_max": grad_rel[worst], "grad_rel_worst": worst,
            "grad_rel_median": rels[len(rels) // 2],
            "param_max": float(flat.max()),
            "settled_max": max(float(d[settled[n]].max())
                               if settled[n].any() else 0.0
                               for n, d in diffs.items()),
            "settled_share": float(sum(int(m.sum()) for m in settled.values())
                                   / flat.numel()),
            "share": {str(tol): float((flat <= tol).double().mean())
                      for tol in (1e-7, 1e-6, 1e-5, 1e-4)}}


def inject_ring_fault(kind: str) -> None:
    """Break ring attention on purpose, forward and backward, in this
    process (``--fault``): ``skip-hop`` drops the hop of the block of the
    rank before this one; ``shift-k-off`` places every visiting block one
    position later, so that the causal mask hides each row's own key."""
    import importlib
    import types

    from horovod_tpu_torch.ops import cuda_kernels as ck

    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")
    shift = int(kind == "shift-k-off")

    def skipped(q, q_off, k_off):
        return kind == "skip-hop" and k_off == q_off - q.shape[1]

    def step(q, k, v, m, l, o, *, q_off, k_off, **kw):
        if skipped(q, q_off, k_off):
            return m, l, o
        return ck.flash_attention_step(q, k, v, m, l, o, q_off=q_off,
                                       k_off=k_off + shift, **kw)

    def bwd(q, k, v, *args, q_off, k_off, **kw):
        if skipped(q, q_off, k_off):
            return tuple(torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in (q, k, v))
        return ck.flash_attention_bwd(q, k, v, *args, q_off=q_off,
                                      k_off=k_off + shift, **kw)

    ra.ck = types.SimpleNamespace(
        flash_attention_step=step, flash_attention_bwd=bwd,
        finalize_attention_stats=ck.finalize_attention_stats)


def sp_train_worker(dp: int, sp: int, layers: int, batch: int, seq: int,
                    steps: int, fault=None) -> dict:
    """One rank of phases 6c / 6d: GPT-2-medium widths at ``layers`` layers
    trained ``steps`` steps with ``torch.optim.AdamW`` on a (dp, sp) grid,
    through ``make_sp_train_step`` (ring attention: K6 / K7), on the seeded
    global batch ``[batch, seq]``; launches counted from 0 just before the
    steps. Then, after a barrier and up to a device synchronize each: one
    ring hop of a k/v block (bf16) and of a dk/dv accumulator (f32), the
    allreduce of every gradient tensor by tensor (as
    ``DistributedOptimizer`` does) and as one flat tensor. Rank 0 then
    takes one world-1 step of the same model on the whole batch, once the
    other ranks have freed their memory. ``fault``: ``inject_ring_fault``
    first."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops.collective_ops import allreduce
    from horovod_tpu_torch.parallel import (make_dp_sp_mesh,
                                            make_sp_train_step,
                                            replicate_to_mesh, sp_model)
    from horovod_tpu_torch.parallel._comm import ppermute
    from horovod_tpu_torch.parallel.sp_training import mean_gradients
    from horovod_tpu_torch.train import params_sha256, synthetic_lm_tokens

    if fault:
        inject_ring_fault(fault)
    marks = {"start": time.time()}
    dev = hvd.device()
    cfg = dict(vocab_size=MEDIUM["vocab"], num_layers=layers,
               num_heads=MEDIUM["heads"], d_model=MEDIUM["d"],
               max_seq_len=seq, dtype=torch.bfloat16, seed=0)
    toks = torch.from_numpy(synthetic_lm_tokens(batch, seq, MEDIUM["vocab"],
                                                0, 1))
    x, y = toks[:, :-1], toks[:, 1:]
    mesh = make_dp_sp_mesh(dp, sp)
    marks["mesh"] = time.time()
    net = sp_model(TransformerLM, mesh, **cfg).to(dev)
    marks["model"] = time.time()
    replicate_to_mesh(net)
    marks["replicate"] = time.time()
    step = make_sp_train_step(net, torch.optim.AdamW(
        net.parameters(), lr=SP_LR, weight_decay=0.01, fused=True), mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    losses, step_ms, snapshot = [], [], None
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0 and hvd.rank() == 0:
            snapshot = {n: (p.detach().to("cpu", copy=True),
                            p.grad.to("cpu", copy=True))
                        for n, p in net.named_parameters()}
    marks["steps"] = time.time()
    res = {"counts": ck.launch_counts(), "losses": losses, "step_ms": step_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "params_sha256": params_sha256(net),
           "grid": [mesh.dp_rank, mesh.sp_rank], "backend": hvd.backend()}

    def clock(fn) -> float:
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    heads = MEDIUM["heads"]
    kv = torch.zeros(2, batch // dp, seq // sp, heads, MEDIUM["d"] // heads,
                     dtype=torch.bfloat16, device=dev)
    dkv = kv.float()
    grads = [p.grad for p in net.parameters()]

    def mean(bucket_mb):  # the step's gradient mean, over the grad group
        os.environ["HOROVOD_BUCKET_MB"] = bucket_mb
        try:
            mean_gradients(list(net.parameters()), mesh.grad_group)
        finally:
            os.environ.pop("HOROVOD_BUCKET_MB")

    res["comm_ms"] = {
        "hop_kv_bf16": clock(lambda: ppermute(kv, mesh.sp_group)),
        "hop_dkv_f32": clock(lambda: ppermute(dkv, mesh.sp_group)),
        "allreduce_per_tensor": clock(lambda: [allreduce(g) for g in grads]),
        "allreduce_flat": clock(lambda: allreduce(torch.cat(
            [g.flatten() for g in grads]))),
        "grad_mean_per_tensor": clock(lambda: mean("")),
        "grad_mean_bucketed": clock(lambda: mean(ENGINE_BUCKET_MB))}
    del step, net, grads, kv, dkv
    torch.cuda.empty_cache()
    dist.barrier()
    marks["hash"] = time.time()
    if hvd.rank() == 0:
        res["world1"] = world1_agreement(cfg, x, y, snapshot, losses[0],
                                         SP_LIMITS[1])
    marks["world1"] = time.time()
    res["marks"] = marks
    return res


# The sequence-parallel step against one world-1 step of the same model on
# the whole batch with PyTorch's attention (bf16 compute, f32 parameters,
# AdamW lr 3e-4). Each bound lies between the sound runs' readings and those
# of a broken ring (``--fault``), all on an H100, 6c / 6d (PERF.md):
# * the first loss to SP_LOSS_REL relative (sound 1.6e-5 / 3.7e-6; a
#   skipped hop 2.8e-4 / 1.0e-4, k_off one late 4.6e-5 / 8.7e-5);
# * each gradient, world-averaged, to SP_GRAD_REL of its tensor's largest
#   |g| (sound 1.9e-2 / 7.7e-3, from bf16 activations that differ in the
#   last bit after attention computed another way; faulted 0.46 to 1.5);
# * after the first step, the elements whose world-1 gradient exceeds
#   SP_GRAD_REL of its tensor's largest |g| (so that the two gradients'
#   signs agree, and AdamW's first step, lr sign(g), moves both alike)
#   within SP_SETTLED_ATOL (sound 1.2e-7, one unit of a weight near 1;
#   faulted 6.0e-4, 2 lr);
# * at least SP_PARAM_SHARE of all elements within SP_PARAM_ATOL (sound
#   0.984 / 0.997; faulted 0.81 / 0.86 and 0.950 / 0.986: at 6d a k_off
#   one late passes this check alone).
SP_LOSS_REL, SP_GRAD_REL = 3e-5, 5e-2
SP_SETTLED_ATOL = 1e-6
SP_PARAM_ATOL, SP_PARAM_SHARE = 1e-5, 0.97
SP_LIMITS = (SP_LOSS_REL, SP_GRAD_REL, SP_SETTLED_ATOL, SP_PARAM_ATOL,
             SP_PARAM_SHARE)


def agreement(w1, limits) -> dict:
    """Each agreement check of ``world1_agreement``'s readings against
    ``limits`` (loss_rel, grad_rel, settled_atol, param_atol, param_share):
    name -> passed."""
    loss_rel, grad_rel, settled_atol, atol, share = limits
    return {"loss": w1["loss_rel"] <= loss_rel,
            "gradients": w1["grad_rel_max"] <= grad_rel,
            "settled parameters": w1["settled_max"] <= settled_atol,
            "parameter share": w1["share"][str(atol)] >= share}


def phase_sp_train(label: str, dp: int, sp: int, layers: int, batch: int,
                   seq: int, steps: int = 2, fault=None) -> dict:
    """Phases 6c / 6d: ``sp_train_worker`` on dp * sp ranks sharing the
    card (gloo); launches, bit-identical parameters on every rank, and
    agreement with the world-1 step. With ``fault``, the readings only:
    the caller checks that the agreement fails."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    wall0 = time.time()
    ranks = testing.run_cluster(sp_train_worker, np=dp * sp, device="cuda",
                                args=(dp, sp, layers, batch, seq, steps,
                                      fault), timeout=900)
    seconds = time.perf_counter() - t0
    per_step = {"flash_attention_step": layers * sp,
                "flash_attention_bwd": layers * sp}
    launched = all(r["counts"][k] == steps * per_step.get(k, 0)
                   for r in ranks for k in r["counts"])
    same = len({r["params_sha256"] for r in ranks}) == 1
    grid = [r["grid"] for r in ranks] == [[i, j] for i in range(dp)
                                          for j in range(sp)]
    w1 = ranks[0]["world1"]
    agree = agreement(w1, SP_LIMITS)
    finite = all(math.isfinite(v) for r in ranks for v in r["losses"])
    seen = [{k: v / steps for k, v in r["counts"].items() if v} for r in ranks]
    peak = [round(r["peak_memory_bytes"] / 2**30, 2) for r in ranks]
    ok = (launched and same and grid and all(agree.values()) and finite
          and all(r["backend"] == "gloo" for r in ranks))
    log(f"phase {label}{f' with fault {fault}' if fault else ''}: dp={dp} x "
        f"sp={sp} (gloo, one card), GPT-2-medium "
        f"widths, {layers} layers, global batch {batch} x {seq}, {steps} "
        f"AdamW steps: launches per rank per step "
        f"{seen} "
        f"(want {per_step}); params bit-identical on all {dp * sp} ranks "
        f"{same}; losses {[[round(v, 5) for v in r['losses']] for r in ranks]}"
        f"; against one world-1 step on the card (SDPA attention): loss "
        f"{w1['loss']:.6f}, rel diff {w1['loss_rel']:.3e} (<= "
        f"{SP_LOSS_REL:g}), gradients {w1['grad_rel_max']:.3e} of the "
        f"tensor's largest |g| (<= {SP_GRAD_REL:g}), settled parameters "
        f"({w1['settled_share']:.4f} of all) max diff "
        f"{w1['settled_max']:.3e} (<= {SP_SETTLED_ATOL:g}), all parameters "
        f"max diff {w1['param_max']:.3e}, share within {SP_PARAM_ATOL:g} "
        f"{w1['share'][str(SP_PARAM_ATOL)]:.6f} (>= {SP_PARAM_SHARE}) "
        f"{w1['share']}; {agree}; step ms per rank "
        f"{[[round(v, 1) for v in r['step_ms']] for r in ranks]}, peak "
        f"memory GiB {peak} (information: {dp * sp} processes share one "
        f"card over gloo); {seconds:.1f} s on {CARD}: ok={ok}")
    m = ranks[0]["marks"]
    comm = [r["comm_ms"] for r in ranks]
    hops = layers * (2 * (sp - 1) * max(c["hop_kv_bf16"] for c in comm)
                     + sp * max(c["hop_dkv_f32"] for c in comm)) / 1e3
    log(f"  {label} rank 0 timeline (s from the phase's start): "
        f"{ {k: round(v - wall0, 1) for k, v in m.items()} }; the worst "
        f"gradient {w1['grad_rel_worst']}, median over tensors "
        f"{w1['grad_rel_median']:.3e}; host-clock ms per rank (gloo, one "
        f"card): {[{k: round(v, 1) for k, v in c.items()} for c in comm]}, "
        f"so the ring's {2 * (sp - 1)} k/v and {sp} dk/dv hops a layer come "
        f"to {hops:.1f} s a step")
    log(f"  {label} the step's gradient mean (host clock, the slowest rank): "
        f"per tensor {max(c['grad_mean_per_tensor'] for c in comm) / 1e3:.3f}"
        f" s, one flat all-reduce a {ENGINE_BUCKET_MB} MiB bucket "
        f"{max(c['grad_mean_bucketed'] for c in comm) / 1e3:.3f} s; through "
        f"the engine (one request a tensor) "
        f"{max(c['allreduce_per_tensor'] for c in comm) / 1e3:.3f} s; on "
        f"{CARD}")
    if not ok and not fault:
        raise AssertionError(f"sequence-parallel training ({label}) failed "
                             f"its checks")
    return {"ranks": ranks, "seconds": seconds, "agreement": agree}


# ---------------------------------------------------------- phases 7-7d
# K10 against its twin torch.matmul(x.float(), w.float()).to(dtype), TF32
# off: both sum K products in f32 in different orders, so elementwise
# |kernel - twin| <= MM_C K 2^-24 (|x| @ |w|) plus one unit in the last
# place of the output (the rounding of a sum the two place on either side
# of a tie or a boundary).
MM_C = 2
MM_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
# Tensor parallelism at GPT-2-medium widths (tp = 4 splits d_ff 4096 and
# the LM head's d_model 1024 into 4): the chunks of the fused matmul +
# reduce-scatter ring over 8 x 1024 tokens, rows 8192 / 4.
MM_CHUNKS = {"mlp_out": (2048, 1024, 1024), "lm_head": (2048, 256, 32768)}
TP = dict(tp=4, batch=8)
HYBRID = dict(dp=2, tp=2, sp=2, layers=2, batch=2, seq=4096)


def mm_tolerance(x, w, k_out, t_out) -> torch.Tensor:
    """The elementwise bound of K10 against its twin (see MM_C)."""
    mag = x.float().abs() @ w.float().abs()
    return (MM_C * x.shape[1] * 2.0 ** -24 * mag
            + MM_ULP[x.dtype] * torch.maximum(k_out.float().abs(),
                                              t_out.float().abs()))


def phase_matmul_kernel(rate: float) -> dict:
    """Phase 7: K10 against its twin on the card at the ring's two chunk
    shapes (bf16), in f32, at a shape where M, K and N each take more than
    one tile (bf16 and f32) and at the smallest M; two launches byte-equal;
    times of kernel, twin and ``torch.matmul`` (cuBLAS) at the chunks."""
    from horovod_tpu_torch.ops import cuda_kernels as ck

    t0 = time.perf_counter()
    sass = {fn: c for fn, c in sass_counts("matmul").items()
            if "hvd_mm_wgmma" in fn}
    log(f"phase 7: HGMMA / UTMALDG / UTMASTG instructions in the SASS of "
        f"matmul.cu's bf16 kernels: {sass} (counted in "
        f"{time.perf_counter() - t0:.1f} s)")
    if len(sass) != 2 or any(0 in c.values() for c in sass.values()):
        raise AssertionError(f"K10's bf16 kernels are not wgmma + TMA loads "
                             f"and stores: {sass}")
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(f"{name} chunk", (m, k, n), torch.bfloat16)
             for name, (m, k, n) in MM_CHUNKS.items()]
    cases += [("f32", (256, 512, 384), torch.float32),
              ("multi-tile bf16", (520, 384, 640), torch.bfloat16),
              ("multi-tile f32", (520, 384, 640), torch.float32),
              ("M=8 bf16", (8, 128, 256), torch.bfloat16),
              ("M=520 bf16, K=256, streaming", (520, 256, 16384),
               torch.bfloat16),
              ("M=520 bf16, resident B", (520, 256, 32768),
               torch.bfloat16)]
    checks, worst, timed = [], 0.0, {}
    for what, (m, k, n), dt in cases:
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        w = torch.randn(k, n, generator=gen, device="cuda").to(dt)
        got = ck.matmul_2d(x, w)
        again = ck.matmul_2d(x, w)
        want = ck.matmul_2d_plain(x, w)
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / mm_tolerance(x, w, got, want)).max())
        err = float(diff.max())
        ok = (ratio <= 1 and bits_equal(got, again) and got.dtype == dt
              and bool(torch.isfinite(got).all()))
        worst = max(worst, err)
        checks.append((what, ok, err, ratio))
        log(f"  matmul_2d {what} [{m}, {k}] @ [{k}, {n}] {dt}: max |kernel "
            f"- twin| {err:.3e} = {ratio:.3f} of its bound (two launches "
            f"byte-equal {bits_equal(got, again)}): ok={ok}")
        if what.endswith("chunk"):
            timed[what] = (x, w)
    failed = [c for c in checks if not c[1]]
    log(f"phase 7: K10 against its twin on the card: {not failed} "
        f"({len(checks)} checks)")
    if failed:
        raise AssertionError(f"K10 disagrees with its twin: {failed}")
    out = {}
    for what, (x, w) in timed.items():
        (m, k), n = x.shape, w.shape[1]
        nbytes = (m * k + k * n + m * n) * x.element_size()
        ops = 2 * m * k * n
        bytes_ms, ops_ms = nbytes / rate * 1e3, ops / BF16_RATE * 1e3
        out[what] = {
            "shape": [m, k, n], "ms": cuda_ms(lambda: ck.matmul_2d(x, w), 20),
            "device_ms": device_ms(lambda: ck.matmul_2d(x, w), 10,
                                   ("hvd_mm",)),
            "plain_ms": cuda_ms(lambda: ck.matmul_2d_plain(x, w), 10),
            "library_ms": cuda_ms(lambda: torch.matmul(x, w), 20),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}
        r = out[what]
        log(f"  matmul_2d {what} [{m}, {k}] @ [{k}, {n}] bf16: kernel "
            f"{r['ms']:.4f} ms (device {r['device_ms']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms "
            f"(torch.matmul), bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({nbytes} bytes, {ops} operations) on {CARD}")
    row = dict(out["lm_head chunk"])
    row.update(name="matmul_2d", route="cuda", launches=0,
               source="horovod_tpu_torch/csrc/matmul.cu",
               replaces=REPLACES["matmul_2d"], max_abs_err=worst,
               library="torch.matmul (cuBLAS)", chunks=out, checks=checks,
               sass=sass)
    return row


def mm_rs_worker(shapes, calls: int) -> dict:
    """One rank of phase 7b: for each (rows, kl, n), every rank's seeded
    bf16 x [rows, kl] and w [kl, n] (this rank's and the others', for the
    f64 dense sum of this rank's chunk); ``matmul_reduce_scatter`` ``calls``
    times (K10's launches counted from 0 around them) and its unfused
    reference, each timed on the host clock after a barrier."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops.matmul import (matmul_reduce_scatter,
                                              matmul_reduce_scatter_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    # the unfused reference's product sums in f32 and rounds once, as the
    # TPU's does: no split-K partial sums rounded to bf16
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev, p, m = hvd.device(), hvd.rank(), hvd.size()
    res = {"backend": hvd.backend(), "shapes": {}}
    counts = {}
    for rows, kl, n in shapes:
        xs, ws = [], []
        for r in range(m):
            gen = torch.Generator(device=dev).manual_seed(1000 * r + kl)
            xs.append(torch.randn(rows, kl, generator=gen,
                                  device=dev).to(torch.bfloat16))
            ws.append((torch.randn(kl, n, generator=gen, device=dev)
                       / kl ** 0.5).to(torch.bfloat16))
        c = rows // m
        chunk = slice(p * c, (p + 1) * c)
        # each of the ring's 2m - 1 bf16 roundings (m partials, m - 1 adds)
        # is at most 2^-8 times a value no larger than sum_r |P_r|, with
        # P_r = x_r @ w_r; K10's f32 sums add K 2^-24 sum_r |x_r| @ |w_r|;
        # the factor 2 covers the second-order terms
        dense = torch.zeros(c, n, dtype=torch.float64, device=dev)
        tol = torch.zeros(c, n, dtype=torch.float64, device=dev)
        for r in range(m):
            part = xs[r][chunk].double() @ ws[r].double()
            dense += part
            tol += 2 * m * 2.0 ** -8 * part.abs()
            tol += 2 * kl * 2.0 ** -24 * (xs[r][chunk].double().abs()
                                          @ ws[r].double().abs())
            if r == p:   # the partial the ring's last hop adds on rank p
                own = part
            del part
        # two faulted rings the gate must refuse: the last hop's partial
        # dropped, and every add rounded to float8 e4m3 (u = 2^-4)
        lowp = xs[0][chunk].float() @ ws[0].float()
        for r in range(1, m):
            lowp = (lowp.to(torch.float8_e4m3fn).float()
                    + xs[r][chunk].float() @ ws[r].float())
        lowp = lowp.to(torch.float8_e4m3fn).double()

        def clock(fn):
            torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize(dev)
            return y, (time.perf_counter() - t0) * 1e3

        ck.reset_launch_counts()
        rings = [clock(lambda: matmul_reduce_scatter(xs[p], ws[p]))
                 for _ in range(calls)]
        for k, v in ck.launch_counts().items():
            counts[k] = counts.get(k, 0) + v
        refs = [clock(lambda: matmul_reduce_scatter_reference(xs[p], ws[p]))
                for _ in range(calls)]
        ring, ref = rings[-1][0], refs[-1][0]

        def ratio(y, want=dense, bound=tol):
            return float(((y.double() - want).abs() / bound).max())

        res["shapes"][f"{rows}x{kl}x{n}"] = {
            "ring_ratio": ratio(ring), "ref_ratio": ratio(ref),
            # both lie within tol of the dense sum, so within 2 tol of
            # each other
            "ring_vs_ref_ratio": ratio(ring, ref.double(), 2 * tol),
            "dropped_ratio": ratio(ring.double() - own),
            "float8_ratio": ratio(lowp),
            "ring_vs_ref": float((ring.float() - ref.float()).abs().max()),
            "max_abs_err": float((ring.double() - dense).abs().max()),
            "shape": list(ring.shape), "dtype": str(ring.dtype),
            "launches_per_call": ck.launch_counts()["matmul_2d"] / calls,
            "ring_ms": [t for _, t in rings], "ref_ms": [t for _, t in refs],
            "finite": bool(torch.isfinite(ring).all())}
        del xs, ws, dense, tol, own, lowp, rings, refs, ring, ref
        torch.cuda.empty_cache()
    res["counts"] = counts
    return res


def phase_matmul_reduce_scatter() -> dict:
    """Phase 7b: ``matmul_reduce_scatter`` at world 4 (gloo, one card) on
    the full operands of phase 7's two chunks: rank p holds chunk p, within
    the ring's bound of the f64 dense sum (as is the unfused reference), K10
    launched 4 times a call on each rank."""
    from horovod_tpu_torch import testing

    m, calls = TP["tp"], 3
    shapes = [(m * rows, k, n) for rows, k, n in MM_CHUNKS.values()]
    t0 = time.perf_counter()
    ranks = testing.run_cluster(mm_rs_worker, np=m, device="cuda",
                                args=(shapes, calls), timeout=600)
    ok = all(r["backend"] == "gloo" for r in ranks)
    for key in ranks[0]["shapes"]:
        rs = [r["shapes"][key] for r in ranks]
        rows, kl, n = (int(v) for v in key.split("x"))
        good = all(s["ring_ratio"] <= 1 and s["ref_ratio"] <= 1
                   and s["ring_vs_ref_ratio"] <= 1 and s["dropped_ratio"] > 1
                   and s["float8_ratio"] > 1
                   and s["shape"] == [rows // m, n] and s["finite"]
                   and s["launches_per_call"] == m
                   and s["dtype"] == "torch.bfloat16" for s in rs)
        log(f"phase 7b: matmul_reduce_scatter world {m} (gloo, one card), x "
            f"[{rows}, {kl}] @ w [{kl}, {n}] bf16 a rank: rank p's "
            f"[{rows // m}, {n}] chunk against the f64 dense sum, worst "
            f"{max(s['ring_ratio'] for s in rs):.4f} of the ring's bound "
            f"2 m 2^-8 sum_r |x_r @ w_r| + 2 K 2^-24 sum_r |x_r| @ |w_r| "
            f"(unfused reference {max(s['ref_ratio'] for s in rs):.4f}; "
            f"ring - reference max {max(s['ring_vs_ref'] for s in rs):.3e} "
            f"= {max(s['ring_vs_ref_ratio'] for s in rs):.4f} of twice the "
            f"bound); faulted rings, which must exceed it: last hop's partial "
            f"dropped {min(s['dropped_ratio'] for s in rs):.1f}, adds in "
            f"float8 e4m3 {min(s['float8_ratio'] for s in rs):.2f} of the "
            f"bound; K10 launches per call "
            f"{[s['launches_per_call'] for s in rs]} (want {m}); ms per call "
            f"ring {[[round(t, 1) for t in s['ring_ms']] for s in rs]}, "
            f"reference {[[round(t, 1) for t in s['ref_ms']] for s in rs]} "
            f"(host clock, gloo staging, 4 ranks on one card) on {CARD}: "
            f"ok={good}")
        ok = ok and good
    if not ok:
        raise AssertionError("matmul_reduce_scatter failed its checks")
    return {"ranks": ranks, "seconds": time.perf_counter() - t0}


def inject_tp_fault(net) -> None:
    """Break tensor parallelism on purpose (``--fault drop-tp-reduce``):
    block 0's row-parallel mlp_out returns its local partial product (plus
    the bias), never summed over tp."""
    import torch.nn.functional as F

    layer = net.blocks[0].mlp_out

    def local_partial(x):
        return (F.linear(x.to(layer.dtype), layer.weight.to(layer.dtype))
                + layer.bias.to(layer.dtype))

    layer.forward = local_partial


def tp_train_worker(dp: int, tp: int, sp: int, layers: int, batch: int,
                    seq: int, steps: int, fault=None) -> dict:
    """One rank of phases 7c (``sp == 1``: ``make_dp_tp_mesh``,
    ``shard_params_tp``, ``make_tp_train_step``) and 7d (the hybrid:
    ``make_dp_tp_sp_mesh``, ``hybrid_model``, ``shard_params_hybrid``,
    ``make_hybrid_train_step``): GPT-2-medium widths at ``layers`` layers,
    seed-0 weights, ``steps`` AdamW steps on the seeded global batch
    ``[batch, seq]``, launches counted from 0 just before the steps. After
    the first step every rank gathers the full parameters and gradients
    over tp; rank 0 then takes one world-1 step of the same model once the
    other ranks have freed their memory. ``fault``: ``inject_tp_fault``."""
    import hashlib

    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import (hybrid_model, make_dp_tp_mesh,
                                            make_dp_tp_sp_mesh,
                                            make_hybrid_train_step,
                                            make_tp_train_step,
                                            shard_params_hybrid,
                                            shard_params_tp)
    from horovod_tpu_torch.parallel.tensor import (full_state_dict_tp,
                                                   torch_param_spec)
    from horovod_tpu_torch.train import synthetic_lm_tokens

    marks = {"start": time.time()}
    dev = hvd.device()
    cfg = dict(vocab_size=MEDIUM["vocab"], num_layers=layers,
               num_heads=MEDIUM["heads"], d_model=MEDIUM["d"],
               max_seq_len=seq, dtype=torch.bfloat16, seed=0)
    toks = torch.from_numpy(synthetic_lm_tokens(batch, seq, MEDIUM["vocab"],
                                                0, 1))
    x, y = toks[:, :-1], toks[:, 1:]
    if sp == 1:
        mesh = make_dp_tp_mesh(dp, tp)
        net = shard_params_tp(TransformerLM(**cfg), mesh).to(dev)
        make_step = make_tp_train_step
    else:
        mesh = make_dp_tp_sp_mesh(dp, tp, sp)
        net = shard_params_hybrid(hybrid_model(TransformerLM, mesh, **cfg),
                                  mesh).to(dev)
        make_step = make_hybrid_train_step
    if fault:
        inject_tp_fault(net)
    marks["model"] = time.time()
    step = make_step(net, torch.optim.AdamW(
        net.parameters(), lr=SP_LR, weight_decay=0.01, fused=True), mesh)
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    losses, step_ms, snapshot = [], [], None
    for i in range(steps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:  # the gathers launch no kernel
            full = full_state_dict_tp(net, mesh)
            grads = full_state_dict_tp(net, mesh, grads=True)
            if hvd.rank() == 0:
                snapshot = {n: (full[n].cpu(), grads[n].cpu()) for n in full}
            del full, grads
    marks["steps"] = time.time()
    counts = ck.launch_counts()

    def digest(replicated: bool) -> str:
        h = hashlib.sha256()
        for name, prm in sorted(net.named_parameters()):
            if ("tp" not in torch_param_spec(name)) == replicated:
                h.update(name.encode())
                h.update(prm.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    res = {"counts": counts, "losses": losses, "step_ms": step_ms,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
           "replicated_sha256": digest(True), "shard_sha256": digest(False),
           "grid": [mesh.dp_rank, mesh.tp_rank, mesh.sp_rank],
           "backend": hvd.backend()}
    del step, net
    torch.cuda.empty_cache()
    dist.barrier()
    marks["hash"] = time.time()
    if hvd.rank() == 0:
        res["world1"] = world1_agreement(cfg, x, y, snapshot, losses[0],
                                         TP_LIMITS[1])
    marks["world1"] = time.time()
    res["marks"] = marks
    return res


# The tensor-parallel and 3D steps against one world-1 step of the same
# model on the whole batch with PyTorch's attention, by the checks and in
# the order of SP_LIMITS. Each limit lies between the sound runs' readings
# and those of a dropped row-parallel reduce (``--fault drop-tp-reduce``),
# on an H100, 7c / 7d (PERF.md):
# * the first loss to 5e-5 relative (sound 1.9e-5 / 1.8e-7; faulted
#   1.3e-3 / 1.2e-4);
# * each gradient to 5e-2 of its tensor's largest |g| (sound 2.2e-2 /
#   1.1e-2, bf16 partial products summed over tp; faulted 2.2 / 1.2);
# * settled elements within 1e-6 (sound 1.2e-7; faulted 6.0e-4, 2 lr);
# * at least 0.97 of all elements within 1e-5 (sound 0.986 / 0.997;
#   faulted 0.605 / 0.789).
TP_LIMITS = (5e-5, 5e-2, 1e-6, 1e-5, 0.97)


def phase_tp_train(label: str, dp: int, tp: int, sp: int, layers: int,
                   batch: int, seq: int, steps: int = 2, fault=None) -> dict:
    """Phases 7c / 7d: ``tp_train_worker`` on dp * tp * sp ranks sharing the
    card (gloo); launches, bit-identical parameters (each tensor shard on
    the ranks that hold it, the replicated ones on every rank) and
    agreement with the world-1 step. With ``fault``, the readings only: the
    caller checks that the agreement fails."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    n = dp * tp * sp
    ranks = testing.run_cluster(tp_train_worker, np=n, device="cuda",
                                args=(dp, tp, sp, layers, batch, seq, steps,
                                      fault), timeout=900)
    seconds = time.perf_counter() - t0
    per_step = ({"flash_attention_fwd": layers, "flash_attention_bwd": layers}
                if sp == 1 else {"flash_attention_step": layers * sp,
                                  "flash_attention_bwd": layers * sp})
    launched = all(r["counts"][k] == steps * per_step.get(k, 0)
                   for r in ranks for k in r["counts"])
    replicated = len({r["replicated_sha256"] for r in ranks}) == 1
    shards = {}
    for r in ranks:
        shards.setdefault(r["grid"][1], set()).add(r["shard_sha256"])
    sharded = (all(len(s) == 1 for s in shards.values())
               and len({next(iter(s)) for s in shards.values()}) == tp)
    grid = [r["grid"] for r in ranks] == [[d, t, s] for d in range(dp)
                                          for t in range(tp)
                                          for s in range(sp)]
    w1 = ranks[0]["world1"]
    agree = agreement(w1, TP_LIMITS)
    loss_rel, grad_rel, settled_atol, atol, share = TP_LIMITS
    finite = all(math.isfinite(v) for r in ranks for v in r["losses"])
    seen = [{k: v / steps for k, v in r["counts"].items() if v} for r in ranks]
    peak = [round(r["peak_memory_bytes"] / 2**30, 2) for r in ranks]
    ok = (launched and replicated and sharded and grid and finite
          and all(agree.values())
          and all(r["backend"] == "gloo" for r in ranks))
    log(f"phase {label}{f' with fault {fault}' if fault else ''}: dp={dp} x "
        f"tp={tp} x sp={sp} (gloo, one card), GPT-2-medium widths, {layers} "
        f"layers, global batch {batch} x {seq}, {steps} AdamW steps: "
        f"launches per rank per step {seen} (want {per_step}); replicated "
        f"parameters bit-identical on all {n} ranks {replicated}, each tensor "
        f"shard on the ranks that hold it {sharded}; losses "
        f"{[[round(v, 5) for v in r['losses']] for r in ranks]}; against one "
        f"world-1 step on the card (SDPA attention): loss {w1['loss']:.6f}, "
        f"rel diff {w1['loss_rel']:.3e} (<= {loss_rel:g}), gradients "
        f"{w1['grad_rel_max']:.3e} of the tensor's largest |g| (<= "
        f"{grad_rel:g}; worst {w1['grad_rel_worst']}, median "
        f"{w1['grad_rel_median']:.3e}), settled parameters "
        f"({w1['settled_share']:.4f} of all) max diff "
        f"{w1['settled_max']:.3e} (<= {settled_atol:g}), all parameters "
        f"max diff {w1['param_max']:.3e}, share within {atol:g} "
        f"{w1['share'][str(atol)]:.6f} (>= {share}) "
        f"{w1['share']}; {agree}; step ms per rank "
        f"{[[round(v, 1) for v in r['step_ms']] for r in ranks]}, peak "
        f"memory GiB {peak} (information: {n} processes share one card over "
        f"gloo); {seconds:.1f} s on {CARD}: ok={ok}")
    if not ok and not fault:
        raise AssertionError(f"tensor-parallel training ({label}) failed its "
                             f"checks")
    return {"ranks": ranks, "seconds": seconds, "agreement": agree}


# the (dp, sp) runs of phases 6c and 6d, the (dp, tp, sp) runs of 7c and
# 7d: (dp, [tp,] sp, layers, global batch, sequence); 6c and 7c at
# GPT-2-medium's widths cut to LONG_LAYERS of its 24 layers (to pay for
# the later phases' time; PERF.md)
LONG_LAYERS = 4
SP_RUNS = {"6c": (1, RING["sp"], LONG_LAYERS, 1, RING["seq"]),
           "6d": (2, 2, 2, 2, RING["seq"] // RING["sp"])}
TP_RUNS = {"7c": (1, TP["tp"], 1, LONG_LAYERS, TP["batch"],
                  MEDIUM["seq"]),
           "7d": (HYBRID["dp"], HYBRID["tp"], HYBRID["sp"], HYBRID["layers"],
                  HYBRID["batch"], HYBRID["seq"])}
FAULTS = {"skip-hop": (phase_sp_train, SP_RUNS),
          "shift-k-off": (phase_sp_train, SP_RUNS),
          "drop-tp-reduce": (phase_tp_train, TP_RUNS)}


def fault_check(fault: str) -> int:
    """Phases 6c and 6d with a broken ring, or 7c and 7d with a dropped
    row-parallel reduce: 0 when each one's agreement with the world-1 step
    fails (each check's verdict is printed)."""
    phase, runs = FAULTS[fault]
    caught = {}
    for label, args in runs.items():
        agree = phase(label, *args, fault=fault)["agreement"]
        caught[label] = {k: not v for k, v in agree.items()}
    print(json.dumps({"fault": fault, "caught": caught}), flush=True)
    return 0 if all(any(c.values()) for c in caught.values()) else 1


# ------------------------------------------------- 8a-8c: MoE and pipeline
# lm_bench --moe's widths on the TPU (benchmarks/lm_bench.py:119-127): one
# weight-tied MoE block, d_model 1024, 4x hidden, vocab 32768, 8 experts,
# 65,536 global tokens a step, CF 1.25, f32; "ample" CF 8 drops nothing
MOE = dict(tokens=65536, cf=1.25, ample_cf=8.0)
# phase 8b's ep axis (dp = 4 / ep ranks) and global tokens (cut to 16,384
# if the phase passes 120 s)
MOE_GRID = dict(ep=2, tokens=65536)
MOE_CONFIGS = ("exact", "capacity", "capacity-int8", "capacity-int4")
# the quantized exchange against the exact one at the step's [E, C, d]
# payload: max |diff| over max |exact| (tests/test_moe.py:140-150)
MOE_A2A_TOL = {"int8": 0.02, "int4": 0.2}
# f32 agreement, relative: 8a's capacity (CF 8) against exact dispatch,
# the MoE output y over max |y| and the first loss; 8b's capacity-off run
# at CF 8 against 8a's first exact loss
MOE_F32_TOL = 1e-5
# wire kernel launches a capacity step a rank (dispatch + combine): the
# pack, and the error-feedback residual's quantize and dequantize (int4's
# residual quantizes in plain torch, ops/compression.py)
MOE_PER_STEP = {"capacity-int8": {"int8_quantize_pack_2d": 2,
                                  "int8_quantize_2d": 2,
                                  "int8_dequantize_2d": 2},
                "capacity-int4": {"int4_quantize_pack_2d": 2,
                                  "int8_dequantize_2d": 2}}
# profiler kernel names: #1 / #3 (the tile kernel they share, the general
# loop, #3's own), #4, #2
MOE_TRACE = {"int8 quantize (#1, #3)": WIRE_Q + ("int8_quant_pack",),
             "int4 pack (#4)": ("int4_quant_pack",),
             "dequantize (#2)": ("int8_dequant",)}
MOE_TRACE_WANT = {"capacity-int8": {"int8 quantize (#1, #3)": 4,
                                    "int4 pack (#4)": 0,
                                    "dequantize (#2)": 2},
                  "capacity-int4": {"int8 quantize (#1, #3)": 0,
                                    "int4 pack (#4)": 2,
                                    "dequantize (#2)": 2}}
MOE_FAULTS = ("moe-skip-dp-sum", "a2a-swap-peers")


@contextmanager
def expandable_segments():
    """Processes spawned inside start with expandable segments in their
    caching allocator, so each keeps little memory reserved but unused:
    8b's four ranks under exact dispatch need 17.8 GiB each, and did not
    fit on one card without."""
    before = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = before


def moe_world1_worker() -> dict:
    """Phase 8a in its own process at world 1: exact dispatch and capacity
    (CF 8, the exact exchange: an ep axis of one rank) held to each other
    on the first step's MoE output y and loss, then ``synthetic_moe_train``
    of each for 2 + 3 steps."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import expert as epar
    from horovod_tpu_torch.train import MoETrainer, synthetic_moe_train

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    tr = MoETrainer("exact", tokens=MOE["tokens"], seed=0)
    with torch.no_grad():
        h = tr.params["emb"][tr.batch[0]]
        y_ex, aux_ex = epar.ExactDispatch(tr.mesh)(tr.params, h)
        y_cap, aux_cap = epar.SwitchDispatch(tr.mesh, MOE["ample_cf"], "",
                                             None, None)(tr.params, h)
        y_rel = float((y_cap - y_ex).abs().max() / y_ex.abs().max())
        aux_rel = float((aux_cap - aux_ex).abs() / aux_ex.abs())
    del tr, h, y_ex, y_cap
    torch.cuda.empty_cache()
    runs = {}
    for name, cf in (("exact", MOE["cf"]), ("capacity", MOE["ample_cf"])):
        ck.reset_launch_counts()
        runs[name] = synthetic_moe_train(
            name, steps=3, warmup=2, tokens=MOE["tokens"],
            capacity_factor=cf, seed=0)
        runs[name]["counts"] = ck.launch_counts()
        torch.cuda.empty_cache()
    return {"y_rel": y_rel, "aux_rel": aux_rel, "runs": runs,
            "world": hvd.size(), "seconds": time.perf_counter() - t0}


def phase_moe_world1() -> dict:
    """Phase 8a: lm_bench's MoE block at full width on one card."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    with expandable_segments():
        r, = testing.run_cluster(moe_world1_worker, np=1, device="cuda",
                                 timeout=600)
    ex, cap = r["runs"]["exact"], r["runs"]["capacity"]
    loss_rel = abs(cap["losses"][0] - ex["losses"][0]) / abs(ex["losses"][0])
    no_kernel = all(v == 0 for run in r["runs"].values()
                    for v in run["counts"].values())
    finite = all(math.isfinite(v) for run in r["runs"].values()
                 for v in run["losses"])
    ok = (r["y_rel"] <= MOE_F32_TOL and loss_rel <= MOE_F32_TOL
          and r["aux_rel"] <= MOE_F32_TOL and no_kernel and finite
          and cap["drop_rate"] == 0 and r["world"] == 1)
    seconds = time.perf_counter() - t0

    def desc(run):
        return (f"{run['tokens_per_sec']:.1f} tokens/s, {run['step_ms']:.2f} "
                f"ms a step, peak memory "
                f"{run['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
                f"{[round(v, 5) for v in run['losses']]}")

    log(f"phase 8a: MoE block at world 1 (d_model 1024, 4x hidden, vocab "
        f"32768, 8 experts, {MOE['tokens']} tokens a step, f32, Adam 1e-2; "
        f"ep = 1, so the exchange is the exact all_to_all, the quantized "
        f"wire's fallback at an axis of one rank: no wire kernel launched "
        f"{no_kernel}): exact {desc(ex)}; capacity (CF "
        f"{MOE['ample_cf']:g}, drop rate {cap['drop_rate']:.4f}, imbalance "
        f"{cap['imbalance']:.3f}) {desc(cap)}; first step, capacity against "
        f"exact: y max diff {r['y_rel']:.3e} of max |y|, aux "
        f"{r['aux_rel']:.3e}, loss {loss_rel:.3e} (each <= "
        f"{MOE_F32_TOL:g}); {seconds:.1f} s on {CARD}: ok={ok}")
    if not ok:
        raise AssertionError("phase 8a (MoE at world 1) failed its checks")
    return {**r, "loss_rel": loss_rel, "seconds": seconds}


def inject_moe_fault(kind: str) -> None:
    """Break the MoE path on purpose in this process (``--fault``):
    ``moe-skip-dp-sum`` leaves the expert gradients unsummed over dp;
    ``a2a-swap-peers`` makes the packed exchange deliver the first two
    peers' row groups swapped."""
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.parallel import expert as epar
    from horovod_tpu_torch.parallel._comm import _exchange

    if kind == "moe-skip-dp-sum":
        def unsummed(params, mesh):
            for path, p in epar._paths(params):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = (g if epar.ep_param_spec(path)
                          else _exchange("all_reduce", g, None)) / mesh.world

        epar.reduce_capacity_gradients = unsummed
    elif kind == "a2a-swap-peers":
        real = spmd._a2a_packed

        def swapped(packed, group, m):
            got = real(packed, group, m)
            k = got.shape[0] // m
            return torch.cat([got[k:2 * k], got[:k], got[2 * k:]])

        spmd._a2a_packed = swapped


def kernel_counts(prof, names: dict) -> dict:
    """Kernel launches in a torch.profiler trace, by group of ``names``
    (substrings of the kernel's name)."""
    from torch.autograd import DeviceType

    out = {k: 0 for k in names}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        for group, pats in names.items():
            if any(p in evt.key for p in pats):
                out[group] += evt.count
    return out


def moe_grid_worker(tokens: int, fault=None) -> dict:
    """One rank of phase 8b, a dp=2 x ep=2 grid on one card over gloo:
    the quantized exchange at the step's payload against the exact one, its
    packed rows against the twin's, and its error-feedback residual's #1 /
    #2 and value against the plain ones; then each of ``MOE_CONFIGS`` for 1
    + 2 steps (launches, hop bytes and step ms per step, a traced step of
    each quantized wire) and capacity off at CF 8 for one step."""
    import hashlib

    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import expert as epar
    from horovod_tpu_torch.parallel._comm import all_to_all
    from horovod_tpu_torch.train import MoETrainer
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    if fault:
        inject_moe_fault(fault)
    marks = {"start": time.time()}
    ep = MOE_GRID["ep"]
    tr = MoETrainer("capacity", tokens=tokens, ep=ep, seed=0)
    mesh = tr.mesh
    res = {"grid": [mesh.dp_rank, mesh.ep_rank], "backend": hvd.backend(),
           "a2a": {}, "runs": {}}
    with torch.no_grad():
        n = tokens // mesh.world
        h = tr.params["emb"][tr.batch[0][mesh.rank * n:(mesh.rank + 1) * n]]
        buf = epar.SwitchDispatch(mesh, MOE["cf"], "", None,
                                  None).route(tr.params, h)[-1]
        exact = all_to_all(buf, mesh.ep_group)
        per = buf.numel() // ep
        rows = F.pad(buf.reshape(ep, per), (0, (-per) % BLOCK)).reshape(
            -1, BLOCK).contiguous()
        zero = torch.zeros_like(buf)
        flat = (buf + zero).reshape(ep, per)  # the function's corrected
        for wire in ("int8", "int4"):
            got, new_ef = spmd.quantized_all_to_all(
                buf, mesh.ep_group, wire, BLOCK, ef=zero)
            pack = getattr(ck, f"{wire}_quantize_pack_2d")
            plain = getattr(ck, f"{wire}_quantize_pack_2d_plain")
            # the residual's rows are the pack's: #1 (int8; int4's
            # quantize is plain torch) and #2 against their twins, and the
            # residual against the plain roundtrip, bit for bit
            if wire == "int8":
                q, s = ck.int8_quantize_2d_plain(rows)
                q1, s1 = ck.int8_quantize_2d(rows)
                quantize_equal = bits_equal(q1, q) and bits_equal(s1, s)
            else:
                q, s = ck.quant_rows(rows, ck.INT4_QMAX)
                quantize_equal = True
            deq = ck.int8_dequantize_2d_plain(q, s)
            want_ef = (flat - deq.reshape(ep, -1)[:, :per]).reshape(buf.shape)
            res["a2a"][wire] = {
                "rel": float((got - exact).abs().max() / exact.abs().max()),
                "byte_equal": bits_equal(pack(rows), plain(rows)),
                "residual_equal": (
                    quantize_equal
                    and bits_equal(ck.int8_dequantize_2d(q, s), deq)
                    and bits_equal(new_ef, want_ef)),
                "payload": list(buf.shape), "rows": rows.shape[0]}
    del tr, h, buf, exact, rows, zero, flat, got, new_ef, deq, want_ef
    torch.cuda.empty_cache()
    marks["a2a"] = time.time()

    runs = [(name, MOE["cf"], 3) for name in MOE_CONFIGS]
    runs.append(("capacity-ample", MOE["ample_cf"], 1))
    counts = {k: 0 for k in ck.launch_counts()}
    for name, cf, steps in runs:
        dispatch = "capacity" if name == "capacity-ample" else name
        tr = MoETrainer(dispatch, tokens=tokens, ep=ep, seed=0,
                        capacity_factor=cf)
        torch.cuda.reset_peak_memory_stats()
        run = {"losses": [], "step_ms": [], "hop_bytes": [], "per_step": []}
        ck.reset_launch_counts()
        for _ in range(steps):
            before = ck.launch_counts()
            sent = spmd.hop_bytes()
            tr.sync()
            t0 = time.perf_counter()
            run["losses"].append(float(tr.step()))
            tr.sync()
            run["step_ms"].append((time.perf_counter() - t0) * 1e3)
            run["hop_bytes"].append(spmd.hop_bytes() - sent)
            after = ck.launch_counts()
            run["per_step"].append({k: after[k] - before[k] for k in after
                                    if after[k] - before[k]})
        if name in MOE_TRACE_WANT:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tr.step()
                tr.sync()
            run["trace"] = kernel_counts(prof, MOE_TRACE)
        # the counters were reset before this run's first step: they hold
        # its steps and its traced step, each launch once
        for k, v in ck.launch_counts().items():
            counts[k] += v
        if tr.capacity:
            load = tr.stats["load"].float()
            run["drop_rate"] = float(tr.stats["dropped"]) / tr.n_tokens
            run["imbalance"] = float(load.max() / load.mean())
            ef = tr.opt_state[1]
            run["ef_nonzero"] = [bool(ef[i].abs().max() > 0)
                                 for i in range(2)]
            run["per_peer"] = ef[0].numel() // ep
            run["footprint"] = (comp.moe_wire_footprint(
                run["per_peer"], tr.config["wire"], ep, BLOCK)
                if tr.config["wire"] else 0)
        digests = {}
        for kind in ("replicated", "shard"):
            hsh = hashlib.sha256()
            for path, p in epar._paths(tr.params):
                if bool(epar.ep_param_spec(path)) == (kind == "shard"):
                    hsh.update("/".join(path).encode())
                    hsh.update(p.detach().cpu().numpy().tobytes())
            digests[kind] = hsh.hexdigest()
        run.update(digests=digests, wire=tr.config["wire"],
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
        res["runs"][name] = run
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        marks[name] = time.time()
    res["counts"] = counts
    res["marks"] = marks
    return res


def moe_grid_checks(ranks: list, world1_loss, same_tokens: bool) -> dict:
    """Phase 8b's checks over the ranks' readings: name -> passed."""
    runs = {name: [r["runs"][name] for r in ranks]
            for name in ranks[0]["runs"]}
    checks = {}
    checks["1 quantized exchange against the exact"] = all(
        r["a2a"][w]["rel"] < tol for r in ranks
        for w, tol in MOE_A2A_TOL.items())
    checks["2 packed rows byte-equal to the twin's"] = all(
        r["a2a"][w]["byte_equal"] for r in ranks for w in MOE_A2A_TOL)
    ample = runs["capacity-ample"][0]["losses"][0]
    exact = runs["exact"][0]["losses"][0]
    checks["3 capacity off at CF 8 against exact"] = (
        abs(ample - exact) / abs(exact) <= MOE_F32_TOL
        and (not same_tokens or world1_loss is None
             or abs(ample - world1_loss) / abs(world1_loss) <= MOE_F32_TOL))
    same = True
    for name, rs in runs.items():
        rep = {r["digests"]["replicated"] for r in rs}
        shard = [r["digests"]["shard"] for r in rs]
        same = (same and len(rep) == 1 and shard[0] == shard[2]
                and shard[1] == shard[3] and shard[0] != shard[1])
    checks["4 replicated leaves and expert shards agree"] = same
    checks["5 error-feedback residual nonzero both ways (int8)"] = all(
        all(r["ef_nonzero"]) for r in runs["capacity-int8"])
    checks["5b residual's #1 / #2 and new_ef bit-equal to the plain ones"] = \
        all(r["a2a"][w]["residual_equal"] for r in ranks for w in MOE_A2A_TOL)
    checks["6 hop bytes a step = moe_wire_footprint"] = all(
        all(b == r["footprint"] for b in r["hop_bytes"])
        for name in MOE_PER_STEP for r in runs[name])
    per_step = all(
        s == MOE_PER_STEP.get(name, {}) for name, rs in runs.items()
        for r in rs for s in r["per_step"])
    traced = all(r["trace"] == MOE_TRACE_WANT[name]
                 for name in MOE_TRACE_WANT for r in runs[name])
    checks["7 wire kernel launches a step (counters, trace)"] = (
        per_step and traced)
    checks["finite losses"] = all(math.isfinite(v) for rs in runs.values()
                                  for r in rs for v in r["losses"])
    checks["grid and backend"] = (
        [r["grid"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
        and all(r["backend"] == "gloo" for r in ranks))
    return checks


def phase_moe_grid(world1_loss=None, fault=None) -> dict:
    """Phase 8b: ``moe_grid_worker`` on 4 ranks sharing the card over gloo
    (dp=2 x ep=2). With ``fault``, the readings only: the caller checks
    that some check fails."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    tokens = MOE_GRID["tokens"]
    with expandable_segments():
        ranks = testing.run_cluster(moe_grid_worker, np=4, device="cuda",
                                    args=(tokens, fault), timeout=900)
    seconds = time.perf_counter() - t0
    checks = moe_grid_checks(ranks, world1_loss, tokens == MOE["tokens"])
    ok = all(checks.values())
    r0 = ranks[0]["runs"]

    def desc(name):
        rs = [r["runs"][name] for r in ranks]
        peak = [round(r["peak_memory_bytes"] / 2**30, 2) for r in rs]
        out = (f"{name}: losses {[round(v, 5) for v in rs[0]['losses']]}, "
               f"step ms per rank "
               f"{[[round(v, 1) for v in r['step_ms']] for r in rs]}, peak "
               f"memory GiB {peak}")
        if "drop_rate" in rs[0]:
            out += (f", drop rate {rs[0]['drop_rate']:.4f}, imbalance "
                    f"{rs[0]['imbalance']:.3f}")
        if name in MOE_PER_STEP:
            out += (f", launches a step {rs[0]['per_step']}, trace "
                    f"{rs[0]['trace']}, hop bytes a step "
                    f"{rs[0]['hop_bytes']} (catalog {rs[0]['footprint']}), "
                    f"residual nonzero {[r['ef_nonzero'] for r in rs]}")
        return out

    a2a = {w: [round(r["a2a"][w]["rel"], 5) for r in ranks]
           for w in MOE_A2A_TOL}
    log(f"phase 8b{f' with fault {fault}' if fault else ''}: MoE block on "
        f"dp=2 x ep=2 (gloo, one card), full widths, {tokens} global tokens, "
        f"CF {MOE['cf']}: exchange payload "
        f"{ranks[0]['a2a']['int8']['payload']} a rank, quantized against "
        f"exact {a2a} (< {MOE_A2A_TOL}); capacity off at CF "
        f"{MOE['ample_cf']:g} first loss "
        f"{r0['capacity-ample']['losses'][0]:.6f} against exact "
        f"{r0['exact']['losses'][0]:.6f} and 8a's "
        f"{world1_loss}; " + "; ".join(desc(n) for n in MOE_CONFIGS)
        + f"; checks {checks}; {seconds:.1f} s on {CARD}: ok={ok}")
    if not ok and not fault:
        raise AssertionError("phase 8b (MoE on a dp x ep grid) failed its "
                             "checks")
    return {"ranks": ranks, "checks": checks, "seconds": seconds,
            "tokens": tokens}


# phase 8c: GPT-2-medium's 24 blocks as 4 stages of 6 on pp = 4 (gloo, one
# card), batch 8 x 1024, bf16, default attention (K5 / K7), 8 microbatches
PIPE = dict(stages=4, microbatches=8, steps=2)
# the pipeline's first step against the 24 blocks run in sequence in one
# process, bf16: the loss, relative; each gradient's max |diff| over its
# tensor's max |g| (stages, embedding, positions, final LayerNorm). On an
# H100 80GB HBM3 at 700 W the sound run read a loss rel of 0 and gradients
# up to 4.6e-3 (bf16 products of microbatch shapes), a stage skipped
# 3.2e-4 and 1.0-1.45 (PERF.md)
PIPE_LIMITS = (1e-5, 2e-2)


def pipe_stage_tree(blocks, per: int) -> dict:
    """The stacked ``[S, ...]`` stage tree of ``blocks``, ``per`` blocks a
    stage, keyed as an ``nn.Sequential`` of ``per`` blocks names its
    parameters."""
    stages = [torch.nn.Sequential(*blocks[s * per:(s + 1) * per])
              for s in range(len(blocks) // per)]
    names = [n for n, _ in stages[0].named_parameters()]
    return {n: torch.stack([dict(st.named_parameters())[n].detach()
                            for st in stages]) for n in names}


def pipe_worker(fault=None) -> dict:
    """One rank of phase 8c: rank 0 first runs the 24 blocks in sequence
    on the whole batch (its loss and gradients: each stage's go to its
    rank); then ``make_pp_train_step`` for ``PIPE["steps"]`` AdamW steps,
    launches counted from 0 just before them, the first step's loss and
    gradients held to the sequential ones. ``fault`` ``pipe-skip-stage``:
    stage 1 forwards its input unchanged, so stage 0's output skips it."""
    import hashlib

    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.func import functional_call

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import pipeline as pp
    from horovod_tpu_torch.train import synthetic_lm_tokens

    marks = {"start": time.time()}
    dev = hvd.device()
    S, M = PIPE["stages"], PIPE["microbatches"]
    per = MEDIUM["layers"] // S
    mesh = pp.make_pp_mesh(S)
    rank = mesh.pp_rank
    cfg = dict(vocab_size=MEDIUM["vocab"], num_layers=MEDIUM["layers"],
               num_heads=MEDIUM["heads"], d_model=MEDIUM["d"],
               max_seq_len=MEDIUM["seq"], dtype=torch.bfloat16, seed=0)
    toks = torch.from_numpy(synthetic_lm_tokens(
        MEDIUM["batch"], MEDIUM["seq"], MEDIUM["vocab"], 0, 1)).to(dev)
    x, y = toks[:, :-1], toks[:, 1:]
    full = TransformerLM(**cfg)
    stacked = pipe_stage_tree(full.blocks, per)
    head_names = ("tok_emb.weight", "pos_emb", "ln_f.weight", "ln_f.bias")
    names = list(stacked)
    sizes = [stacked[n][0].numel() for n in names]
    head_sizes = [dict(full.named_parameters())[n].numel()
                  for n in head_names]
    ref = {}
    if rank == 0:
        net = TransformerLM(**cfg).to(dev)
        ref_loss = lm_loss(net(x), y)
        ref_loss.backward()
        flat = []
        for s in range(S):
            grads = dict(torch.nn.Sequential(
                *net.blocks[s * per:(s + 1) * per]).named_parameters())
            flat.append(torch.cat([grads[n].grad.float().reshape(-1).cpu()
                                   for n in names]))
        params = dict(net.named_parameters())
        head = torch.cat([params[n].grad.float().reshape(-1).cpu()
                          for n in head_names]
                         + [ref_loss.detach().float().reshape(1).cpu()])
        del net, grads, params, ref_loss
        torch.cuda.empty_cache()
        for s in range(1, S):
            dist.send(flat[s], dst=s)
        mine = flat[0]
        del flat
    else:
        mine = torch.empty(sum(sizes))
        dist.recv(mine, src=0)
        head = torch.empty(sum(head_sizes) + 1)
    dist.broadcast(head, src=0)
    ref["loss"] = float(head[-1])
    ref["stage"] = dict(zip(names, mine.split(sizes)))
    ref["head"] = dict(zip(head_names, head[:-1].split(head_sizes)))
    marks["reference"] = time.time()

    template = torch.nn.Sequential(*full.blocks[:per]).to(dev)
    stage = {k: v.detach().to(dev).requires_grad_()
             for k, v in pp.shard_stage_params(stacked, mesh).items()}
    fp = dict(full.named_parameters())
    head_p = {n: fp[n].detach().to(dev).requires_grad_() for n in head_names}
    ln_f = full.ln_f.to(dev)
    del full, stacked

    def stage_fn(p, act):
        return functional_call(template, p, (act,))

    if fault == "pipe-skip-stage" and rank == 1:
        def stage_fn(p, act):  # noqa: F811
            return act

    def loss_head(acts, tgt):
        hdn = functional_call(ln_f, {"weight": head_p["ln_f.weight"],
                                     "bias": head_p["ln_f.bias"]}, (acts,))
        logits = F.linear(hdn, head_p["tok_emb.weight"].to(torch.bfloat16))
        return lm_loss(logits.float(), tgt)

    opt = torch.optim.AdamW(list(stage.values()) + list(head_p.values()),
                            lr=SP_LR, weight_decay=0.01, fused=True)
    step = pp.make_pp_train_step(stage_fn, loss_head, opt, mesh, M)
    t = x.shape[1]
    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    losses, step_ms, agree = [], [], None
    for i in range(PIPE["steps"]):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        emb = (F.embedding(x, head_p["tok_emb.weight"]).to(torch.bfloat16)
               + head_p["pos_emb"][:t].to(torch.bfloat16))
        losses.append(float(step(stage, emb, y)))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts_first = ck.launch_counts()
            rel = {}
            for n, g_ref in list(ref["stage"].items()) + list(
                    ref["head"].items()):
                g = head_p[n].grad if n in head_p else stage[n].grad
                g = (g.float().reshape(-1).cpu() if g is not None
                     else torch.zeros_like(g_ref))
                rel[n] = float((g - g_ref).abs().max()
                               / g_ref.abs().max().clamp_min(1e-30))
            worst = max(rel, key=rel.get)
            agree = {"loss": losses[0], "loss_ref": ref["loss"],
                     "loss_rel": abs(losses[0] - ref["loss"])
                     / abs(ref["loss"]),
                     "grad_rel_max": rel[worst], "grad_rel_worst": worst}
    marks["steps"] = time.time()
    hsh = hashlib.sha256()
    for n in head_names:
        hsh.update(head_p[n].detach().float().cpu().numpy().tobytes())
    return {"counts": ck.launch_counts(), "counts_first": counts_first,
            "losses": losses, "step_ms": step_ms, "agreement": agree,
            "head_sha256": hsh.hexdigest(), "rank": rank,
            "backend": hvd.backend(),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "marks": marks}


def phase_pipeline(fault=None) -> dict:
    """Phase 8c: ``pipe_worker`` on pp = 4 ranks sharing the card over
    gloo. With ``fault``, the readings only: the caller checks that the
    agreement fails."""
    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    S, M, steps = PIPE["stages"], PIPE["microbatches"], PIPE["steps"]
    ranks = testing.run_cluster(pipe_worker, np=S, device="cuda",
                                args=(fault,), timeout=900)
    seconds = time.perf_counter() - t0
    per = MEDIUM["layers"] // S
    ticks = M + S - 1
    want = {"flash_attention_fwd": per * ticks,
            "flash_attention_bwd": per * ticks}
    launched = all(r["counts"][k] == steps * want.get(k, 0)
                   for r in ranks for k in r["counts"])
    loss_lim, grad_lim = PIPE_LIMITS
    agree = {"loss": all(r["agreement"]["loss_rel"] <= loss_lim
                         for r in ranks),
             "gradients": all(r["agreement"]["grad_rel_max"] <= grad_lim
                              for r in ranks)}
    same_head = len({r["head_sha256"] for r in ranks}) == 1
    same_loss = len({tuple(r["losses"]) for r in ranks}) == 1
    finite = all(math.isfinite(v) for r in ranks for v in r["losses"])
    ok = (launched and all(agree.values()) and same_head and same_loss
          and finite and [r["rank"] for r in ranks] == list(range(S))
          and all(r["backend"] == "gloo" for r in ranks))
    seen = [{k: v / steps for k, v in r["counts"].items() if v}
            for r in ranks]
    grads = [(round(r["agreement"]["grad_rel_max"], 5),
              r["agreement"]["grad_rel_worst"]) for r in ranks]
    peak = [round(r["peak_memory_bytes"] / 2**30, 2) for r in ranks]
    log(f"phase 8c{f' with fault {fault}' if fault else ''}: GPipe, "
        f"GPT-2-medium's {MEDIUM['layers']} blocks as {S} stages of {per} "
        f"on pp={S} (gloo, one card), batch {MEDIUM['batch']} x "
        f"{MEDIUM['seq']} bf16, {M} microbatches, {steps} AdamW steps: "
        f"launches per rank per step {seen} (want {want}); first step "
        f"against the {MEDIUM['layers']} blocks in sequence: loss "
        f"{[round(r['agreement']['loss'], 6) for r in ranks]} against "
        f"{ranks[0]['agreement']['loss_ref']:.6f}, rel "
        f"{max(r['agreement']['loss_rel'] for r in ranks):.3e} (<= "
        f"{loss_lim:g}); gradients per rank "
        f"{grads} of the tensor's max |g| (<= {grad_lim:g}); {agree}; head "
        f"parameters bit-identical on all ranks {same_head}; losses "
        f"{[round(v, 5) for v in ranks[0]['losses']]}; step ms per rank "
        f"{[[round(v, 1) for v in r['step_ms']] for r in ranks]}; peak "
        f"memory GiB {peak}; {seconds:.1f} s on {CARD}: ok={ok}")
    if not ok and not fault:
        raise AssertionError("phase 8c (the pipeline) failed its checks")
    return {"ranks": ranks, "seconds": seconds, "agreement": agree}


def moe_fault_check(fault: str) -> int:
    """``--fault moe-skip-dp-sum`` / ``a2a-swap-peers`` (phase 8b) or
    ``pipe-skip-stage`` (phase 8c): 0 when some check of the phase
    fails."""
    if fault == "pipe-skip-stage":
        caught = {k: not v for k, v in
                  phase_pipeline(fault=fault)["agreement"].items()}
    else:
        caught = {k: not v for k, v in
                  phase_moe_grid(fault=fault)["checks"].items()}
    print(json.dumps({"fault": fault, "caught": caught}), flush=True)
    return 0 if any(caught.values()) else 1


# ----------------------------------------------- phases 9a-9e: the model zoo
# the image models of phases 9a / 9b at full width (bench.py's TPU
# defaults): batch, image side, and the parameter count or its range
ZOO = {"9a": ("VGG16", 128, 224, (138_357_544, 138_357_544)),
       "9b": ("InceptionV3", 128, 299, (23.0e6, 24.5e6))}
# phase 9c: (model, image side, batch, dtype); VGG with a short cfg at
# 64x64 (five pools leave 2 x 2, so the flatten's order matters). Inception
# runs in f64, its loss taken from the head's f64 output: in f32 its ~94
# BatchNorms over few values a channel make 3 steps chaotic (on the CPU the
# thread count alone moves an f32 run far past the bounds, and an f64 run
# nowhere near them), so f32 could not tell a wrong kernel from the order
# of a sum
ZOO_SMALL = (("VGG", 64, 8, torch.float32),
             ("InceptionV3", 139, 8, torch.float64),
             ("MNISTConvNet", 28, 8, torch.float32))
ZOO_SHORT_CFG = [16, "M", 32, "M", 64, "M", 64, "M", 64, "M"]
# phase 9c's bounds, card against CPU after 3 steps of f32 SGD with int8
# error feedback (TF32 off), as phase 2b's: the loss relative, the
# parameters absolute (a flipped int8 rounding moves one block's residual)
ZOO_LOSS_REL, ZOO_PARAM_ABS = 1e-4, 2e-4
# phase 9e: the real-data folder (4 classes of 224x224 uint8 .npy images,
# plus PNGs through PIL where it is installed), ResNet-50 at batch 32 a
# rank for 2 epochs with a 2-epoch warmup from BASE_LR
REALDATA = dict(classes=4, npy=512, png=8, side=224, batch=32, epochs=2,
                seed=3, base_lr=0.0125)
ZOO_FAULTS = ("dots-save-none", "shard-overlap")
# the exit code of a zoo fault whose phase failed a check (the fault was
# caught): not 1, which any uncaught error gives
ZOO_FAULT_CAUGHT = 4


class ChecksFailed(AssertionError):
    """A phase failed some of its named checks (``checks``: name -> bool)."""

    def __init__(self, phase: str, checks: dict):
        self.checks = checks
        super().__init__(f"{phase} failed: "
                         f"{[k for k, v in checks.items() if not v]}")


def ef_residual_check(tr) -> tuple:
    """One more int8 + error-feedback step of an ``ImageTrainer`` on the
    engine's plane at world 1: the new residual of every leaf against the
    plain roundtrip of ``grad + residual`` (the twins of the grouped #1 and
    of #2), bit for bit, then #1 / #2 against their twins at the largest
    leaf (VGG-16's first dense kernel, 102.76M elements). Returns the main
    path's launch counts before the twin comparisons."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.ops import cuda_kernels as ck

    opt = tr.dist_opt
    named = [(n, p) for n, p in tr.net.named_parameters() if p.requires_grad]
    opt.zero_grad()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        logits = tr.net(tr.x)
    F.cross_entropy(logits.float(), tr.y).backward()
    with torch.no_grad():
        corrected = [p.grad + opt._ef_residual[n] if n in opt._ef_residual
                     else p.grad.clone() for n, p in named]
    opt.step()
    tr.sync()
    counts = ck.launch_counts()
    block = comp.block_size()
    out = {}
    with torch.no_grad():
        q, sc = ck.int8_quantize_2d_many_plain(corrected, block)
        y = ck.int8_dequantize_2d_plain(q, sc).reshape(-1)
        equal, start = True, 0
        for (n, _), c in zip(named, corrected):
            k = c.numel()
            want = c - y[start:start + k].view(c.shape)
            equal = equal and bits_equal(opt._ef_residual[n], want)
            start += -(-k // block) * block
        del q, sc, y
        i = max(range(len(named)), key=lambda j: corrected[j].numel())
        c = corrected[i].reshape(-1)
        rows = torch.nn.functional.pad(
            c, (0, (-c.numel()) % block)).reshape(-1, block)
        q1, s1 = ck.int8_quantize_2d(rows)
        q0, s0 = ck.int8_quantize_2d_plain(rows)
        out = {"residual_equal": equal, "leaf": named[i][0],
               "leaf_elements": c.numel(),
               "quantize_equal": bits_equal(q1, q0) and bits_equal(s1, s0),
               "dequantize_equal": bits_equal(ck.int8_dequantize_2d(q0, s0),
                                              ck.int8_dequantize_2d_plain(
                                                  q0, s0))}
    out["ok"] = (out["residual_equal"] and out["quantize_equal"]
                 and out["dequantize_equal"])
    return out, counts


def phase_zoo_world1(label: str) -> dict:
    """Phases 9a (VGG-16) / 9b (Inception V3): world 1 at full width (bf16
    autocast, channels_last, SGD 0.01 momentum 0.9) on the engine's plane,
    int8 with error feedback (2 warm-up, 5 timed steps, then one more step
    whose residual is held to the plain roundtrip bit for bit) and then
    without compression; images/s, ms a step, peak memory, #1 / #2
    launches a step; 9b also one graphed step of the compiled plane against
    the eager first step's loss."""
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import ImageTrainer

    model, batch, image, (lo, hi) = ZOO[label]
    steps, warmup = 5, 2
    t0 = time.perf_counter()
    out, ok = {"model": model, "batch": batch, "image": image}, True
    table = ck._kernel("hvd_int8_table_leaves")[1]()
    for wire in ("int8", "none"):
        ck.reset_launch_counts()
        tr = ImageTrainer(model, batch=batch, image=image, compression=wire,
                          error_feedback=wire == "int8", device="cuda:0")
        torch.cuda.reset_peak_memory_stats()
        losses, secs = timed_steps(tr, warmup, steps)
        peak = torch.cuda.max_memory_allocated()
        leaves = sum(1 for p in tr.net.parameters() if p.requires_grad)
        n_params = sum(p.numel() for p in tr.net.parameters())
        ran = warmup + steps
        r = {"losses": losses, "images_per_sec": batch * steps / secs,
             "step_ms": 1e3 * secs / steps, "peak_memory_bytes": peak,
             "leaves": leaves, "params": n_params}
        good = (all(math.isfinite(v) for v in losses)
                and lo <= n_params <= hi)
        if wire == "int8":
            residual, counts = ef_residual_check(tr)
            ran += 1
            r["residual"] = residual
            want = {"int8_quantize_2d": -(-leaves // table),
                    "int8_dequantize_2d": 1}
            good = good and residual["ok"] and all(
                counts[k] == ran * n for k, n in want.items())
        else:
            counts = ck.launch_counts()
            want = {k: 0 for k in WIRE}
            good = good and all(counts[k] == 0 for k in WIRE)
        r.update(counts=counts, per_step={k: counts[k] / ran for k in want},
                 want_per_step=want)
        out[wire] = r
        ok = ok and good
        log(f"phase {label}: {model} world 1 batch {batch} {image}x{image} "
            f"{wire}{'+EF' if wire == 'int8' else ''}: "
            f"{r['images_per_sec']:.1f} images/s, {r['step_ms']:.2f} ms a "
            f"step, peak memory {peak / 2**30:.2f} GiB, {n_params} "
            f"parameters in {leaves} leaves, launches a step "
            f"{r['per_step']} (want {want}), losses "
            f"{[round(v, 4) for v in losses]}"
            + (f", residual {residual}" if wire == "int8" else "")
            + f" on {CARD}: ok={good}")
        del tr
        release()
    if label == "9b":
        ck.reset_launch_counts()
        tr = ImageTrainer(model, batch=batch, image=image,
                          compression="int8", device="cuda:0",
                          plane="compiled", graph=True)
        loss = float(tr.step())
        tr.sync()
        eager = out["int8"]["losses"][0]
        rel = abs(loss - eager) / abs(eager)
        ts = tr.train_step
        g = {"loss": loss, "eager_loss": eager, "rel": rel,
             "graphed": ts.graphed, "counts": ck.launch_counts(),
             "launches_per_replay": ts.launches_per_replay}
        good = (ts.graphed and rel <= RESNET_GRAPH_LOSS
                and ts.launches_per_replay == {"int8_quantize_2d": 1,
                                               "int8_dequantize_2d": 1})
        ok = ok and good
        out["graphed"] = g
        log(f"phase 9b: {model} compiled plane, one graphed step: loss "
            f"{loss:.6f} against the eager first step's {eager:.6f}, rel "
            f"{rel:.3e} (<= {RESNET_GRAPH_LOSS}), per replay "
            f"{ts.launches_per_replay}: ok={good}")
        del tr, ts
        release()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase {label} took {out['seconds']:.1f} s")
    if not ok:
        raise AssertionError(f"phase {label} ({model}) failed its checks")
    return out


def zoo_small_net(name: str, image: int):
    from horovod_tpu_torch.models import InceptionV3, VGG, mnist

    if name == "VGG":
        return VGG(ZOO_SHORT_CFG, num_classes=10, dropout=0.0,
                   image_size=image, seed=2)
    if name == "InceptionV3":
        return InceptionV3(num_classes=10, seed=2)
    return mnist.MNISTConvNet(num_classes=10, dropout=(0.0, 0.0), seed=2,
                              image_size=image)


def zoo_small_run(name: str, image: int, batch: int, dev: str,
                  dtype=torch.float32, lr: float = 0.01) -> tuple:
    """3 steps of SGD (``lr``, momentum 0.9) with int8 error feedback on
    ``dev`` in ``dtype``: (losses, parameters on the CPU)."""
    from horovod_tpu_torch.ops.compression import Compression
    from horovod_tpu_torch.optim.distributed import DistributedOptimizer
    from horovod_tpu_torch.train import synthetic_batch

    channels = 1 if name.startswith("MNIST") else 3
    images, labels = synthetic_batch(batch, image, 10, 0, 1, channels)
    net = zoo_small_net(name, image).to(dev, dtype)
    opt = DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=lr, momentum=0.9),
        named_parameters=net.named_parameters(),
        compression=Compression.int8, error_feedback=True)
    x = torch.from_numpy(images).to(dev, dtype)
    y = torch.from_numpy(labels).to(dev)
    head = {}
    if dtype == torch.float64:
        # the model casts its logits to f32 (as the Flax model does), which
        # would put f32 rounding back into an f64 run: take the loss from
        # the head's own output
        last = [m for m in net.modules() if isinstance(m, torch.nn.Linear)]
        last[-1].register_forward_hook(
            lambda m, i, o: head.__setitem__("logits", o))
    losses = []
    for _ in range(3):
        opt.zero_grad()
        out = net(x)
        loss = torch.nn.functional.cross_entropy(head.get("logits", out), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, {k: v.detach().cpu().double() for k, v in
                    net.named_parameters()}


def phase_zoo_small_agreement() -> dict:
    """Phase 9c: VGG (a short cfg at 64x64) and MNISTConvNet (28x28) in
    f32, Inception V3 (139x139) in f64 (``ZOO_SMALL``), batch 8, 3 steps
    with int8 error feedback (the wire kernels take the f64 leaves as f32)
    on the card (kernels) and on the CPU (twins), TF32 off: the losses and
    parameters within ZOO_LOSS_REL / ZOO_PARAM_ABS."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck

    hvd.init(device="cuda:0")
    t0 = time.perf_counter()
    out, ok = {}, True
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = {k: 0 for k in ck.launch_counts()}
    try:
        for name, image, batch, dtype in ZOO_SMALL:
            lc, pc = zoo_small_run(name, image, batch, "cpu", dtype)
            ck.reset_launch_counts()
            lg, pg = zoo_small_run(name, image, batch, "cuda", dtype)
            for k, v in ck.launch_counts().items():
                counts[k] += v
            loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
            param_abs = max(float((pc[k] - pg[k]).abs().max()) for k in pc)
            good = loss_rel < ZOO_LOSS_REL and param_abs < ZOO_PARAM_ABS
            ok = ok and good
            out[name] = {"loss_rel": loss_rel, "param_abs": param_abs,
                         "image": image, "dtype": str(dtype),
                         "losses_cpu": lc, "losses_card": lg}
            log(f"phase 9c: small {name} ({image}x{image}) card vs CPU, 3 "
                f"steps int8+EF in {dtype}: loss rel diff {loss_rel:.3e} (< "
                f"{ZOO_LOSS_REL}), param abs diff {param_abs:.3e} (< "
                f"{ZOO_PARAM_ABS}): ok={good}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9c took {out['seconds']:.1f} s")
    if not ok:
        raise AssertionError("card and CPU disagree on a small zoo model")
    return out


def lm_remat_per_step(remat: str, layers: int) -> dict:
    """Kernel launches a step of the fused LM (K8, K9) under ``remat``:
    a recomputing mode runs each block's K5 and its two K8 again."""
    want = lm_per_step(True, layers)
    if remat != "none":
        want["flash_attention_fwd"] += layers
        want["layer_norm_fwd"] += 2 * layers
    return want


def phase_lm_remat(fault=None) -> dict:
    """Phase 9d: GPT-2-medium (5b's widths, fused LN and AdamW) at world 1
    under ``remat`` none, full and dots, 2 + 5 steps each: ms a step,
    tokens/s, peak memory (of the 6 steps after the first), launches a
    step; the first step's loss and gradients under dots bit-equal to
    none's (the same kernels on the same inputs: K7 has no float atomics);
    peak memory full < dots < none; then each mode as one CUDA graph (the
    compiled plane), with its launches a replay. ``fault="dots-save-none"``
    makes the dots policy save nothing (it then recomputes what full does)
    and skips the graphed runs. Raises :class:`ChecksFailed` naming the
    failed checks."""
    from horovod_tpu_torch.models import transformer
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import LMTrainer

    if fault == "dots-save-none":
        transformer.DOTS_SAVED = ()
    steps, warmup = 5, 2
    t0 = time.perf_counter()
    out, checks, first = {}, {}, None
    for remat in ("none", "full", "dots"):
        ck.reset_launch_counts()
        tr = LMTrainer("medium", fused_ln=True, fused_opt=True, remat=remat,
                       device="cuda:0")
        loss0 = tr.step()
        tr.sync()
        # the first step's loss and gradients, kept on the host so that no
        # mode's peak memory carries them
        grads = [p.grad.cpu() for p in tr.net.parameters()]
        if remat == "none":
            first = (loss0.cpu(), grads)
        elif remat == "dots":
            same_loss = bits_equal(loss0.cpu(), first[0])
            same = [bits_equal(g, g0) for g, g0 in zip(grads, first[1])]
            worst = max(float((g - g0).abs().max()
                              / g0.abs().max().clamp_min(1e-30))
                        for g, g0 in zip(grads, first[1]))
            out["dots_vs_none"] = {"loss_bit_equal": same_loss,
                                   "grads_bit_equal": sum(same),
                                   "grads": len(same), "worst_rel": worst}
            checks["dots' first loss and gradients bit-equal to none's"] = (
                same_loss and all(same))
            first = None
        del grads
        # peak memory of the steps after the first (which made the
        # optimizer's state): the same weights and state in every mode
        torch.cuda.reset_peak_memory_stats()
        losses, secs = timed_steps(tr, warmup - 1, steps)
        peak = torch.cuda.max_memory_allocated()
        counts = ck.launch_counts()
        ran = warmup + steps
        want = lm_remat_per_step(remat, MEDIUM["layers"])
        r = {"losses": [float(loss0)] + losses, "step_ms": 1e3 * secs / steps,
             "tokens_per_sec": tr.batch * tr.seq * steps / secs,
             "peak_memory_bytes": peak, "counts": counts,
             "per_step": {k: counts[k] / ran for k in want}}
        good = (all(math.isfinite(v) for v in r["losses"])
                and all(counts[k] == ran * n for k, n in want.items()))
        checks[f"remat={remat}: finite losses, launches a step"] = good
        out[remat] = r
        log(f"phase 9d: GPT-2-medium world 1 fused, remat={remat}: "
            f"{r['step_ms']:.2f} ms a step, {r['tokens_per_sec']:.1f} "
            f"tokens/s, peak memory {peak / 2**30:.2f} GiB, launches a step "
            f"{r['per_step']} (want {want}), losses "
            f"{[round(v, 4) for v in r['losses']]} on {CARD}: ok={good}")
        del tr
        release()
    # the same three steps as one CUDA graph each (the compiled plane): the
    # eager step is host-bound, and the selective checkpoint's dispatch
    # mode adds host work that a replay does not repeat
    for remat in ("none", "full", "dots"):
        if fault:
            break
        want = lm_remat_per_step(remat, MEDIUM["layers"])
        tr = LMTrainer("medium", fused_ln=True, fused_opt=True, remat=remat,
                       device="cuda:0", compiled=True)
        losses, secs = timed_steps(tr, warmup, steps)
        per = tr.train_step.launches_per_replay
        g = {"graphed": tr.train_step.graphed, "step_ms": 1e3 * secs / steps,
             "tokens_per_sec": tr.batch * tr.seq * steps / secs,
             "launches_per_replay": per, "losses": losses}
        good = (g["graphed"] and all(math.isfinite(v) for v in losses)
                and all(per.get(k, 0) == n for k, n in want.items()))
        checks[f"remat={remat} graphed: one graph, finite losses, launches "
               f"a replay"] = good
        log(f"phase 9d: remat={remat} as one CUDA graph: "
            f"{g['step_ms']:.2f} ms a step, {g['tokens_per_sec']:.1f} "
            f"tokens/s, per replay {per}: ok={good}")
        out[remat]["graph"] = g
        del tr
        release()
    peaks = {m: out[m]["peak_memory_bytes"] for m in ("none", "full", "dots")}
    # what dots keeps beyond full: the four products' bf16 outputs, 9 d
    # values a token a layer; at least half of it must show
    kept = 9 * MEDIUM["batch"] * MEDIUM["seq"] * MEDIUM["d"] * 2 * \
        MEDIUM["layers"]
    order = (peaks["full"] + kept // 2 <= peaks["dots"] < peaks["none"])
    out["products_bytes"] = kept
    checks["peak memory full + half the products <= dots < none"] = order
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 9d: dots against none, first step: "
        f"{out.get('dots_vs_none')}; peak memory full "
        f"{peaks['full'] / 2**30:.2f} + half the products "
        f"{kept // 2 / 2**30:.2f} <= dots {peaks['dots'] / 2**30:.2f} < "
        f"none {peaks['none'] / 2**30:.2f} GiB: {order}; checks {checks}; "
        f"took {out['seconds']:.1f} s")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise ChecksFailed("phase 9d (remat none / full / dots)", checks)
    return out


def write_image_folder(root: str, cfg: dict) -> dict:
    """Phase 9e's folder: ``cfg["classes"]`` classes of 224x224 uint8
    ``.npy`` images from a seeded generator, plus PNGs where PIL is
    installed."""
    import numpy as np

    rng = np.random.RandomState(cfg["seed"])
    side, n_cls = cfg["side"], cfg["classes"]
    try:
        from PIL import Image
    except ImportError:
        Image = None
    pngs = cfg["png"] if Image is not None else 0
    for i in range(cfg["npy"] + pngs):
        cdir = os.path.join(root, f"class_{i % n_cls}")
        os.makedirs(cdir, exist_ok=True)
        arr = rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
        if i < cfg["npy"]:
            np.save(os.path.join(cdir, f"img_{i:04d}.npy"), arr)
        else:
            Image.fromarray(arr).save(os.path.join(cdir, f"img_{i:04d}.png"))
    return {"npy": cfg["npy"], "png": pngs}


def realdata_worker(root: str, cfg: dict, overlap: bool = False) -> dict:
    """One rank of phase 9e: ResNet-50 (seeded by rank, so the broadcast
    matters) on this rank's ``ShardedImageFolder`` shard, SGD under
    ``DistributedOptimizer`` on the packed int8 wire with error feedback,
    the broadcast, warmup and metric-average callbacks, ``cfg["epochs"]``
    epochs (``cfg``: ``REALDATA``). ``overlap``: every rank reads rank 0's
    stride."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.callbacks import (BroadcastGlobalVariablesCallback,
                                             CallbackList,
                                             LearningRateWarmupCallback,
                                             MetricAverageCallback)
    from horovod_tpu_torch.data import ShardedImageFolder
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.train import params_sha256

    os.environ["HOROVOD_PACKED_WIRE"] = "1"
    ck.reset_launch_counts()
    dev = hvd.device()
    ds = ShardedImageFolder(root, batch_size=cfg["batch"],
                            image_size=cfg["side"],
                            rank=0 if overlap else None, seed=cfg["seed"])
    net = ResNet50(num_classes=cfg["classes"], seed=hvd.rank()).to(dev)
    net = net.to(memory_format=torch.channels_last)
    sgd = torch.optim.SGD(net.parameters(), lr=cfg["base_lr"], momentum=0.9)
    opt = hvd.DistributedOptimizer(sgd, named_parameters=net.named_parameters(),
                                   compression=hvd.Compression.int8,
                                   error_feedback=True)
    state = {"params": net, "optimizer": sgd, "lr": cfg["base_lr"]}
    cbs = CallbackList([
        BroadcastGlobalVariablesCallback(root_rank=0),
        LearningRateWarmupCallback(warmup_epochs=cfg["epochs"],
                                   steps_per_epoch=ds.steps_per_epoch),
        MetricAverageCallback()])
    t0 = time.perf_counter()
    cbs.on_train_begin(state)
    res = {"rank": hvd.rank(), "size": hvd.size(), "backend": hvd.backend(),
           "steps_per_epoch": ds.steps_per_epoch, "n_files": len(ds.paths),
           "shards": [], "lrs": [], "metrics": [], "local_loss": [],
           "sha": [], "losses": []}
    for epoch in range(cfg["epochs"]):
        ds.set_epoch(epoch)
        res["shards"].append(ds._indices().tolist())
        cbs.on_epoch_begin(epoch, state)
        losses = []
        for b, (x, y) in enumerate(ds):
            for g in sgd.param_groups:
                g["lr"] = state["lr"]
            res["lrs"].append(state["lr"])
            opt.zero_grad()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                logits = net(torch.from_numpy(x).to(dev))
            loss = F.cross_entropy(logits.float(),
                                   torch.from_numpy(y).long().to(dev))
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            cbs.on_batch_end(b, state)
        local = float(torch.stack(losses).mean())
        metrics = {"loss": local}
        cbs.on_epoch_end(epoch, state, metrics)
        res["local_loss"].append(local)
        res["metrics"].append(metrics)
        res["losses"] += [float(v) for v in losses]
        res["sha"].append(params_sha256(net))
    res["seconds"] = time.perf_counter() - t0
    res["counts"] = ck.launch_counts()
    return res


def realdata_lr(epoch: int, batch: int, steps: int, size: int,
                cfg: dict) -> float:
    """The reference's warmup lr in force at ``batch`` of ``epoch``
    (``horovod_tpu/callbacks.py``): ``base * (size * p + 1 - p)`` at ``p =
    (epoch + batch / steps) / warmup``, ``base * size`` once warm."""
    warmup, base = cfg["epochs"], cfg["base_lr"]
    frac = epoch + min(1.0, batch / float(steps))
    if frac >= warmup:
        return base * size
    p = frac / float(warmup)
    return base * (size * p + (1 - p))


def phase_realdata(fault=None, cfg: dict = REALDATA,
                   device: str = "cuda") -> dict:
    """Phase 9e: the real-data path at world 2 (two gloo processes sharing
    the card) on a written image folder: disjoint shards covering the
    truncated epoch, reshuffled identically by ``set_epoch``, parameters
    bit-identical across ranks after each epoch, the averaged metric equal
    on both ranks, the reference's warmup lr at every batch, #1 - #3
    launched. ``fault="shard-overlap"``: both ranks read the same stride."""
    import tempfile

    import numpy as np

    from horovod_tpu_torch import testing

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hvd_realdata_") as root:
        files = write_image_folder(root, cfg)
        written = time.perf_counter() - t0
        ranks = testing.run_cluster(
            realdata_worker, np=2, device=device,
            args=(root, cfg, fault == "shard-overlap"), timeout=900)
    n, steps = ranks[0]["n_files"], ranks[0]["steps_per_epoch"]
    used = steps * cfg["batch"] * 2
    checks = {}
    cover = []
    for epoch in range(cfg["epochs"]):
        a, b = (set(r["shards"][epoch]) for r in ranks)
        perm = np.random.RandomState(cfg["seed"] + epoch).permutation(
            n)[:used]
        cover.append(a.isdisjoint(b) and (a | b) == set(perm.tolist()))
    checks["shards disjoint, covering the truncated epoch"] = all(cover)
    checks["set_epoch reshuffles"] = all(
        r["shards"][0] != r["shards"][1] for r in ranks)
    checks["parameters bit-identical after each epoch"] = (
        ranks[0]["sha"] == ranks[1]["sha"])
    checks["averaged metric equal on both ranks"] = (
        ranks[0]["metrics"] == ranks[1]["metrics"]
        and all(abs(m["loss"] - (l0 + l1) / 2) <= 1e-6 * abs(m["loss"])
                for m, l0, l1 in zip(ranks[0]["metrics"],
                                     ranks[0]["local_loss"],
                                     ranks[1]["local_loss"])))
    want = [realdata_lr(e, b, steps, 2, cfg) for e in range(cfg["epochs"])
            for b in range(steps)]
    checks["the reference's warmup lr at every batch"] = all(
        r["lrs"] == want for r in ranks)
    checks["wire kernels launched (#1, #2, #3)"] = all(
        r["counts"][k] > 0 for r in ranks
        for k in ("int8_quantize_2d", "int8_dequantize_2d",
                  "int8_quantize_pack_2d"))
    checks["finite losses, gloo"] = all(
        r["backend"] == "gloo" and all(math.isfinite(v) for v in r["losses"])
        for r in ranks)
    secs = time.perf_counter() - t0
    log(f"phase 9e: ResNet-50 on a written folder ({files['npy']} .npy + "
        f"{files['png']} PNG, {n} files, written in {written:.1f} s), world "
        f"2 (gloo, one card), batch {cfg['batch']} a rank, {steps} steps "
        f"an epoch x {cfg['epochs']}, packed int8 + EF: training "
        f"{[round(r['seconds'], 1) for r in ranks]} s a rank, metrics "
        f"{ranks[0]['metrics']}, lrs {ranks[0]['lrs']}, launches "
        f"{[{k: v for k, v in r['counts'].items() if v} for r in ranks]}; "
        f"checks {checks}; took {secs:.1f} s")
    if not all(checks.values()):
        raise ChecksFailed("phase 9e (the real-data path)", checks)
    return {"ranks": ranks, "checks": checks, "files": files,
            "seconds": secs}


def zoo_fault_check(fault: str) -> int:
    """``--fault dots-save-none`` (phase 9d) or ``shard-overlap`` (phase
    9e): the phase runs with the fault and each check's verdict is
    printed; ZOO_FAULT_CAUGHT when some check fails, 0 when all pass. Any
    other error propagates (and exits 1)."""
    phase = phase_lm_remat if fault == "dots-save-none" else phase_realdata
    try:
        checks = phase(fault=fault)["checks"]
    except ChecksFailed as e:
        checks = e.checks
    caught = {k: not v for k, v in checks.items()}
    print(json.dumps({"fault": fault, "caught": caught}), flush=True)
    return ZOO_FAULT_CAUGHT if any(caught.values()) else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", metavar="PATH", default=None,
                        help="also write the full report to PATH as JSON")
    parser.add_argument("--fault",
                        choices=sorted(FAULTS) + ["flip-byte", "zero1",
                                                  "pipe-skip-stage",
                                                  *MOE_FAULTS, *ZOO_FAULTS],
                        default=None,
                        help="break ring attention (skip-hop, shift-k-off: "
                        "phases 6c and 6d only), a row-parallel reduce "
                        "(drop-tp-reduce: phases 7c and 7d only) or one "
                        "byte of one hop of the compiled plane's allreduces "
                        "(flip-byte: phase 3c only), or plant wrong ZeRO-1 "
                        "steps (zero1: phase 3d only), the MoE path "
                        "(moe-skip-dp-sum, a2a-swap-peers: phase 8b only) or "
                        "the pipeline (pipe-skip-stage: phase 8c only) on "
                        "purpose; exits 0 when each phase's agreement check "
                        "fails; or make remat='dots' save nothing "
                        "(dots-save-none: phase 9d only) or both ranks read "
                        "one shard (shard-overlap: phase 9e only), which exit "
                        f"{ZOO_FAULT_CAUGHT} when a check of the phase fails")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build

    start = time.perf_counter()
    global CARD
    CARD = card_line()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    log(f"card: {CARD}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"memory rate {rate / 1e12} TB/s; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cudnn.benchmark=True")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(_build.load, LIBRARIES))  # one nvcc each, at once
    log(f"built {', '.join(f'{n}.cu' for n in LIBRARIES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for n in LIBRARIES:
        print(_build.compile_log(n), file=sys.stderr, flush=True)
    if args.fault == "flip-byte":
        return algo_fault_check()
    if args.fault == "zero1":
        return zero1_fault_check()
    if args.fault in MOE_FAULTS + ("pipe-skip-stage",):
        return moe_fault_check(args.fault)
    if args.fault in ZOO_FAULTS:
        return zoo_fault_check(args.fault)
    if args.fault:
        return fault_check(args.fault)

    # phases 8a-8c first, while this process holds almost nothing on the
    # card: 8b's four ranks need nearly all of it
    moe1 = phase_moe_world1()
    moe_grid = phase_moe_grid(moe1["runs"]["exact"]["losses"][0])
    pipeline = phase_pipeline()
    kernels = phase_kernels(rate)
    kernels["adasum_combine_pairs"] = phase_adasum_kernel(rate)
    lm_kernels = phase_lm_kernels(rate)
    lm_checks = lm_kernels.pop("checks")
    attention_sass = lm_kernels.pop("sass")
    kernels.update(lm_kernels)
    kernels["matmul_2d"] = phase_matmul_kernel(rate)
    world1 = phase_world1()
    breakdown = phase_breakdown(world1["batch"])
    small = phase_small_agreement()
    compiled1 = phase_compiled_resnet(world1["batch"], {
        "int8": world1["images_per_sec"],
        "none": breakdown["plain_images_per_sec"]})
    lm1 = phase_lm_world1()
    lm_profile = phase_lm_profile()
    lm_compiled = phase_compiled_lm(lm1)
    lm_small = phase_lm_small_agreement()
    engine1 = phase_engine_world1()
    release()
    vgg = phase_zoo_world1("9a")
    inception = phase_zoo_world1("9b")
    zoo_small = phase_zoo_small_agreement()
    lm_remat = phase_lm_remat()
    hvd.shutdown()
    realdata = phase_realdata()
    world2 = phase_world2()
    algorithms = phase_algorithms()
    zero1 = phase_zero1()
    engine2 = phase_engine_world2()
    programs = phase_programs()
    adasum2 = phase_adasum_world2()
    adasum4 = phase_adasum_world4()
    lm2 = phase_lm_world2()
    # phase 6 in a fresh process: this late in a long one, a trace loses
    # kernels (K6's and K7's device times came back short, then empty)
    with ProcessPoolExecutor(1, mp_context=get_context("spawn")) as pool:
        ring = pool.submit(ring_kernels_child, rate, CARD).result()
    kernels["flash_attention_step"] = ring["kernel"]
    for name in ("fwd", "bwd"):
        k = kernels[f"flash_attention_{name}"]
        k["max_abs_err"] = max(k["max_abs_err"], ring[f"{name}_max_abs_err"])
    torch.cuda.empty_cache()  # the four-rank phases share the card
    sp_attention = phase_sp_attention()
    sp_long = phase_sp_train("6c", *SP_RUNS["6c"])
    sp_grid = phase_sp_train("6d", *SP_RUNS["6d"])
    mm_rs = phase_matmul_reduce_scatter()
    tp_long = phase_tp_train("7c", *TP_RUNS["7c"])
    tp_hybrid = phase_tp_train("7d", *TP_RUNS["7d"])

    # each main-path run counted its launches from 0
    runs = ([world1["counts"]]
            + [r["counts"] for r in compiled1.values()
               if isinstance(r, dict) and "counts" in r]
            + [r["counts"] for r in lm_compiled.values()]
            + [c for r in algorithms.values() for c in r["counts"]]
            + [r[z]["counts"] for r in zero1["ranks"]
               for z in ("replicated", "zero1")]
            + [r[m]["counts"] for r in world2["ranks"]
               for m in ("int8", "int4")]
            + [run["counts"] for r in engine2["ranks"]
               for run in r["runs"].values()]
            + [x["counts"] for rs in programs["clusters"].values()
               for r in rs for kind in ("runs", "flat")
               for x in r[kind].values()]
            + [r["counts"] for r in adasum2["ranks"] + adasum4["ranks"]]
            + [r["counts"] for r in lm1.values()]
            + [r["counts"] for r in lm2["ranks"]]
            + [r[m]["counts"] for r in sp_attention["ranks"]
               for m in ("ring", "ulysses")]
            + [r["counts"] for r in sp_long["ranks"] + sp_grid["ranks"]]
            + [r["counts"] for r in mm_rs["ranks"] + tp_long["ranks"]
               + tp_hybrid["ranks"]]
            + [r["counts"] for r in moe1["runs"].values()]
            + [r["counts"] for r in moe_grid["ranks"] + pipeline["ranks"]]
            + [z[w]["counts"] for z in (vgg, inception)
               for w in ("int8", "none")]
            + [inception["graphed"]["counts"], zoo_small["counts"]]
            + [lm_remat[m]["counts"] for m in ("none", "full", "dots")]
            + [r["counts"] for r in realdata["ranks"]])
    for k in kernels.values():
        k["launches"] = sum(c[k["name"]] for c in runs)
    missing = [k for k, v in kernels.items() if v["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    report = {"card": CARD, "kernels": list(kernels.values()),
              "world1": world1, "breakdown": breakdown, "small": small,
              "world2": world2, "engine_world1": engine1,
              "compiled_resnet": compiled1, "compiled_lm": lm_compiled,
              "algorithms": algorithms, "zero1": zero1,
              "engine_world2": engine2, "programs": programs,
              "adasum_world2": adasum2,
              "attention_sass": attention_sass,
              "adasum_world4": adasum4, "lm_checks": lm_checks,
              "lm_world1": lm1, "lm_profile": lm_profile,
              "lm_small": lm_small, "lm_world2": lm2,
              "ring_checks": ring["checks"], "sp_attention": sp_attention,
              "sp_long": sp_long, "sp_grid": sp_grid,
              "matmul_reduce_scatter": mm_rs, "tp": tp_long,
              "hybrid": tp_hybrid, "moe_world1": moe1, "moe_grid": moe_grid,
              "pipeline": pipeline, "vgg16": vgg, "inception_v3": inception,
              "zoo_small": zoo_small, "lm_remat": lm_remat,
              "realdata": realdata}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(f"every phase passed in {time.perf_counter() - start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = [{k: v[k] for k in keys} for v in kernels.values()]
    # the grouped form of K4, the main path's, beside its single-pair row
    grouped = kernels["adasum_combine_pairs"]["grouped"]
    line[list(kernels).index("adasum_combine_pairs")]["grouped"] = {
        k: grouped[k] for k in ("leaves", "launches", "ms", "device_ms",
                                "bound_ms", "per_leaf_ms",
                                "per_leaf_device_ms")}
    print(json.dumps({"kernels": line}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
