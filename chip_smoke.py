#!/usr/bin/env python3
"""Drive horovod_tpu_torch on one NVIDIA GPU (an H100) and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA wire-compression kernels from ``horovod_tpu_torch/csrc`` at first use
(into ``build/torch_kernels/``), then:

1. holds each kernel against its plain-PyTorch twin on the card, byte for
   byte, at the main-path shape (the flat ResNet-50 gradient as
   ``[rows, 256]``) and at ragged shapes, and times both;
2. trains ResNet-50 at full width (batch 256, 224x224, bf16 autocast) at
   world size 1 through ``DistributedOptimizer(int8, error_feedback=True)``,
   whose error-feedback roundtrip runs the int8 quantize and dequantize
   kernels on every gradient leaf; measures the same step without
   compression and profiles two steps; and checks a small model against
   the same training on the CPU;
3. trains ResNet-50 at world size 2 (two gloo processes sharing the card) on
   the packed int8 wire and then the int4 wire, and checks that the
   parameters are bit-identical on both ranks.

Exits non-zero, with no result line, when a phase fails or no CUDA device
is present. The last line of standard output is
``{"ok": true, "device": {...}}``; before it come the card's name and power
limit and a ``{"kernels": [...]}`` line. ``--report PATH`` also writes
the full report (every phase's numbers) to PATH as JSON.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

BLOCK = 256
SOURCE = "horovod_tpu_torch/csrc/wire_quant.cu"
REPLACES = {
    "int8_quantize_2d": "horovod_tpu/ops/pallas_kernels.py:1578",
    "int8_dequantize_2d": "horovod_tpu/ops/pallas_kernels.py:1596",
    "int8_quantize_pack_2d": "horovod_tpu/ops/pallas_kernels.py:1637",
    "int4_quantize_pack_2d": "horovod_tpu/ops/pallas_kernels.py:1728",
}
# Device memory rate by card name (NVIDIA data sheets), bytes/s.
MEMORY_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
               ("H100", 3.35e12))
F32_RATE = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
CARD = ""  # the nvidia-smi name and power limit line, set by main()


def log(*a):
    print(*a, flush=True)


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
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
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


# --------------------------------------------------------------- phase 1
def phase_kernels(rate: float) -> dict:
    from horovod_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = resnet50_gradient_rows()
    shapes = [(rows, BLOCK, torch.float32), (1, BLOCK, torch.float32),
              (5, 100, torch.float32), (64, BLOCK, torch.bfloat16)]
    checks = {name: [] for name in REPLACES}
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
    torch.cuda.synchronize()
    failed = [(k, shape) for k, cs in checks.items() for shape, ok, _ in cs
              if not ok]
    log(f"phase 1: kernel == plain on the card: {not failed} "
        f"(nan row scale pinned: {nan_ok})")
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
    out = {}
    for name, (kern, plain, library, nbytes, ops) in work.items():
        ms = cuda_ms(kern, 50)
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
            "GBps": nbytes / ms / 1e6,
        }
        lib = f", library {library_ms:.4f} ms" if library else ""
        log(f"  {name}: [{rows}, {BLOCK}] f32 kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms{lib}, {nbytes} bytes, bound {bytes_ms:.4f} ms "
            f"({nbytes / ms / 1e6:.0f} GB/s) on {CARD}")
    return out


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
    ok = (all(math.isfinite(v) for v in res["losses"])
          and res["device"].startswith("cuda")
          and hvd.device().type == "cuda"
          and counts["int8_quantize_2d"] >= (steps + warmup) * leaves
          and counts["int8_dequantize_2d"] >= (steps + warmup) * leaves
          and (counts["int8_quantize_2d"] + counts["int8_dequantize_2d"]
               >= 2 * steps * leaves))
    log(f"phase 2: ResNet-50 world 1 batch {batch} 224x224 int8+EF: "
        f"{res['images_per_sec']:.1f} images/s, peak memory "
        f"{res['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
        f"{[round(v, 4) for v in res['losses']]}, launches {counts}, "
        f"{leaves} gradient leaves, on {CARD}: ok={ok}")
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
            if "int8_quant_kernel" in k or "int8_dequant_kernel" in k}
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    res = {"plain_images_per_sec": plain["images_per_sec"],
           "profiled_steps": steps, "device_ms_total": total,
           "wire_kernel_ms": sum(wire.values()), "top_kernels": top}
    share = (f"{100 * res['wire_kernel_ms'] / total:.2f}% of {total:.1f} ms "
             f"device time" if total else "profiler recorded no device time")
    log(f"phase 2c: world 1 without compression {plain['images_per_sec']:.1f}"
        f" images/s; 2 profiled int8+EF steps: wire kernels "
        f"{res['wire_kernel_ms']:.2f} ms = {share}; on {CARD}")
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", metavar="PATH", default=None,
                        help="also write the full report to PATH as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build

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
    _build.load("wire_quant")
    log(f"built wire_quant.cu in {time.perf_counter() - t0:.1f} s")
    print(_build.compile_log("wire_quant"), file=sys.stderr, flush=True)

    kernels = phase_kernels(rate)
    world1 = phase_world1()
    breakdown = phase_breakdown(world1["batch"])
    small = phase_small_agreement()
    hvd.shutdown()
    world2 = phase_world2()

    for k in kernels.values():
        name_ = k["name"]
        k["launches"] = world1["counts"][name_] + sum(
            r[m]["counts"][name_] for r in world2["ranks"]
            for m in ("int8", "int4"))
    missing = [k for k, v in kernels.items() if v["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    report = {"card": CARD, "kernels": list(kernels.values()),
              "world1": world1, "breakdown": breakdown, "small": small,
              "world2": world2}
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: v[k] for k in keys}
                                  for v in kernels.values()]}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
