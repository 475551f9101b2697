#!/usr/bin/env python3
"""Time kernels of two checkouts of the port on one card: the int8 / int4
wire kernels (#1-#4), the Adasum combine K4, K5-K8, K10.

    python3 kernel_ab.py --parent DIR [--report PATH] [--only adasum|matmul]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory ``.gitignore``
lists). Each side runs in a process of its own, which imports
``horovod_tpu_torch`` from its checkout and builds that checkout's kernels,
in the order parent, this checkout, this checkout, parent, so that drift
on the card shows. Every side times:

* at the flat ResNet-50 gradient as ``[99851, 256]`` f32 rows
  (``chip_smoke.gradient_like``): ``wire_q``, ``int8_quantize_2d`` (#1);
  ``wire_dq``, ``int8_dequantize_2d`` (#2); ``wire_pack``,
  ``int8_quantize_pack_2d`` (#3); ``wire_pack4``,
  ``int4_quantize_pack_2d`` (#4, whose code neither side changed: the
  control); ``wire_q_<rows>`` / ``wire_pack_<rows>``, #1 and #3 at 64,
  9216 and 30000 seeded normal rows of 256 (per-tensor sizes), and
  ``wire_q_zeros_9216``, #1 on 9216 rows of zeros;
* at ResNet-50's 161 gradient leaves (seeded normal values in each
  parameter's shape): ``leaves_per_leaf``, ``int8_quantize_2d`` on each
  leaf padded to whole rows beforehand (161 launches); ``leaves_grouped``,
  ``int8_quantize_2d_many`` on the leaves as they are (where the side has
  it); ``roundtrip_per_leaf``, ``quantize_roundtrip`` on each leaf (what
  error feedback ran per leaf: pad, #1, #2); ``roundtrip_many``,
  ``quantize_roundtrip_many`` (where the side has it);

* at the LM's attention shape (q, k, v the strided views of a ``[8, 1024,
  16, 3, 64]`` bf16 qkv tensor, causal): ``fwd``, ``flash_attention_fwd``
  (K5); ``bwd``, ``flash_attention_bwd`` with a given D = rowsum(dO * O)
  (K7); ``bwd_f32``, the same with f32 gradients (the contract of
  ``_flash_bwd_resident``); ``bwd_as_called``, the backward as the
  autograd function calls it;
  ``sdpa_fwd`` / ``sdpa_bwd``, ``F.scaled_dot_product_attention`` and its
  backward on the same inputs;
* at the ring's hop (``chip_smoke.ring_hop_inputs``: phase 6's inputs,
  q, k, v ``[1, 4096, 16, 64]`` bf16, rank 2 of a 4-rank causal ring),
  below the diagonal (every pair visible) and on it: ``step_<hop>``,
  ``flash_attention_step`` (K6) folding the hop into a carried (m, l, o);
  ``bwd_f32_<hop>``, ``flash_attention_bwd`` with f32 gradients (K7 as the
  ring's backward calls it); ``fwd_below``, K5 on the hop below the
  diagonal (the same products as ``step_below`` without the carry); and,
  as the nearest library call but not the same contract (no carry, bf16
  gradients), ``sdpa_fwd_<hop>`` / ``sdpa_bwd_<hop>`` (``is_causal`` on
  the diagonal hop only);
* K4 (``--only adasum`` times it alone): ``adasum_1`` / ``adasum_4``,
  ``adasum_combine_pairs`` on ``[1 | 4, 2359296]`` f32 pairs
  (``chip_smoke.adasum_pairs``); ``adasum_4_add``, ``torch.add(a, b,
  out=)`` on the ``[4, 2359296]`` pair: not the same function, but the
  same bytes moved (two reads, one write), a yardstick of the card's
  rate; ``adasum_leaves_per_leaf``, one
  single-pair call on each of ResNet-50's 161 leaves as a world-2 tree
  level (``chip_smoke.adasum_level_pairs``); ``adasum_leaves_grouped``,
  ``adasum_combine_pairs_many`` on the same levels (where the side has
  it); under ``adasum``, the device ms of ``[1 | 4, 2359296]`` with L2
  flushed before each call (``cold_device_ms``) and the host
  microseconds a single-pair call at ``[1, 4096]`` and ``[1, 2359296]``
  (``host_us``, as K8's below);
* ``mm_lm_head`` / ``mm_mlp_out``: ``matmul_2d`` (K10) at the fused
  ring's two bf16 chunks, ``[2048, 256] @ [256, 32768]`` and ``[2048,
  1024] @ [1024, 1024]``, and ``torch.matmul`` on the same operands
  (``_library``); ``mm_lm_head_f32`` / ``mm_mlp_out_f32`` (and their
  ``_library``), the same in f32 (K10's f32 route; TF32 off);
  ``mm_f32_sha256``, the SHA-256 of K10's f32 output at both chunks and at
  ``chip_smoke.MM_F32_RAGGED``'s ragged shapes, on seeded inputs that
  both sides share: the summary's ``mm_f32_bits_equal`` says whether every
  side gave the same bits (``--only matmul`` times K10 alone);
* ``ln``: ``layer_norm_fwd`` (K8) at ``[8192, 1024]`` bf16 with f32 gamma
  and beta; ``ln_as_called``, ``fused_layer_norm`` as the model calls it
  (autograd recording); ``ln_library``, ``F.layer_norm`` with gamma and
  beta cast to bf16 before the timed calls.

Each is the median of per-call CUDA-event times (ms), and for the kernels
also the device time a call from ``torch.profiler`` (kernels whose name
holds ``flash``, ``hvd_mm`` (``hvd_mm_fma`` for f32), ``ln_fwd`` or
``adasum_``; for the wire,
each call runs one kernel: ``int8_quant_tiles`` (the register path of #1
and #3) or a general loop's ``int8_quant_rows`` / ``int8_quant_pack`` for
#1 and #3, the parent's ``int8_quant_kernel`` for #1, ``int8_dequant`` for
#2 and ``int4_quant_pack`` for #4), both timed by ``chip_smoke.py``'s
``cuda_ms`` and ``device_ms``; ``step_<hop>`` updates its own copy of the
carry in place, call after call, as phase 6 times it. Then the host side
of K8: ``host_us``, microseconds a call over 1000 back-to-back calls on
the host clock without synchronising, of the three LayerNorm calls at
``[8192, 1024]`` and at
``[64, 1024]`` (where the device is idle most of the time, so the host's
cost shows); and ``host_profile_us``, the functions that took the most
time of their own (cProfile, which adds its own cost to each) over 1000
calls of the public ``layer_norm_fwd`` at ``[64, 1024]``. Prints one JSON
line per side, then a summary line, and writes all of it to PATH with
``--report``. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_CALLS = 1000


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """Microseconds a call over ``calls`` back-to-back calls, host clock,
    no synchronisation inside the window."""
    import time

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def layer_norm_host(torch, ck, fused_layer_norm) -> dict:
    """K8's host side: whole calls at two sizes, and a cProfile of the
    wrapper at the smaller."""
    import cProfile
    import pstats

    import torch.nn.functional as F

    out = {"host_us": {}, "host_profile_us": {}}
    gen = torch.Generator(device="cuda").manual_seed(8)
    for label, n in (("8192x1024", 8192), ("64x1024", 64)):
        x = torch.randn(n, 1024, generator=gen, device="cuda").to(
            torch.bfloat16)
        gm = torch.randn(1024, generator=gen, device="cuda")
        bt = torch.randn(1024, generator=gen, device="cuda")
        xg = x.detach().requires_grad_()
        gp, bp = (t.detach().requires_grad_() for t in (gm, bt))
        g16, b16 = gm.to(x.dtype), bt.to(x.dtype)
        out["host_us"][label] = {
            "layer_norm_fwd": host_us(
                torch, lambda: ck.layer_norm_fwd(x, gm, bt, 1e-6)),
            "fused_layer_norm (autograd on)": host_us(
                torch, lambda: fused_layer_norm(xg, gp, bp, eps=1e-6)),
            "F.layer_norm": host_us(
                torch, lambda: F.layer_norm(x, (1024,), g16, b16, 1e-6)),
        }
    prof = cProfile.Profile()  # x, gm, bt: the [64, 1024] inputs
    prof.enable()
    for _ in range(HOST_CALLS):
        ck.layer_norm_fwd(x, gm, bt, 1e-6)
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:12]
    for (file, line, func), (_, _, tottime, _, _) in top:
        where = f"{os.path.basename(file)}:{line}({func})"
        out["host_profile_us"][where] = tottime / HOST_CALLS * 1e6
    return out


def hop_calls(torch, F, ck, hop, q, k, v, do, lse, dd, kw, carry) -> dict:
    """The calls timed at one ring hop (see the module's docstring)."""
    scratch = [c.clone() for c in carry]
    causal = kw["k_off"] == kw["q_off"]  # the diagonal hop
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sd = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    calls = {
        f"step_{hop}": (lambda: ck.flash_attention_step(q, k, v, *scratch,
                                                        **kw), "flash"),
        f"bwd_f32_{hop}": (lambda: ck.flash_attention_bwd(
            q, k, v, do, lse, dd, out_dtype=torch.float32, **kw), "flash"),
        f"sdpa_fwd_{hop}": (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal), None),
        f"sdpa_bwd_{hop}": (lambda: torch.autograd.grad(
            sd, (qs, ks, vs), do.transpose(1, 2), retain_graph=True), None),
    }
    if hop == "below":
        calls["fwd_below"] = (lambda: ck.flash_attention_fwd(q, k, v, **kw),
                              "flash")
    return calls


def wire_calls(torch, ck, comp) -> dict:
    """The wire kernels' calls (see the module's docstring)."""
    import torch.nn.functional as F

    from chip_smoke import (WIRE_Q, gradient_like, resnet50_gradient_rows,
                            resnet50_leaves)

    q1 = WIRE_Q + ("int8_quant_kernel",)  # and the parent's #1
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = gradient_like(resnet50_gradient_rows(), 256, gen)
    q, s = ck.int8_quantize_2d_plain(x)
    leaves = resnet50_leaves(gen)
    padded = [F.pad(t.reshape(-1), (0, -t.numel() % 256)).reshape(-1, 256)
              for t in leaves]
    calls = {
        "wire_q": (lambda: ck.int8_quantize_2d(x), q1),
        "wire_dq": (lambda: ck.int8_dequantize_2d(q, s), ("int8_dequant",)),
        "wire_pack": (lambda: ck.int8_quantize_pack_2d(x),
                      ("int8_quant_tiles", "int8_quant_pack")),
        "wire_pack4": (lambda: ck.int4_quantize_pack_2d(x),
                       ("int4_quant_pack",)),
        "leaves_per_leaf": (lambda: [ck.int8_quantize_2d(t) for t in padded],
                            q1),
        "roundtrip_per_leaf": (
            lambda: [comp.quantize_roundtrip(t) for t in leaves],
            q1 + ("int8_dequant",)),
    }
    # smaller calls, as the executor's per-tensor wire makes them, and
    # zeros (the IEEE division's slow path for a zero numerator)
    for rows in (64, 9216, 30000):
        xs = torch.randn(rows, 256, generator=gen, device="cuda")
        calls[f"wire_q_{rows}"] = (lambda xs=xs: ck.int8_quantize_2d(xs), q1)
        calls[f"wire_pack_{rows}"] = (
            lambda xs=xs: ck.int8_quantize_pack_2d(xs),
            ("int8_quant_tiles", "int8_quant_pack"))
    zeros = torch.zeros(9216, 256, device="cuda")
    calls["wire_q_zeros_9216"] = (lambda: ck.int8_quantize_2d(zeros), q1)
    if hasattr(ck, "int8_quantize_2d_many"):
        calls["leaves_grouped"] = (
            lambda: ck.int8_quantize_2d_many(leaves, 256), q1)
        calls["roundtrip_many"] = (
            lambda: comp.quantize_roundtrip_many(leaves),
            q1 + ("int8_dequant",))
    return calls


def adasum_calls(torch, ck) -> dict:
    """K4's calls (see the module's docstring)."""
    from chip_smoke import (ADASUM_N, adasum_level_pairs, adasum_pairs,
                            resnet50_leaves)

    gen = torch.Generator(device="cuda").manual_seed(10)
    p1 = adasum_pairs(1, ADASUM_N, gen)
    p4 = adasum_pairs(4, ADASUM_N, gen)
    pairs = adasum_level_pairs(resnet50_leaves(gen), gen)
    out4 = torch.empty_like(p4[0])
    calls = {
        "adasum_1": (lambda: ck.adasum_combine_pairs(*p1), "adasum_"),
        "adasum_4": (lambda: ck.adasum_combine_pairs(*p4), "adasum_"),
        "adasum_4_add": (lambda: torch.add(*p4, out=out4),
                         "elementwise_kernel"),
        "adasum_leaves_per_leaf": (
            lambda: [ck.adasum_combine_pairs(a, b) for a, b in pairs],
            "adasum_"),
    }
    if hasattr(ck, "adasum_combine_pairs_many"):
        calls["adasum_leaves_grouped"] = (
            lambda: ck.adasum_combine_pairs_many(pairs), "adasum_")
    return calls


def adasum_host(torch, ck) -> dict:
    """K4's host side: device times with L2 flushed before each call, and
    microseconds a single-pair call, host clock, at ``[1, 4096]`` (the
    device idle most of the time) and ``[1, 2359296]``."""
    from chip_smoke import ADASUM_N, adasum_device_ms, adasum_pairs

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {"host_us": {}, "cold_device_ms": {}}
    for m, n in ((1, 4096), (1, ADASUM_N), (4, ADASUM_N)):
        a, b = adasum_pairs(m, n, gen)
        if m == 1:
            out["host_us"][f"{m}x{n}"] = host_us(
                torch, lambda: ck.adasum_combine_pairs(a, b))
        if n == ADASUM_N:
            out["cold_device_ms"][f"{m}x{n}"] = adasum_device_ms(
                lambda: ck.adasum_combine_pairs(a, b), 20, cold=True)
    return out


def matmul_calls(torch, ck) -> dict:
    """K10's calls at the ring's two chunks, bf16 and f32, with
    ``torch.matmul`` on the same operands (see the module's docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    calls = {}
    for chunk, (m, kd, n) in (("lm_head", (2048, 256, 32768)),
                              ("mlp_out", (2048, 1024, 1024))):
        for dt, tag, match in ((torch.bfloat16, "", "hvd_mm"),
                               (torch.float32, "_f32", "hvd_mm_fma")):
            xm = torch.randn(m, kd, generator=gen, device="cuda").to(dt)
            wm = torch.randn(kd, n, generator=gen, device="cuda").to(dt)
            calls[f"mm_{chunk}{tag}"] = (
                lambda xm=xm, wm=wm: ck.matmul_2d(xm, wm), match)
            calls[f"mm_{chunk}{tag}_library"] = (
                lambda xm=xm, wm=wm: torch.matmul(xm, wm), None)
    return calls


def matmul_f32_digests(torch, ck) -> dict:
    """SHA-256 of K10's f32 output, by case, on inputs seeded the same on
    every side."""
    import hashlib

    from chip_smoke import MM_CHUNKS, MM_F32_RAGGED

    shapes = {f"{name} chunk": shape for name, shape in MM_CHUNKS.items()}
    shapes.update(MM_F32_RAGGED)
    out = {}
    for i, (what, (m, kd, n)) in enumerate(sorted(shapes.items())):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        xm = torch.randn(m, kd, generator=gen, device="cuda")
        wm = torch.randn(kd, n, generator=gen, device="cuda")
        got = ck.matmul_2d(xm, wm)
        out[what] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    return out


def worker(root: str, only) -> dict:
    """One side: this process imports the port from ``root`` and the
    timers from this checkout's ``chip_smoke.py``; ``only``: the groups
    to time (all when empty)."""
    from chip_smoke import RING, cuda_ms, device_ms, ring_hop_inputs

    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops.layer_norm import fused_layer_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"root": root, "card": torch.cuda.get_device_name(0)}
    if only == ["matmul"]:
        for name, (fn, match) in matmul_calls(torch, ck).items():
            res[f"{name}_ms"] = cuda_ms(fn, 30, 5)
            if match is not None:
                res[f"{name}_device_ms"] = device_ms(fn, 10, (match,))
        res["mm_f32_sha256"] = matmul_f32_digests(torch, ck)
        return res
    if only == ["adasum"]:
        calls = adasum_calls(torch, ck)
        for name, (fn, match) in calls.items():
            res[f"{name}_ms"] = cuda_ms(fn, 30, 5)
            res[f"{name}_device_ms"] = device_ms(fn, 10, (match,))
        res["adasum"] = adasum_host(torch, ck)
        return res
    gen = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn(8, 1024, 16, 3, 64, generator=gen,
                      device="cuda").to(torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    do = torch.randn(8, 1024, 16, 64, generator=gen,
                     device="cuda").to(torch.bfloat16)
    out, lse = ck.flash_attention_fwd(q, k, v, causal=True)
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    y = attention.flash_attention(*leaves, causal=True)
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sd = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    # name: (call, kernel-name match for the device time)
    calls = wire_calls(torch, ck, comp)
    calls.update({
        "fwd": (lambda: ck.flash_attention_fwd(q, k, v, causal=True),
                "flash"),
        "bwd": (lambda: ck.flash_attention_bwd(q, k, v, do, lse, dd,
                                               causal=True), "flash"),
        "bwd_f32": (lambda: ck.flash_attention_bwd(
            q, k, v, do, lse, dd, causal=True, out_dtype=torch.float32),
            "flash"),
        "bwd_as_called": (lambda: torch.autograd.grad(
            y, leaves, do, retain_graph=True), "flash"),
        "sdpa_fwd": (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), None),
        "sdpa_bwd": (lambda: torch.autograd.grad(
            sd, (qs, ks, vs), do.transpose(1, 2), retain_graph=True), None),
    })
    hops, carry = ring_hop_inputs(
        ck, torch.Generator(device="cuda").manual_seed(6), 1,
        RING["seq"] // RING["sp"], 16, 64, torch.bfloat16)
    for hop in ("below", "diagonal"):
        calls.update(hop_calls(torch, F, ck, hop, *hops[hop], carry))
    calls.update(matmul_calls(torch, ck))
    x = torch.randn(8192, 1024, generator=gen, device="cuda").to(
        torch.bfloat16)
    gm = torch.randn(1024, generator=gen, device="cuda")
    bt = torch.randn(1024, generator=gen, device="cuda")
    xg = x.detach().requires_grad_()
    gp, bp = (t.detach().requires_grad_() for t in (gm, bt))
    g16, b16 = gm.to(x.dtype), bt.to(x.dtype)
    calls["ln"] = (lambda: ck.layer_norm_fwd(x, gm, bt, 1e-6), "ln_fwd")
    calls["ln_as_called"] = (
        lambda: fused_layer_norm(xg, gp, bp, eps=1e-6), "ln_fwd")
    calls["ln_library"] = (
        lambda: F.layer_norm(x, (1024,), g16, b16, 1e-6), None)
    calls.update(adasum_calls(torch, ck))
    for name, (fn, match) in calls.items():
        res[f"{name}_ms"] = cuda_ms(fn, 30, 5)
        if match is not None:
            res[f"{name}_device_ms"] = device_ms(
                fn, 10, match if isinstance(match, tuple) else (match,))
    res.update(layer_norm_host(torch, ck, fused_layer_norm))
    res["adasum"] = adasum_host(torch, ck)
    res["mm_f32_sha256"] = matmul_f32_digests(torch, ck)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="the other checkout's directory")
    parser.add_argument("--report", help="also write the results here")
    parser.add_argument("--only", choices=["adasum", "matmul"],
                        action="append", default=[],
                        help="time K4 or K10 alone")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("kernel_ab: needs a CUDA card and --parent DIR",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sides = []
    for label, root in (("parent", args.parent), ("change", HERE),
                        ("change", HERE), ("parent", args.parent)):
        run = subprocess.run([sys.executable, __file__, "--worker",
                              os.path.abspath(root)]
                             + [f"--only={g}" for g in args.only],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {label} side ({root}) failed")
        side = json.loads(run.stdout.strip().splitlines()[-1])
        side["side"] = label
        print(json.dumps(side), flush=True)
        sides.append(side)
    summary = {"card": card}
    for label in ("parent", "change"):
        mine = [s for s in sides if s["side"] == label]
        for key in mine[0]:
            if key.endswith("_ms"):
                summary[f"{label}_{key}"] = [s[key] for s in mine]
        summary[f"{label}_host_us"] = [s.get("host_us") for s in mine]
        summary[f"{label}_adasum"] = [s.get("adasum") for s in mine]
    digests = [s["mm_f32_sha256"] for s in sides if "mm_f32_sha256" in s]
    if digests:
        summary["mm_f32_bits_equal"] = all(d == digests[0] for d in digests)
        summary["mm_f32_sha256"] = digests[0]
    print(json.dumps(summary), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"sides": sides, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
