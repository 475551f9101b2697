#!/usr/bin/env python3
"""Time flash attention K5 and K7 of two checkouts of the port on one card.

    python3 attention_ab.py --parent DIR [--report PATH]

DIR holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory ``.gitignore``
lists). Each side runs in a process of its own, which imports
``horovod_tpu_torch`` from its checkout and builds that checkout's kernels,
in the order parent, this checkout, this checkout, parent, so that drift
on the card shows. Every side times, at the LM's main shape (q, k, v the
strided views of a ``[8, 1024, 16, 3, 64]`` bf16 qkv tensor, causal):

* ``fwd``: ``flash_attention_fwd`` (K5);
* ``bwd``: ``flash_attention_bwd`` with a given D = rowsum(dO * O) (K7);
* ``bwd_as_called``: the backward as the autograd function calls it
  (``flash_attention(...).backward``'s kernels and the work around them);
* ``sdpa_fwd`` / ``sdpa_bwd``: ``F.scaled_dot_product_attention`` and its
  backward on the same inputs.

Each is the median of per-call CUDA-event times (ms), and for the kernels
also the device time a call from ``torch.profiler`` (kernels whose name
holds ``flash``). Prints one JSON line per side, then a summary line, and
writes all of it to PATH with ``--report``. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
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
    return sorted(times)[iters // 2]


def device_ms(torch, fn, iters: int = 10) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "flash" in e.key) \
        / 1e3 / iters


def worker(root: str) -> dict:
    """One side: this process imports the port from ``root``."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from horovod_tpu_torch.ops import attention
    from horovod_tpu_torch.ops import cuda_kernels as ck

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
    calls = {
        "fwd": lambda: ck.flash_attention_fwd(q, k, v, causal=True),
        "bwd": lambda: ck.flash_attention_bwd(q, k, v, do, lse, dd,
                                              causal=True),
        "bwd_as_called": lambda: torch.autograd.grad(y, leaves, do,
                                                     retain_graph=True),
        "sdpa_fwd": lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True),
        "sdpa_bwd": lambda: torch.autograd.grad(
            sd, (qs, ks, vs), do.transpose(1, 2), retain_graph=True),
    }
    res = {"root": root, "card": torch.cuda.get_device_name(0)}
    for name, fn in calls.items():
        res[f"{name}_ms"] = cuda_ms(torch, fn)
        if not name.startswith("sdpa"):
            res[f"{name}_device_ms"] = device_ms(torch, fn)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", help="the other checkout's directory")
    parser.add_argument("--report", help="also write the results here")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("attention_ab: needs a CUDA card and --parent DIR",
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
                              os.path.abspath(root)], capture_output=True,
                             text=True)
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
    print(json.dumps(summary), flush=True)
    if args.report:
        with open(args.report, "w") as f:
            json.dump({"sides": sides, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
