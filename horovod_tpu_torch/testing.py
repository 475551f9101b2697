"""Local multi-process cluster: run a function as N ranks, one process each
(counterpart of ``horovod_tpu/testing.py``'s ``run_cluster``, whose ranks
are threads over one JAX engine).

The ranks meet through a ``file://`` store in a private temporary
directory, never a TCP port, so clusters started side by side (parallel
test workers) cannot collide.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def _rank_main(fn, rank: int, world: int, store: str, device: str,
               args, kwargs, results) -> None:
    from . import basics

    os.environ.update({
        "HVD_NUM_PROCS": str(world), "HVD_PROCESS_ID": str(rank),
        "HVD_COORDINATOR_ADDR": "file://" + store,
        "HVD_LOCAL_RANK": str(rank), "HVD_LOCAL_SIZE": str(world),
        "HVD_CROSS_RANK": "0", "HVD_CROSS_SIZE": "1",
    })
    try:
        basics.init(device=device)
        results.put((rank, True, fn(*args, **kwargs)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        basics.shutdown()


def run_cluster(fn: Callable, np: int = 2, device: str = "cuda",
                args: Sequence = (), kwargs: Optional[dict] = None,
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` once per rank in ``np`` spawned processes
    after ``init(device=device)`` in each; returns the per-rank results in
    rank order. ``fn`` and its results must pickle (``fn`` by import path).
    Raises the first rank failure with that rank's traceback, and
    ``TimeoutError`` past ``timeout`` seconds. Every process started is
    stopped before returning."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory(prefix="hvd_torch_cluster_") as td:
        store = os.path.join(td, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, np, store, device, tuple(args),
                                   dict(kwargs or {}), results))
                 for r in range(np)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < np:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(
                            f"rank(s) {dead} exited without a result "
                            f"(exit codes {[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"ranks {[r for r in range(np) if r not in got]} "
                            f"did not finish within {timeout:g}s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            results.close()
    return [got[r] for r in range(np)]


def numpy_adasum_pair(a, b):
    """The Adasum combine of two numpy vectors in float64 (the numpy oracle
    of the reference's tests, ``tests/tests_adasum_ref.py``, kept here so
    that the port needs nothing of the reference)."""
    import numpy

    dot = float(numpy.dot(a.ravel(), b.ravel()))
    na = float(numpy.dot(a.ravel(), a.ravel()))
    nb = float(numpy.dot(b.ravel(), b.ravel()))
    ac = 1.0 if na == 0 else 1.0 - dot / (2 * na)
    bc = 1.0 if nb == 0 else 1.0 - dot / (2 * nb)
    return ac * a + bc * b


def numpy_adasum(bufs):
    """Root of the pairwise tree over ``bufs`` (a power-of-2 count)."""
    while len(bufs) > 1:
        bufs = [numpy_adasum_pair(bufs[i], bufs[i + 1])
                for i in range(0, len(bufs), 2)]
    return bufs[0]


def adasum_dryrun_worker():
    """One rank of the Adasum check (BASELINE tracked config 5; the
    reference's ``testing.adasum_dryrun_worker``): an eager Adasum
    allreduce of 257 f32 values from ``RandomState(7 + rank)``, once plain
    and once through ``Compression.fp16``. Returns ``(rank, input,
    plain result, fp16 result)`` as lists."""
    import numpy
    import torch

    from . import basics
    from .ops import collective_ops as C
    from .ops.compression import Compression

    r = basics.rank()
    x = numpy.random.RandomState(7 + r).randn(257).astype(numpy.float32)
    t = torch.from_numpy(x).to(basics.device())
    plain = C.allreduce(t, name="adsm", op=basics.Adasum)
    comp = C.allreduce(t, name="adsm16", op=basics.Adasum,
                       compression=Compression.fp16)
    return (r, x.tolist(), plain.cpu().tolist(), comp.cpu().tolist())
