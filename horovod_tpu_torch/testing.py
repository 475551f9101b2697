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
