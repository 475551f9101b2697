"""Rank functions of ``tests/test_torch_algo_eager.py`` and
``tests/test_torch_sparse.py``, run by ``horovod_tpu_torch.testing.
run_cluster`` in spawned gloo processes, with the case table and seeded
inputs the tests also feed the reference. The module imports neither jax
nor the reference, so that the ranks start fast."""

import os

import numpy as np
import torch

N = 5000  # not a multiple of world * block: every program pads

# (label, HOROVOD_GSPMD_ALGO, compression, op, dtype, prescale, postscale, n)
# "adaptive:<mode>" primes the selector to decide <mode> for the case's
# name; "packed" runs the case under HOROVOD_PACKED_WIRE=1
CASES = [
    ("ring", "", "none", "Sum", "float32", 1.0, 1.0, N),
    ("ring_avg", "", "none", "Average", "float32", 1.0, 1.0, N),
    ("hier", "hier", "none", "Sum", "float32", 1.0, 1.0, N),
    ("hier_scaled", "hier", "none", "Average", "float32", 2.0, 0.5, N),
    ("hier_i32", "hier", "none", "Sum", "int32", 1.0, 1.0, N),
    ("hier_i32_avg", "hier", "none", "Average", "int32", 1.0, 1.0, N),
    ("hier_bf16", "hier", "none", "Sum", "bfloat16", 1.0, 1.0, N),
    ("hier_odd", "hier", "none", "Sum", "float32", 1.0, 1.0, 17),
    ("tree", "tree", "none", "Sum", "float32", 1.0, 1.0, N),
    ("tree_avg", "tree", "none", "Average", "float32", 0.5, 3.0, N),
    ("tree_i32", "tree", "none", "Sum", "int32", 1.0, 1.0, N),
    ("bf16", "", "adaptive:bf16", "Sum", "float32", 1.0, 1.0, N),
    ("bf16_avg", "", "adaptive:bf16", "Average", "float32", 2.0, 3.0, N),
    ("dcn", "", "int8_dcn", "Sum", "float32", 1.0, 1.0, N),
    ("dcn_avg", "", "int8_dcn", "Average", "float32", 2.0, 0.5, N),
    ("dcn_packed", "", "int8_dcn packed", "Average", "float32", 1.0, 1.0,
     N),
    ("dcn_small", "", "int8_dcn", "Sum", "float32", 1.0, 1.0, 100),
    ("dcn_i32", "", "int8_dcn", "Sum", "int32", 1.0, 1.0, N),
    ("adaptive_int4", "", "adaptive:int4", "Average", "float32", 1.0, 1.0,
     N),
    ("adaptive_int8", "", "adaptive:int8", "Average", "float32", 1.0, 1.0,
     N),
]


def case_input(i: int, rank: int) -> np.ndarray:
    """Case ``i``'s contribution of ``rank``: f32 from N(0, 1), scaled by
    the case, or small integers; a bf16 case rounds the f32 to bf16."""
    _, _, _, _, dtype, _, _, n = CASES[i]
    rng = np.random.RandomState(1000 + 10 * i + rank)
    if dtype == "int32":
        return rng.randint(-100, 100, n).astype(np.int32)
    return (rng.randn(n) * (i + 1)).astype(np.float32)


def priming_sample(mode: str):
    """``(sample, HOROVOD_ADAPTIVE_TOL)`` under which one observation with
    ``HOROVOD_ADAPTIVE_INTERVAL=1`` decides ``mode``: Gaussian rows go
    int4 at the default tolerance, cubed Gaussian ones int8, and any row
    bf16 at a tolerance under int8's residual."""
    g = np.random.RandomState(7).randn(4096).astype(np.float32)
    if mode == "int4":
        return g, "0.2"
    if mode == "int8":
        return g ** 3, "0.2"
    return g, "0.001"


def prime_selector(compressor, name: str, mode: str) -> None:
    """Feed ``compressor``'s selector one observation that decides
    ``mode`` for ``name`` (the environment is restored after)."""
    sample, tol = priming_sample(mode)
    saved = {k: os.environ.get(k) for k in ("HOROVOD_ADAPTIVE_INTERVAL",
                                             "HOROVOD_ADAPTIVE_TOL")}
    os.environ.update(HOROVOD_ADAPTIVE_INTERVAL="1",
                      HOROVOD_ADAPTIVE_TOL=tol)
    try:
        compressor.observe(name, sample)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert compressor.selector().decide(name) == mode, (name, mode)


def _compressor(hvd, spec: str):
    name = spec.split()[0]
    if name.startswith("adaptive:"):
        return hvd.Compression.adaptive
    return getattr(hvd.Compression, name)


def case_worker() -> dict:
    """One rank of the 4-rank (2 hosts x 2) cluster: every case of
    :data:`CASES` with its wire mode, bytes and algorithm; the grouping the
    engine made; an adaptive race and an adaptive / static mix."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import adaptive
    from horovod_tpu_torch.runtime.executor import group_ranks

    torch.set_num_threads(1)  # ranks beside other test workers
    r = hvd.rank()
    ex = basics._executor()
    hvd.Compression.adaptive.reset()
    adaptive.reset()
    out = {"cases": {}}
    for i, (label, algo, comp, op, dtype, pre, post, _) in enumerate(CASES):
        if comp.startswith("adaptive:"):
            prime_selector(hvd.Compression.adaptive, label,
                           comp.split(":")[1])
        os.environ["HOROVOD_GSPMD_ALGO"] = algo
        os.environ["HOROVOD_PACKED_WIRE"] = "1" if "packed" in comp else ""
        x = torch.from_numpy(case_input(i, r))
        if dtype == "bfloat16":
            x = x.bfloat16()
        y = hvd.allreduce(x, op=getattr(hvd, op), name=label,
                          compression=_compressor(hvd, comp),
                          prescale_factor=pre, postscale_factor=post)
        y = y.view(torch.int16) if dtype == "bfloat16" else y
        out["cases"][label] = (y.numpy(), ex.last_wire_mode,
                               ex.last_wire_bytes, ex.last_algorithm)
    os.environ["HOROVOD_GSPMD_ALGO"] = ""
    os.environ["HOROVOD_PACKED_WIRE"] = ""
    two = ex._two_level
    out["mesh"] = (two.shape, two.ranks, group_ranks(two.host_group),
                   group_ranks(two.cross_group))

    class Int4Race(hvd.Compression.none):
        wire = "adaptive:int4"

    class Int8Race(hvd.Compression.none):
        wire = "adaptive:int8"

    x = torch.from_numpy(case_input(0, r))
    y = hvd.allreduce(x, op=hvd.Sum, name="race",
                      compression=Int4Race if r == 0 else Int8Race)
    out["race"] = (y.numpy(), ex.last_wire_mode, ex.last_wire_bytes)
    try:
        hvd.allreduce(x, op=hvd.Sum, name="mixed",
                      compression=(Int8Race if r == 0
                                   else hvd.Compression.int8))
        out["mixed"] = None
    except hvd.HorovodInternalError as e:
        out["mixed"] = str(e)
    return out


def knob_worker() -> dict:
    """One rank of a 4-rank cluster started with
    ``HOROVOD_HIERARCHICAL_ALLREDUCE=1`` and ``_ALLGATHER=1``: an allreduce
    (the two-level program even under ``HOROVOD_GSPMD_ALGO=tree``), an
    integer average and a ragged allgather."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics

    torch.set_num_threads(1)
    r = hvd.rank()
    ex = basics._executor()
    os.environ["HOROVOD_GSPMD_ALGO"] = "tree"
    out = {}
    y = hvd.allreduce(torch.from_numpy(case_input(0, r)), op=hvd.Sum,
                      name="k0")
    out["sum"] = (y.numpy(), ex.last_wire_mode, ex.last_wire_bytes,
                  ex.last_algorithm)
    y = hvd.allreduce(torch.from_numpy(case_input(4, r)), op=hvd.Average,
                      name="k1")
    out["int_avg"] = (y.numpy(), ex.last_algorithm)
    rows = torch.full((r + 1, 3), float(r)) + torch.arange(3.0)
    out["gather"] = hvd.allgather(rows, name="kg").numpy()
    return out


class _AdaptiveNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.w1 = torch.nn.Parameter(torch.randn(64, 48, generator=gen) * .1)
        self.w2 = torch.nn.Parameter(torch.randn(48, 8, generator=gen) * .1)

    def forward(self, x):
        return torch.tanh(x @ self.w1) @ self.w2


def adaptive_optimizer_worker(steps: int) -> dict:
    """One rank of a 2-rank run of ``DistributedOptimizer(Compression.
    adaptive, error_feedback=True)`` with ``HOROVOD_ADAPTIVE_INTERVAL=1``:
    each step's wire mode (of the last allreduce) and the selector's
    decisions, and the final parameters."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import adaptive

    torch.set_num_threads(1)
    os.environ["HOROVOD_ADAPTIVE_INTERVAL"] = "1"
    hvd.Compression.adaptive.reset()
    adaptive.reset()
    r = hvd.rank()
    net = _AdaptiveNet()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.1),
        named_parameters=net.named_parameters(),
        compression=hvd.Compression.adaptive, error_feedback=True)
    ex = basics._executor()
    modes, decisions = [], []
    for step in range(steps):
        rng = np.random.RandomState(100 * step + r)
        x = torch.from_numpy(rng.randn(32, 64).astype(np.float32))
        y = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
        opt.zero_grad()
        torch.nn.functional.mse_loss(net(x), y).backward()
        opt.step()
        modes.append(ex.last_wire_mode)
        decisions.append(hvd.Compression.adaptive.selector().decisions())
    return {"modes": modes, "decisions": decisions,
            "record": adaptive.bitwidth_decisions(),
            "params": [p.detach().numpy().copy() for p in net.parameters()]}


SPARSE_DTYPES = ("float32", "float64", "int32")


def sparse_worker() -> dict:
    """One rank of the 2-rank sparse run: ragged Sum of each dtype, an
    Average, a sum with duplicate indices against the dense allreduce,
    Adasum refused; ``DistributedOptimizer`` with a sparse embedding
    gradient (mixed with a dense one, densified before or after the wire),
    and refused under accumulation."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import sparse as sp

    torch.set_num_threads(1)
    r = hvd.rank()
    out = {}
    for dt in SPARSE_DTYPES:
        k = r + 1  # ragged: rank 0 one row, rank 1 two
        s = sp.IndexedSlices(torch.full((k, 3), r + 1,
                                        dtype=getattr(torch, dt)),
                             torch.arange(k) + 2 * r, (4, 3))
        res = sp.allreduce_sparse(s, name=f"sum_{dt}", op=hvd.Sum)
        out[f"sum_{dt}"] = (res.values.numpy(), res.indices.numpy(),
                            res.dense_shape)
    res = sp.allreduce_sparse(sp.IndexedSlices(
        torch.full((2, 2), 4.0), torch.tensor([0, 1]), (2, 2)), name="avg")
    out["avg"] = res.values.numpy()
    idx = torch.tensor([1, 3]) if r == 0 else torch.tensor([3, 4])
    vals = torch.full((2, 2), float(r + 1))
    dense = torch.zeros(5, 2).index_add_(0, idx, vals)
    got = sp.to_dense(sp.allreduce_sparse(
        sp.IndexedSlices(vals, idx, (5, 2)), name="vs_dense", op=hvd.Sum))
    out["vs_dense"] = (got.numpy(),
                       hvd.allreduce(dense, op=hvd.Sum,
                                     name="dense_ref").numpy())
    try:
        sp.allreduce_sparse(sp.IndexedSlices(torch.ones(1, 2),
                                             torch.tensor([0]), (2, 2)),
                            name="adasum", op=hvd.Adasum)
        out["adasum"] = None
    except NotImplementedError as e:
        out["adasum"] = str(e)

    def embedding_step(sparse_as_dense, k=1, op=hvd.Sum):
        emb = torch.nn.Embedding(3, 2, sparse=True)
        w = torch.nn.Parameter(torch.zeros(2))
        with torch.no_grad():
            emb.weight.zero_()
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(list(emb.parameters()) + [w], lr=1.0),
            named_parameters=[("e", emb.weight), ("w", w)], op=op,
            sparse_as_dense=sparse_as_dense, backward_passes_per_step=k)
        opt.zero_grad()
        loss = (emb(torch.tensor([r])).sum() * (r + 1) / 2
                + (w * float(r)).sum())
        loss.backward()
        sparse_grad = emb.weight.grad.is_sparse
        opt.step()
        return (emb.weight.detach().numpy().copy(), w.detach().numpy(),
                sparse_grad, emb.weight.grad.is_sparse)

    out["opt"] = embedding_step(False)
    out["opt_dense"] = embedding_step(True)
    out["opt_avg"] = embedding_step(False, op=hvd.Average)
    try:
        embedding_step(False, k=2)
        out["accumulate"] = None
    except NotImplementedError as e:
        out["accumulate"] = str(e)
    return out
