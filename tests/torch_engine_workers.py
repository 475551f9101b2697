"""Rank functions of ``tests/test_torch_async.py`` and
``tests/test_torch_engine.py``, run by ``horovod_tpu_torch.testing.
run_cluster`` in spawned gloo processes. The module imports neither jax nor
the reference, so that the ranks start fast."""

import os
import threading
import time

import numpy as np
import torch


def _error(fn):
    """The message of the ``HorovodInternalError`` that ``fn`` raises (its
    class name first), or None."""
    import horovod_tpu_torch as hvd

    try:
        fn()
    except hvd.HorovodInternalError as e:
        return f"{type(e).__name__}: {e}"
    return None


def matrix_inputs(rank: int) -> dict:
    """Seeded per-rank inputs of the op matrix."""
    rng = np.random.RandomState(10 + rank)
    return {"f32": rng.randn(5, 3).astype(np.float32),
            "f64": rng.randn(7),
            "i32": rng.randint(-50, 50, (4, 2)).astype(np.int32),
            "big": rng.randn(3000).astype(np.float32),
            "ag": np.full((rank + 1, 2), float(rank), np.float32)}


def matrix_worker() -> dict:
    """One rank of the async op matrix: every collective in its
    synchronous, async and in-place forms, ``poll``, the refused requests
    (duplicate name, mismatched shape, misordered names, ``join``), and
    the ranks going on after each."""
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)  # ranks beside other test workers
    r, w = hvd.rank(), hvd.size()
    x = {k: torch.from_numpy(v) for k, v in matrix_inputs(r).items()}
    out = {}
    for k in ("f32", "f64", "i32"):
        out[f"sum_{k}"] = hvd.allreduce(x[k], op=hvd.Sum, name=f"s{k}").numpy()
        out[f"avg_{k}"] = hvd.allreduce(x[k], name=f"a{k}").numpy()
    out["scaled"] = hvd.allreduce(x["f32"], op=hvd.Sum, prescale_factor=0.5,
                                  postscale_factor=3.0).numpy()
    out["int8"] = hvd.allreduce(x["big"], op=hvd.Sum,
                                compression=hvd.Compression.int8).numpy()
    # async: several in flight, drained in reverse; poll until done
    handles = [hvd.allreduce_async(x["f32"] * (i + 1), op=hvd.Sum,
                                   name=f"many.{i}") for i in range(4)]
    out["many"] = [hvd.synchronize(h).numpy() for h in reversed(handles)]
    h = hvd.allreduce_async(x["f64"], op=hvd.Sum, name="polled")
    while not hvd.poll(h):
        pass
    out["polled"] = hvd.synchronize(h).numpy()
    # in place
    t = x["f32"].clone()
    out["inplace_same"] = hvd.allreduce_(t, op=hvd.Sum) is t
    out["inplace"] = t.numpy()
    t = x["f64"].clone()
    h = hvd.allreduce_async_(t, name="inplace_async")
    out["inplace_async_same"] = hvd.synchronize(h) is t
    out["inplace_async"] = t.numpy()
    b = torch.full((3,), float(r + 7))
    out["bcast"] = hvd.broadcast(b, root_rank=w - 1).numpy()
    hb = hvd.broadcast_async_(b, 0, name="bc_")
    out["bcast_inplace"] = (hvd.synchronize(hb) is b, b.numpy())
    out["gather"] = hvd.allgather(x["ag"], name="ag").numpy()
    out["gather_async"] = hvd.synchronize(
        hvd.allgather_async(x["ag"] + 1)).numpy()
    eq = torch.cat([torch.full((2,), r * 10.0 + d) for d in range(w)])
    out["a2a"] = hvd.alltoall(eq, name="a2a").numpy()
    splits = [r + d + 1 for d in range(w)]
    rows = torch.tensor([[100.0 * r + d, 200.0 * r + d]
                         for d in range(w) for _ in range(splits[d])])
    got, rs = hvd.alltoall(rows, splits=splits, name="a2av")
    out["a2av"] = (got.numpy(), rs.tolist())
    zsplits = [3] * w if r == 0 else [0] * w
    zrows = (torch.arange(6.0 * w).reshape(3 * w, 2) if r == 0
             else torch.zeros(0, 2))
    got, rs = hvd.alltoall(zrows, splits=zsplits, name="a2av0")
    out["a2av0"] = (got.numpy(), rs.tolist())
    out["adasum"] = (_error(lambda: hvd.allreduce(x["f32"], op=hvd.Adasum,
                                                  name="ad"))
                     if w & (w - 1) else
                     hvd.allreduce(x["f32"], op=hvd.Adasum, name="ad").numpy())
    # Adasum requests that reach the engine in one tick on rank 0 (held in
    # a completion callback meanwhile) and in two on the others still pair
    # (each is negotiated and gathered alone)
    hold = threading.Event()
    hg = hvd.allreduce_async(torch.ones(1), name="hold",
                             callback=lambda ok, res: r or hold.wait(60))
    hs = []
    for i in range(2):
        if r and i:
            time.sleep(0.2)
        hs.append(hvd.allreduce_async(x["f32"] * (i + 1), op=hvd.Adasum,
                                      name=f"ticks.{i}"))
    hold.set()
    hvd.synchronize(hg)
    out["adasum_ticks"] = [
        _error(lambda h=h: hvd.synchronize(h)) if w & (w - 1)
        else hvd.synchronize(h).numpy() for h in hs]
    # refused requests, each followed by one that must go through
    out["shape"] = _error(lambda: hvd.allreduce(
        torch.ones((2, 3) if r == 0 else (3, 2)), name="mismatch"))
    out["splits_usage"] = _error(lambda: hvd.alltoall(
        torch.ones(2 * w, 2), name="a2av_mix",
        **({"splits": [2] * w} if r == 0 else {})))
    out["indivisible"] = _error(lambda: hvd.alltoall(
        torch.ones(2 * w + 1), name="a2a_odd"))

    def misordered():
        names = ["first", "second"] if r == 0 else ["second", "first"]
        hs = [hvd.allreduce_async(torch.ones(2), name=n) for n in names]
        return [_error(lambda h=h: hvd.synchronize(h)) for h in hs]

    out["misordered"] = misordered()
    out["after"] = hvd.allreduce(torch.ones(3) * (r + 1), op=hvd.Sum).numpy()
    try:
        hvd.join()
        out["join"] = None
    except NotImplementedError as e:
        out["join"] = str(e)
    # duplicate: the engine is held in a completion callback, so the first
    # request is surely still pending when the second arrives
    gate = threading.Event()
    hg = hvd.allreduce_async(torch.ones(1), name="gate",
                             callback=lambda ok, res: gate.wait(60))
    h1 = hvd.allreduce_async(torch.ones(2), op=hvd.Sum, name="dup")
    h2 = hvd.allreduce_async(torch.ones(2), op=hvd.Sum, name="dup")
    gate.set()
    hvd.synchronize(hg)
    out["dup"] = (hvd.synchronize(h1).numpy(),
                  _error(lambda: hvd.synchronize(h2)))
    # gradients through the engine: alltoall (its own adjoint) and ragged
    xe = eq.clone().requires_grad_()
    hvd.alltoall(xe).backward(torch.arange(2.0 * w))
    xr = rows.clone().requires_grad_()
    got, _ = hvd.alltoall(xr, splits=splits)
    got.backward(torch.ones_like(got) * (r + 1))
    out["a2a_grad"] = (xe.grad.numpy(), xr.grad.numpy())
    return out


def engine_grads(rank: int) -> dict:
    """Seeded per-rank gradients of the optimizer checks, named in the
    order of the parameters (sorted keys, as a reference pytree flattens
    them). Sizes straddle the bucket budget of ``BUCKET_MB``."""
    rng = np.random.RandomState(200 + rank)
    return {"a_embed": rng.randn(1500).astype(np.float32),
            "b_head": rng.randn(30, 40).astype(np.float32),
            "c_bias": rng.randn(17).astype(np.float32),
            "d_conv": rng.randn(8, 3, 3, 3).astype(np.float32),
            "e_proj": rng.randn(900).astype(np.float32)}


# 5242 bytes: buckets [e, d, c] (1133 f32, over the int8 wire's 1024-element
# floor that each of the three alone is under), [b], [a]
BUCKET_MB = "0.005"


def _params(rank):
    grads = engine_grads(rank)
    params = [(n, torch.nn.Parameter(torch.zeros(g.shape)))
              for n, g in sorted(grads.items())]
    return params, [torch.from_numpy(grads[n]) for n, _ in params]


def _reduced(hvd, compression, bucket_mb, op):
    """Each gradient after ``DistributedOptimizer.synchronize``, with the
    hooks firing during backward."""
    os.environ["HOROVOD_BUCKET_MB"] = bucket_mb
    params, grads = _params(hvd.rank())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in params], lr=0.1),
        named_parameters=params, compression=compression, op=op)
    sum((p * g).sum() for (_, p), g in zip(params, grads)).backward()
    pending = len(opt._handles)
    opt.synchronize()
    return [p.grad.numpy().copy() for _, p in params], pending


def _adasum_flow(hvd, bucket_mb):
    """Parameters after two Adasum steps of SGD(0.1, momentum 0.9)."""
    from horovod_tpu_torch.runtime.engine import Engine

    os.environ["HOROVOD_BUCKET_MB"] = bucket_mb
    params, grads = _params(hvd.rank())
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([p for _, p in params], lr=0.1, momentum=0.9),
        named_parameters=params, op=hvd.Adasum)
    eng: Engine = hvd.basics._engine()
    before = eng.responses_performed
    for k in range(2):
        opt.zero_grad()
        sum(((p * g) * (k + 1)).sum()
            for (_, p), g in zip(params, grads)).backward()
        opt.step()
    return ([p.detach().numpy().copy() for _, p in params],
            eng.responses_performed - before)


def optimizer_worker() -> dict:
    """One rank of the optimizer checks: buckets against the per-tensor
    path (exact and int8 wires, Average and Sum, Adasum), the hooks
    (``backward_passes_per_step``, ``zero_grad`` while handles are
    pending, unused parameters with buckets) and the parallel step's
    bucketed gradient mean."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel.sp_training import mean_gradients

    torch.set_num_threads(1)
    r = hvd.rank()
    out = {}
    try:
        for label, comp, op in (("avg", hvd.Compression.none, hvd.Average),
                                ("sum", hvd.Compression.none, hvd.Sum),
                                ("int8", hvd.Compression.int8, hvd.Average)):
            out[label] = {mb: _reduced(hvd, comp, mb, op)
                          for mb in ("", BUCKET_MB)}
        out["adasum"] = {mb: _adasum_flow(hvd, mb) for mb in ("", BUCKET_MB)}
        # backward_passes_per_step=2: nothing goes before the second pass
        os.environ["HOROVOD_BUCKET_MB"] = ""
        p = torch.nn.Parameter(torch.ones(3))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                       named_parameters=[("w", p)],
                                       backward_passes_per_step=2)
        pending = []
        for k in (1, 2):
            (p * float(k * (r + 1))).sum().backward()
            pending.append(len(opt._handles))
        try:
            opt.zero_grad()
            zero = None
        except AssertionError as e:
            zero = str(e)
        opt.step()
        out["bpps"] = (pending, zero, p.grad.numpy().copy(),
                       p.detach().numpy().copy())
        # unused parameters differ between the ranks, in one bucket
        os.environ["HOROVOD_BUCKET_MB"] = "1"
        a = torch.nn.Parameter(torch.zeros(4))
        b = torch.nn.Parameter(torch.zeros(4))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([a, b], lr=0.1),
                                       named_parameters=[("a", a), ("b", b)])
        ((a if r == 0 else b * 100.0)).sum().backward()
        opt.step()
        out["unused"] = (a.grad.numpy().copy(), b.grad.numpy().copy())
        # the parallel step's gradient mean, per tensor and bucketed
        group = hvd.basics.process_group(range(hvd.size()))
        means = {}
        for mb in ("", BUCKET_MB):
            os.environ["HOROVOD_BUCKET_MB"] = mb
            params, grads = _params(r)
            for (_, q), g in zip(params, grads):
                q.grad = g.clone()
            params[2][1].grad = None  # unused here: zeros
            mean_gradients([q for _, q in params], group)
            means[mb] = [q.grad.numpy().copy() for _, q in params]
        out["mean"] = means
    finally:
        os.environ.pop("HOROVOD_BUCKET_MB", None)
    return out


def cuda_adasum_worker() -> dict:
    """One rank of the card test: an Adasum allreduce through the engine,
    with the stream and thread of each grouped combine recorded."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck

    seen = []
    many = ck.adasum_combine_pairs_many

    def recorded(pairs):
        seen.append((torch.cuda.current_stream().cuda_stream,
                     threading.current_thread().name))
        return many(pairs)

    ck.adasum_combine_pairs_many = recorded
    try:
        x = torch.from_numpy(np.random.RandomState(5 + hvd.rank()).randn(
            4099).astype(np.float32)).cuda()
        ck.reset_launch_counts()
        y = hvd.allreduce(x, op=hvd.Adasum, name="k4")
        launches = ck.launch_counts()["adasum_combine_pairs"]
    finally:
        ck.adasum_combine_pairs_many = many
    return {"seen": seen, "launches": launches, "y": y.cpu().numpy(),
            "main_stream": torch.cuda.current_stream().cuda_stream,
            "engine_stream": hvd.basics._engine()._stream.cuda_stream}
