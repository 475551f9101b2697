"""The port's controller, gradient buckets and optimizer hooks against the
reference.

* The controller: the same submits go to the reference's ``PyController``
  and the port's; their responses agree (names, fusion grouping,
  ``fusable=False`` kept apart, readiness), and so do their duplicate,
  mismatch and stall reports (the port's messages start with the
  reference's text and add each rank's value).
* Buckets: ``partition_buckets`` and the ``HOROVOD_BUCKET_MB`` parse equal
  the reference's on the cases of ``tests/test_overlap.py``; on two gloo
  processes the bucketed optimizer, the Adasum delta flow and the parallel
  step's gradient mean are bit-identical to the per-tensor path on the
  exact wire, and an int8 bucket equals the reference's
  ``allreduce_gradients`` with ``HOROVOD_BUCKET_MB`` set, bit for bit.
* Hooks: ``backward_passes_per_step=2`` accumulates before anything is
  enqueued, ``zero_grad`` raises while handles are pending, and ranks with
  different unused parameters in one bucket still agree.

The port's ranks run ``torch_engine_workers.optimizer_worker`` once, in
one cluster the module's tests share.
"""

import numpy as np
import pytest
import torch

import horovod_tpu as ref_hvd
from horovod_tpu import testing as ref_testing
from horovod_tpu.optim import distributed as ref_dist
from horovod_tpu.runtime import messages as ref_messages
from horovod_tpu.runtime import pycontroller as ref_pycontroller
from horovod_tpu_torch import testing
from horovod_tpu_torch.optim import distributed as port_dist
from horovod_tpu_torch.runtime import messages, pycontroller
from torch_engine_workers import BUCKET_MB, engine_grads, optimizer_worker

# ------------------------------------------------------------ controller


def _controllers(world=1, **kw):
    args = dict(world=world, fusion_threshold=kw.pop("threshold", 1 << 20),
                stall_warning_s=kw.pop("stall", 60.0), stall_shutdown_s=0.0,
                fusion_enabled=kw.pop("fusion", True), timeline_path=None,
                cycle_time_ms=1.0)
    return (ref_pycontroller.PyController(cache_capacity=0, autotune=False,
                                          **args),
            pycontroller.PyController(**args))


def _submit(ctrls, name, array, rank=0, kind="ALLREDUCE", **kw):
    """Submit one request to both controllers: a numpy array to the
    reference's, the same values as a torch tensor to the port's."""
    array = np.asarray(array)
    got = []
    for mod, arr, ctrl in ((ref_messages, array, ctrls[0]),
                           (messages, torch.from_numpy(array), ctrls[1])):
        got.append(ctrl.submit(mod.TensorTableEntry(
            tensor_name=name, rank=rank,
            request_type=getattr(mod.RequestType, kind), array=arr, **kw)))
    return got


def _summary(tick):
    if tick is None:
        return None
    responses, pairs, _, _, warnings, shutdown = tick
    return ([(r.response_type.name, list(r.tensor_names), r.average,
              r.prescale, r.postscale, r.root_rank, r.compression)
             for r in responses],
            [[rank for rank, _ in p] for p in pairs], warnings, shutdown,
            [r.error_message for r in responses])


def _ticks(ctrls):
    ref, port = (_summary(c.tick()) for c in ctrls)
    if ref is None or port is None:
        assert ref is port
        return ref
    assert ref[:4] == port[:4]
    for want, got in zip(ref[4], port[4]):
        assert got.startswith(want), (got, want)
    return port


def test_controller_fusion_grouping_matches_reference():
    """Same-signature requests fuse up to the threshold; another dtype,
    op, scale or wire starts its own response; client-built buckets
    (``fusable=False``) never merge; with fusion off every request is its
    own response."""
    for fusion in (True, False):
        ctrls = _controllers(threshold=100, fusion=fusion)
        f32 = np.zeros(8, np.float32)  # 32 bytes
        for name, arr, kw in (
                ("a", f32, {}), ("b", f32, {}), ("c", f32, {}),
                ("d", f32, {}),  # over the 100-byte threshold: new bucket
                ("e", np.zeros(8, np.float64), {}),
                ("f", f32, {"average": True}),
                ("g", f32, {"compression": "int8"}),
                ("bucket.0", f32, {"fusable": False}),
                ("bucket.1", f32, {"fusable": False}),
                ("h", f32, {"prescale_factor": 2.0})):
            assert min(_submit(ctrls, name, arr, **kw)) >= 0
        tick = _ticks(ctrls)
        names = [n for _, n, *_ in tick[0]]
        if fusion:
            assert names == [["a", "b", "c"], ["d"], ["e"], ["f"], ["g"],
                             ["bucket.0"], ["bucket.1"], ["h"]]
        else:
            assert all(len(n) == 1 for n in names)
        assert _ticks(ctrls) is None


def test_controller_readiness_and_duplicates_match_reference():
    """At world 2 in one process a name is ready once both ranks submit;
    a rank that submits a pending name again is refused."""
    ctrls = _controllers(world=2)
    x = np.ones(4, np.float32)
    assert _submit(ctrls, "x", x, rank=0) == [0, 0]
    assert _ticks(ctrls) is None
    dup = _submit(ctrls, "x", x, rank=0)
    assert dup == [ctrls[0].SUBMIT_DUPLICATE, ctrls[1].SUBMIT_DUPLICATE]
    _submit(ctrls, "x", x, rank=1)
    tick = _ticks(ctrls)
    assert tick[0][0][1] == ["x"] and tick[1] == [[0, 1]]


MISMATCHES = {
    "shape": [({}, np.ones((2, 3), np.float32)),
              ({}, np.ones((3, 2), np.float32))],
    "dtype": [({}, np.ones(2, np.float32)), ({}, np.ones(2, np.float64))],
    "op": [({"average": True}, np.ones(2, np.float32)),
           ({}, np.ones(2, np.float32))],
    "wire": [({"compression": "int8"}, np.ones(2, np.float32)),
             ({}, np.ones(2, np.float32))],
    "kind": [({}, np.ones(2, np.float32)),
             ({"kind": "BROADCAST", "root_rank": 0}, np.ones(2, np.float32))],
    "root": [({"kind": "BROADCAST", "root_rank": 0}, np.ones(2, np.float32)),
             ({"kind": "BROADCAST", "root_rank": 1}, np.ones(2, np.float32))],
    "bad_root": [({"kind": "BROADCAST", "root_rank": 5}, np.ones(2)),
                 ({"kind": "BROADCAST", "root_rank": 5}, np.ones(2))],
    "tail": [({"kind": "ALLGATHER"}, np.ones((2, 3), np.float32)),
             ({"kind": "ALLGATHER"}, np.ones((1, 4), np.float32))],
    "scalar_gather": [({"kind": "ALLGATHER"}, np.float32(1.0)),
                      ({"kind": "ALLGATHER"}, np.float32(1.0))],
    "a2a_indivisible": [({"kind": "ALLTOALL"}, np.ones(3, np.float32)),
                        ({"kind": "ALLTOALL"}, np.ones(3, np.float32))],
    "a2a_usage": [({"kind": "ALLTOALL", "splits": (1, 1)},
                   np.ones(2, np.float32)),
                  ({"kind": "ALLTOALL"}, np.ones(2, np.float32))],
    "a2a_sum": [({"kind": "ALLTOALL", "splits": (1, 2)},
                 np.ones((2, 2), np.float32)),
                ({"kind": "ALLTOALL", "splits": (1, 1)},
                 np.ones((2, 2), np.float32))],
}


@pytest.mark.parametrize("case", sorted(MISMATCHES))
def test_controller_errors_match_reference(case):
    """Each refused request at world 2 gives one ERROR response whose text
    starts with the reference's."""
    ctrls = _controllers(world=2)
    for rank, (kw, arr) in enumerate(MISMATCHES[case]):
        kw = dict(kw)
        kind = kw.pop("kind", "ALLREDUCE")
        _submit(ctrls, "t", arr, rank=rank, kind=kind, **kw)
    tick = _ticks(ctrls)
    (resp,) = tick[0]
    assert resp[0] == "ERROR" and tick[4][0]


def test_adasum_world_and_stall_warning_match_reference():
    """Adasum at world 3 is refused; a request that waits past the stall
    threshold is reported once, naming the ranks it waits on."""
    ctrls = _controllers(world=3)
    for rank in range(3):
        _submit(ctrls, "ad", np.ones(2, np.float32), rank=rank, kind="ADASUM")
    assert _ticks(ctrls)[4] == [
        "Adasum requires a power-of-2 number of ranks; got 3."]
    ctrls = _controllers(world=2, stall=0.0)
    _submit(ctrls, "late", np.ones(2, np.float32), rank=0)
    tick = _ticks(ctrls)
    assert tick[2] == ["late (waiting on ranks [1] for 0s)"]
    assert _ticks(ctrls) is None  # reported once


# --------------------------------------------------------------- buckets
@pytest.mark.parametrize("sizes,dtypes,budget", [
    ([4, 4, 4, 4], ["f"] * 4, 8), ([4, 4, 4], ["f", "f", "i"], 100),
    ([4, 1000, 4], ["f"] * 3, 8), ([], [], 8),
    ([40, 4, 12, 4, 4], ["f", "f", "f", "h", "h"], 16)])
def test_partition_buckets_matches_reference(sizes, dtypes, budget):
    assert port_dist.partition_buckets(sizes, dtypes, budget) == \
        ref_dist.partition_buckets(sizes, dtypes, budget)


@pytest.mark.parametrize("value", ["", "0", "4", "0.5", "lots"])
def test_bucket_knob_matches_reference(value, monkeypatch):
    monkeypatch.setenv("HOROVOD_BUCKET_MB", value)
    try:
        want = ref_dist._bucket_bytes()
    except ValueError:
        with pytest.raises(ValueError, match="HOROVOD_BUCKET_MB"):
            port_dist._bucket_bytes()
        return
    assert port_dist._bucket_bytes() == want


@pytest.fixture(scope="module")
def port():
    return testing.run_cluster(optimizer_worker, np=2, device="cpu",
                               timeout=300)


def _mean(op="avg"):
    gs = [engine_grads(r) for r in range(2)]
    total = {k: gs[0][k] + gs[1][k] for k in gs[0]}
    return [total[k] / 2 if op == "avg" else total[k] for k in sorted(total)]


@pytest.mark.parametrize("op", ["avg", "sum"])
def test_buckets_keep_the_bits_of_the_per_tensor_path(port, op):
    """Exact wire: bucketed and per-tensor gradients are bit-identical, and
    equal the numpy mean; the hooks enqueued every unit during backward
    (one per tensor, or one per bucket: fewer)."""
    for r in port:
        per, n_per = r[op][""]
        buck, n_buck = r[op][BUCKET_MB]
        assert n_per == 5 and 1 < n_buck < 5
        for a, b, want in zip(per, buck, _mean(op)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, want)


@pytest.fixture(scope="module")
def reference_int8():
    """The reference's ``allreduce_gradients`` on the int8 wire, with and
    without buckets, on its thread-rank cluster, with fusion off
    (``HOROVOD_FUSION_THRESHOLD=0``): its thread ranks may otherwise fuse
    the per-leaf requests of one tick, and a fused buffer crosses the
    wire's 1024-element floor where a leaf alone does not."""
    def fn():
        g = engine_grads(ref_hvd.rank())
        out = ref_dist.allreduce_gradients(
            g, op=ref_hvd.Average, compression=ref_hvd.Compression.int8)
        return [np.asarray(out[k]) for k in sorted(out)]

    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOROVOD_FUSION_THRESHOLD", "0")
        ref_hvd.shutdown()
        for mb in ("", BUCKET_MB):
            mp.setenv("HOROVOD_BUCKET_MB", mb)
            res[mb] = ref_testing.run_cluster(fn, np=2)
        ref_hvd.shutdown()
    return res


def test_int8_buckets_match_the_reference(port, reference_int8):
    """The quantized wire over a bucket's flat concat (blocks span leaves)
    equals the reference's bucketed int8 allreduce bit for bit, and per
    tensor its per-leaf one; the two differ from each other."""
    for rank, r in enumerate(port):
        for mb in ("", BUCKET_MB):
            got, _ = r["int8"][mb]
            for a, b in zip(got, reference_int8[mb][rank]):
                np.testing.assert_array_equal(a, b)
    per, buck = (port[0]["int8"][mb][0] for mb in ("", BUCKET_MB))
    assert any(not np.array_equal(a, b) for a, b in zip(per, buck))


def test_adasum_buckets_keep_the_bits(port):
    """The delta flow with buckets (one gather a bucket, each member
    combined with its own coefficients) gives the per-tensor parameters bit
    for bit, on both ranks, in fewer responses (two steps)."""
    (p0, n_per), (b0, n_buck) = (port[0]["adasum"][mb]
                                 for mb in ("", BUCKET_MB))
    assert n_per == 10 and 2 < n_buck < 10
    for r in port:
        for mb in ("", BUCKET_MB):
            for a, b in zip(r["adasum"][mb][0], p0):
                np.testing.assert_array_equal(a, b)
    assert all(p.any() for p in p0)


def test_parallel_gradient_mean_buckets_keep_the_bits(port):
    """The parallel step's gradient mean: one all-reduce a bucket equals
    one a tensor, with zeros for the parameter left unused."""
    for r in port:
        per, buck = r["mean"][""], r["mean"][BUCKET_MB]
        for i, (a, b) in enumerate(zip(per, buck)):
            np.testing.assert_array_equal(a, b)
        want = _mean()
        want[2] = np.zeros_like(want[2])
        for a, w in zip(per, want):
            np.testing.assert_array_equal(a, w)


def test_backward_passes_per_step_and_zero_grad(port):
    """Two backward passes accumulate before the hook enqueues (nothing
    pending after the first), ``zero_grad`` raises the reference's
    AssertionError while the handle is pending, and the raw accumulated
    sum is averaged over the ranks (not divided by the pass count)."""
    for r in port:
        pending, zero, grad, param = r["bpps"]
        assert pending == [0, 1]
        assert zero == ("optimizer.zero_grad() was called after "
                        "loss.backward() but before optimizer.step() or "
                        "optimizer.synchronize()")
        # rank q's two passes sum to 3 (q + 1); the mean over 2 ranks is 4.5
        np.testing.assert_array_equal(grad, np.full(3, 4.5, np.float32))
        np.testing.assert_allclose(param, np.full(3, 1.0 - 0.45), rtol=1e-6)


def test_unused_parameters_agree_inside_a_bucket(port):
    """F1 with buckets: rank 0 uses only a, rank 1 only b (x100); both sit
    in one bucket, whose missing member goes as zeros."""
    for r in port:
        a, b = r["unused"]
        np.testing.assert_array_equal(a, np.full(4, 0.5, np.float32))
        np.testing.assert_array_equal(b, np.full(4, 50.0, np.float32))


def test_reference_torch_hook_accumulates_as_the_port_does():
    """The reference's torch front end, two passes at
    ``backward_passes_per_step=2`` on its thread ranks: the same averaged
    accumulated gradient as the port's (4.5)."""
    import horovod_tpu.torch as ref_torch

    def fn():
        p = torch.nn.Parameter(torch.ones(3))
        opt = ref_torch.DistributedOptimizer(
            torch.optim.SGD([p], lr=0.1), named_parameters=[("w", p)],
            backward_passes_per_step=2)
        for k in (1, 2):
            (p * float(k * (ref_torch.rank() + 1))).sum().backward()
        opt.synchronize()
        return p.grad.numpy().copy()

    for g in ref_testing.run_cluster(fn, np=2):
        np.testing.assert_array_equal(g, np.full(3, 4.5, np.float32))
