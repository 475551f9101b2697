"""The port's eager collectives through its engine, against numpy and the
reference: the op matrix of ``tests/test_collectives.py`` and
``tests/test_allreduce.py`` (sync, async and in-place forms, ``poll``,
ragged allgather and alltoall, duplicate names, mismatches, ``join``) on
2 and 3 gloo processes, each world one cluster that the module's tests
share; and the async API at world 1 in this process (fused responses,
the timeline).

Sums are exact at world 2 and for integers; at world 3 gloo may add in
another order than numpy, so floats hold to 1e-6 (f32) and 1e-13 (f64)
relative; int8 within its quantization bound.
"""

import json
import os

import numpy as np
import pytest
import torch

import horovod_tpu as ref_hvd
from horovod_tpu import testing as ref_testing
from horovod_tpu_torch import testing
from torch_engine_workers import matrix_inputs, matrix_worker


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def cluster(request):
    w = request.param
    return w, testing.run_cluster(matrix_worker, np=w, device="cpu",
                                  timeout=300)


def _inputs(w):
    return [matrix_inputs(r) for r in range(w)]


def _same_sum(got, want, w):
    """``got`` equals the numpy sum ``want`` (see the module's note)."""
    want = np.asarray(want)
    if w == 2 or want.dtype.kind == "i":
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 1e-6 if want.dtype == np.float32 else 1e-13
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "f64", "i32"])
def test_sum_and_average(cluster, dtype):
    w, ranks = cluster
    xs = [x[dtype] for x in _inputs(w)]
    total = xs[0].copy()
    for x in xs[1:]:
        total = total + x
    avg = total // w if dtype == "i32" else total / w
    for r in ranks:
        _same_sum(r[f"sum_{dtype}"], total, w)
        _same_sum(r[f"avg_{dtype}"], avg.astype(total.dtype), w)


def test_scale_factors_and_int8(cluster):
    w, ranks = cluster
    xs = _inputs(w)
    want = sum(x["f32"] * np.float32(0.5) for x in xs) * np.float32(3.0)
    exact = sum(x["big"] for x in xs)
    for r in ranks:
        np.testing.assert_allclose(r["scaled"], want, rtol=1e-6)
        err = np.abs(r["int8"] - exact).max() / np.abs(exact).max()
        assert 0 < err < 1.5e-2
        np.testing.assert_array_equal(r["int8"], ranks[0]["int8"])


def test_async_handles_and_poll(cluster):
    """Four requests in flight, drained in reverse; a polled one."""
    w, ranks = cluster
    xs = _inputs(w)
    f32 = sum(x["f32"] for x in xs)
    for r in ranks:
        for i, got in enumerate(reversed(r["many"])):
            np.testing.assert_allclose(got, f32 * (i + 1), rtol=1e-6)
        _same_sum(r["polled"], sum(x["f64"] for x in xs), w)


def test_inplace_forms(cluster):
    w, ranks = cluster
    xs = _inputs(w)
    for r in ranks:
        assert r["inplace_same"] and r["inplace_async_same"]
        _same_sum(r["inplace"], sum(x["f32"] for x in xs), w)
        _same_sum(r["inplace_async"], sum(x["f64"] for x in xs) / w, w)
        same, b = r["bcast_inplace"]
        assert same
        np.testing.assert_array_equal(b, np.full(3, 7.0))
        np.testing.assert_array_equal(r["bcast"], np.full(3, w + 6.0))


def test_allgather_ragged(cluster):
    w, ranks = cluster
    want = np.concatenate([x["ag"] for x in _inputs(w)])
    for r in ranks:
        np.testing.assert_array_equal(r["gather"], want)
        np.testing.assert_array_equal(r["gather_async"], want + 1)


def test_alltoall_equal_and_ragged(cluster):
    """Against numpy, as ``tests/test_collectives.py`` checks the
    reference (equal split, uneven rank-dependent splits, zero rows)."""
    w, ranks = cluster
    for me, r in enumerate(ranks):
        np.testing.assert_array_equal(r["a2a"], np.concatenate(
            [np.full(2, src * 10.0 + me) for src in range(w)]))
        got, rs = r["a2av"]
        want = [[100.0 * src + me, 200.0 * src + me]
                for src in range(w) for _ in range(src + me + 1)]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
        assert rs == [src + me + 1 for src in range(w)]
        got, rs = r["a2av0"]
        np.testing.assert_array_equal(
            got, np.arange(6.0 * w, dtype=np.float32).reshape(3 * w, 2)
            [3 * me:3 * (me + 1)])
        assert rs == [3] + [0] * (w - 1)


def test_alltoall_gradients(cluster):
    """The equal exchange's gradient is the exchange of the incoming
    gradient; the ragged one routes each row's gradient back to its
    sender."""
    w, ranks = cluster
    for me, r in enumerate(ranks):
        eq, ragged = r["a2a_grad"]
        # rank src's block me of the incoming gradient arange(2w) comes back
        np.testing.assert_array_equal(eq, np.concatenate(
            [np.arange(2.0 * w)[2 * me:2 * me + 2] for _ in range(w)]))
        # row sent to rank d carries d + 1
        splits = [me + d + 1 for d in range(w)]
        np.testing.assert_array_equal(ragged, np.concatenate(
            [np.full((s, 2), d + 1.0) for d, s in enumerate(splits)]))


def test_adasum_world_rules(cluster):
    """Adasum combines at world 2 (the numpy oracle) and is refused at
    world 3 with the reference's message on every rank."""
    w, ranks = cluster
    if w & (w - 1):
        assert {r["adasum"] for r in ranks} == {
            "HorovodInternalError: Adasum requires a power-of-2 number of "
            "ranks; got 3."}
        return
    want = testing.numpy_adasum([x["f32"].astype(np.float64).ravel()
                                 for x in _inputs(w)])
    for r in ranks:
        np.testing.assert_allclose(r["adasum"].ravel(), want, rtol=1e-5)


def test_adasum_requests_in_different_ticks_still_pair(cluster):
    """Two Adasum requests that rank 0 enqueues back to back and the others
    0.2 s apart: the ranks' engines tick them differently, and each is
    still negotiated and gathered on its own, in the same order on every
    rank (the numpy oracle at world 2; world 3 refuses both)."""
    w, ranks = cluster
    if w & (w - 1):
        for r in ranks:
            assert r["adasum_ticks"] == [
                "HorovodInternalError: Adasum requires a power-of-2 number "
                "of ranks; got 3."] * 2
        return
    for i in range(2):
        want = testing.numpy_adasum([x["f32"].astype(np.float64).ravel()
                                     * (i + 1) for x in _inputs(w)])
        for r in ranks:
            np.testing.assert_allclose(r["adasum_ticks"][i].ravel(), want,
                                       rtol=1e-5)


@pytest.fixture(scope="module")
def reference_errors():
    """The reference's messages for the same refused requests, on its
    thread-rank cluster with its Python controller (``HVD_TPU_NATIVE=0``;
    the native core words one of them differently)."""
    def fn():
        r = ref_hvd.rank()
        out = {}
        for key, call in (
                ("shape", lambda: ref_hvd.allreduce(
                    np.ones((2, 3) if r == 0 else (3, 2), np.float32),
                    name="mismatch")),
                ("splits_usage", lambda: ref_hvd.alltoall(
                    np.ones((4, 2), np.float32), name="a2av_mix",
                    **({"splits": [2, 2]} if r == 0 else {}))),
                ("indivisible", lambda: ref_hvd.alltoall(
                    np.ones(5, np.float32), name="a2a_odd"))):
            try:
                call()
                out[key] = None
            except ref_hvd.HorovodInternalError as e:
                out[key] = str(e)
        return out

    saved = os.environ.get("HVD_TPU_NATIVE")
    os.environ["HVD_TPU_NATIVE"] = "0"
    ref_hvd.shutdown()
    try:
        return ref_testing.run_cluster(fn, np=2)
    finally:
        ref_hvd.shutdown()
        if saved is None:
            del os.environ["HVD_TPU_NATIVE"]
        else:
            os.environ["HVD_TPU_NATIVE"] = saved


@pytest.mark.parametrize("key", ["shape", "splits_usage", "indivisible"])
def test_refused_requests_raise_the_reference_message(cluster,
                                                      reference_errors, key):
    """The same message on every rank, the reference's text first (the
    port appends each rank's value of the field that differs)."""
    w, ranks = cluster
    got = {r[key] for r in ranks}
    assert len(got) == 1
    msg = got.pop()
    assert msg.startswith("HorovodInternalError: ")
    want = reference_errors[0][key]
    if key == "indivisible":
        want = want.replace("(5)", f"({2 * w + 1})").replace(
            "size 2", f"size {w}")
    assert msg[len("HorovodInternalError: "):].startswith(want), (msg, want)


def test_misordered_enqueue_fails_every_rank_and_the_ranks_go_on(cluster):
    """Ranks that enqueue two names in opposite orders pair different
    tensors: the per-response gather refuses both on every rank, nothing
    is computed, and the next allreduce goes through."""
    w, ranks = cluster
    got = ranks[0]["misordered"]
    assert all(r["misordered"] == got for r in ranks)
    for k, name in enumerate(("first", "second")):
        other = "second" if name == "first" else "first"
        assert got[k] == (
            "HorovodInternalError: Mismatched tensor names: "
            + ", ".join(f"rank {q} {name if q == 0 else other}"
                        for q in range(w)))
    for r in ranks:
        np.testing.assert_array_equal(r["after"],
                                      np.full(3, w * (w + 1) / 2))


def test_duplicate_name_and_join(cluster):
    """A name enqueued again while pending fails with DuplicateNameError
    (the first completes); ``join`` raises the reference's
    NotImplementedError in multiprocess mode."""
    w, ranks = cluster
    for r in ranks:
        first, err = r["dup"]
        np.testing.assert_array_equal(first, np.full(2, float(w)))
        assert err.startswith("DuplicateNameError: Duplicate tensor name "
                              "'dup'")
        assert r["join"] == (
            "join() in multiprocess mode requires the cross-process control "
            "plane (launch via hvdrun / horovod_tpu.run so ranks share a "
            "coordinator address channel).")


# ----------------------------------------------------------- world 1
@pytest.fixture
def world1(monkeypatch, tmp_path):
    import horovod_tpu_torch as hvd

    path = tmp_path / "timeline.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    try:
        yield hvd, path
    finally:
        hvd.shutdown()


def test_world1_requests_fuse_and_complete(world1):
    """At world 1 the controller fuses what one tick finds: 40 in-place
    requests in one batch come back as one response; results are the
    inputs (scale factors applied); the timeline is valid Chrome-trace
    JSON with a negotiation span a tensor."""
    hvd, path = world1
    from horovod_tpu_torch.ops.collective_ops import enqueue_together

    eng = hvd.basics._engine()
    ts = [torch.full((10,), float(i)) for i in range(40)]
    before = eng.responses_performed
    with enqueue_together():
        hs = [hvd.allreduce_async_(t, name=f"t{i}", op=hvd.Sum,
                                   postscale_factor=2.0)
              for i, t in enumerate(ts)]
        polled = hvd.poll(hs[0])
    outs = [hvd.synchronize(h) for h in hs]
    assert not polled
    assert eng.responses_performed - before == 1
    for i, (o, t) in enumerate(zip(outs, ts)):
        assert o is t
        np.testing.assert_array_equal(o.numpy(), np.full(10, 2.0 * i))
    hvd.shutdown()
    events = json.loads(path.read_text())
    begun = {e["name"] for e in events if e.get("ph") == "B"}
    assert {f"NEGOTIATE_t{i}" for i in range(40)} <= begun
    assert "ALLREDUCE" in begun


def test_world1_shutdown_fails_what_is_pending(world1):
    """Requests enqueued after shutdown fail with ShutdownError."""
    hvd, _ = world1
    from horovod_tpu_torch.exceptions import ShutdownError

    eng = hvd.basics._engine()
    eng.shutdown()
    h = hvd.allreduce_async(torch.ones(2))
    with pytest.raises(ShutdownError):
        hvd.synchronize(h)
