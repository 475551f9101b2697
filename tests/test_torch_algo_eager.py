"""The engine's allreduce programs (``horovod_tpu_torch.runtime.executor``):
the flat ring, the exact two-level program, the tree, the bf16 wire,
int8-dcn and the adaptive wire, on 4 spawned gloo ranks grouped 2 hosts x
2 (``HVD_UNIFORM_LOCAL_SIZE=2``), against the reference's
``testing.run_cluster(np=4)`` with ``HVD_LOCAL_SIZE=2`` on the same seeded
inputs; ``last_wire_mode``, ``last_wire_bytes`` and ``last_algorithm``
must equal the reference's.

Tolerances: every result equals the reference's bit for bit but the flat
exact ring's (the bypasses' too), which is gloo's allreduce against XLA's
psum (another order of a 4-term f32 sum: within 1e-6 of the result's
magnitude, as
``tests/test_torch_algo.py`` holds the compiled plane's ring). At 2 x 2
every sum of the two-level programs has two terms, which add alike in any
order; the bf16 wire's 4-term sums add in f32 in rank order and round once
to bf16, as XLA's CPU reduction of a bf16 collective does (the reference's
program; checked bit for bit here).
"""

import os
import types

import numpy as np
import pytest

import horovod_tpu as ref_hvd
from horovod_tpu import basics as ref_basics
from horovod_tpu import testing as ref_testing
from horovod_tpu.ops import adaptive as ref_adaptive
from horovod_tpu.ops import compression as ref_comp
from horovod_tpu_torch import testing
from horovod_tpu_torch.ops import adaptive
from horovod_tpu_torch.runtime import executor as port_executor
from horovod_tpu_torch.runtime import pycontroller

import torch_algo_workers as W

RING_TOL = 1e-6


def _spawn(fn, np_, env, **kw):
    """``run_cluster`` with ``env`` in the spawned ranks' environment."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return testing.run_cluster(fn, np=np_, device="cpu", timeout=300,
                                   **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def port_cases():
    return _spawn(W.case_worker, 4, {"HVD_UNIFORM_LOCAL_SIZE": "2"})


def _ref_input(i, r):
    x = W.case_input(i, r)
    if W.CASES[i][4] == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16)
    return x


def _reference_cases(monkeypatch, algo: str, packed: bool) -> dict:
    """The reference's results of the cases run under ``algo`` and the
    packed flag, on 4 thread ranks over the 2 x 2 mesh."""
    idx = [i for i, c in enumerate(W.CASES)
           if c[1] == algo and ("packed" in c[2]) == packed]
    monkeypatch.setenv("HVD_LOCAL_SIZE", "2")
    monkeypatch.setenv("HOROVOD_GSPMD_ALGO", algo)
    monkeypatch.setenv("HOROVOD_PACKED_WIRE", "1" if packed else "")
    ref_comp.AdaptiveCompressor.reset()
    ref_adaptive.reset()
    for i in idx:
        comp = W.CASES[i][2]
        if comp.startswith("adaptive:"):
            W.prime_selector(ref_comp.AdaptiveCompressor, W.CASES[i][0],
                             comp.split(":")[1])

    def compressor(spec):
        name = spec.split()[0]
        if name.startswith("adaptive:"):
            return ref_comp.AdaptiveCompressor
        return getattr(ref_hvd.Compression, name)

    def fn():
        r = ref_hvd.rank()
        ex = ref_basics._engine()._executor
        res = {}
        for i in idx:
            label, _, comp, op, dtype, pre, post, _ = W.CASES[i]
            y = np.asarray(ref_hvd.allreduce(
                _ref_input(i, r), name=label, op=getattr(ref_hvd, op),
                compression=compressor(comp), prescale_factor=pre,
                postscale_factor=post))
            if dtype == "bfloat16":
                y = y.view(np.int16)
            res[label] = (y, ex.last_wire_mode, ex.last_wire_bytes,
                          ex.last_algorithm)
        return res

    if ref_hvd.is_initialized():
        ref_hvd.shutdown()
    try:
        return ref_testing.run_cluster(fn, np=4)
    finally:
        ref_hvd.shutdown()
        ref_comp.AdaptiveCompressor.reset()
        ref_adaptive.reset()


@pytest.mark.parametrize("algo,packed", [("", False), ("hier", False),
                                         ("tree", False), ("", True)])
def test_programs_match_reference(port_cases, monkeypatch, algo, packed):
    ref = _reference_cases(monkeypatch, algo, packed)
    assert ref[0], "no case ran"
    for rank in range(4):
        for label, (y_ref, mode, nbytes, algorithm) in ref[rank].items():
            y, p_mode, p_bytes, p_algorithm = \
                port_cases[rank]["cases"][label]
            assert (p_mode, p_bytes, p_algorithm) == (mode, nbytes,
                                                      algorithm), label
            assert y.shape == y_ref.shape, label
            # the reference's flat integer sum comes back int64 under the
            # tests' jax_enable_x64 (jnp.sum's promotion); the port keeps
            # the input's dtype, and the values must agree
            assert y.dtype == y_ref.dtype or (
                y.dtype == np.int32 and y_ref.dtype == np.int64), label
            if (mode, algorithm) == ("", "ring"):  # gloo's allreduce
                scale = float(np.max(np.abs(y_ref)))
                np.testing.assert_allclose(y, y_ref, rtol=0,
                                           atol=RING_TOL * scale,
                                           err_msg=label)
            else:
                np.testing.assert_array_equal(y, y_ref, err_msg=label)


def test_programs_and_accounting(port_cases):
    """Every rank ran the configured program and holds the same bits; the
    bytes are the reference's accounting (``2 * n * 2`` for bf16, the
    quantized layout for int8-dcn and adaptive int4 / int8)."""
    from horovod_tpu_torch.runtime.executor import Executor

    expect = {"ring": ("", "ring"), "hier": ("", "hier"),
              "hier_i32": ("", "hier"), "tree": ("", "tree"),
              "tree_i32": ("", "ring"), "bf16": ("bf16", "ring"),
              "dcn": ("int8-dcn", "ring"), "dcn_small": ("", "ring"),
              "dcn_i32": ("", "ring"), "adaptive_int4": ("int4", "ring"),
              "adaptive_int8": ("int8", "ring")}
    for label, (mode, algorithm) in expect.items():
        for r in port_cases:
            y, m, nbytes, a = r["cases"][label]
            assert (m, a) == (mode, algorithm), label
            np.testing.assert_array_equal(
                y, port_cases[0]["cases"][label][0], err_msg=label)
        n = W.N
        if mode == "bf16":
            assert nbytes == 2 * n * 2
        elif mode:
            bits = 4 if mode == "int4" else 8
            assert nbytes == Executor.quantized_wire_layout(
                n, 4, bits=bits)["wire_bytes"]


def test_wire_errors_against_exact_sum(port_cases):
    """The lossy programs stay near the exact sum: bf16 within two bf16
    roundings of the result, int8-dcn within int8's bound plus the bf16
    hops', adaptive int4 within the 4-bit grid's."""
    bounds = {"bf16": 2 ** -7, "dcn": 0.03, "adaptive_int4": 0.3,
              "adaptive_int8": 0.02}
    for label, bound in bounds.items():
        i = [c[0] for c in W.CASES].index(label)
        _, _, _, op, _, pre, post, _ = W.CASES[i]
        exact = sum(W.case_input(i, r).astype(np.float64) * pre
                    for r in range(4))
        if op == "Average":
            exact = exact / 4
        exact = exact * post
        y = port_cases[0]["cases"][label][0]
        err = np.max(np.abs(y - exact)) / np.max(np.abs(exact))
        assert 0 < err <= bound, (label, err)


def test_two_level_grouping(port_cases):
    """Host-major rows of 2, as the reference's mesh: ``{"dcn": 2, "ici":
    2}``, ranks in rank order; this rank's host row and cross column."""
    for r, res in enumerate(port_cases):
        shape, ranks, host, cross = res["mesh"]
        assert shape == {"dcn": 2, "ici": 2} and ranks == [0, 1, 2, 3]
        assert host == [2 * (r // 2), 2 * (r // 2) + 1]
        assert cross == [r % 2, r % 2 + 2]


def test_adaptive_race_resolves_least_aggressive(port_cases):
    """Rank 0 proposes adaptive:int4, the others adaptive:int8: every rank
    runs int8, with one result."""
    from horovod_tpu_torch.runtime.executor import Executor

    for res in port_cases:
        y, mode, nbytes = res["race"]
        assert mode == "int8"
        assert nbytes == Executor.quantized_wire_layout(W.N, 4)["wire_bytes"]
        np.testing.assert_array_equal(y, port_cases[0]["race"][0])


def test_adaptive_mixed_with_static_refused(port_cases):
    for res in port_cases:
        msg = res["mixed"]
        assert msg is not None
        assert "compression" in msg and "HOROVOD_COMPRESSION" in msg
        assert "rank" in msg
    assert len({res["mixed"] for res in port_cases}) == 1


class _Meta:
    def __init__(self, compression):
        self.compression = compression


@pytest.mark.parametrize("wires", [
    ("adaptive:int4", "adaptive:int8"), ("adaptive:bf16", "adaptive:int4"),
    ("adaptive:int8", "adaptive:int8"), ("int8", "int8"), ("", "")])
def test_resolve_compression_matches_reference(wires):
    from horovod_tpu.runtime.coordinator import CoordState

    metas = [_Meta(w) for w in wires]
    assert pycontroller.resolve_compression(metas) == \
        CoordState._resolve_compression(metas)


def test_validate_refuses_mixed_adaptive_and_static():
    from horovod_tpu_torch.runtime.messages import RequestType

    def meta(rank, compression):
        return types.SimpleNamespace(
            name="g", rank=rank, type=RequestType.ALLREDUCE, dtype="f32",
            shape=(4,), average=False, prescale=1.0, postscale=1.0,
            compression=compression, parts=None, splits=None)

    race = {0: meta(0, "adaptive:int4"), 1: meta(1, "adaptive:int8")}
    assert pycontroller.validate("g", race, 2) is None
    for other in ("int4", ""):
        err = pycontroller.validate(
            "g", {0: meta(0, "adaptive:int8"), 1: meta(1, other)}, 2)
        assert "compression" in err and "HOROVOD_COMPRESSION" in err
        assert "rank" in err


def test_executor_algo_choice(monkeypatch):
    """As ``tests/test_algo.py::test_executor_algo_choice``."""
    from horovod_tpu.runtime.executor import Executor as RefExecutor

    ex = port_executor.Executor.__new__(port_executor.Executor)
    ref = RefExecutor.__new__(RefExecutor)

    def both():
        got = port_executor.Executor._algo_choice(ex)
        assert got == RefExecutor._algo_choice(ref)
        return got

    adaptive.reset()
    ref_adaptive.reset()
    monkeypatch.delenv("HOROVOD_GSPMD_ALGO", raising=False)
    assert both() == "ring"
    monkeypatch.setenv("HOROVOD_GSPMD_ALGO", "tree")
    assert both() == "tree"
    monkeypatch.setenv("HOROVOD_GSPMD_ALGO", "auto")
    assert both() == "ring"
    adaptive.set_autotuned_algorithm("hier")
    ref_adaptive.set_autotuned_algorithm("hier")
    assert both() == "hier"
    monkeypatch.setenv("HOROVOD_GSPMD_ALGO", "ring")
    assert both() == "ring"
    monkeypatch.setenv("HOROVOD_GSPMD_ALGO", "bogus")
    with pytest.raises(ValueError):
        port_executor.Executor._algo_choice(ex)
    adaptive.reset()
    ref_adaptive.reset()


@pytest.mark.parametrize("world,ls,multiprocess", [
    (8, 2, False), (8, 4, False), (8, 1, False), (8, 8, False),
    (8, 3, False), (4, 2, True), (4, 0, True), (6, 4, True)])
def test_two_level_size_matches_reference(monkeypatch, world, ls,
                                          multiprocess):
    """The grouping as the reference's ``_build_two_level_mesh`` makes it
    (``tests/test_hierarchical_eager.py::test_two_level_mesh_construction``):
    host-major rows, none when degenerate."""
    import jax

    from horovod_tpu.parallel.hierarchical import make_two_level_mesh
    from horovod_tpu.runtime.executor import Executor as RefExecutor
    from horovod_tpu_torch.parallel.hierarchical import build_two_level_mesh

    var = "HVD_UNIFORM_LOCAL_SIZE" if multiprocess else "HVD_LOCAL_SIZE"
    monkeypatch.setenv(var, str(ls))
    ref = RefExecutor.__new__(RefExecutor)
    ref._multiproc, ref._world = multiprocess, world
    ref._rank_devices = list(jax.devices())[:world]
    mesh2 = ref._build_two_level_mesh(types.SimpleNamespace(local_size=1))
    got = port_executor.two_level_size(world, multiprocess, 1)
    if mesh2 is None:
        assert got == 0
        return
    assert got == mesh2.shape["ici"]
    mesh = build_two_level_mesh(world, 0, got, None)
    assert mesh.shape == dict(mesh2.shape)
    assert [ref._rank_devices.index(d) for d in mesh2.devices.flat] == \
        mesh.ranks
    ref_mesh = make_two_level_mesh(got, devices=ref._rank_devices)
    assert dict(ref_mesh.shape) == mesh.shape


@pytest.fixture(scope="module")
def knob_results():
    return _spawn(W.knob_worker, 4, {
        "HVD_UNIFORM_LOCAL_SIZE": "2", "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
        "HOROVOD_HIERARCHICAL_ALLGATHER": "1"})


def test_hierarchical_knobs_match_reference(knob_results, monkeypatch):
    """``HOROVOD_HIERARCHICAL_ALLREDUCE`` takes the two-level program even
    under ``HOROVOD_GSPMD_ALGO=tree``; ``_ALLGATHER``'s ragged gather gives
    the flat one's rows; both equal the reference's."""
    monkeypatch.setenv("HVD_LOCAL_SIZE", "2")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLGATHER", "1")
    monkeypatch.setenv("HOROVOD_GSPMD_ALGO", "tree")

    def fn():
        r = ref_hvd.rank()
        ex = ref_basics._engine()._executor
        y = np.asarray(ref_hvd.allreduce(W.case_input(0, r), name="k0",
                                         op=ref_hvd.Sum))
        out = {"sum": (y, ex.last_wire_mode, ex.last_wire_bytes,
                       ex.last_algorithm)}
        y = np.asarray(ref_hvd.allreduce(W.case_input(4, r), name="k1",
                                         op=ref_hvd.Average))
        out["int_avg"] = (y, ex.last_algorithm)
        rows = np.full((r + 1, 3), float(r), np.float32) + np.arange(
            3, dtype=np.float32)
        out["gather"] = np.asarray(ref_hvd.allgather(rows, name="kg"))
        return out

    if ref_hvd.is_initialized():
        ref_hvd.shutdown()
    try:
        ref = ref_testing.run_cluster(fn, np=4)
    finally:
        ref_hvd.shutdown()
    for r in range(4):
        got, want = knob_results[r], ref[r]
        assert got["sum"][1:] == want["sum"][1:] == ("", 2 * W.N * 4,
                                                     "hier")
        np.testing.assert_array_equal(got["sum"][0], want["sum"][0])
        assert got["int_avg"][1] == want["int_avg"][1] == "hier"
        np.testing.assert_array_equal(got["int_avg"][0],
                                      want["int_avg"][0])
        np.testing.assert_array_equal(got["gather"], want["gather"])
        assert got["gather"].shape == (10, 3)


def test_adaptive_optimizer_modes_agree_across_ranks():
    """A 2-rank ``DistributedOptimizer(Compression.adaptive,
    error_feedback=True)``: every rank's wire-mode sequence and decisions
    are the same, a decision lands, and the parameters are bit-identical."""
    steps = 4
    a, b = testing.run_cluster(W.adaptive_optimizer_worker, np=2,
                               device="cpu", args=(steps,), timeout=300)
    assert a["modes"] == b["modes"] and len(a["modes"]) == steps
    assert a["decisions"] == b["decisions"]
    assert a["record"] == b["record"]
    assert a["modes"][0] == "int8"  # before any statistics
    assert a["decisions"][-1]  # the selector saw the reduced tensors
    assert a["record"]  # and changed a decision
    for p, q in zip(a["params"], b["params"]):
        np.testing.assert_array_equal(p, q)
