"""The port's allreduce over two gloo processes against the reference's
``horovod_tpu.testing.run_cluster(np=2)`` on the same seeded per-rank inputs.

Every quantized mode (int8 unpacked, int8 packed, int4) and the exact wire,
each with Sum and Average, must be bit-identical to the reference, and the
wire accounting must equal the reference's. The small-tensor and integer
bypasses, broadcast and allgather ride the same cluster.
"""

import numpy as np
import pytest
import torch

import horovod_tpu as ref_hvd
from horovod_tpu import basics as ref_basics
from horovod_tpu import testing as ref_testing
from horovod_tpu_torch import testing

N = 5000  # not a multiple of world * block: the padding path runs

# (compression, op, packed wire)
CASES = [("none", "Sum", False), ("none", "Average", False),
         ("int8", "Sum", False), ("int8", "Average", False),
         ("int8", "Sum", True), ("int8", "Average", True),
         ("int4", "Sum", False), ("int4", "Average", False)]


def _input(case_idx: int, rank: int) -> np.ndarray:
    rng = np.random.RandomState(100 + 10 * case_idx + rank)
    return (rng.randn(N) * (case_idx + 1)).astype(np.float32)


def port_worker() -> dict:
    """One rank of the port's cluster: every case, then the bypasses,
    broadcast and allgather."""
    import os

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics

    torch.set_num_threads(1)  # two ranks beside other test workers
    r = hvd.rank()
    ex = basics._executor()
    out = {"cases": [], "backend": hvd.backend(),
           "layout": (hvd.rank(), hvd.size(), hvd.local_rank(),
                      hvd.local_size(), hvd.cross_rank(), hvd.cross_size())}
    for i, (mode, op, packed) in enumerate(CASES):
        os.environ["HOROVOD_PACKED_WIRE"] = "1" if packed else ""
        y = hvd.allreduce(torch.from_numpy(_input(i, r)),
                          op=getattr(hvd, op), name=f"c{i}",
                          compression=getattr(hvd.Compression, mode))
        out["cases"].append((y.numpy(), ex.last_wire_mode,
                             ex.last_wire_bytes))
    small = hvd.allreduce(torch.full((100,), float(r + 1)), op=hvd.Sum,
                          compression=hvd.Compression.int8)
    out["small"] = (small.numpy(), ex.last_wire_mode)
    ints = hvd.allreduce(torch.arange(2048, dtype=torch.int32) * (r + 1),
                         op=hvd.Sum, compression=hvd.Compression.int8)
    out["ints"] = (ints.numpy(), ex.last_wire_mode)
    out["bcast"] = hvd.broadcast(torch.full((3,), float(r + 7)),
                                 root_rank=1).numpy()
    out["gather"] = hvd.allgather(torch.full((2, 2), float(r))).numpy()
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.fill_(float(r))
    opt = torch.optim.SGD(model.parameters(), lr=0.1 * (r + 1), momentum=0.9)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    out["bparams"] = model.weight.detach().numpy()
    out["lr"] = opt.param_groups[0]["lr"]
    return out


def _reference(packed_cases) -> dict:
    """The reference's outputs for the cases whose packed flag matches."""

    def fn():
        r = ref_hvd.rank()
        ex = ref_basics._engine()._executor
        res = {}
        for i, (mode, op, packed) in enumerate(CASES):
            if packed != packed_cases:
                continue
            y = ref_hvd.allreduce(_input(i, r), name=f"c{i}",
                                  op=getattr(ref_hvd, op),
                                  compression=getattr(ref_hvd.Compression,
                                                      mode))
            res[i] = (np.asarray(y, np.float32), ex.last_wire_mode,
                      ex.last_wire_bytes)
        return res

    return ref_testing.run_cluster(fn, np=2)


@pytest.fixture(scope="module")
def port_results():
    return testing.run_cluster(port_worker, np=2, device="cpu", timeout=300)


def test_port_cluster_is_gloo_on_cpu(port_results):
    """Two ranks on one host read the launcher's env: gloo on the CPU."""
    assert [r["backend"] for r in port_results] == ["gloo", "gloo"]
    assert [r["layout"] for r in port_results] == [(0, 2, 0, 2, 0, 1),
                                                   (1, 2, 1, 2, 0, 1)]


@pytest.mark.parametrize("packed", [False, True])
def test_allreduce_bit_identical_to_reference(port_results, packed,
                                              monkeypatch):
    monkeypatch.setenv("HOROVOD_PACKED_WIRE", "1" if packed else "")
    ref = _reference(packed)
    for rank in range(2):
        for i, (y_ref, mode_ref, bytes_ref) in ref[rank].items():
            y, mode, nbytes = port_results[rank]["cases"][i]
            np.testing.assert_array_equal(y, y_ref, err_msg=str(CASES[i]))
            assert mode == mode_ref and nbytes == bytes_ref, CASES[i]
    # the replicated result is the same on both ranks
    for i in ref[0]:
        np.testing.assert_array_equal(port_results[0]["cases"][i][0],
                                      port_results[1]["cases"][i][0])


def test_quantized_modes_really_quantized(port_results):
    from horovod_tpu_torch.runtime.executor import Executor

    for i, (mode, _, _) in enumerate(CASES):
        y, wire, nbytes = port_results[0]["cases"][i]
        if mode == "none":
            assert wire == "" and nbytes == 2 * N * 4
            continue
        bits = 4 if mode == "int4" else 8
        assert wire == mode
        assert nbytes == Executor.quantized_wire_layout(N, 2, bits=bits)[
            "wire_bytes"]
        exact = _input(i, 0) + _input(i, 1)
        if CASES[i][1] == "Average":
            exact = exact / 2
        err = np.max(np.abs(y - exact)) / np.max(np.abs(exact))
        assert 0 < err <= (0.25 if bits == 4 else 1.5e-2), (CASES[i], err)


def test_small_and_integer_tensors_bypass_quantization(port_results):
    for r in port_results:
        small, mode = r["small"]
        np.testing.assert_array_equal(small, np.full(100, 3.0, np.float32))
        assert mode == ""
        ints, mode = r["ints"]
        np.testing.assert_array_equal(ints,
                                      np.arange(2048, dtype=np.int32) * 3)
        assert mode == "" and ints.dtype == np.int32


def test_broadcast_and_allgather(port_results):
    for r in port_results:
        np.testing.assert_array_equal(r["bcast"], np.full(3, 8.0, np.float32))
        np.testing.assert_array_equal(
            r["gather"], np.repeat([0.0, 1.0], 2)[:, None].repeat(2, 1)
            .astype(np.float32))
        np.testing.assert_array_equal(r["bparams"], np.zeros((3, 4)))
        assert r["lr"] == pytest.approx(0.1)
