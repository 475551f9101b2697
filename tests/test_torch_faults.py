"""The port's eager collectives and optimizers against the reference where
the two once differed (F1-F4), on two gloo processes of the port and two
thread ranks of the reference, on the same inputs.

* F1: a parameter one rank's loss leaves unused takes part as zeros, so
  ranks that leave different parameters unused still reduce the same
  tensors (the reference pairs its requests by name);
* F2: mismatched shape, size, dtype, op, broadcast root or allgather tail
  raises ``HorovodInternalError`` on every rank, with the reference's
  message, and the ranks go on;
* F3: allgather concatenates a ragged first dimension and refuses a 0-dim
  input with ``ValueError``;
* F4: allreduce, allgather and broadcast carry the reference's gradients.

The port's ranks run ``torch_parallel_workers.fault_worker`` once, in one
cluster the module's tests share.
"""

import numpy as np
import pytest
import torch

import horovod_tpu.torch as ref_hvd
from horovod_tpu import testing as ref_testing
from horovod_tpu_torch import testing
from torch_parallel_workers import (fault_grads, fault_worker,
                                    unused_params_step)


@pytest.fixture(scope="module")
def port():
    return testing.run_cluster(fault_worker, np=2, device="cpu", timeout=300)


@pytest.fixture(scope="module")
def reference():
    def fn():
        r = ref_hvd.rank()

        def error(f):
            try:
                f()
            except ref_hvd.HorovodInternalError as e:
                return str(e)
            return None

        ones = torch.ones
        errors = {
            "shape": error(lambda: ref_hvd.allreduce(
                ones((2, 3) if r == 0 else (3, 2)), name="mismatch",
                op=ref_hvd.Sum)),
            "size": error(lambda: ref_hvd.allreduce(
                ones(4 if r == 0 else 5), name="size", op=ref_hvd.Sum)),
            "dtype": error(lambda: ref_hvd.allreduce(
                ones(2, dtype=torch.float32 if r == 0 else torch.float64),
                name="dtmismatch", op=ref_hvd.Sum)),
            "op": error(lambda: ref_hvd.allreduce(
                ones(2), name="opmix",
                op=ref_hvd.Sum if r == 0 else ref_hvd.Average)),
            "root": error(lambda: ref_hvd.broadcast(ones(2), root_rank=r,
                                                    name="bcroot")),
            "tail": error(lambda: ref_hvd.allgather(
                ones((2, 3) if r == 0 else (2, 4)), name="agerr")),
        }
        try:
            ref_hvd.allgather(torch.tensor(1.0))
            scalar = None
        except ValueError as e:
            scalar = str(e)
        return {"f1": unused_params_step(ref_hvd, r), "f2": errors,
                "f3": ref_hvd.allgather(torch.full((r + 1, 2), float(r)),
                                        name="agv").numpy(),
                "f3_scalar": scalar,
                "f4": fault_grads(ref_hvd, r, ref_hvd.size())}

    return ref_testing.run_cluster(fn, np=2)


def test_unused_parameters_reduce_as_zeros(port, reference):
    """F1: rank 0 uses only a (gradient 1), rank 1 only b (gradient 100):
    a.grad is 0.5 and b.grad 50 on both ranks, as in the reference with
    explicit zero gradients, and so are the parameters after a step."""
    for got, want in zip(port, reference):
        for g, w in zip(got["f1"][0] + got["f1"][1],
                        want["f1"][0] + want["f1"][1]):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port[0]["f1"][0][1], np.full(4, 50.0))


def test_parallel_step_reduces_unused_parameters(port):
    """F1 in the parallel step: ``scale`` is unused on rank 0, yet both
    ranks hold the same parameters after the step, and rank 1's gradient
    reached rank 0's copy."""
    a, b = (r["f1_sp"] for r in port)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert (a["scale"] != 1.0).any()


@pytest.mark.parametrize("case", ["shape", "size", "dtype", "op", "root",
                                  "tail"])
def test_mismatched_collectives_raise_on_every_rank(port, reference, case):
    """F2: the same error on both ranks, whose text before its per-rank
    detail is the reference's."""
    got = [r["f2"][case] for r in port]
    want = [r["f2"][case] for r in reference]
    assert got[0] is not None and got[0] == got[1], got
    for g, w in zip(got, want):
        assert w is not None
        assert g.split(":")[0] == w.split(":")[0], (g, w)


def test_mismatch_in_synchronize_raises_and_the_ranks_go_on(port):
    """F2 in ``DistributedOptimizer.synchronize``, checked in one gather;
    after every refused call the ranks still reduce together."""
    msgs = [r["f2"]["synchronize"] for r in port]
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("Mismatched tensor shapes for 'grad.p'")
    for r in port:
        np.testing.assert_array_equal(r["f2_after"], np.full(3, 3.0))


def test_allgather_ragged_and_scalar(port, reference):
    """F3: [r + 1, 2] on rank r gathers to [3, 2] in rank order; a 0-dim
    input raises ValueError, as in the reference."""
    for got, want in zip(port, reference):
        np.testing.assert_array_equal(got["f3"], want["f3"])
        assert got["f3_scalar"] == want["f3_scalar"]
    np.testing.assert_array_equal(port[0]["f3"],
                                  [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]])


@pytest.mark.parametrize("key", ["ar0", "ar1", "ar2", "avg", "mid", "ag",
                                 "bc"])
def test_collective_gradients_match_reference(port, reference, key):
    """F4: sum and average allreduce (the same reduction of the incoming
    gradient), allreduce inside a graph, a ragged allgather (this rank's
    rows of the summed gradient) and broadcast (the sum on the root, zero
    elsewhere)."""
    for got, want in zip(port, reference):
        np.testing.assert_allclose(got["f4"][key], want["f4"][key],
                                   rtol=1e-12, atol=0)
