"""Sparse (indexed-slices) allreduce: the port's ``ops/sparse.py`` and
``DistributedOptimizer``'s sparse gradients, the torch counterparts of
``tests/test_sparse.py``. Two spawned gloo ranks share one cluster; the
allreduce results are held equal to the reference's
``testing.run_cluster(np=2)`` on the same inputs.
"""

import numpy as np
import pytest
import torch

import horovod_tpu as ref_hvd
from horovod_tpu import testing as ref_testing
from horovod_tpu.ops import sparse as ref_sp
from horovod_tpu_torch import testing
from horovod_tpu_torch.ops import sparse as sp

import torch_algo_workers as W


@pytest.fixture(scope="module")
def port():
    return testing.run_cluster(W.sparse_worker, np=2, device="cpu",
                               timeout=300)


@pytest.fixture(scope="module")
def reference():
    def fn():
        r = ref_hvd.rank()
        out = {}
        for dt in W.SPARSE_DTYPES:
            k = r + 1
            res = ref_sp.allreduce_sparse(ref_sp.IndexedSlices(
                np.full((k, 3), r + 1, dtype=dt),
                np.arange(k, dtype=np.int64) + 2 * r, (4, 3)),
                name=f"sum_{dt}", op=ref_hvd.Sum)
            out[f"sum_{dt}"] = (np.asarray(res.values),
                                np.asarray(res.indices))
        res = ref_sp.allreduce_sparse(ref_sp.IndexedSlices(
            np.full((2, 2), 4.0, np.float32), np.array([0, 1]), (2, 2)),
            name="avg")
        out["avg"] = np.asarray(res.values)
        return out

    if ref_hvd.is_initialized():
        ref_hvd.shutdown()
    try:
        return ref_testing.run_cluster(fn, np=2)
    finally:
        ref_hvd.shutdown()


@pytest.mark.parametrize("dtype", W.SPARSE_DTYPES)
def test_sparse_allreduce_sum_ragged(port, reference, dtype):
    """Rank 0 one row, rank 1 two: Sum keeps the raw rows, as the
    reference's."""
    for r in range(2):
        values, indices, shape = port[r][f"sum_{dtype}"]
        ref_values, ref_indices = reference[r][f"sum_{dtype}"]
        assert values.dtype == np.dtype(dtype) and shape == (4, 3)
        assert values.shape == (3, 3) and indices.shape == (3,)
        np.testing.assert_array_equal(indices, [0, 2, 3])
        np.testing.assert_array_equal(indices, ref_indices)
        np.testing.assert_array_equal(values, ref_values)


def test_sparse_allreduce_average_divides_values(port, reference):
    for r in range(2):
        np.testing.assert_allclose(port[r]["avg"], np.full((4, 2), 2.0))
        np.testing.assert_array_equal(port[r]["avg"], reference[r]["avg"])


def test_sparse_allreduce_matches_dense_allreduce(port):
    """Densified, duplicate indices added, the sparse sum is the dense
    allreduce's."""
    for r in range(2):
        got, want = port[r]["vs_dense"]
        np.testing.assert_array_equal(got, want)


def test_sparse_adasum_rejected(port):
    for r in range(2):
        assert "Adasum" in port[r]["adasum"]
        assert "sparse_as_dense=True" in port[r]["adasum"]


def test_to_dense_requires_shape_and_accumulates_duplicates():
    values = np.array([[1.0], [2.0]], np.float32)
    s = sp.IndexedSlices(torch.from_numpy(values), torch.tensor([1, 1]),
                         (3, 1))
    want = np.asarray(ref_sp.to_dense(ref_sp.IndexedSlices(
        values, np.array([1, 1]), (3, 1))))
    np.testing.assert_array_equal(sp.to_dense(s).numpy(), want)
    np.testing.assert_allclose(want, [[0.0], [3.0], [0.0]])
    with pytest.raises(ValueError, match="dense_shape"):
        sp.to_dense(sp.IndexedSlices(torch.ones(1, 1), torch.tensor([0])))


def test_densify_tree_lists_and_dicts():
    s = sp.IndexedSlices(torch.ones(1, 2), torch.tensor([1]), (2, 2))
    d = torch.zeros(3)
    tree = sp.densify_tree({"a": s, "b": [d, s], "c": (s,)})
    assert tree["b"][0] is d
    for t in (tree["a"], tree["b"][1], tree["c"][0]):
        np.testing.assert_array_equal(t.numpy(), [[0, 0], [1, 1]])
    assert isinstance(tree["c"], tuple)


def test_from_sparse_coo_of_an_embedding_gradient():
    emb = torch.nn.Embedding(4, 3, sparse=True)
    emb(torch.tensor([2, 0, 2])).sum().backward()
    s = sp.from_sparse_coo(emb.weight.grad)
    assert s.dense_shape == (4, 3)
    np.testing.assert_array_equal(sp.to_dense(s).numpy(),
                                  emb.weight.grad.to_dense().numpy())


def test_distributed_optimizer_densifies_sparse_updates(port):
    """SGD(lr=1) on Sum: rank r's sparse row r carries r + 1; the gathered
    rows come back densified into ``.grad`` (as the reference's
    ``test_distributed_optimizer_densifies_sparse_updates``), beside a
    dense parameter reduced on the usual wire."""
    for r in range(2):
        emb, w, was_sparse, still_sparse = port[r]["opt"]
        assert was_sparse and not still_sparse
        np.testing.assert_allclose(emb, [[-0.5, -0.5], [-1, -1], [0, 0]])
        np.testing.assert_allclose(w, [-1.0, -1.0])


def test_distributed_optimizer_sparse_as_dense(port):
    for r in range(2):
        emb, w, was_sparse, still_sparse = port[r]["opt_dense"]
        assert was_sparse and not still_sparse
        np.testing.assert_allclose(emb, [[-0.5, -0.5], [-1, -1], [0, 0]])
        emb_avg = port[r]["opt_avg"][0]
        np.testing.assert_allclose(emb_avg, [[-0.25, -0.25], [-0.5, -0.5],
                                             [0, 0]])


def test_distributed_optimizer_accumulation_rejects_sparse(port):
    for r in range(2):
        assert "sparse_as_dense" in port[r]["accumulate"]
