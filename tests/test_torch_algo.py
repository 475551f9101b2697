"""The port's compiled-plane allreduces (``horovod_tpu_torch.spmd``: the
quantized ring, the recursive halving / doubling tree and the two-level
hierarchical schedule) at worlds 2, 3 and 4 on spawned gloo processes,
against the reference's (``horovod_tpu.spmd``) on the same number of JAX
CPU devices, under ``spmd._shard_map`` with ``HVD_PALLAS=interpret``, on
the same seeded numpy inputs.

Tolerances: every result must equal the reference's bit for bit (the
hop's dequantize-and-add is the fused multiply-add XLA makes on the CPU),
but the exact ring, which is the backend's allreduce against XLA's psum
(another order of the sum: within 1e-6, ``tests/test_algo.py``'s bound);
every result must be bit-identical on every rank, and
stay within ``tests/test_algo.py``'s error bounds of the exact mean (int8
0.05, int4 0.6). The bytes each rank's hops sent must equal the
reference's catalog, ``gspmd_wire_footprint``, for the ring and the
hierarchical schedule at every world and for the tree at world 2; at world
4 the tree's halving and doubling send the ring's bytes, 3/4 of what the
catalog's tree row counts (``2 * log2(world)`` payload halves). Each
world's cases share one cluster (a module-scoped fixture).
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import testing

BLOCK = 256
N = 3000           # not a multiple of world * block: the padding runs
ALGOS = ("ring", "tree", "hier")
WIRES = ("int8", "int4", "off")
TOL = {"int8": 0.05, "int4": 0.6}


def _data(world: int, n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randn(world, n).astype(np.float32)


def _seed(algo: str, wire: str) -> int:
    return 10 * ALGOS.index(algo) + WIRES.index(wire)


def algo_worker(n: int) -> dict:
    """One rank: every (algorithm, wire) over ``n`` f32 values, with the
    bytes its hops sent; the exact ring with raw hops; the fallbacks."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd

    torch.set_num_threads(1)
    world, r = hvd.size(), hvd.rank()
    fns = {"ring": spmd.quantized_allreduce,
           "tree": spmd.quantized_allreduce_tree,
           "hier": spmd.quantized_allreduce_hier}
    out = {"cases": {}}
    for algo in ALGOS:
        for wire in WIRES:
            x = torch.from_numpy(_data(world, n, _seed(algo, wire))[r])
            spmd.reset_hop_bytes()
            y = fns[algo](x, hvd.Average, wire, BLOCK)
            out["cases"][(algo, wire)] = (y.numpy(), spmd.hop_bytes())
    x = torch.from_numpy(_data(world, n, 99)[r])
    spmd.reset_hop_bytes()
    chunk = spmd.quantized_reduce_scatter(x, "off", BLOCK)
    full = spmd.quantized_all_gather(chunk, "off", BLOCK)[:n]
    out["ring_hops"] = (full.numpy(), spmd.hop_bytes())
    small = torch.from_numpy(_data(world, 200, 7)[r])
    ints = torch.arange(2048, dtype=torch.int32) * (r + 1)
    out["fallbacks"] = {
        algo: (fns[algo](small, hvd.Average, "int8", BLOCK).numpy(),
               fns[algo](ints, hvd.Average, "int8", BLOCK).numpy())
        for algo in ALGOS}
    out["exact"] = (spmd.allreduce(small, hvd.Average).numpy(),
                    spmd.allreduce(ints, hvd.Average).numpy())
    return out


def _cluster(world: int, n: int):
    return testing.run_cluster(algo_worker, np=world, device="cpu",
                               args=(n,), timeout=300)


@pytest.fixture(scope="module")
def world2():
    return _cluster(2, N)


@pytest.fixture(scope="module")
def world4():
    return _cluster(4, N)


@pytest.fixture(scope="module")
def world3():
    return _cluster(3, 777)


def _reference(algo: str, wire: str, data: np.ndarray) -> np.ndarray:
    """The reference's allreduce of ``data``'s rows (one a device)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu import spmd as ref
    from horovod_tpu.basics import MESH_AXIS, Average

    fn = {"ring": ref.quantized_allreduce,
          "tree": ref.quantized_allreduce_tree,
          "hier": ref.quantized_allreduce_hier}[algo]
    mesh = Mesh(np.array(jax.devices()[:data.shape[0]]), (MESH_AXIS,))

    def body(row):
        return fn(row[0], Average, MESH_AXIS, wire, block=BLOCK)[None]

    sm = ref._shard_map(body, mesh, in_specs=P(MESH_AXIS),
                        out_specs=P(MESH_AXIS))
    return np.asarray(jax.jit(sm)(data))


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    monkeypatch.delenv("HOROVOD_MESH_HOSTS", raising=False)
    monkeypatch.delenv("HOROVOD_GSPMD_WIRE", raising=False)
    monkeypatch.delenv("HOROVOD_ADAPTIVE_GATE", raising=False)


def _hosts(algo: str, world: int):
    from horovod_tpu_torch import spmd

    return spmd.mesh_hosts(world) if algo == "hier" else None


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("world", [2, 4])
def test_algorithm_bits_equal_reference(request, world, algo, wire):
    ranks = request.getfixturevalue(f"world{world}")
    data = _data(world, N, _seed(algo, wire))
    want = _reference(algo, wire, data)
    got = [r["cases"][(algo, wire)][0] for r in ranks]
    for p in range(world):
        if algo == "ring" and wire == "off":
            # the backend's allreduce against XLA's psum: another order of
            # the sum (tests/test_algo.py's tolerance)
            np.testing.assert_allclose(got[p], want[p], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[p], want[p],
                                          err_msg=f"rank {p}")
        np.testing.assert_array_equal(got[p], got[0])
    err = np.abs(got[0] - data.mean(axis=0)).max()
    assert err < TOL.get(wire, 1e-6), err


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("world", [2, 4])
def test_hop_bytes_equal_catalog(request, world, algo, wire):
    from horovod_tpu_torch.ops import compression as comp

    ranks = request.getfixturevalue(f"world{world}")
    mode = "none" if wire == "off" else wire
    sent = {r["cases"][(algo, wire)][1] for r in ranks}
    assert len(sent) == 1, sent
    sent = sent.pop()
    hosts = _hosts(algo, world)
    row = comp.gspmd_wire_footprint(N, mode, world, BLOCK, algorithm=algo,
                                    hosts=hosts)
    if wire == "off" and (algo == "ring" or hosts == 1):
        assert sent == 0  # the exact ring is the backend's allreduce
    elif algo == "tree" and world > 2:
        ring = comp.gspmd_wire_footprint(N, mode, world, BLOCK)
        assert sent == ring and 4 * sent == 3 * row, (sent, ring, row)
    else:
        assert sent == row, (sent, row)


@pytest.mark.parametrize("world", [2, 4])
def test_exact_ring_hops_equal_reference_and_catalog(request, world):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu import spmd as ref
    from horovod_tpu.basics import MESH_AXIS
    from horovod_tpu_torch.ops import compression as comp

    ranks = request.getfixturevalue(f"world{world}")
    data = _data(world, N, 99)
    mesh = Mesh(np.array(jax.devices()[:world]), (MESH_AXIS,))

    def body(row):
        c = ref.quantized_reduce_scatter(row[0], MESH_AXIS, "off", BLOCK)
        return ref.quantized_all_gather(c, MESH_AXIS, "off")[:N][None]

    want = np.asarray(jax.jit(ref._shard_map(
        body, mesh, in_specs=P(MESH_AXIS), out_specs=P(MESH_AXIS)))(data))
    for p, r in enumerate(ranks):
        np.testing.assert_array_equal(r["ring_hops"][0], want[p])
        assert r["ring_hops"][1] == comp.gspmd_wire_footprint(
            N, "none", world, BLOCK)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("world", [2, 4])
def test_fallbacks_equal_exact_path(request, world, algo):
    """Under one block and an integer payload, every algorithm is the
    exact allreduce, here and in the reference."""
    ranks = request.getfixturevalue(f"world{world}")
    small = _data(world, 200, 7)
    want = _reference(algo, "int8", small)
    for p, r in enumerate(ranks):
        got_small, got_ints = r["fallbacks"][algo]
        exact_small, exact_ints = r["exact"]
        np.testing.assert_array_equal(got_small, exact_small)
        # the backend's allreduce against XLA's psum (orders differ at 4)
        np.testing.assert_allclose(got_small, want[p], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got_ints, exact_ints)
        np.testing.assert_array_equal(
            got_ints, sum(np.arange(2048, dtype=np.int32) * (q + 1)
                          for q in range(world)) // world)


@pytest.mark.parametrize("algo", ["tree", "hier"])
def test_world3_falls_back_to_the_ring(world3, algo):
    """A world of 3 is no power of 2 (the tree) and prime (the
    hierarchical schedule): both are the ring, bit for bit, here and in
    the reference."""
    data = _data(3, 777, _seed(algo, "int8"))
    ring_data = _data(3, 777, _seed("ring", "int8"))
    want = _reference("ring", "int8", data)
    for p, r in enumerate(world3):
        np.testing.assert_array_equal(r["cases"][(algo, "int8")][0], want[p])
    want_ring = _reference("ring", "int8", ring_data)
    for p, r in enumerate(world3):
        np.testing.assert_array_equal(r["cases"][("ring", "int8")][0],
                                      want_ring[p])
        # same bytes as the ring too
        assert (r["cases"][(algo, "int8")][1]
                == r["cases"][("ring", "int8")][1])
