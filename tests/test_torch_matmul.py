"""The port's matmul kernel K10 and fused matmul + reduce-scatter
(``horovod_tpu_torch/ops/cuda_kernels.py`` ``matmul_2d`` / ``matmul_tiles``,
``horovod_tpu_torch/ops/matmul.py``) against the reference's
``horovod_tpu/ops/pallas_kernels.py`` on the CPU.

The reference runs its Pallas kernel in interpret mode (``HVD_PALLAS=
interpret``): on the CPU ``mode()`` is ``"off"``, where ``matmul_tiles``
gives None and the ring quietly takes its unfused reference. Its ring runs
shard_mapped over a mesh of 2 or 4 JAX CPU devices, the port's over as many
gloo ranks (``testing.run_cluster``), on the same numpy inputs.

Tolerances, elementwise. For one product, with A = ``|x| @ |w|``: an f32
sum of K products reassociated differs by at most ``K 2^-24 A`` (twice
that between two orders), so kernel against reference within ``2 K 2^-24
A`` plus one unit in the last place of the output. A ring of m ranks
rounds each partial P_r = x_r @ w_r and each of its m - 1 adds to the
output dtype (unit roundoff u = 2^-24 in f32, 2^-8 in bf16); every
rounding is at most u times a value no larger than S = sum_r |P_r|, so
ring (or unfused reference) against the f64 dense sum within ``2 m u S +
2 K 2^-24 sum_r A_r`` (the factor 2 covers the second-order terms), and
ring against the reference's ring within twice that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch import testing
from horovod_tpu_torch.ops import cuda_kernels as ck
from torch_parallel_workers import matmul_rs_worker

ULP = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}
UNIT = {"float32": 2.0 ** -24, "bfloat16": 2.0 ** -8}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")


def _abs_product(x, w):
    return np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 256, 128), (520, 384, 640),
                                   (8, 128, 256)])
def test_matmul_2d_plain_matches_pallas_interpret(interpret, dtype, shape):
    m, k, n = shape
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randn(k, n).astype(np.float32)
    xt, wt = (torch.from_numpy(a).to(TORCH[dtype]) for a in (x, w))
    assert pk.matmul_tiles(m, k, n) is not None
    want = np.asarray(pk.matmul_2d(jnp.asarray(x, JNP[dtype]),
                                   jnp.asarray(w, JNP[dtype]))
                      ).astype(np.float64)
    # the operands as both sides see them (bf16-rounded for bf16)
    s = _abs_product(xt.float().numpy(), wt.float().numpy())
    for got in (ck.matmul_2d_plain(xt, wt), ck.matmul_2d(xt, wt)):
        assert got.dtype == TORCH[dtype] and tuple(got.shape) == (m, n)
        g = got.float().numpy().astype(np.float64)
        bound = (2 * k * 2.0 ** -24 * s
                 + ULP[dtype] * np.maximum(np.abs(g), np.abs(want)))
        assert (np.abs(g - want) <= bound).all()


_SHAPES = [(m, k, n) for m in (0, 1, 5, 8, 12, 24, 96, 256, 520, 2048, 4104)
           for k in (64, 128, 250, 256, 384, 1024)
           for n in (96, 128, 256, 384, 32768)]


def test_matmul_tiles_matches_reference(interpret):
    for m, k, n in _SHAPES:
        assert ck.matmul_tiles(m, k, n) == pk.matmul_tiles(m, k, n), (m, k, n)


def test_matmul_2d_refuses_what_it_does_not_take():
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="dtype"):
        ck.matmul_2d(x, torch.zeros(128, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="does not tile"):
        ck.matmul_2d(x, torch.zeros(128, 96))
    with pytest.raises(ValueError, match="does not tile"):
        ck.matmul_2d(torch.zeros(5, 128), torch.zeros(128, 128))
    with pytest.raises(ValueError, match="does not tile"):
        ck.matmul_2d(x, torch.zeros(256, 128))
    with pytest.raises(TypeError):
        ck.matmul_2d(x.half(), torch.zeros(128, 128).half())


def _cases(m):
    """name -> (x [m, R, Kl], w [m, Kl, N]) with one slice per rank."""
    rng = np.random.RandomState(8 + m)

    def pair(rows, kl, n):
        return (rng.randn(m, rows, kl).astype(np.float32),
                rng.randn(m, kl, n).astype(np.float32))

    return {"aligned": pair(16 * m, 128, 128),        # K10 chunks
            "bf16 aligned": pair(8 * m, 256, 256),
            "unaligned": pair(2 * m, 64, 96),         # torch.matmul chunks
            "rows not divisible": pair(4 * m + 1, 128, 128)}


def _jax_ring(fn, x, w, m, dtype):
    mesh = Mesh(np.asarray(jax.devices()[:m]), ("hvd",))
    put = [jax.device_put(jnp.asarray(a, JNP[dtype]),
                          NamedSharding(mesh, P("hvd"))) for a in (x, w)]
    sm = jax.shard_map(lambda a, b: fn(a[0], b[0], "hvd")[None], mesh=mesh,
                       in_specs=P("hvd"), out_specs=P("hvd"),
                       check_vma=False)
    return np.asarray(jax.jit(sm)(*put)).astype(np.float64)


@pytest.fixture(scope="module", params=[2, 4])
def ring(request):
    m = request.param
    cases = _cases(m)
    ranks = testing.run_cluster(matmul_rs_worker, np=m, device="cpu",
                                args=(cases,), timeout=300)
    return m, cases, ranks


def test_matmul_reduce_scatter_matches_reference(ring, monkeypatch):
    """Rank p holds chunk p of the dense sum; the port's ring agrees with
    the reference's ring (interpret mode), with the dense sum and with its
    own unfused reference; K10's wrapper runs m times a call where the chunk
    tiles and never where it does not."""
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    m, cases, ranks = ring
    for name in ("aligned", "bf16 aligned", "unaligned"):
        dtype = "bfloat16" if name.startswith("bf16") else "float32"
        x, w = cases[name]
        xr = torch.from_numpy(x).to(TORCH[dtype]).float().numpy()
        wr = torch.from_numpy(w).to(TORCH[dtype]).float().numpy()
        rows, kl = x.shape[1:]
        c = rows // m
        parts = [xr[r].astype(np.float64) @ wr[r] for r in range(m)]
        dense = sum(parts)
        tol = (2 * m * UNIT[dtype] * sum(np.abs(q) for q in parts)
               + 2 * kl * 2.0 ** -24
               * sum(_abs_product(xr[r], wr[r]) for r in range(m)))
        want = _jax_ring(pk.matmul_reduce_scatter, x, w, m, dtype)
        tiled = pk.matmul_tiles(c, kl, w.shape[2]) is not None
        for p, rank in enumerate(ranks):
            got = rank[name]
            assert got["dtype"] == str(TORCH[dtype])
            assert got["calls"] == (m if tiled else 0), name
            chunk = slice(p * c, (p + 1) * c)
            for out in (got["ring"], got["ref"]):
                assert out.shape == (c, w.shape[2])
                assert (np.abs(out - dense[chunk]) <= tol[chunk]).all(), name
            assert (np.abs(got["ring"] - want[p]) <= 2 * tol[chunk]).all()
            # a ring whose last hop dropped its partial (rank p's own) fails
            dropped = got["ring"] - parts[p][chunk]
            assert not (np.abs(dropped - dense[chunk]) <= tol[chunk]).all()


def test_rows_not_divisible_take_the_reference(ring):
    """R % m != 0 routes to the unfused reference, whose tiled
    reduce-scatter refuses it, as the reference's ``psum_scatter`` does."""
    m, cases, ranks = ring
    x, w = cases["rows not divisible"]
    for rank in ranks:
        assert "do not split" in rank["rows not divisible"]["error"]
    with pytest.raises(ValueError, match="divisible"):
        _jax_ring(pk.matmul_reduce_scatter_reference, x, w, m, "float32")


def test_matmul_reduce_scatter_is_forward_only(ring):
    for rank in ring[2]:
        assert "forward only" in rank["grad"]


def test_parallel_modules_import_no_jax():
    """A fresh interpreter importing the port's parallel package, the
    fused ring and the weight converter loads no jax and no module of the
    reference package."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    code = ("import json, sys; import horovod_tpu_torch.parallel, "
            "horovod_tpu_torch.parallel.hybrid, horovod_tpu_torch.ops.matmul, "
            "horovod_tpu_torch.models.convert; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "horovod_tpu_torch.parallel.tensor" in mods
    assert not [m for m in mods if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "horovod_tpu")]


def test_signatures_match_the_c_prototypes():
    """Each ctypes signature declares as many arguments as its C function
    in ``csrc/`` takes (the launchers' last one the stream): one too few
    passes the stream as a 32-bit int. Each argument's type matches too: a
    pointer is ``c_void_p``, an ``int64_t`` ``c_int64``, an ``int``
    ``c_int`` and a ``float`` ``c_float`` (a 64-bit stride declared as an
    int would be cut to 32 bits). The Hopper attention launchers are among
    them."""
    import ctypes
    import re
    from pathlib import Path

    csrc = Path(ck.__file__).resolve().parent.parent / "csrc"
    assert {"hvd_flash_fwd_sm90", "hvd_flash_bwd_sm90"} <= set(ck._SIGNATURES)

    def ctype(param: str):
        if "*" in param:
            return ctypes.c_void_p
        for c_name, t in (("int64_t", ctypes.c_int64),
                          ("float", ctypes.c_float), ("int", ctypes.c_int)):
            if re.search(r"\b%s\b" % c_name, param):
                return t
        raise AssertionError(f"unknown C type in {param!r}")

    for name, (library, argtypes, _) in ck._SIGNATURES.items():
        src = (csrc / f"{library}.cu").read_text()
        proto = re.search(r"\b%s\(([^)]*)\)" % name, src)
        assert proto, name
        params = [a for a in proto.group(1).split(",") if a.strip()]
        assert len(argtypes) == len(params), name
        assert [ctype(a) for a in params] == list(argtypes), name
