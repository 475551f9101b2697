"""The port's wire-compression kernels (horovod_tpu_torch/ops/cuda_kernels.py)
against the reference Pallas kernels.

On the CPU each wrapper runs its plain-PyTorch twin, so these tests hold the
twins byte-equal to the Pallas kernels (run in interpret mode, as
tests/test_pallas.py runs them) and to their jnp ``_ref`` formulas. The CUDA
kernels themselves are held against the same twins on the card by
``chip_smoke.py``. Reference arrays are cast to f32 because the test
platform enables x64.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import cuda_kernels as ck

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    ck.reset_launch_counts()
    yield


def _matrix(case: str, qmax: int) -> np.ndarray:
    """f32 rows for one named edge case (values exact in bf16 for 'bf16')."""
    rows, block = (5, 100) if case == "ragged" else (8, 256)
    rng = np.random.RandomState(len(case) * 31 + qmax)
    x = (rng.randn(rows, block)
         * 10.0 ** rng.uniform(-3, 2, (rows, 1))).astype(np.float32)
    if case == "zero_row":
        x[0] = 0.0
        x[3] = 0.0
    elif case == "ties":
        # absmax == qmax makes the scale exactly 1.0 (checked below), so
        # x / scale lands on exact .5 ties; half-to-even must round them
        ties = (np.arange(block) % (2 * qmax) - qmax + 0.5).astype(np.float32)
        ties[0], ties[1] = qmax, -qmax
        x[1], x[2] = ties, -ties
    elif case == "clip":
        x[4, ::2] = 3.0
        x[4, 1::2] = -3.0          # every value at +-absmax -> +-qmax
        x[5, 7] = -1e4             # one dominant value: the rest round small
    elif case == "bf16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _inputs(case: str, qmax: int):
    """(torch tensor for the port, jnp array for the reference)."""
    x = _matrix(case, qmax)
    if case == "bf16":
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))
    return torch.from_numpy(x), jnp.asarray(x, jnp.float32)


def _np(a) -> np.ndarray:
    return np.asarray(a)


def _tiles(x) -> bool:
    rows, block = x.shape
    return rows % 8 == 0 and block % 128 == 0


CASES = ["zero_row", "ties", "clip", "bf16", "ragged"]


@pytest.mark.parametrize("case", CASES)
def test_int8_quantize_twin_matches_pallas(case):
    xt, xj = _inputs(case, 127)
    q, s = ck.int8_quantize_2d(xt)
    assert q.dtype == torch.int8 and s.shape == (xt.shape[0], 1)
    if _tiles(xt):
        qk, sk = pk.int8_quantize_2d(xj)
        np.testing.assert_array_equal(q.numpy(), _np(qk))
        np.testing.assert_array_equal(s.numpy().view(np.int32),
                                      _np(sk).view(np.int32))
    # the jnp formula of the reference (its non-kernel path)
    from horovod_tpu.ops import compression as comp

    qr, sr = comp.quantize_blocks(xj.reshape(-1), xt.shape[1])
    np.testing.assert_array_equal(q.numpy().reshape(-1), _np(qr))
    np.testing.assert_array_equal(s.numpy()[:, 0].view(np.int32),
                                  _np(sr).view(np.int32))
    if case == "ties":
        assert float(s[1]) == 1.0
        # numpy's rint rounds half to even; round-half-away would differ
        half = _matrix(case, 127)[1]
        np.testing.assert_array_equal(q[1].numpy()[2:],
                                      np.rint(half[2:]).astype(np.int8))
    assert ck.launch_counts()["int8_quantize_2d"] == 0


@pytest.mark.parametrize("case", CASES)
def test_int8_dequantize_twin_matches_pallas(case):
    xt, xj = _inputs(case, 127)
    q, s = ck.int8_quantize_2d(xt)
    y = ck.int8_dequantize_2d(q, s)
    assert y.dtype == torch.float32
    if _tiles(xt):
        yk = pk.int8_dequantize_2d(jnp.asarray(q.numpy()),
                                   jnp.asarray(s.numpy()))
        np.testing.assert_array_equal(y.numpy().view(np.int32),
                                      _np(yk).view(np.int32))
    ref = q.numpy().astype(np.float32) * s.numpy()
    np.testing.assert_array_equal(y.numpy(), ref)
    assert ck.launch_counts()["int8_dequantize_2d"] == 0


@pytest.mark.parametrize("case", CASES)
def test_int8_quantize_pack_twin_matches_pallas(case):
    xt, xj = _inputs(case, 127)
    p = ck.int8_quantize_pack_2d(xt)
    assert p.shape == (xt.shape[0], xt.shape[1] + ck.PACK_SCALE_BYTES)
    np.testing.assert_array_equal(p.numpy(), _np(pk.int8_quantize_pack_ref(xj)))
    if _tiles(xt):
        np.testing.assert_array_equal(p.numpy(),
                                      _np(pk.int8_quantize_pack_2d(xj)))
    # the packed payload is the unpacked quantizer's
    q, s = ck.int8_quantize_2d(xt)
    qu, su = ck.int8_unpack(p)
    np.testing.assert_array_equal(qu.numpy(), q.numpy())
    np.testing.assert_array_equal(su.numpy(), s.numpy())
    assert ck.launch_counts()["int8_quantize_pack_2d"] == 0


@pytest.mark.parametrize("case", CASES)
def test_int4_quantize_pack_twin_matches_pallas(case):
    xt, xj = _inputs(case, 7)
    p = ck.int4_quantize_pack_2d(xt)
    assert p.shape == (xt.shape[0], xt.shape[1] // 2 + ck.PACK_SCALE_BYTES)
    np.testing.assert_array_equal(p.numpy(), _np(pk.int4_quantize_pack_ref(xj)))
    if xt.shape[0] % 8 == 0 and xt.shape[1] % 256 == 0:
        np.testing.assert_array_equal(p.numpy(),
                                      _np(pk.int4_quantize_pack_2d(xj)))
    q, s = ck.int4_unpack(p)
    assert int(q.abs().max()) <= 7
    if case == "ties":
        assert float(s[1]) == 1.0
        half = _matrix(case, 7)[1]
        np.testing.assert_array_equal(q[1].numpy()[2:],
                                      np.rint(half[2:]).astype(np.int8))
    assert ck.launch_counts()["int4_quantize_pack_2d"] == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_unpack_matches_reference_and_roundtrips(bits):
    xt, xj = _inputs("zero_row", 127 if bits == 8 else 7)
    if bits == 8:
        p = ck.int8_quantize_pack_2d(xt)
        q, s = ck.int8_unpack(p)
        qr, sr = pk.int8_unpack(jnp.asarray(p.numpy()))
        qmax = 127
    else:
        p = ck.int4_quantize_pack_2d(xt)
        q, s = ck.int4_unpack(p)
        qr, sr = pk.int4_unpack(jnp.asarray(p.numpy()))
        qmax = 7
    np.testing.assert_array_equal(q.numpy(), _np(qr))
    np.testing.assert_array_equal(s.numpy(), _np(sr))
    # dequantized values sit within half a step of the input
    y = q.float() * s
    bound = xt.abs().amax(dim=1, keepdim=True) / (2 * qmax) * (1 + 1e-6)
    assert bool(((y - xt).abs() <= bound + 1e-30).all())


def test_nan_row_pins_only_the_scale():
    x = _matrix("zero_row", 127)
    x[2, 5] = np.nan
    q, s = ck.int8_quantize_2d(torch.from_numpy(x))
    _, sr = pk.int8_quantize_2d(jnp.asarray(x))
    assert np.isnan(s[2].item()) and np.isnan(_np(sr)[2, 0])
    keep = [0, 1, 3, 4, 5, 6, 7]
    np.testing.assert_array_equal(s.numpy()[keep], _np(sr)[keep])


def test_cpu_tensor_takes_twin_and_counts_nothing():
    xt, _ = _inputs("clip", 127)
    q, s = ck.int8_quantize_2d(xt)
    ck.int8_dequantize_2d(q, s)
    ck.int8_quantize_pack_2d(xt)
    ck.int4_quantize_pack_2d(xt)
    assert ck.launch_counts() == {w.__name__: 0 for w in ck.WRAPPERS}
    assert _build._libs == {}  # no kernel library was loaded for the CPU


@pytest.mark.parametrize("bad", ["dtype", "rank", "contiguity", "odd_int4",
                                 "scale_shape"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    x = torch.zeros(8, 256)
    if bad == "dtype":
        with pytest.raises(TypeError):
            ck.int8_quantize_2d(x.double())
    elif bad == "rank":
        with pytest.raises(ValueError):
            ck.int8_quantize_pack_2d(x.reshape(-1))
    elif bad == "contiguity":
        with pytest.raises(ValueError, match="contiguous"):
            ck.int4_quantize_pack_2d(torch.zeros(256, 8).t())
    elif bad == "odd_int4":
        with pytest.raises(ValueError, match="even"):
            ck.int4_quantize_pack_2d(torch.zeros(4, 129))
    else:
        q, s = ck.int8_quantize_2d(x)
        with pytest.raises(ValueError):
            ck.int8_dequantize_2d(q, s[:4])


# leaf lengths of a step's kinds: whole blocks (rows that tile for the
# Pallas kernel at block 256), a ragged tail, one short block, 8 rows + 3
LEAF_SIZES = (256 * 8, 1000, 7, 256 * 16 + 3)


def _leaves(seed: int):
    """f32 numpy leaves, magnitudes spread over four decades."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
            for n in LEAF_SIZES]


@pytest.mark.parametrize("case", ["f32-256", "bf16-256", "f32-100"])
def test_int8_quantize_many_twin_matches_reference_per_leaf(case):
    """The many-leaf quantize's twin, leaf by leaf, against the reference:
    its dequantized rows cut to the leaf equal ``quantize_roundtrip`` (the
    Pallas kernels in interpret mode where the padded leaf tiles) bit for
    bit in f32, and its q and scales equal ``int8_quantize_2d``'s where
    the padded leaf tiles for it."""
    from horovod_tpu.ops import compression as ref_comp

    dtype, block = case.split("-")
    block = int(block)
    leaves = _leaves(block)
    if dtype == "bf16":  # values exact in bf16, so f32 references agree
        leaves = [torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                  for x in leaves]
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, s = ck.int8_quantize_2d_many(
        [torch.from_numpy(x).to(tdt) for x in leaves], block)
    assert q.shape == (sum(-(-x.size // block) for x in leaves), block)
    row = 0
    for x in leaves:
        n, rows = x.size, -(-x.size // block)
        qi, si = q[row:row + rows], s[row:row + rows]
        got = (qi.float() * si).reshape(-1)[:n].numpy()
        want = np.asarray(ref_comp.quantize_roundtrip(jnp.asarray(x),
                                                      block=block))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.astype(np.float32).view(np.int32))
        if pk.int8_supported(rows, block):
            padded = np.zeros(rows * block, np.float32)
            padded[:n] = x
            qk, sk = pk.int8_quantize_2d(jnp.asarray(padded.reshape(rows,
                                                                    block)))
            np.testing.assert_array_equal(qi.numpy(), _np(qk))
            np.testing.assert_array_equal(si.numpy().view(np.int32),
                                          _np(sk).view(np.int32))
        row += rows
    assert ck.launch_counts()["int8_quantize_2d"] == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_roundtrip_many_equals_per_leaf(bits):
    """``quantize_roundtrip_many`` equals ``quantize_roundtrip`` leaf by
    leaf, bit for bit, in each leaf's shape and dtype: f32 leaves of a
    step's kinds, a 2-D one, a transposed view, bf16, f16 and f64 leaves,
    an all-zero and an empty one; ``Compression.int8/int4.roundtrip_many``
    does too and passes an integer tensor through."""
    from horovod_tpu_torch.ops import compression as comp

    leaves = [torch.from_numpy(x) for x in _leaves(bits)]
    rng = np.random.RandomState(bits + 1)
    leaves += [torch.from_numpy(rng.randn(37, 11).astype(np.float32)),
               torch.from_numpy(rng.randn(9, 40).astype(np.float32)).t(),
               torch.from_numpy(rng.randn(700).astype(np.float32)).to(
                   torch.bfloat16),
               torch.from_numpy(rng.randn(300).astype(np.float32)).half(),
               torch.from_numpy(rng.randn(5, 5)),
               torch.zeros(300), torch.zeros(0)]
    got = comp.quantize_roundtrip_many(leaves, bits=bits)
    compressor = comp.Compression.int8 if bits == 8 else comp.Compression.int4
    via = compressor.roundtrip_many(leaves + [torch.arange(5)])
    assert torch.equal(via[-1], torch.arange(5))
    for t, g, v in zip(leaves, got, via):
        want = comp.quantize_roundtrip(t, bits=bits)
        for y in (g, v):
            assert y.dtype == t.dtype and y.shape == t.shape
            assert torch.equal(y.reshape(-1).double(),
                               want.reshape(-1).double())
    assert ck.launch_counts()["int8_quantize_2d"] == 0


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "device", "block",
                                 "not_a_tensor"])
def test_int8_quantize_many_rejects_what_the_kernel_does_not_take(bad):
    ok = torch.zeros(300)
    args = {"dtype": ([ok, torch.zeros(3, dtype=torch.float64)], 256),
            "contiguity": ([ok, torch.zeros(8, 4).t()], 256),
            "device": ([ok, torch.zeros(3, device="meta")], 256),
            "block": ([ok], 1),
            "not_a_tensor": ([ok, np.zeros(3, np.float32)], 256)}[bad]
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        ck.int8_quantize_2d_many(*args)


def test_modules_import_and_build_needs_nvcc(monkeypatch, tmp_path):
    """cuda_kernels and _build import with no nvcc (none is installed on
    the test platform); only building a kernel asks for it."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("an nvcc is installed at /usr/local/cuda on this machine")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    assert _build.library_path("wire_quant").parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == ROOT / "build" / "torch_kernels"


def test_library_path_hashes_the_included_headers(monkeypatch, tmp_path):
    """A build is named by its source, every csrc header that source
    includes (through another header too) and the flags: editing an
    included header names another library, so no stale build is loaded;
    editing a header nothing includes does not. No nvcc is needed."""
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n #include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b, first version\n")
    (tmp_path / "other.cuh").write_text("// included by nothing\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, second version\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    assert _build.library_path("k") not in (first, second)


@pytest.mark.parametrize("name", ["matmul", "flash_attention_sm90",
                                  "layer_norm"])
def test_sources_share_the_sm90_header(name):
    """Only the sources on Hopper's TMA -- the wgmma ones and the Adasum
    combine's bulk loads -- take their helpers from csrc/sm90.cuh, so its
    bytes are part of their libraries' hash; the LayerNorm source and the
    others include no csrc header, so an edit of those helpers rebuilds
    none of them."""
    headers = [] if name == "layer_norm" else ["sm90.cuh"]
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu"] + headers
    assert [p.name for p in _build.sources("adasum")] == ["adasum.cu",
                                                          "sm90.cuh"]
    for other in ("wire_quant", "flash_attention", "adamw"):
        assert [p.name for p in _build.sources(other)] == [f"{other}.cu"]


def test_import_hygiene_no_jax_no_reference():
    """A fresh interpreter importing the port (and its trainer) loads no
    jax and no module of the reference package; the sources say so too."""
    code = ("import json, sys; import horovod_tpu_torch, "
            "horovod_tpu_torch.train, horovod_tpu_torch.testing, "
            "horovod_tpu_torch.spmd, horovod_tpu_torch.data, "
            "horovod_tpu_torch.callbacks, horovod_tpu_torch.models; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                  "optax", "horovod_tpu")]
    assert not bad, bad
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+horovod_tpu"
                         r"(\s|\.|$)|from\s+horovod_tpu(\s|\.))", re.M)
    files = sorted((ROOT / "horovod_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
