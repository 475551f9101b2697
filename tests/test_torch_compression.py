"""The port's compression module (horovod_tpu_torch/ops/compression.py) and
its wire byte accounting against the reference's.

Quantized payloads, scales and roundtrips are held byte-equal to
``horovod_tpu.ops.compression`` (Pallas kernels in interpret mode where the
reference takes them); the footprint and layout catalogs must return the
same integers.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import compression as ref_comp
from horovod_tpu.runtime.executor import Executor as RefExecutor
from horovod_tpu_torch.ops import compression as comp
from horovod_tpu_torch.ops import cuda_kernels as ck
from horovod_tpu_torch.runtime.executor import Executor


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    monkeypatch.delenv("HOROVOD_INT8_BLOCK", raising=False)
    monkeypatch.delenv("HOROVOD_COMPRESSION", raising=False)
    yield


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * 10.0 ** rng.uniform(-2, 1)).astype(np.float32)


@pytest.mark.parametrize("bits,n,block", [(8, 2048, 256), (8, 1000, 100),
                                          (4, 2048, 256), (4, 1024, 128)])
def test_quantize_blocks_matches_reference(bits, n, block):
    x = _data(n, seed=bits + n)
    q, s = comp.quantize_blocks(torch.from_numpy(x), block, bits=bits)
    qr, sr = ref_comp.quantize_blocks(jnp.asarray(x), block, bits=bits)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(sr, np.float32).view(np.int32))
    y = comp.dequantize_blocks(q, s, block=block)
    yr = ref_comp.dequantize_blocks(qr, sr, block=block)
    np.testing.assert_array_equal(y.numpy(), np.asarray(yr, np.float32))


def test_quantize_blocks_rejects_bad_input():
    with pytest.raises(ValueError, match="bits"):
        comp.quantize_blocks(torch.zeros(256), 256, bits=5)
    with pytest.raises(ValueError, match="multiple"):
        comp.quantize_blocks(torch.zeros(300), 256)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(1000,), (3, 7, 11), (64, 64)])
def test_quantize_roundtrip_matches_reference(bits, shape):
    x = _data(int(np.prod(shape)), seed=len(shape)).reshape(shape)
    y = comp.quantize_roundtrip(torch.from_numpy(x), bits=bits)
    yr = ref_comp.quantize_roundtrip(jnp.asarray(x), bits=bits)
    assert tuple(y.shape) == shape and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(yr, np.float32))


@pytest.mark.parametrize("name", ["none", "fp16", "bf16", "int8", "int4"])
def test_compressor_roundtrip_matches_reference(name):
    x = _data(3000, seed=5)
    y = comp.by_name(name).roundtrip(torch.from_numpy(x))
    yr = ref_comp.by_name(name).roundtrip(jnp.asarray(x))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(yr, np.float32))
    # integers pass the wire compressors unchanged
    i = torch.arange(10, dtype=torch.int32)
    assert torch.equal(comp.by_name(name).roundtrip(i), i)


def test_cast_compressor_dtypes():
    t = torch.ones(4)
    c, ctx = comp.Compression.bf16.compress(t)
    assert c.dtype == torch.bfloat16 and ctx == torch.float32
    assert comp.Compression.bf16.decompress(c, ctx).dtype == torch.float32
    c, ctx = comp.Compression.int8.compress(t)
    assert c is t and comp.Compression.int8.wire == "int8"
    assert comp.Compression.int4.wire == "int4"


def test_by_name_and_env(monkeypatch):
    for name in ("none", "fp16", "bf16", "int8", "int4", "", " INT8 "):
        mine, ref = comp.by_name(name), ref_comp.by_name(name)
        assert mine.__name__ == ref.__name__
        assert mine.wire == ref.wire
    with pytest.raises(ValueError, match="unknown compression"):
        comp.by_name("int3")
    assert comp.from_env() is comp.NoneCompressor
    monkeypatch.setenv("HOROVOD_COMPRESSION", "int4")
    assert comp.from_env() is comp.Int4Compressor
    monkeypatch.setenv("HOROVOD_INT8_BLOCK", "128")
    assert comp.block_size() == 128
    monkeypatch.setenv("HOROVOD_INT8_BLOCK", "0")
    with pytest.raises(ValueError):
        comp.block_size()


FOOTPRINT_GRID = list(itertools.product(
    [1, 255, 256, 5000, 65537], ["none", "fp32", "fp16", "bf16", "int8",
                                 "int4"], [None, 2, 100, 256]))


@pytest.mark.parametrize("n,mode,block", FOOTPRINT_GRID[::3])
def test_wire_footprint_equals_reference(n, mode, block):
    assert comp.wire_footprint(n, mode, block) == ref_comp.wire_footprint(
        n, mode, block)


def test_wire_footprint_full_grid_and_unknown_mode():
    for n, mode, block in FOOTPRINT_GRID:
        assert comp.wire_footprint(n, mode, block) == \
            ref_comp.wire_footprint(n, mode, block), (n, mode, block)
    with pytest.raises(ValueError):
        comp.wire_footprint(10, "int3")


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_wire_layout_equals_reference(world, bits):
    for n, block in itertools.product([1, 100, 1024, 5000, 65537],
                                      [None, 2, 100, 256]):
        assert Executor.quantized_wire_layout(n, world, block, bits) == \
            RefExecutor.quantized_wire_layout(n, world, block, bits), \
            (n, world, block, bits)


def test_effective_wire_bypass_rules(monkeypatch):
    ex = Executor(2, "gloo")
    assert ex.effective_wire("int8", torch.float32, 5000) == "int8"
    assert ex.effective_wire("int4", torch.bfloat16, 5000) == "int4"
    assert ex.effective_wire(None, torch.float32, 5000) == ""
    assert ex.effective_wire("int8", torch.int32, 5000) == ""
    assert ex.effective_wire("int8", torch.float32, 1023) == ""
    assert Executor(1, None).effective_wire(
        "int8", torch.float32, 5000) == ""
    monkeypatch.setenv("HOROVOD_COMPRESSION_MIN_SIZE", "10")
    assert ex.effective_wire("int8", torch.float32, 100) == "int8"
    monkeypatch.setenv("HOROVOD_INT8_BLOCK", "255")
    assert ex.effective_wire("int4", torch.float32, 5000) == "int8"


def test_world1_allreduce_is_a_copy_with_wire_accounting():
    ex = Executor(1, None)
    x = torch.arange(5000, dtype=torch.float32)
    out = ex.allreduce(x, average=True, wire="int8")
    assert torch.equal(out, x) and out is not x
    assert ex.last_wire_mode == "" and ex.last_wire_bytes == 2 * 5000 * 4
    assert ck.launch_counts()["int8_quantize_2d"] == 0
