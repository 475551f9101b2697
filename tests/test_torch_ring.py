"""The port's ring attention and Ulysses attention
(``horovod_tpu_torch/parallel``) and the kernels under them, against the
reference on the CPU.

* ``flash_attention_step_plain`` (the twin of kernel K6) against the
  reference's ``pallas_kernels.flash_attention_step`` in interpret mode,
  on its resident kernel and forced onto its streaming kernel,
  over chained hops of a causal and a full ring, a fully masked hop
  included;
* ``flash_attention_bwd_plain`` with f32 outputs at hop offsets (the twin
  of K7 as the ring's backward runs it) against ``pallas_kernels._flash_bwd``
  forced onto the streaming branch of ``_flash_bwd_hm``;
* ``ring_attention`` on 2 and 4 gloo ranks (``testing.run_cluster(...,
  device="cpu")``, one cluster per world size) against ``make_ring_attention``
  on as many JAX CPU devices with the Pallas path in interpret mode, and
  against plain full attention; ``ulysses_attention`` on 4 ranks against
  ``make_ulysses_attention``.

Tolerances, f32:
* the step's carry: m to 2e-6 absolute (natural units, values up to ~3;
  kernel and twin convert to base 2 and back once, the streaming reference
  once per tile), l to 2e-6 of its value, o to 2e-6 of its largest
  |value| (the two sum 64 to 192 terms in different orders); measured:
  m equal, l 2.7e-7, o 1.9e-7;
* the hop backward: 1e-5 of each gradient's largest |value| (measured at
  most 5.1e-7); a hop past the last q row gives exact zeros on both;
* ring and Ulysses attention: 3e-4 absolute on outputs and gradients, the
  bar ``tests/test_pallas.py`` holds the reference's ring to (measured at
  most 9.7e-7 against the reference's ring, 2.9e-6 against plain
  attention, 8.3e-7 for the plain ring against the reference's jnp ring,
  2.6e-6 for Ulysses).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch import testing
from horovod_tpu_torch.ops import cuda_kernels as ck
from torch_parallel_workers import attention_inputs, attention_worker

# the package's names shadow these two modules
ref_ring = importlib.import_module("horovod_tpu.parallel.ring_attention")
ref_seq = importlib.import_module("horovod_tpu.parallel.sequence")
M_ATOL, L_REL, O_REL = 2e-6, 2e-6, 2e-6
BWD_REL = 1e-5
RING_ATOL = 3e-4
T, H, D = 64, 2, 64  # one hop's block


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    ck.reset_launch_counts()
    yield


def _blocks(seed, n=4, t=T):
    """q, k, v, dO of a 3-block sequence [1, 3t, H, D] f32."""
    rng = np.random.RandomState(seed)
    return [rng.randn(1, 3 * t, H, D).astype(np.float32) for _ in range(n)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ------------------------------------------------------------------ K6
@pytest.mark.parametrize("streaming", [False, True],
                         ids=["resident", "streaming"])
@pytest.mark.parametrize("causal", [True, False])
def test_step_twin_matches_pallas_over_chained_hops(streaming, causal,
                                                    monkeypatch):
    """Rank 1 of a 3-rank ring: q block 1 against k/v blocks 1 (the
    diagonal), 0 (below it) and 2 (above it: fully masked when causal),
    the carry chained from hop to hop on both sides."""
    if streaming:
        monkeypatch.setattr(pk, "_KV_VMEM_CAP", 1)
    q, k, v, _ = _blocks(1)
    scale = D ** -0.5
    qb = q[:, T:2 * T]
    m = np.full((1, H, T), -np.inf, np.float32)
    l = np.zeros((1, H, T), np.float32)
    o = np.zeros((1, T, H, D), np.float32)
    carry = [torch.from_numpy(x.copy()) for x in (m, l, o)]
    ref = [jnp.asarray(x) for x in (m, l, o)]
    for src in (1, 0, 2):
        kb, vb = (x[:, src * T:(src + 1) * T] for x in (k, v))
        before = [c.clone() for c in carry]
        got = ck.flash_attention_step(
            *map(torch.from_numpy, (qb, kb, vb)), *carry, causal=causal,
            scale=scale, q_off=T, k_off=src * T)
        assert all(g is c for g, c in zip(got, carry))  # in place
        ref = pk.flash_attention_step(
            *map(jnp.asarray, (qb, kb, vb)), *ref, T, src * T,
            causal=causal, scale=scale)
        gm, gl, go = (c.numpy() for c in carry)
        rm, rl, ro = (np.asarray(r) for r in ref)
        assert np.array_equal(np.isinf(gm), np.isinf(rm))
        finite = np.isfinite(rm)
        assert np.abs(gm[finite] - rm[finite]).max() <= M_ATOL
        assert np.all(np.abs(gl - rl) <= L_REL * np.abs(rl))
        assert _rel(go, ro) <= O_REL
        if causal and src == 2:  # no key visible: the carry stays, bits
            assert all(torch.equal(b, c) for b, c in zip(before, carry))
    assert ck.launch_counts()["flash_attention_step"] == 0  # CPU: the twin


def test_step_twin_keeps_m_of_rows_the_hop_does_not_raise():
    """A row whose maximum the hop leaves where it was keeps its m bit
    for bit (no round trip through base 2)."""
    q, k, v, _ = [torch.from_numpy(x) for x in _blocks(2)]
    m = torch.full((1, H, T), 50.0)  # far above any logit of the hop
    l = torch.ones((1, H, T))
    o = torch.zeros((1, T, H, D))
    mn, _, _ = ck.flash_attention_step_plain(
        q[:, :T], k[:, :T], v[:, :T], m, l, o, causal=False, scale=0.125)
    assert torch.equal(mn, m)


def test_step_wrapper_checks_the_carry():
    q = torch.zeros(1, T, H, D)
    m, l = torch.zeros(1, H, T), torch.zeros(1, H, T)
    with pytest.raises(ValueError, match="o must be a contiguous f32"):
        ck.flash_attention_step(q, q, q, m, l,
                                torch.zeros(1, H, T, D).transpose(1, 2))
    with pytest.raises(ValueError, match="m must be a contiguous f32"):
        ck.flash_attention_step(q, q, q, m.double(), l, torch.zeros_like(q))


def test_finalize_matches_reference():
    rng = np.random.RandomState(3)
    m = rng.randn(1, H, T).astype(np.float32)
    m[0, 0, :4] = -np.inf
    l = np.abs(rng.randn(1, H, T)).astype(np.float32)
    l[0, 0, :4] = 0
    o = rng.randn(1, T, H, D).astype(np.float32)
    o[0, :4, 0] = 0  # what a row that saw no key carries
    out, lse = ck.finalize_attention_stats(*map(torch.from_numpy, (m, l, o)),
                                           torch.float32)
    rout, rlse = pk.finalize_attention_stats(*map(jnp.asarray, (m, l, o)),
                                             jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), rtol=1e-6,
                               atol=1e-7)
    assert not out[:, :4, 0].any() and not lse[0, 0, :4].any()


# ------------------------------------------------------------------ K7
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("src", [1, 0, 2], ids=["diagonal", "below", "above"])
def test_hop_backward_twin_matches_streaming_pallas(causal, src,
                                                    monkeypatch):
    """Rank 1's hop against block src, f32 gradients, with the global LSE
    of q block 1 over the whole sequence."""
    monkeypatch.setenv("HVD_PALLAS_FUSED_BWD", "0")
    monkeypatch.setattr(pk, "_BWD_RESIDENT_CAP", 1)
    q, k, v, do = _blocks(4)
    scale = D ** -0.5
    qb, dob = q[:, T:2 * T], do[:, T:2 * T]
    kb, vb = (x[:, src * T:(src + 1) * T] for x in (k, v))
    out, lse = ck.flash_attention_fwd_plain(
        *map(torch.from_numpy, (qb, k, v)), causal=causal, scale=scale,
        q_off=T, k_off=0)
    dd = (torch.from_numpy(dob) * out).sum(-1).transpose(1, 2).contiguous()
    got = ck.flash_attention_bwd(
        *map(torch.from_numpy, (qb, kb, vb, dob)), lse, dd, causal=causal,
        scale=scale, out_dtype=torch.float32, q_off=T, k_off=src * T)
    want = pk._flash_bwd(*map(jnp.asarray, (qb, kb, vb, out.numpy(),
                                            lse.numpy(), dob)),
                         T, src * T, causal=causal, scale=scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        if causal and src == 2:
            assert not g.any() and not w.any()
        else:
            assert _rel(g.numpy(), w) <= BWD_REL
    assert ck.launch_counts()["flash_attention_bwd"] == 0


# ------------------------------------------------- ring / Ulysses clusters
@pytest.fixture(scope="module")
def port2():
    return testing.run_cluster(attention_worker, np=2, device="cpu",
                               args=(2,), timeout=300)


@pytest.fixture(scope="module")
def port4():
    return testing.run_cluster(attention_worker, np=4, device="cpu",
                               args=(4,), timeout=300)


def _jax_grads(fn, q, k, v, w):
    qkv = tuple(map(jnp.asarray, (q, k, v)))
    out, vjp = jax.vjp(fn, *qkv)
    return [np.asarray(out)] + [np.asarray(g)
                                for g in vjp(jnp.asarray(w))]


def _mesh(world):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:world]), ("sp",))


def _assert_ranks_close(port, key, want):
    for rank in port:  # every rank holds the whole output and gradients
        for got, ref in zip(rank[key], want):
            np.testing.assert_allclose(got, ref, rtol=0, atol=RING_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_matches_reference(world, causal, port2, port4):
    port = port2 if world == 2 else port4
    q, k, v, w = attention_inputs(world)
    fn = ref_ring.make_ring_attention(_mesh(world), causal=causal)
    want = _jax_grads(fn, q, k, v, w)
    _assert_ranks_close(port, ("ring", causal), want)
    plain = _jax_grads(lambda q, k, v: ref_ring.reference_attention(
        q, k, v, causal=causal), q, k, v, w)
    _assert_ranks_close(port, ("ring", causal), plain)
    for rank in port:  # CPU tensors: the kernels' twins ran
        assert not any(rank["launches"].values())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", [2, 4])
def test_plain_ring_matches_reference(world, causal, port2, port4):
    """The plain per-hop step ``_block_attn``, differentiated through the
    forward ring ``_ring_fwd_stats``, against the reference's jnp ring."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    port = port2 if world == 2 else port4
    q, k, v, w = attention_inputs(world)
    spec = P(None, "sp")
    fn = jax.jit(jax.shard_map(
        partial(ref_ring.ring_attention, causal=causal, use_pallas=False),
        mesh=_mesh(world), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False))
    _assert_ranks_close(port, ("plain", causal), _jax_grads(fn, q, k, v, w))


def test_ulysses_matches_reference(port4):
    q, k, v, w = attention_inputs(4)
    fn = ref_seq.make_ulysses_attention(_mesh(4), causal=True)
    _assert_ranks_close(port4, ("ulysses", True), _jax_grads(fn, q, k, v, w))
    for rank in port4:
        assert "head count (2)" in rank["heads"]
