"""The port's flash attention (K5 forward, K7 backward:
``horovod_tpu_torch/ops/attention.py`` over ``ops/cuda_kernels.py``)
against the reference's Pallas kernels.

On the CPU the wrappers run their plain twins, so these tests hold the twins
to the Pallas kernels, run in interpret mode as ``tests/test_pallas.py``
runs them, with 64-row tiles so that the reference walks several tiles.
Inputs come from numpy seeds and reach both sides as the same f32 (or bf16)
values.

Tolerances (f32):
* out and lse: 2e-6 absolute (out is O(1), lse O(1-10); the two sum ~256
  terms in different orders and take exp2 against exp: measured <= 5e-7);
* gradients: 1e-4 absolute and relative, as ``tests/test_pallas.py``
  holds the reference's kernel to plain attention (measured <= 3e-6).
bf16 (operands rounded to bf16 on both sides, p and dS rounded before their
products): 2^-6 of each tensor's largest |value|, the kernels' own bound
on the card.

Which source a call on the card would launch is a pure function of the
operands' dtype, the head dim and the gradients' dtype, pinned here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import cuda_kernels as ck
from horovod_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_plain)

SHAPE = (2, 256, 2, 64)
F32_OUT_ATOL = 2e-6
F32_GRAD_TOL = 1e-4
BF16_REL = 2.0 ** -6


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    monkeypatch.setenv("HVD_PALLAS_BLOCK_Q", "64")
    monkeypatch.setenv("HVD_PALLAS_BLOCK_K", "64")
    ck.reset_launch_counts()
    yield


def _arrays(seed, shape=SHAPE, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _heads_major(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _close_rel(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(a).max(), np.abs(b).max())
    assert np.abs(a - b).max() <= rel * scale, (np.abs(a - b).max(), scale)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_matches_reference(causal):
    q, k, v, _ = _arrays(1)
    b, t, h, d = SHAPE
    out, lse = ck.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    ref = pk.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=F32_OUT_ATOL)
    _, ref_lse = pk._flash_fwd_once_call(
        _heads_major(q), _heads_major(k), _heads_major(v),
        jnp.zeros((2,), jnp.int32), causal=causal, scale=d ** -0.5,
        block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(b, h, t),
                               rtol=0, atol=F32_OUT_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_reference(causal):
    q, k, v, w = _arrays(2)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (flash_attention(qt, kt, vt, causal=causal) * torch.from_numpy(w)
     ).sum().backward()
    ref = jax.grad(lambda q, k, v: jnp.sum(
        pk.flash_attention(q, k, v, causal=causal) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_GRAD_TOL, atol=F32_GRAD_TOL)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_contract_matches_reference(fused, causal, monkeypatch):
    """The backward alone on the same (q, k, v, dO, lse, D): the reference's
    one-pass fused kernel (row #10, ``HVD_PALLAS_FUSED_BWD=1``) and its
    two-pass resident kernels (row #11, ``=0``, f32 out) against
    ``flash_attention_bwd`` with the matching ``out_dtype``."""
    monkeypatch.setenv("HVD_PALLAS_FUSED_BWD", fused)
    q, k, v, do = _arrays(3)
    b, t, h, d = SHAPE
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = ck.flash_attention_fwd(tq, tk, tv, causal=causal)
    dd = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    got = ck.flash_attention_bwd(tq, tk, tv, tdo, lse, dd, causal=causal,
                                 out_dtype=torch.float32)
    want = pk._flash_bwd_hm(
        _heads_major(q), _heads_major(k), _heads_major(v), _heads_major(do),
        jnp.asarray(lse.numpy()).reshape(b * h, t, 1),
        jnp.asarray(dd.numpy()).reshape(b * h, t, 1), causal=causal,
        scale=d ** -0.5)
    for g, w in zip(got, want):
        w = np.asarray(w).reshape(b, h, t, d).transpose(0, 2, 1, 3)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=F32_GRAD_TOL,
                                   atol=F32_GRAD_TOL)


def test_bf16_forward_and_gradients_match_reference():
    q, k, v, w = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _arrays(4, (1, 128, 2, 64)))
    qj, kj, vj, wj = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                      for x in (q, k, v, w))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qt, kt, vt, causal=True)
    (out.float() * w.float()).sum().backward()
    ref = pk.flash_attention(qj, kj, vj, causal=True)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _close_rel(out.detach().float().numpy(), np.asarray(ref, np.float32),
               BF16_REL)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        pk.flash_attention(q, k, v, causal=True).astype(jnp.float32)
        * wj.astype(jnp.float32)), argnums=(0, 1, 2))(qj, kj, vj)
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads):
        assert got.dtype == torch.bfloat16
        _close_rel(got.float().numpy(), np.asarray(want, np.float32),
                   BF16_REL)


@pytest.mark.parametrize("offs", [(128, 0), (0, 64)])
def test_offsets_and_fully_masked_rows_match_reference(offs):
    """Global positions ``q_off`` / ``k_off`` (the ring's hop offsets); with
    ``k_off > q_off`` the first rows see no key: out 0 and lse 0."""
    q_off, k_off = offs
    rng = np.random.RandomState(5)
    q = rng.randn(1, 128, 2, 64).astype(np.float32)
    k, v = (rng.randn(1, 256, 2, 64).astype(np.float32) for _ in range(2))
    out, lse = ck.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=True, q_off=q_off, k_off=k_off)
    ref_out, ref_lse = pk._flash_fwd_once_call(
        _heads_major(q), _heads_major(k), _heads_major(v),
        jnp.asarray([q_off, k_off], jnp.int32), causal=True,
        scale=64 ** -0.5, block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(ref_out).reshape(1, 2, 128, 64).transpose(
            0, 2, 1, 3), rtol=0, atol=F32_OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(ref_lse).reshape(1, 2, 128),
                               rtol=0, atol=F32_OUT_ATOL)
    hidden = max(0, k_off - q_off)
    assert not out[:, :hidden].any() and not lse[..., :hidden].any()
    assert torch.isfinite(out).all()


def test_custom_backward_equals_autograd_through_the_twin():
    """The recomputing backward (lse, D, no [T, T] saved) gives autograd's
    gradients of the plain twin."""
    q, k, v, w = _arrays(6, (2, 96, 2, 32))
    grads = []
    for fn in (flash_attention, flash_attention_plain):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*ts, causal=True) * torch.from_numpy(w)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_twins_and_count_nothing():
    q, k, v, do = map(torch.from_numpy, _arrays(7, (1, 64, 2, 64)))
    out, lse = ck.flash_attention_fwd(q, k, v, causal=True)
    dd = (do * out).sum(-1).transpose(1, 2).contiguous()
    ck.flash_attention_bwd(q, k, v, do, lse, dd, causal=True)
    assert ck.launch_counts() == {w.__name__: 0 for w in ck.WRAPPERS}
    assert "flash_attention" not in _build._libs


@pytest.mark.parametrize("bad", ["dtype", "rank", "heads", "d_stride",
                                 "lse_shape", "out_dtype"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 2, 64)
    if bad == "dtype":
        with pytest.raises(TypeError):
            ck.flash_attention_fwd(q.half(), q.half(), q.half())
    elif bad == "rank":
        with pytest.raises(ValueError):
            ck.flash_attention_fwd(q[0], q[0], q[0])
    elif bad == "heads":
        with pytest.raises(ValueError, match="agree"):
            ck.flash_attention_fwd(q, torch.zeros(1, 8, 1, 64),
                                   torch.zeros(1, 8, 1, 64))
    elif bad == "d_stride":
        with pytest.raises(ValueError, match="contiguous"):
            ck.flash_attention_fwd(q, q, torch.zeros(1, 8, 64, 2).transpose(
                2, 3))
    else:
        out, lse = ck.flash_attention_fwd(q, q, q)
        if bad == "lse_shape":
            with pytest.raises(ValueError, match="lse"):
                ck.flash_attention_bwd(q, q, q, q, lse[:, :1], lse)
        else:
            with pytest.raises(TypeError, match="out_dtype"):
                ck.flash_attention_bwd(q, q, q, q, lse, lse,
                                       out_dtype=torch.float16)


LAUNCHERS = {"fwd": "hvd_flash_fwd", "step": "hvd_flash_step",
             "bwd": "hvd_flash_bwd"}
ROUTE_CASES = [  # (operand dtype, D, kernel, gradients' dtype)
    (dtype, d, kernel, out_dtype)
    for dtype in (torch.float32, torch.bfloat16) for d in (32, 64, 128)
    for kernel, out_dtype in (("fwd", None), ("step", None), ("bwd", None),
                              ("bwd", dtype), ("bwd", torch.float32))
    if (kernel, out_dtype) != ("bwd", torch.float32)
    or dtype != torch.float32]


@pytest.mark.parametrize("dtype,d,kernel,out_dtype", ROUTE_CASES, ids=[
    f"{str(c[0])[6:]}-D{c[1]}-{c[2]}" + (f"-{str(c[3])[6:]}-grads"
                                          if c[3] else "")
    for c in ROUTE_CASES])
def test_card_route_by_dtype_head_dim_and_gradients(dtype, d, kernel,
                                                    out_dtype):
    """bf16 operands at D = 64 take the wgmma / TMA kernels of
    ``flash_attention_sm90.cu`` for the forward (K5), the ring step (K6)
    and the backward (K7) with bf16 or f32 gradients; f32 operands and D =
    32 or 128 stay on ``flash_attention.cu``. The launcher a wrapper calls
    is ``LAUNCHERS[kernel]``, with ``_sm90`` where ``_hopper_route`` holds;
    its library is the source that runs."""
    hopper = ck._hopper_route(dtype, d, out_dtype)
    library = ck._SIGNATURES[LAUNCHERS[kernel] + ("_sm90" if hopper
                                                  else "")][0]
    want = ("flash_attention_sm90" if (dtype, d) == (torch.bfloat16, 64)
            else "flash_attention")
    assert library == want
