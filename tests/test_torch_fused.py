"""The port's fused LayerNorm (K8: ``ops/layer_norm.py``) and fused AdamW
(K9: ``optim/fused.py``) against the reference's Pallas kernels.

On the CPU the wrappers run their plain twins; the reference runs its
kernels in interpret mode (``HVD_PALLAS=interpret``). Inputs come from
numpy seeds.

Tolerances:
* LayerNorm, f32: y to 2e-6 absolute (O(1) values; the two sides sum in
  different orders; measured 1.4e-6), the gradients to 2e-6 absolute plus
  2e-6 relative (dgamma and dbeta sum the rows' O(1-10) terms: measured
  3.8e-6 on values near 10); bf16: one unit in
  the last place of the larger of the two values (the f32 results differ
  by far less, their roundings to bf16 by at most one).
* AdamW, after 3 steps of lr 1e-2 on O(1) values: the reference's XLA
  program may contract a multiply and an add into one FMA, and its f32
  power may round differently, so a few units in the last place: with mu
  in f32, parameters to 5e-7 absolute (measured 2.4e-7), mu to 1e-7
  absolute (measured 6e-8), nu to 1e-6 relative (measured 2.4e-7). With mu
  in bf16 an f32 difference of one unit can flip mu's rounding, and the
  flip carries 0.9 of itself into the next step, where it may flip again:
  mu within two bf16 units (measured 2), and the parameters, whose update
  then moves by 2^-8 of itself, to 1e-4 absolute (measured 4e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu.optim import fused_adamw as ref_fused_adamw
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import cuda_kernels as ck
from horovod_tpu_torch.ops.layer_norm import fused_layer_norm
from horovod_tpu_torch.optim.fused import (FusedAdamW, adamw_scalars,
                                           fused_adamw)

LN_ATOL = 2e-6
BF16_EPS = 2.0 ** -7


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    ck.reset_launch_counts()
    yield


def _ln_inputs(seed, n, d):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 3 + rng.rand(n, 1)).astype(np.float32)
    return (x, rng.randn(d).astype(np.float32),
            rng.randn(d).astype(np.float32), rng.randn(n, d).astype(
                np.float32))


def _ulp_close(a, b, eps):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bound = eps * np.maximum(np.abs(a), np.abs(b))
    assert (np.abs(a - b) <= bound).all(), np.abs(a - b).max()


def _bf16_ulps(a: torch.Tensor, b: np.ndarray) -> int:
    """Largest distance in bf16 units between a (torch) and b (numpy)."""
    def key(i):
        return torch.where(i < 0, -(i + 32768), i)

    ia = a.view(torch.int16).long()
    ib = torch.from_numpy(b.view(np.int16).astype(np.int64))
    return int((key(ia) - key(ib)).abs().max())


# --------------------------------------------------------------- layernorm
@pytest.mark.parametrize("shape", [(16, 128), (24, 256)])
def test_layer_norm_forward_and_gradients_match_reference(shape):
    x, g, b, w = _ln_inputs(1, *shape)
    assert pk.ln_supported(jnp.asarray(x))  # the reference takes its kernel
    xt, gt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, g, b))
    y = fused_layer_norm(xt, gt, bt, eps=1e-6)
    (y * torch.from_numpy(w)).sum().backward()
    ref_y = pk.fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), eps=1e-6)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=0, atol=LN_ATOL)
    grads = jax.grad(lambda x, g, b: jnp.sum(
        pk.fused_layer_norm(x, g, b, eps=1e-6) * w), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    for got, want in zip((xt.grad, gt.grad, bt.grad), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LN_ATOL, atol=LN_ATOL)


def test_layer_norm_statistics_match_the_reference_kernel():
    x, g, b, _ = _ln_inputs(2, 16, 128)
    y, mean, rstd = ck.layer_norm_fwd(*map(torch.from_numpy, (x, g, b)),
                                      1e-6)
    ry, rmean, rrstd = pk._ln_fused_fwd_call(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-6)
    assert mean.shape == rstd.shape == (16,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean)[:, 0],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rrstd)[:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=0,
                               atol=LN_ATOL)


def test_layer_norm_bf16_and_ragged_width():
    """bf16 rows through the reference kernel, and a width the reference
    does not tile (d = 100: it takes its jnp formula; the port's kernel takes
    any width)."""
    x, g, b, _ = _ln_inputs(3, 8, 256)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = fused_layer_norm(xb, torch.from_numpy(g), torch.from_numpy(b))
    ref = pk.fused_layer_norm(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(g), jnp.asarray(b))
    assert y.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    _ulp_close(y.float().numpy(), np.asarray(ref, np.float32), BF16_EPS)
    x, g, b, _ = _ln_inputs(4, 5, 100)
    assert not pk.ln_supported(jnp.asarray(x))
    y = fused_layer_norm(*map(torch.from_numpy, (x, g, b)))
    ref = pk.fused_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=0,
                               atol=LN_ATOL)


def test_layer_norm_cpu_takes_the_twin_and_checks_its_inputs():
    x, g, b, _ = _ln_inputs(5, 4, 128)
    ck.layer_norm_fwd(*map(torch.from_numpy, (x, g, b)))
    assert ck.launch_counts() == {w.__name__: 0 for w in ck.WRAPPERS}
    assert "layer_norm" not in _build._libs
    with pytest.raises(ValueError, match="gamma"):
        ck.layer_norm_fwd(torch.from_numpy(x), torch.zeros(64),
                          torch.from_numpy(b))
    with pytest.raises(ValueError, match="contiguous"):
        ck.layer_norm_fwd(torch.zeros(128, 4).t(), torch.zeros(128),
                          torch.zeros(128))


# ------------------------------------------------------------------- adamw
def _leaves(seed):
    """A [512, 256] leaf and one of odd length, both at least 65536 long so
    that the reference takes its kernel (its threshold, fused.py:45-47)."""
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(512, 256).astype(np.float32),
            "b": rng.randn(70001).astype(np.float32)}


def _schedule(count):
    return 1e-2 * 0.5 ** count


@pytest.mark.parametrize("lr", ["const", "schedule"])
@pytest.mark.parametrize("mu_dtype", ["f32", "bf16"])
def test_fused_adamw_matches_reference(mu_dtype, lr):
    learning_rate = 1e-2 if lr == "const" else _schedule
    params = _leaves(1)
    rng = np.random.RandomState(2)
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)

    ref = ref_fused_adamw(learning_rate, mu_dtype={
        "f32": None, "bf16": jnp.bfloat16}[mu_dtype], **kw)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref.init(rp)
    for g in grads:
        rp, state = ref.apply({k: jnp.asarray(v) for k, v in g.items()},
                              state, rp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = fused_adamw(list(tp.values()), learning_rate,
                      mu_dtype=None if mu_dtype == "f32" else mu_dtype, **kw)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()

    p_atol = 5e-7 if mu_dtype == "f32" else 1e-4
    for k, p in tp.items():
        st = opt.state[p]
        assert st["count"] == 3 and st["nu"].dtype == torch.float32
        assert st["mu"].dtype == (torch.float32 if mu_dtype == "f32"
                                  else torch.bfloat16)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp[k]),
                                   rtol=0, atol=p_atol, err_msg=k)
        np.testing.assert_allclose(st["nu"].numpy(),
                                   np.asarray(state.nu[k]), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
        rmu = np.asarray(state.mu[k])
        if mu_dtype == "f32":
            np.testing.assert_allclose(st["mu"].numpy(), rmu, rtol=0,
                                       atol=1e-7)
        else:
            assert _bf16_ulps(st["mu"], rmu) <= 2, k


def test_adamw_scalars_match_the_reference_formula():
    for count in (0, 1, 9, 999):
        t = jnp.float32(count + 1)
        want = (1.0 / (1.0 - jnp.float32(0.9) ** t),
                1.0 / (1.0 - jnp.float32(0.999) ** t))
        lr, ibc1, ibc2 = adamw_scalars(count, _schedule, 0.9, 0.999)
        assert lr == float(np.float32(_schedule(count)))
        np.testing.assert_allclose((ibc1, ibc2), np.asarray(want, np.float32),
                                   rtol=2e-7)


def test_fused_adamw_skips_leaves_without_grad_and_counts_per_leaf():
    a = torch.nn.Parameter(torch.ones(4))
    b = torch.nn.Parameter(torch.ones(3))
    opt = FusedAdamW([a, b], lr=0.1)
    a.grad = torch.ones(4)
    opt.step()
    assert opt.state[a]["count"] == 1 and b not in opt.state
    assert torch.equal(b.detach(), torch.ones(3))
    b.grad = torch.ones(3)
    opt.step()
    # each leaf's bias correction follows its own count: both took a first
    # step of the same size
    assert opt.state[a]["count"] == 2 and opt.state[b]["count"] == 1
    assert ck.launch_counts()["adamw_update"] == 0
    with pytest.raises(ValueError, match="mu_dtype"):
        FusedAdamW([a], mu_dtype="f16")


def test_fused_adamw_state_keeps_its_dtypes_through_a_reload():
    """``load_state_dict`` (which ``broadcast_optimizer_state`` calls) casts
    floating state to the parameter's dtype; mu comes back in its bf16 and
    nu in f32, with the same values."""
    import horovod_tpu_torch as hvd

    w = torch.nn.Parameter(torch.ones(5))
    opt = FusedAdamW([w], lr=0.1, mu_dtype="bf16")
    w.grad = torch.full((5,), 0.3)
    opt.step()
    mu, nu = opt.state[w]["mu"].clone(), opt.state[w]["nu"].clone()
    opt.load_state_dict(opt.state_dict())
    hvd.init(device="cpu")
    try:
        hvd.broadcast_optimizer_state(opt, root_rank=0)
    finally:
        hvd.shutdown()
    st = opt.state[w]
    assert st["mu"].dtype == torch.bfloat16 and torch.equal(st["mu"], mu)
    assert st["nu"].dtype == torch.float32 and torch.equal(st["nu"], nu)
    assert st["count"] == 1


def test_adamw_update_rejects_mixed_leaves():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="leaf 0"):
        ck.adamw_update([p], [p.double()], [p.clone()], [p.clone()], lr=0.1,
                        ibc1=1.0, ibc2=1.0)
    with pytest.raises(ValueError, match="length"):
        ck.adamw_update([p], [], [], [], lr=0.1, ibc1=1.0, ibc2=1.0)
