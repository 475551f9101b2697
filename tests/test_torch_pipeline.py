"""The port's GPipe pipeline (``horovod_tpu_torch/parallel/pipeline.py``)
against the reference's (``horovod_tpu/parallel/pipeline.py``) on the CPU:
the cases of ``tests/test_pipeline_parallel.py``.

Four tanh stages (``tanh(x @ w + b)``, d = 6, batch 8), the reference's
PRNGKey(0) stacked weights carried across (``moe_params_from_jax``); the
reference runs on a pp = 4 mesh of JAX CPU devices, the port on 4 gloo
ranks (one module-scoped ``testing.run_cluster``). Tolerances: the
forward at every microbatch count to 1e-6 of the reference's and of the
stages run in sequence; gradients and 10 SGD steps to 1e-5 relative (the
reference test's own bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from horovod_tpu.parallel import pipeline as rpp
from horovod_tpu_torch import testing
from torch_moe_workers import pipeline_worker

S, DIM, BATCH = 4, 6, 8


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _init_stage(rng, sample):
    d = sample.shape[-1]
    k1, k2 = jax.random.split(rng)
    return {"w": 0.5 * jax.random.normal(k1, (d, d), jnp.float32),
            "b": 0.01 * jax.random.normal(k2, (d,), jnp.float32)}


def _sequential(stacked, x):
    for s in range(jax.tree_util.tree_leaves(stacked)[0].shape[0]):
        x = _stage_fn(jax.tree_util.tree_map(lambda l: l[s], stacked), x)
    return x


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def case():
    x = np.random.RandomState(0).randn(BATCH, DIM).astype(np.float32)
    xj = jnp.asarray(x)
    stacked = rpp.stack_stage_params(_init_stage, jax.random.PRNGKey(0), S,
                                     xj)
    stacked8 = rpp.stack_stage_params(_init_stage, jax.random.PRNGKey(0),
                                      8, xj)
    mesh = rpp.make_pp_mesh(S, devices=jax.devices()[:S])
    sharded = rpp.shard_stage_params(stacked, mesh)
    ref = {"seq": np.asarray(_sequential(stacked, xj))}
    for m in (1, 2, 4, 8):
        ref[f"fwd_{m}"] = np.asarray(
            rpp.make_pipeline_fn(_stage_fn, mesh, m)(sharded, xj))
    pipe = rpp.make_pipeline_fn(_stage_fn, mesh, 4)
    ref["grads"] = _np(jax.grad(
        lambda p: ((pipe(p, xj) - 1.0) ** 2).mean())(sharded))
    ref["seq_grads"] = _np(jax.grad(
        lambda p: ((_sequential(p, xj) - 1.0) ** 2).mean())(stacked))
    ref["x_grad"] = np.asarray(jax.grad(
        lambda z: (pipe(sharded, z) ** 2).sum())(xj))
    tx = optax.sgd(0.1)
    step = rpp.make_pp_train_step(
        _stage_fn, lambda a, t: ((a - t) ** 2).mean(), tx, mesh, 2)
    p, o, losses = sharded, tx.init(sharded), []
    for _ in range(10):
        p, o, loss = step(p, o, xj, jnp.zeros_like(xj))
        losses.append(float(loss))
    ref["losses"], ref["trained"] = losses, _np(p)
    ranks = testing.run_cluster(
        pipeline_worker, np=S, device="cpu",
        args=(dict(x=x, stacked=_np(stacked), stacked8=_np(stacked8)),),
        timeout=300)
    return dict(ref=ref, ranks=ranks)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_pipeline_forward_matches_reference(case, m):
    ref = case["ref"]
    for r in case["ranks"]:
        np.testing.assert_allclose(r[f"fwd_{m}"], ref[f"fwd_{m}"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r[f"fwd_{m}"], ref["seq"], rtol=1e-6,
                                   atol=1e-6)


def test_pipeline_output_is_the_same_on_every_rank(case):
    outs = [r["fwd_4"] for r in case["ranks"]]
    assert all(np.array_equal(outs[0], o) for o in outs)


def test_pipeline_backward_matches_reference(case):
    """Each rank holds its stage's gradient: the reference's block s of its
    pipeline gradient and of the sequential one."""
    ref = case["ref"]
    for s, r in enumerate(case["ranks"]):
        assert r["rank"] == s
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grads"][k], ref["grads"][k][s:s + 1],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(r["grads"][k],
                                       ref["seq_grads"][k][s:s + 1],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_pipeline_input_gradient_summed_over_pp(case):
    """Only stage 0 reads x; its gradient is summed over pp, so every rank
    holds the reference's (the cotangent of a replicated input)."""
    for r in case["ranks"]:
        np.testing.assert_allclose(r["x_grad"], case["ref"]["x_grad"],
                                   rtol=1e-5, atol=1e-6)


def test_pp_train_step_matches_reference(case):
    ref = case["ref"]
    for s, r in enumerate(case["ranks"]):
        assert r["losses"][-1] < r["losses"][0]
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["trained"][k],
                                       ref["trained"][k][s:s + 1],
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_pp_rejects_stage_count_mismatch(case):
    """8 stages on a 4-stage axis must raise, not run half of them."""
    for r in case["ranks"]:
        assert "8 stages" in r["eight_stages"]


def test_pp_rejects_indivisible_batch(case):
    for r in case["ranks"]:
        assert "not divisible by n_microbatches=3" in r["microbatches"]


def test_pp_mesh_errors(case):
    for r in case["ranks"]:
        assert r["world"] == S
        assert "exceeds" in r["mesh_8"]
        assert "must be the world size" in r["mesh_2"]
    with pytest.raises(ValueError, match="exceeds"):
        rpp.make_pp_mesh(64)


def test_stack_stage_params_distinct_seeds():
    import torch

    from horovod_tpu_torch.parallel import pipeline as pp

    def init(gen, sample):
        return {"w": torch.randn(3, 3, generator=gen)}

    stacked = pp.stack_stage_params(init, 7, 4, None)
    assert stacked["w"].shape == (4, 3, 3)
    assert len({stacked["w"][s].sum().item() for s in range(4)}) == 4
    again = pp.stack_stage_params(init, 7, 4, None)
    assert torch.equal(stacked["w"], again["w"])
