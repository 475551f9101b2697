"""The port's 3D hybrid parallelism (``horovod_tpu_torch/parallel/hybrid.py``)
against the reference's ``horovod_tpu/parallel/hybrid.py`` on the CPU.

The case of ``tests/test_hybrid_parallel.py``: a ``TransformerLM`` of 2
layers, d_model 64, 2 heads, vocab 89, f32, global batch 4 x 32, the
reference's PRNGKey(0) weights. The reference runs ``make_hybrid_train_step``
on a (2, 2, 2) mesh of JAX CPU devices, the port 8 gloo ranks on a dp=2 x
tp=2 x sp=2 grid (``testing.run_cluster``): 3 steps of SGD(5e-2, momentum
0.9), at that test's tolerances (losses rtol 2e-4; parameters rtol 2e-3,
atol 2e-5). Then a full optimizer state carried across by
``shard_opt_state_hybrid``: one more SGD step from a world-1 run's momentum
after its first step, against that run's second step, at the same
tolerances (AdamW would turn gradients that cancel to rounding noise into
steps of lr, whatever the decomposition), and a full AdamW state loaded.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import TransformerLM
from horovod_tpu.parallel import hybrid
from horovod_tpu_torch import testing
from horovod_tpu_torch.models.convert import transformer_state_dict_from_flax
from horovod_tpu_torch.models.transformer import TransformerLM as TorchLM
from horovod_tpu_torch.models.transformer import lm_loss as torch_lm_loss
from torch_parallel_workers import hybrid_worker

CFG = dict(vocab_size=89, num_layers=2, num_heads=2, d_model=64,
           max_seq_len=64)
STEPS, LR, MOMENTUM = 3, 5e-2, 0.9
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5


def _flat(tree):
    return {k: v.numpy() for k, v in transformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _carried_reference(state, x, y):
    """World 1: the parameters and full optimizer state after one step of
    SGD with momentum, and the loss and parameters of the second step; and
    a full AdamW state after one step."""
    net = TorchLM(dtype=torch.float32, **CFG)
    net.load_state_dict(state)
    out = {}
    for name, opt in (("adamw", torch.optim.AdamW(net.parameters())),
                      ("sgd", torch.optim.SGD(net.parameters(), lr=LR,
                                              momentum=MOMENTUM))):
        net.load_state_dict(state)
        steps = []
        for _ in range(2):
            opt.zero_grad()
            loss = torch_lm_loss(net(torch.from_numpy(x)),
                                 torch.from_numpy(y))
            loss.backward()
            opt.step()
            steps.append((loss.item(), {k: p.detach().clone()
                                        for k, p in net.named_parameters()},
                          copy.deepcopy(opt.state_dict())))
        out[name] = steps
    return out


@pytest.fixture(scope="module")
def case():
    toks = np.random.RandomState(0).randint(0, CFG["vocab_size"], (4, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    mesh = hybrid.make_dp_tp_sp_mesh(dp=2, tp=2, sp=2)
    # host copies: the reference step donates its inputs
    params0 = jax.tree_util.tree_map(np.array, TransformerLM(
        dtype=jnp.float32, **CFG).init(jax.random.PRNGKey(0),
                                       jnp.asarray(x))["params"])
    tx = optax.sgd(LR, momentum=MOMENTUM)
    step = hybrid.make_hybrid_train_step(
        hybrid.hybrid_model(TransformerLM, dtype=jnp.float32, **CFG), tx,
        mesh)
    p = hybrid.shard_params_hybrid(params0, mesh)
    o = jax.device_put(tx.init(params0), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    xs, ys = (hybrid.shard_data_hybrid(jnp.asarray(a), mesh) for a in (x, y))
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, xs, ys)
        losses.append(float(loss))
    state = {k: torch.from_numpy(v) for k, v in _flat(params0).items()}
    carried = _carried_reference(state, x, y)
    (_, params1, sgd1), (loss2, params2, _) = carried["sgd"]
    ranks = testing.run_cluster(
        hybrid_worker, np=8, device="cpu",
        args=(state, CFG, x, y, STEPS, LR, MOMENTUM,
              (params1, sgd1, carried["adamw"][0][2])), timeout=300)
    return dict(losses=losses, after=_flat(p), ranks=ranks, x=x,
                carried_loss=loss2, carried_params=params2, params1=params1)


def test_hybrid_grid_and_data_blocks(case):
    """Rank r = (d tp + t) sp + s holds batch rows d and sequence block s
    of the global tokens, the same on both ranks of its tp group."""
    x = case["x"]
    for r, rank in enumerate(case["ranks"]):
        d, t, s = rank["grid"]
        assert r == (d * 2 + t) * 2 + s
        np.testing.assert_array_equal(rank["block"],
                                      x[2 * d:2 * d + 2, 16 * s:16 * s + 16])


def test_hybrid_matches_reference(case):
    for rank in case["ranks"]:
        np.testing.assert_allclose(rank["losses"], case["losses"],
                                   rtol=LOSS_RTOL)
        assert sorted(rank["full"]) == sorted(case["after"])
        for name, want in case["after"].items():
            np.testing.assert_allclose(rank["full"][name], want,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_hybrid_shards_agree_bit_for_bit(case):
    """Each tensor shard is bit-identical on the four dp x sp ranks that
    hold it, every replicated parameter on all eight, and the two tp
    shards differ."""
    ranks = case["ranks"]
    for name in ranks[0]["shards"]:
        by_t = [[r["shards"][name] for r in ranks if r["grid"][1] == t]
                for t in (0, 1)]
        for group in by_t:
            assert all(np.array_equal(group[0], a) for a in group), name
        sharded = by_t[0][0].shape != case["after"][name].shape
        assert np.array_equal(by_t[0][0], by_t[1][0]) != sharded, name


def test_full_optimizer_state_carries_across(case):
    """``shard_opt_state_hybrid`` slices a full optimizer state by each
    parameter's spec: one hybrid SGD step from the sliced momentum matches
    the world-1 run's next step, and a full AdamW state loads with its
    moments shaped like this rank's shards and its step counts kept."""
    for rank in case["ranks"]:
        np.testing.assert_allclose(rank["carried_loss"], case["carried_loss"],
                                   rtol=LOSS_RTOL)
        for name, want in case["carried_params"].items():
            np.testing.assert_allclose(rank["carried_full"][name],
                                       want.numpy(), rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=name)
        shapes = {k: v.shape for k, v in rank["shards"].items()}
        for name, state in rank["adamw_state"].items():
            assert state["exp_avg"] == state["exp_avg_sq"] == shapes[name]
            assert state["step"] == 1.0
