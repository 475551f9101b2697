"""The port's tensor parallelism (``horovod_tpu_torch/parallel/tensor.py``)
against the reference's ``horovod_tpu/parallel/tensor.py`` on the CPU.

The case of ``tests/test_tensor_parallel.py``: a ``TransformerLM`` of 2
layers, d_model 16, 4 heads, vocab 61, f32, plain causal attention, batch 4
x 12, the reference's PRNGKey(0) weights carried across by
``transformer_state_dict_from_flax``. The reference runs its GSPMD step on a
(2, 2) mesh of JAX CPU devices, the port 4 gloo ranks on a dp=2 x tp=2 grid
(``testing.run_cluster``); 3 steps of SGD(0.1, momentum 0.9), at the
reference test's own tolerances (losses rtol 2e-5; parameters rtol 2e-4,
atol 1e-5, the bar it sets for the qkv kernel, here for every parameter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import TransformerLM
from horovod_tpu.parallel import tensor as tpar
from horovod_tpu_torch import testing
from horovod_tpu_torch.models.convert import transformer_state_dict_from_flax
from horovod_tpu_torch.models.transformer import TransformerLM as TorchLM
from horovod_tpu_torch.parallel import tensor as ttp
from torch_parallel_workers import tp_worker

CFG = dict(vocab_size=61, num_layers=2, num_heads=4, d_model=16,
           max_seq_len=64)
STEPS, LR, MOMENTUM = 3, 0.1, 0.9
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-4, 1e-5


def _flat(tree):
    return {k: v.numpy() for k, v in transformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _paths(tree):
    return [([p.key for p in path], leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(tree)]


@pytest.fixture(scope="module")
def case():
    model = TransformerLM(dtype=jnp.float32, attn_fn=tpar.plain_attention,
                          **CFG)
    toks = np.random.RandomState(0).randint(0, CFG["vocab_size"], (4, 13))
    x, y = toks[:, :-1], toks[:, 1:]
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def loss_fn(p, batch):
        logits = model.apply({"params": p}, batch[0])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, batch[1]).mean()

    tx = optax.sgd(LR, momentum=MOMENTUM)
    mesh = tpar.make_dp_tp_mesh(dp=2, tp=2)
    p = tpar.shard_params_tp(params, mesh)
    o = tx.init(p)
    batch = tpar.shard_batch_dp((jnp.asarray(x), jnp.asarray(y)), mesh)
    step = tpar.make_tp_train_step(loss_fn, tx, mesh)
    losses = []
    for _ in range(STEPS):
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
    state = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    ranks = testing.run_cluster(
        tp_worker, np=4, device="cpu",
        args=(state, CFG, x, y, STEPS, LR, MOMENTUM), timeout=300)
    return dict(params=params, losses=losses, after=_flat(p), ranks=ranks,
                state=state)


def test_spec_table_matches_reference(case):
    """The port's spec of every leaf of the Flax tree is the reference's;
    in the torch layout a Dense weight's spec is reversed."""
    for path, leaf in _paths(case["params"]):
        assert ttp.tp_param_spec(path, leaf) == tuple(
            tpar.tp_param_spec(path, leaf)), path
    torch_specs = case["ranks"][0]["specs"]
    assert sorted(torch_specs) == sorted(case["state"])
    want = {"blocks.0.qkv.weight": ("tp", None), "blocks.0.qkv.bias": ("tp",),
            "blocks.1.proj.weight": (None, "tp"), "blocks.1.proj.bias": (),
            "blocks.0.mlp_in.weight": ("tp", None),
            "blocks.0.mlp_out.weight": (None, "tp"),
            "blocks.0.ln_attn.weight": (), "tok_emb.weight": (),
            "pos_emb": (), "ln_f.bias": ()}
    for name, spec in want.items():
        assert torch_specs[name] == spec, name


def test_tp_rejects_indivisible_shapes():
    """d_model 18 with 3 heads at tp=4: 54 qkv features do not split."""
    model = TorchLM(vocab_size=61, num_layers=2, num_heads=3, d_model=18,
                    max_seq_len=64, dtype=torch.float32)
    mesh = ttp.DpTpMesh(dp=2, tp=4, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None)
    with pytest.raises(ValueError, match="not divisible"):
        ttp.tp_param_shardings(model, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        ttp.shard_params_tp(model, mesh)
    # every sharded dim splits over tp=2, but one head does not
    mesh = ttp.DpTpMesh(dp=1, tp=2, dp_rank=0, tp_rank=0, dp_group=None,
                        tp_group=None)
    odd = TorchLM(vocab_size=61, num_layers=1, num_heads=1, d_model=16,
                  max_seq_len=64, dtype=torch.float32)
    with pytest.raises(ValueError, match="num_heads 1 not divisible"):
        ttp.shard_params_tp(odd, mesh)


def test_shard_is_a_tp_part_of_the_kernel(case):
    """A rank's column- or row-parallel weight holds 1/tp of the full one;
    slicing the model in place and loading ``shard_state_dict_tp`` of the
    full weights give the same bits."""
    full = case["state"]
    for rank in case["ranks"]:
        shapes = rank["shard_shapes"]
        for name in ("blocks.0.mlp_in.weight", "blocks.0.qkv.weight",
                     "blocks.1.proj.weight", "blocks.1.mlp_out.weight"):
            assert np.prod(shapes[name]) == full[name].numel() // 2, name
        assert shapes["blocks.0.mlp_in.weight"] == (32, 16)
        assert shapes["blocks.0.mlp_out.weight"] == (16, 32)
        assert shapes["blocks.0.mlp_out.bias"] == (16,)
        assert rank["loaded_equal"]


def test_column_shard_is_whole_heads(case):
    """Rank (d, t)'s q, k and v are heads [t h/tp, (t + 1) h/tp) of the
    full projection: the head-major qkv columns split into whole heads."""
    h, hd = CFG["num_heads"], CFG["d_model"] // CFG["num_heads"]
    for rank in case["ranks"]:
        t = rank["grid"][1]
        b, s = rank["qkv_full"].shape[:2]
        full = rank["qkv_full"].reshape(b, s, h, 3, hd)
        mine = rank["qkv_shard"].reshape(b, s, h // 2, 3, hd)
        np.testing.assert_allclose(mine, full[:, :, t * h // 2:
                                              (t + 1) * h // 2],
                                   rtol=0, atol=1e-6)


def test_tp_train_step_matches_reference(case):
    ranks = case["ranks"]
    assert [r["grid"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"], case["losses"],
                                   rtol=LOSS_RTOL)
        assert sorted(rank["full"]) == sorted(case["after"])
        for name, want in case["after"].items():
            np.testing.assert_allclose(rank["full"][name], want,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=name)


def test_tp_parameters_agree_bit_for_bit(case):
    """Replicated parameters are bit-identical on all four ranks (their
    gradients are equal on the ranks of a tp group), and each tensor shard
    on the two ranks of its dp group."""
    ranks = case["ranks"]
    specs = ranks[0]["specs"]
    for name, spec in specs.items():
        shards = [r["shards"][name] for r in ranks]
        if "tp" in spec:
            same_t = [(0, 2), (1, 3)]
            for i, j in same_t:
                assert np.array_equal(shards[i], shards[j]), name
            assert not np.array_equal(shards[0], shards[1]), name
        else:
            assert all(np.array_equal(shards[0], s) for s in shards), name
