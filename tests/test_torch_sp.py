"""The port's sequence-parallel LM training
(``horovod_tpu_torch/parallel/sp_training.py``) against the reference's
``horovod_tpu/parallel/sp_training.py`` on the CPU.

One 4-rank gloo cluster (``testing.run_cluster(..., device="cpu")``) runs
``TransformerLMTiny`` (2 layers, d_model 128, 2 heads of 64, f32) with the
reference's weights (``transformer_state_dict_from_flax``):

* the forward on a dp=1 x sp=4 grid against ``make_sp_forward`` on a
  (1, 4) mesh of JAX CPU devices: logits to 2e-4 (the bar of
  ``tests/test_transformer.py``; measured 6.0e-7);
* one SGD(0.1) step on a dp=2 x sp=2 grid against ``make_sp_train_step``
  on a (2, 2) mesh: the loss to 1e-5 and every parameter to 5e-5 (the
  same file's bar; measured 4.8e-7 and 7.9e-9), parameters bit-identical
  on the four ranks;
* a global sequence longer than ``max_seq_len`` raises ``ValueError`` on
  every rank, in the train step and in the forward, before any
  collective; ``make_dp_sp_mesh(4, 4)`` at world 4 asks for 16 devices;
  a grid built twice reuses its process groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import TransformerLMTiny
from horovod_tpu.parallel import (make_dp_sp_mesh, make_sp_forward,
                                  make_sp_train_step, replicate_to_mesh,
                                  sp_model)
from horovod_tpu_torch import testing
from horovod_tpu_torch.models.convert import transformer_state_dict_from_flax
from torch_parallel_workers import sp_worker

VOCAB = 97
LOGIT_TOL = 2e-4
LOSS_TOL, PARAM_TOL = 1e-5, 5e-5


def _data(seed, b, t):
    toks = np.random.RandomState(seed).randint(0, VOCAB, (b, t + 1))
    return toks[:, :-1], toks[:, 1:]


def _flat(tree):
    """Flax params as {torch name: numpy}, through the converter."""
    return {k: v.numpy() for k, v in transformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def case():
    """The reference's forward and train step, and the port's cluster, on
    the same weights and tokens."""
    fwd_tokens, _ = _data(1, 2, 128)
    tokens, targets = _data(2, 4, 64)
    long_tokens = np.zeros((4, 1024), np.int64)  # 1024 > max_seq_len 512
    params = TransformerLMTiny(vocab_size=VOCAB, dtype=jnp.float32).init(
        jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    state = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    model = sp_model(TransformerLMTiny, vocab_size=VOCAB, dtype=jnp.float32)

    mesh = make_dp_sp_mesh(dp=1, sp=4)
    ref_logits = make_sp_forward(model, mesh)(
        replicate_to_mesh(params, mesh), jnp.asarray(fwd_tokens))
    mesh = make_dp_sp_mesh(dp=2, sp=2)
    tx = optax.sgd(0.1)
    ref_params, _, ref_loss = make_sp_train_step(model, tx, mesh)(
        replicate_to_mesh(params, mesh),
        replicate_to_mesh(tx.init(params), mesh), jnp.asarray(tokens),
        jnp.asarray(targets))

    ranks = testing.run_cluster(
        sp_worker, np=4, device="cpu",
        args=(state, VOCAB, fwd_tokens, tokens, targets, long_tokens),
        timeout=300)
    return dict(logits=np.asarray(ref_logits), loss=float(ref_loss),
                params=_flat(ref_params), ranks=ranks)


def test_sp_forward_matches_reference(case):
    for rank in case["ranks"]:
        np.testing.assert_allclose(rank["forward"], case["logits"], rtol=0,
                                   atol=LOGIT_TOL)


def test_sp_train_step_matches_reference(case):
    ranks = case["ranks"]
    assert [r["grid"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({r["sha"] for r in ranks}) == 1
    for rank in ranks:
        assert abs(rank["loss"] - case["loss"]) <= LOSS_TOL
        assert sorted(rank["params"]) == sorted(case["params"])
        for name, want in case["params"].items():
            np.testing.assert_allclose(rank["params"][name], want, rtol=0,
                                       atol=PARAM_TOL, err_msg=name)


def test_over_length_sequence_raises_on_every_rank(case):
    for rank in case["ranks"]:
        assert len(rank["too_long"]) == 2
        for msg in rank["too_long"]:
            assert msg is not None and "max_seq_len=512" in msg
            assert "global sequence length 1024" in msg


def test_mesh_needs_dp_times_sp_ranks(case):
    for rank in case["ranks"]:
        assert rank["mesh"] is not None and "need 16 devices" in rank["mesh"]


def test_mesh_built_again_reuses_its_groups(case):
    assert all(rank["groups_reused"] for rank in case["ranks"])
