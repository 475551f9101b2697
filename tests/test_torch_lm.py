"""The transformer-LM slice of the port (``models/transformer.py``,
``optim/fused.py``, ``train.synthetic_lm_train``) against the reference's
Flax model and optimizers, on the same weights (carried by
``transformer_state_dict_from_flax``) and the same seeded tokens.

The reference runs its Pallas kernels in interpret mode
(``HVD_PALLAS=interpret``): flash attention in every layer and, with
``HVD_FUSED_LN=1``, the fused LayerNorm. The port runs its plain twins
(CPU tensors). The model is ``TransformerLMTiny`` (2 layers, d_model 128,
2 heads of 64) with a vocabulary of 256, at batch 2 and sequence 128.

Tolerances, in f32:
* logits to 5e-6 absolute on values up to ~1.2 (measured 6.9e-7), the
  losses to 1e-6 relative, every gradient to 2e-5 of its tensor's largest
  |value| (measured 1.2e-6): the frameworks sum in different orders;
* after 2 AdamW steps of lr 3e-4 the losses to 1e-6 relative, and at
  least 99.9% of the parameter elements to 2e-6 absolute (measured 99.99%),
  every one to 1e-4 (measured 3.4e-5): Adam divides each gradient element
  by its own root mean square, so where an element is as small as eps a
  last-bit difference in it moves that element's update by a visible
  fraction of the step (lr per step, 6e-4 over both).
In bf16 (one forward), the logits to 2^-5 of their largest |value|
(measured 2^-7: bf16 rounds at other places in the two frameworks), and at
least 10% of them bit-equal (measured 24%): a head computed in f32 instead
of the reference's bf16 product gives logits that are not bf16 values, and
fails the second bound (measured 0.002% equal).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import transformer as ref_tf
from horovod_tpu.optim import fused_adamw as ref_fused_adamw
import horovod_tpu_torch as hvd
from horovod_tpu_torch import testing
from horovod_tpu_torch.models import transformer as tf
from horovod_tpu_torch.models.convert import transformer_state_dict_from_flax
from horovod_tpu_torch.ops import cuda_kernels as ck
from horovod_tpu_torch.optim.fused import FusedAdamW
from horovod_tpu_torch.train import synthetic_lm_train, synthetic_lm_tokens

VOCAB, BATCH, SEQ = 256, 2, 128
STEPS = 2
LOGIT_ATOL = 5e-6
GRAD_REL = 2e-5
PARAM_ATOL, PARAM_SHARE, PARAM_MAX = 2e-6, 0.999, 1e-4


@pytest.fixture(autouse=True)
def _interpret_and_port_state(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    monkeypatch.delenv("HVD_FUSED_LN", raising=False)
    ck.reset_launch_counts()
    yield
    hvd.shutdown()


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _tokens(batch=BATCH):
    toks = np.random.RandomState(0).randint(0, VOCAB, (batch, SEQ + 1))
    return toks[:, :-1], toks[:, 1:]


@functools.lru_cache(maxsize=None)
def _reference(dtype=jnp.float32):
    model = ref_tf.TransformerLMTiny(vocab_size=VOCAB, dtype=dtype)
    x, _ = _tokens()
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    return model, params


def _port(dtype=torch.float32, fused_ln=False):
    _, params = _reference()
    net = tf.TransformerLMTiny(vocab_size=VOCAB, dtype=dtype,
                               fused_ln=fused_ln)
    net.load_state_dict(transformer_state_dict_from_flax(_np_tree(params)))
    return net


def _params_close(got: dict, want: dict) -> None:
    diffs = {k: np.abs(p - want[k].numpy()) for k, p in got.items()}
    assert sorted(diffs) == sorted(want)
    worst = max(diffs, key=lambda k: diffs[k].max())
    assert diffs[worst].max() <= PARAM_MAX, (worst, diffs[worst].max())
    flat = np.concatenate([d.ravel() for d in diffs.values()])
    assert (flat <= PARAM_ATOL).mean() >= PARAM_SHARE


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_converted_weights_fill_the_model_exactly():
    _, params = _reference()
    sd = transformer_state_dict_from_flax(_np_tree(params))
    net = tf.TransformerLMTiny(vocab_size=VOCAB)
    assert sorted(sd) == sorted(net.state_dict())
    assert all(sd[k].shape == v.shape for k, v in net.state_dict().items())
    # the qkv columns keep the reference's head-major [h][3][hd] order
    kernel = params["block_0"]["qkv"]["kernel"]
    np.testing.assert_array_equal(sd["blocks.0.qkv.weight"].numpy(),
                                  np.asarray(kernel).T)
    assert sum(v.numel() for v in sd.values()) == sum(
        np.size(a) for a in jax.tree_util.tree_leaves(params))


def test_logits_losses_and_gradients_match_reference():
    model, params = _reference()
    x, y = _tokens()
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def loss(p):
        return ref_tf.lm_loss(model.apply({"params": p}, xj), yj)

    def loss_chunked(p):
        hid = model.apply({"params": p}, xj, return_hidden=True)
        return ref_tf.lm_loss_chunked(hid, p["tok_emb"]["embedding"], yj,
                                      chunk_tokens=96)

    ref_logits = model.apply({"params": params}, xj)
    ref_loss, ref_grads = jax.value_and_grad(loss)(params)
    ref_chunked = loss_chunked(params)

    net = _port()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    logits = net(xt)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=0,
                               atol=LOGIT_ATOL)
    lv = tf.lm_loss(logits, yt)
    lv.backward()
    # 256 tokens in chunks of 96: three chunks, the last padded
    chunked = tf.lm_loss_chunked(net(xt, return_hidden=True),
                                 net.tok_emb.weight, yt, chunk_tokens=96)
    np.testing.assert_allclose(lv.item(), float(ref_loss), rtol=1e-6)
    np.testing.assert_allclose(chunked.item(), float(ref_chunked), rtol=1e-6)
    want = transformer_state_dict_from_flax(_np_tree(ref_grads))
    for name, p in net.named_parameters():
        assert _max_rel(p.grad.numpy(), want[name].numpy()) <= GRAD_REL, name


def test_bf16_forward_matches_reference():
    model, params = _reference(jnp.bfloat16)
    x, _ = _tokens()
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)),
                     np.float32)
    got = _port(torch.bfloat16)(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - ref).max() <= 2.0 ** -5 * np.abs(ref).max()
    assert (got == ref).mean() >= 0.10


def _reference_train(fused: bool, batch: int = BATCH):
    """Parameters (port names) and losses after STEPS steps of the
    reference: ``optax.adamw(3e-4, weight_decay=0.01, mu_dtype=f32)``, or
    with ``fused`` the fused LayerNorm and ``fused_adamw(mu_dtype=bf16)``
    (lm_bench's ``HVD_FUSED_LN=1 LM_FUSED_OPT=1``)."""
    model, params = _reference()
    x, y = _tokens(batch)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    old = os.environ.get("HVD_FUSED_LN")
    os.environ["HVD_FUSED_LN"] = "1" if fused else "0"
    try:
        grad_fn = jax.value_and_grad(
            lambda p: ref_tf.lm_loss(model.apply({"params": p}, xj), yj))
        if fused:
            tx = ref_fused_adamw(3e-4, weight_decay=0.01,
                                 mu_dtype=jnp.bfloat16)
        else:
            tx = optax.adamw(3e-4, weight_decay=0.01, mu_dtype=jnp.float32)
        state, losses = tx.init(params), []
        for _ in range(STEPS):
            loss, grads = grad_fn(params)
            if fused:
                params, state = tx.apply(grads, state, params)
            else:
                updates, state = tx.update(grads, state, params)
                params = optax.apply_updates(params, updates)
            losses.append(float(loss))
    finally:
        if old is None:
            os.environ.pop("HVD_FUSED_LN")
        else:
            os.environ["HVD_FUSED_LN"] = old
    return (transformer_state_dict_from_flax(_np_tree(params)), losses)


def lm_train_worker(state: dict, fused: bool, batch: int) -> dict:
    """One rank: TransformerLMTiny from ``state``, trained STEPS steps on
    this rank's ``batch`` rows of the global batch through
    ``DistributedOptimizer`` (AdamW, or with ``fused`` the fused LayerNorm
    and ``FusedAdamW(mu_dtype=bf16)``). Returns losses and parameters."""
    rank, world = hvd.rank(), hvd.size()
    net = tf.TransformerLMTiny(vocab_size=VOCAB, dtype=torch.float32,
                               fused_ln=fused)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    x, y = (torch.from_numpy(a[rank * batch:(rank + 1) * batch])
            for a in _tokens(batch * world))
    inner = (FusedAdamW(net.parameters(), lr=3e-4, weight_decay=0.01,
                        mu_dtype="bf16") if fused else
             torch.optim.AdamW(net.parameters(), lr=3e-4, weight_decay=0.01))
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=net.named_parameters())
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = tf.lm_loss(net(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return {"losses": losses,
            "params": {k: p.detach().numpy().copy()
                       for k, p in net.named_parameters()}}


def _state():
    _, params = _reference()
    return {k: v.numpy() for k, v in
            transformer_state_dict_from_flax(_np_tree(params)).items()}


@pytest.mark.parametrize("fused", [False, True],
                         ids=["adamw", "fused_ln+fused_adamw"])
def test_two_training_steps_match_reference(fused):
    want, ref_losses = _reference_train(fused)
    hvd.init(device="cpu")
    got = lm_train_worker(_state(), fused, BATCH)
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-6)
    _params_close(got["params"], want)
    assert ck.launch_counts() == {w.__name__: 0 for w in ck.WRAPPERS}


def test_two_ranks_bit_identical_and_match_the_global_batch_step():
    """Two gloo ranks, each on its half of a global batch of 2 x BATCH:
    parameters bit-identical on both ranks, and within the tolerance of the
    reference's single-process step on the whole global batch (the mean of
    the two ranks' mean losses is the global mean)."""
    ranks = testing.run_cluster(lm_train_worker, np=2, device="cpu",
                                args=(_state(), True, BATCH), timeout=300)
    for name, p in ranks[0]["params"].items():
        assert np.array_equal(p.view(np.int32),
                              ranks[1]["params"][name].view(np.int32)), name
    want, ref_losses = _reference_train(True, 2 * BATCH)
    _params_close(ranks[0]["params"], want)
    np.testing.assert_allclose(
        np.mean([r["losses"] for r in ranks], axis=0), ref_losses,
        rtol=1e-6)


def test_synthetic_lm_train_on_the_cpu():
    res = synthetic_lm_train("tiny", vocab=VOCAB, steps=1, warmup=1,
                             device="cpu", fused_ln=True, fused_opt=True)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["device"] == "cpu" and res["mfu_pct"] is None
    assert res["peak_memory_bytes"] is None and res["chunked"] is False
    assert res["gradient_leaves"] == 2 * 12 + 4
    assert res["launches"] == {w.__name__: 0 for w in ck.WRAPPERS}
    assert res["n_params"] - res["n_nonemb_params"] == (VOCAB + 64) * 64
    assert len(res["params_sha256"]) == 64


def test_synthetic_lm_train_tokens_are_lm_bench_shards():
    whole = np.random.RandomState(0).randint(0, 100, (6, 9))
    parts = [synthetic_lm_tokens(2, 8, 100, r, 3) for r in range(3)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)


def test_synthetic_lm_train_needs_a_card_unless_the_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(hvd.HorovodError, match="device='cpu'"):
        synthetic_lm_train("tiny", vocab=VOCAB, steps=1, warmup=0)
    assert not hvd.is_initialized()


def test_remat_full_matches_none_and_unported_paths_raise():
    """``remat="full"`` and ``"dots"`` change what the backward recomputes,
    never the math: on the CPU their gradients equal ``"none"``'s bit for
    bit (on one thread: threaded CPU BLAS may split the tied head's sums
    another way from one call to the next). The unported KV-cache path
    raises."""
    x, y = _tokens()
    grads = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for remat in ("none", "full", "dots"):
            net = tf.TransformerLMTiny(vocab_size=VOCAB, dtype=torch.float32,
                                       remat=remat)
            tf.lm_loss(net(torch.from_numpy(x)),
                       torch.from_numpy(y)).backward()
            grads.append({k: p.grad for k, p in net.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    for other in grads[1:]:
        for k in grads[0]:
            assert torch.equal(grads[0][k], other[k]), k
    with pytest.raises(ValueError, match="remat"):
        tf.TransformerLMTiny(vocab_size=VOCAB, remat="bogus")
    net = tf.TransformerLMTiny(vocab_size=VOCAB, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="cached_attention"):
        net(torch.from_numpy(x), kv_cache=(None, None, None))
    with pytest.raises(ValueError, match="max_seq_len"):
        net(torch.from_numpy(x), pos_offset=400)


def test_remat_dots_gradients_match_the_reference_dots():
    """The port's ``remat="dots"`` against the reference's
    ``TransformerLMTiny(remat="dots")`` (``jax.checkpoint`` with
    ``dots_with_no_batch_dims_saveable``) on the same weights, to the
    reference test's own 1e-6 (``tests/test_transformer.py:185-199``)."""
    _, params = _reference()
    model = ref_tf.TransformerLMTiny(vocab_size=VOCAB, dtype=jnp.float32,
                                     remat="dots")
    x, y = _tokens()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    ref = jax.grad(lambda p: ref_tf.lm_loss(model.apply({"params": p}, xj),
                                            yj))(params)
    want = transformer_state_dict_from_flax(_np_tree(ref))
    net = _port()
    net.remat = "dots"
    tf.lm_loss(net(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def _activation_bytes(remat: str) -> int:
    """Bytes the autograd graph of one forward keeps for the backward:
    every op's output storage is recorded (a dispatch mode) and those still
    alive once the forward's locals are gone, the loss aside, are summed.
    ``saved_tensors_hooks`` cannot see them all: non-reentrant checkpoint
    and its selective cache keep theirs apart (through an outer hook
    ``"full"`` and ``"dots"`` pack the same bytes)."""
    import gc
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.storages = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    self.storages[st.data_ptr()] = (weakref.ref(st),
                                                    st.nbytes())
            return out

    x, y = _tokens()
    net = tf.TransformerLMTiny(vocab_size=VOCAB, dtype=torch.float32,
                               remat=remat)
    with Record() as rec:
        loss = tf.lm_loss(net(torch.from_numpy(x)), torch.from_numpy(y))
    gc.collect()
    held = sum(n for ref, n in rec.storages.values() if ref() is not None)
    loss.backward()  # the graph was whole
    return held


def test_remat_dots_keeps_less_than_none_and_more_than_full():
    held = {m: _activation_bytes(m) for m in ("none", "full", "dots")}
    assert held["full"] < held["dots"] < held["none"], held
