"""Rank functions of the port's sequence-parallel clusters, for
``tests/test_torch_ring.py`` and ``tests/test_torch_sp.py``. They import
only the port (never jax), so that the spawned ranks start quickly; each
returns numpy arrays and strings for the test process to compare."""

import numpy as np
import torch

# ring / Ulysses attention: per-rank block of the sequence
ATTN_SHAPE = dict(b=1, t=64, h=4, d=64)


def attention_inputs(world, seed=0):
    """Global q, k, v and a row-dependent cotangent w, [B, world*t, H, D]
    f32."""
    s = ATTN_SHAPE
    rng = np.random.RandomState(seed + world)
    return [rng.randn(s["b"], world * s["t"], s["h"], s["d"]).astype(
        np.float32) for _ in range(4)]


def _value_and_grads(fn, q, k, v, w):
    qs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*qs)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), qs)
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def attention_worker(world):
    """Ring attention (causal and not), the plain per-hop step
    ``_block_attn`` differentiated through the forward ring, and, at world
    4, Ulysses attention: outputs and gradients of the global inputs, the
    launch counts, and Ulysses's refusal of H % sp != 0."""
    import importlib
    from functools import partial

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import (make_ring_attention,
                                            make_ulysses_attention)
    from horovod_tpu_torch.parallel._comm import gather_seq, shard_seq

    # the package's function shadows the module's name
    ra = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

    torch.set_num_threads(1)  # ranks beside other test workers
    assert hvd.size() == world
    q, k, v, w = attention_inputs(world)
    out = {}
    for causal in (True, False):
        out[("ring", causal)] = _value_and_grads(
            make_ring_attention(causal=causal), q, k, v, w)

        def plain(q, k, v, causal=causal):
            blocks = [shard_seq(x) for x in (q, k, v)]
            _, l, o = ra._ring_fwd_stats(*blocks, None, partial(
                ra._block_attn, causal=causal, scale=q.shape[-1] ** -0.5))
            return gather_seq(o / l.transpose(1, 2)[..., None])

        out[("plain", causal)] = _value_and_grads(plain, q, k, v, w)
    if world == 4:
        out[("ulysses", True)] = _value_and_grads(
            make_ulysses_attention(causal=True), q, k, v, w)
        try:
            make_ulysses_attention()(*(torch.from_numpy(x[:, :, :2])
                                       for x in (q, k, v)))
            out["heads"] = None
        except ValueError as e:
            out["heads"] = str(e)
    out["launches"] = ck.launch_counts()
    return out


def sp_worker(state_dict, vocab, fwd_tokens, tokens, targets, long_tokens):
    """The sequence-parallel LM on 4 ranks: the forward on a 1 x 4 grid,
    one SGD(0.1) step on a 2 x 2 grid (its groups reused when the grid is
    built again), the over-length refusals and the grid's size check."""
    from horovod_tpu_torch.models.transformer import TransformerLMTiny
    from horovod_tpu_torch.parallel import (make_dp_sp_mesh, make_sp_forward,
                                            make_sp_train_step,
                                            replicate_to_mesh, sp_model)
    from horovod_tpu_torch.train import params_sha256

    torch.set_num_threads(1)
    out = {}

    def model(mesh):
        net = sp_model(TransformerLMTiny, mesh, vocab_size=vocab,
                       dtype=torch.float32)
        net.load_state_dict(state_dict)
        return replicate_to_mesh(net)

    mesh = make_dp_sp_mesh(dp=1, sp=4)
    out["forward"] = make_sp_forward(model(mesh), mesh)(
        torch.from_numpy(fwd_tokens)).numpy()

    mesh = make_dp_sp_mesh(dp=2, sp=2)
    again = make_dp_sp_mesh(dp=2, sp=2)
    out["groups_reused"] = (again.sp_group is mesh.sp_group
                            and again.dp_group is mesh.dp_group)
    net = model(mesh)
    step = make_sp_train_step(net, torch.optim.SGD(net.parameters(), lr=0.1),
                              mesh)
    out["loss"] = float(step(torch.from_numpy(tokens),
                             torch.from_numpy(targets)))
    out["params"] = {k: p.detach().numpy().copy()
                     for k, p in net.named_parameters()}
    out["sha"] = params_sha256(net)
    out["grid"] = (mesh.dp_rank, mesh.sp_rank)

    errors = []
    long = torch.from_numpy(long_tokens)
    for call in (lambda: step(long, long),
                 lambda: make_sp_forward(net, mesh)(long)):
        try:
            call()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["too_long"] = errors
    try:
        make_dp_sp_mesh(dp=4, sp=4)
        out["mesh"] = None
    except ValueError as e:
        out["mesh"] = str(e)
    return out
