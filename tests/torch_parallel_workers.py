"""Rank functions of the port's parallel clusters, for
``tests/test_torch_ring.py``, ``test_torch_sp.py``, ``test_torch_matmul.py``,
``test_torch_tp.py`` and ``test_torch_hybrid.py``. They import
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


def matmul_rs_worker(cases):
    """``matmul_reduce_scatter`` and its unfused reference on every rank:
    ``cases`` maps a name to (x, w), numpy arrays ``[world, ...]`` with one
    leading slice per rank (f32; the name ``bf16`` casts them). Returns
    each case's two results (as f32), the calls of K10's wrapper per ring
    call, or the message of the ``ValueError`` both raise."""
    import types

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.ops import matmul as mm

    torch.set_num_threads(1)
    calls = []
    wrapped = ck.matmul_2d

    def counted(x2, w2):
        calls.append(tuple(x2.shape))
        return wrapped(x2, w2)

    mm.ck = types.SimpleNamespace(matmul_2d=counted,
                                  matmul_tiles=ck.matmul_tiles)
    out = {}
    for name, (x, w) in cases.items():
        dt = torch.bfloat16 if name.startswith("bf16") else torch.float32
        xr = torch.from_numpy(x[hvd.rank()]).to(dt)
        wr = torch.from_numpy(w[hvd.rank()]).to(dt)
        try:
            del calls[:]
            ring = mm.matmul_reduce_scatter(xr, wr)
            n_calls = len(calls)
            ref = mm.matmul_reduce_scatter_reference(xr, wr)
            out[name] = dict(ring=ring.float().numpy(),
                             ref=ref.float().numpy(), calls=n_calls,
                             dtype=str(ring.dtype))
        except ValueError as e:
            out[name] = dict(error=str(e))
    try:
        with torch.enable_grad():
            mm.matmul_reduce_scatter(
                torch.zeros(8 * hvd.size(), 128, requires_grad=True),
                torch.zeros(128, 128))
        out["grad"] = None
    except NotImplementedError as e:
        out["grad"] = str(e)
    return out


def _tp_model(state_dict, cfg, attn):
    from horovod_tpu_torch.models.transformer import TransformerLM

    net = TransformerLM(attn_fn=attn, dtype=torch.float32, **cfg)
    net.load_state_dict(state_dict)
    return net


def tp_worker(state_dict, cfg, tokens, targets, steps, lr, momentum):
    """dp=2 x tp=2 on 4 ranks: the model sharded two ways (slicing its
    weights in place, and loading ``shard_state_dict_tp`` of the full
    ones), ``steps`` SGD steps with momentum through ``make_tp_train_step``
    on the global batch; returns the losses, this rank's shards, the full
    parameters gathered over tp, this rank's q/k/v of the first block, and
    the spec table."""
    from horovod_tpu_torch.parallel.tensor import shard_state_dict_tp
    from horovod_tpu_torch.parallel import (make_dp_tp_mesh,
                                            make_tp_train_step,
                                            plain_attention, shard_batch_dp,
                                            shard_params_tp,
                                            tp_param_shardings)
    from horovod_tpu_torch.parallel.tensor import full_state_dict_tp
    from horovod_tpu_torch.train import params_sha256

    torch.set_num_threads(1)
    out = {}
    mesh = make_dp_tp_mesh(dp=2, tp=2)
    out["grid"] = (mesh.dp_rank, mesh.tp_rank)
    full = _tp_model(state_dict, cfg, plain_attention)
    out["specs"] = tp_param_shardings(full, mesh)
    # this rank's q, k, v of block 0, full model and sharded
    x = shard_batch_dp(torch.from_numpy(tokens), mesh)
    with torch.no_grad():
        h = full.tok_emb(x) + full.pos_emb[:x.shape[1]]
        ln = full.blocks[0].ln_attn(h)
        out["qkv_full"] = full.blocks[0].qkv(ln).numpy()
    net = shard_params_tp(full, mesh)
    with torch.no_grad():
        out["qkv_shard"] = net.blocks[0].qkv(ln).numpy()
    other = shard_params_tp(_tp_model(state_dict, cfg, plain_attention), mesh)
    other.load_state_dict(shard_state_dict_tp(state_dict, mesh))
    out["loaded_equal"] = params_sha256(other) == params_sha256(net)
    out["shard_shapes"] = {k: tuple(p.shape)
                           for k, p in net.named_parameters()}
    opt = torch.optim.SGD(net.parameters(), lr=lr, momentum=momentum)
    step = make_tp_train_step(net, opt, mesh)
    out["losses"] = [float(step(torch.from_numpy(tokens),
                                torch.from_numpy(targets)))
                     for _ in range(steps)]
    out["shards"] = {k: p.detach().numpy().copy()
                     for k, p in net.named_parameters()}
    out["full"] = {k: v.numpy()
                   for k, v in full_state_dict_tp(net, mesh).items()}
    return out


def hybrid_worker(state_dict, cfg, tokens, targets, steps, lr, momentum,
                  carried):
    """dp=2 x tp=2 x sp=2 on 8 ranks: ``steps`` SGD steps with momentum
    through ``make_hybrid_train_step`` from the full weights. Then the
    carried optimizer state: ``carried`` = (parameters after one SGD step,
    that optimizer's full state_dict, a full AdamW state_dict) of a world-1
    run; the SGD state, sliced by ``shard_opt_state_hybrid``, is taken one
    more step here, and the AdamW state is loaded. Returns the losses, the
    full parameters gathered over tp, this rank's shards, the carried step's
    result and the loaded AdamW state's shapes."""
    from horovod_tpu_torch.parallel.tensor import shard_state_dict_tp
    from horovod_tpu_torch.models.transformer import TransformerLM
    from horovod_tpu_torch.parallel import (hybrid_model, make_dp_tp_sp_mesh,
                                            make_hybrid_train_step,
                                            shard_data_hybrid,
                                            shard_opt_state_hybrid,
                                            shard_params_hybrid)
    from horovod_tpu_torch.parallel.tensor import full_state_dict_tp

    torch.set_num_threads(1)
    mesh = make_dp_tp_sp_mesh(dp=2, tp=2, sp=2)
    out = {"grid": (mesh.dp_rank, mesh.tp_rank, mesh.sp_rank),
           "block": shard_data_hybrid(torch.from_numpy(tokens), mesh).numpy()}

    def model(state):
        net = hybrid_model(TransformerLM, mesh, dtype=torch.float32, **cfg)
        net.load_state_dict(state)
        return shard_params_hybrid(net, mesh)

    def sgd(net):
        return torch.optim.SGD(net.parameters(), lr=lr, momentum=momentum)

    net = model(state_dict)
    step = make_hybrid_train_step(net, sgd(net), mesh)
    out["losses"] = [float(step(torch.from_numpy(tokens),
                                torch.from_numpy(targets)))
                     for _ in range(steps)]
    out["full"] = {k: v.numpy()
                   for k, v in full_state_dict_tp(net, mesh).items()}
    out["shards"] = {k: p.detach().numpy().copy()
                     for k, p in net.named_parameters()}

    params1, sgd_state, adamw_state = carried
    net = model(state_dict)
    net.load_state_dict(shard_state_dict_tp(params1, mesh))
    opt = sgd(net)
    opt.load_state_dict(shard_opt_state_hybrid(sgd_state, params1, mesh))
    out["carried_loss"] = float(make_hybrid_train_step(net, opt, mesh)(
        torch.from_numpy(tokens), torch.from_numpy(targets)))
    out["carried_full"] = {k: v.numpy() for k, v in
                           full_state_dict_tp(net, mesh).items()}
    adamw = torch.optim.AdamW(net.parameters())
    adamw.load_state_dict(shard_opt_state_hybrid(adamw_state, params1, mesh))
    out["adamw_state"] = {
        name: {k: (tuple(v.shape) if v.dim() else float(v))
               for k, v in adamw.state[p].items()}
        for name, p in net.named_parameters()}
    return out
