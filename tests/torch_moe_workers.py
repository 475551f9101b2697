"""Rank functions of the port's expert- and pipeline-parallel clusters, for
``tests/test_torch_moe.py`` and ``tests/test_torch_pipeline.py``. They
import only the port (never jax), so that the spawned ranks start quickly;
each takes numpy inputs made by the test process and returns numpy arrays
and numbers for it to compare with the reference."""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block(a, parts, index):
    k = a.shape[0] // parts
    return a[index * k:(index + 1) * k]


def _tree_np(tree):
    from horovod_tpu_torch.parallel.expert import tree_map_with_path

    return tree_map_with_path(lambda _p, t: t.detach().numpy().copy(), tree)


def _trainable(tree):
    from horovod_tpu_torch.parallel.expert import tree_map_with_path

    return tree_map_with_path(lambda _p, t: t.clone().requires_grad_(), tree)


def _cap_loss(p, batch, moe):
    xb, yb = batch
    y, aux = moe(p, xb)
    return torch.mean((y - yb) ** 2) + 0.01 * aux


def _capacity_run(full, xb, yb, mesh, wire, steps, cf, block, opt):
    """``steps`` capacity steps from the full tree ``full`` (numpy): the
    losses, the last stats, this rank's final shards and residual."""
    from horovod_tpu_torch.models.convert import moe_params_from_jax
    from horovod_tpu_torch.parallel import expert as epar

    p = _trainable(epar.shard_params_ep(moe_params_from_jax(full), mesh))
    n = xb.shape[0]
    make = ((lambda ls: torch.optim.SGD(ls, lr=0.1)) if opt == "sgd"
            else (lambda ls: torch.optim.Adam(ls, lr=1e-2)))
    state = epar.moe_opt_state(make, p, mesh, n, cf)
    step = epar.make_ep_train_step(_cap_loss, mesh, dispatch="capacity",
                                   capacity_factor=cf, wire=wire or "off",
                                   block=block)
    losses, stats = [], None
    for _ in range(steps):
        loss, stats = step(p, state, (_t(xb), _t(yb)))
        losses.append(float(loss))
    return dict(losses=losses, params=_tree_np(p), ef=state[1].numpy(),
                load=stats["load"].numpy(), dropped=float(stats["dropped"]),
                capacity=float(stats["capacity"]))


def moe_worker(c):
    """Every expert-parallel case of ``test_torch_moe.py`` on one rank of a
    dp=2 x ep=2 grid (``c``: the inputs)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.models.convert import moe_params_from_jax
    from horovod_tpu_torch.ops import cuda_kernels as ck
    from horovod_tpu_torch.parallel import expert as epar
    from horovod_tpu_torch.train import synthetic_moe_train

    torch.set_num_threads(1)  # ranks beside other test workers
    mesh = epar.make_dp_ep_mesh(2, 2)
    r, world = hvd.rank(), hvd.size()
    out = {"grid": (mesh.dp_rank, mesh.ep_rank), "rank": mesh.rank}
    g = mesh.ep_group

    # the quantized all_to_all: values, fallbacks, gradient, residual
    x = _t(_block(c["a2a_x"], world, r))
    spmd.reset_hop_bytes()
    for wire in ("int8", "int4"):
        out[f"a2a_{wire}"] = spmd.quantized_all_to_all(x, g, wire,
                                                       256).numpy()
    out["a2a_hop_bytes"] = spmd.hop_bytes()
    out["a2a_exact"] = spmd.quantized_all_to_all(x, g, "", 256).numpy()
    for name in ("int32", "small"):
        xi = _t(_block(c[f"a2a_{name}"], world, r))
        out[f"a2a_{name}"] = spmd.quantized_all_to_all(xi, g, "int8",
                                                       256).numpy()
    xg = x.clone().requires_grad_()
    w = _t(_block(c["a2a_w"], world, r))
    (spmd.quantized_all_to_all(xg, g, "int8", 256) * w).sum().backward()
    out["a2a_grad"] = xg.grad.numpy()
    xe = _t(_block(c["ef_x"], world, r))
    y1, ef1 = spmd.quantized_all_to_all(xe, g, "int8", 64,
                                        ef=torch.zeros_like(xe))
    y2, ef2 = spmd.quantized_all_to_all(
        xe, g, "int8", 64, ef=_t(_block(c["ef_ref1"], world, r)))
    out["ef"] = [a.numpy() for a in (y1, ef1, y2, ef2)]
    y0 = spmd.quantized_all_to_all(xe, g, "int8", 64)
    out["ef_none_equal"] = bool(torch.equal(y0, y1))
    _, efz = spmd.quantized_all_to_all(
        _t(_block(c["a2a_int32"], world, r)), g, "int8", 256,
        ef=torch.zeros(8, 64))
    out["ef_fallback_zero"] = bool((efz == 0).all())
    try:
        spmd.quantized_all_to_all(torch.zeros(3, 4), g, "int8", 256)
    except ValueError as e:
        out["a2a_indivisible"] = str(e)

    # capacity dispatch with ample capacity against the dense math
    full = c["params"]
    xb, yb = c["xb"], c["yb"]
    p = epar.shard_params_ep(moe_params_from_jax(full), mesh)
    moe = epar.SwitchDispatch(mesh, 8.0, "", None, None)
    y, aux = moe(p, _t(_block(xb, world, r)))
    out["ample"] = (y.numpy(), float(aux))
    out["ample_stats"] = (moe.stats["load"].numpy(),
                          float(moe.stats["dropped"]))
    y_d, aux_d = epar.dense_moe_apply(moe_params_from_jax(full), _t(xb))
    out["dense"] = (y_d.numpy(), float(aux_d))

    # the capacity step against the reference's
    ck.reset_launch_counts()
    out["cap_off"] = _capacity_run(full, xb, yb, mesh, "", 3, 2.0, 64, "sgd")
    out["cap_int8"] = _capacity_run(full, xb, yb, mesh, "int8", 3, 2.0, 64,
                                    "sgd")
    out["cap_tight"] = _capacity_run(full, xb, yb, mesh, "", 1, 0.25, 64,
                                     "sgd")

    # the record of one int8 step against the byte catalog
    epar.reset_moe_record()
    rec_run = _capacity_run(full, xb, yb, mesh, "int8", 1, 2.0, 64, "adam")
    out["record"] = (epar.moe_record(), rec_run["load"], rec_run["dropped"])

    # 30 Adam steps: the int8 / int4 wires and the off wire, for the gate
    for wire in ("", "int8", "int4"):
        out[f"conv_{wire or 'off'}"] = _capacity_run(
            full, xb, yb, mesh, wire, 30, 2.0, 64, "adam")["losses"]

    # the exact-dispatch step (MoEMLP's tree, (y ** 2).mean() + aux)
    ex = c["exact"]
    pe = _trainable(epar.shard_params_ep(moe_params_from_jax(ex["params"]),
                                         mesh))
    opt = torch.optim.SGD(epar.tree_leaves(pe), lr=0.05)

    def exact_loss(pp, batch, moe):
        xx, = batch
        y, aux = moe(pp, xx.reshape(-1, xx.shape[-1]))
        return (y ** 2).mean() + 0.01 * aux

    step = epar.make_ep_train_step(exact_loss, mesh)
    out["exact_losses"] = [float(step(pe, opt, (_t(ex["x"]),)))
                           for _ in range(3)]
    out["exact_params"] = _tree_np(pe)

    # the capacity step refuses a loss that never calls moe
    st = epar.make_ep_train_step(lambda pp, b, moe: pp["w_in"].sum() * 0,
                                 mesh, dispatch="capacity")
    pz = _trainable(p)
    try:
        st(pz, epar.moe_opt_state(lambda ls: torch.optim.SGD(ls, lr=0.1),
                                  pz, mesh, xb.shape[0], 1.25),
           (_t(xb), _t(yb)))
    except ValueError as e:
        out["no_moe_call"] = str(e)
    try:
        epar.moe_opt_state(lambda ls: None, pz, mesh, xb.shape[0] + 1, 1.25)
    except ValueError as e:
        out["opt_state_indivisible"] = str(e)
    out["opt_state_shape"] = tuple(epar.moe_opt_state(
        lambda ls: None, pz, mesh, xb.shape[0], 1.25)[1].shape)

    # the whole slice: lm_bench's MoE block through the trainer
    tr = c["trainer"]
    for dispatch in ("exact", "capacity-int8"):
        res = synthetic_moe_train(dispatch, steps=2, warmup=0, device="cpu",
                                  params=moe_params_from_jax(tr["params"]),
                                  **tr["widths"])
        out[f"trainer_{dispatch}"] = (res["losses"], res["drop_rate"],
                                      res["imbalance"], res["dp"], res["ep"])
    out["launches"] = ck.launch_counts()
    return out


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_worker(c):
    """Every pipeline case of ``test_torch_pipeline.py`` on one rank of
    pp = 4 (``c``: the inputs)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.convert import moe_params_from_jax
    from horovod_tpu_torch.parallel import pipeline as pp

    torch.set_num_threads(1)
    mesh = pp.make_pp_mesh(4)
    out = {"rank": mesh.pp_rank}
    stacked = moe_params_from_jax(c["stacked"])
    x = _t(c["x"])

    def fresh():
        return pp.shard_stage_params(stacked, mesh)

    for m in (1, 2, 4, 8):
        with torch.no_grad():
            out[f"fwd_{m}"] = pp.make_pipeline_fn(_tanh_stage, mesh, m)(
                fresh(), x).numpy()
    mine = fresh()
    y = pp.make_pipeline_fn(_tanh_stage, mesh, 4)(mine, x)
    ((y - 1.0) ** 2).mean().backward()
    out["grads"] = {k: v.grad.numpy() for k, v in mine.items()}
    # a gradient of the input: summed over pp, the same on every rank
    xg = x.clone().requires_grad_()
    (pp.make_pipeline_fn(_tanh_stage, mesh, 4)(fresh(), xg) ** 2).sum() \
        .backward()
    out["x_grad"] = xg.grad.numpy()

    mine = fresh()
    opt = torch.optim.SGD(mine.values(), lr=0.1)
    step = pp.make_pp_train_step(
        _tanh_stage, lambda a, t: ((a - t) ** 2).mean(), opt, mesh, 2)
    out["losses"] = [float(step(mine, x, torch.zeros_like(x)))
                     for _ in range(10)]
    out["trained"] = {k: v.detach().numpy() for k, v in mine.items()}

    wide = moe_params_from_jax(c["stacked8"])
    try:
        pp.make_pipeline_fn(_tanh_stage, mesh, 2)(
            pp.shard_stage_params(wide, mesh), x)
    except ValueError as e:
        out["eight_stages"] = str(e)
    try:
        pp.make_pipeline_fn(_tanh_stage, mesh, 3)(fresh(), x)
    except ValueError as e:
        out["microbatches"] = str(e)
    for bad in (8, 2):
        try:
            pp.make_pp_mesh(bad)
        except ValueError as e:
            out[f"mesh_{bad}"] = str(e)
    out["world"] = hvd.size()
    return out
