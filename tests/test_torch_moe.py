"""The port's Switch MoE (``horovod_tpu_torch/parallel/expert.py``) and
quantized all_to_all (``spmd.quantized_all_to_all``) against the
reference's (``horovod_tpu/parallel/expert.py``, ``horovod_tpu/spmd.py``) on
the CPU: the cases of ``tests/test_moe.py`` and
``tests/test_expert_parallel.py``.

The reference runs in this process on a dp=2 x ep=2 mesh of JAX CPU
devices; the port on 4 gloo ranks (one module-scoped
``testing.run_cluster``, rank r at ``divmod(r, 2)``), from the same seeded
numpy inputs (f32) and the reference's weights (``moe_params_from_jax``).
Tolerances: the quantized exchange bit for bit (its straight-through
gradient to rtol 1e-6, its residual to one ulp of the product ``q *
scale``, which XLA may fuse into ``x - q * scale``); capacity with ample
CF against the dense math to 1e-6; the capacity and exact steps to 1e-5
relative (parameters with an atol of 1e-7 for elements near zero); int8
steps to 1e-4 (a value of the reference's einsums one rounding away from
the port's can round to the next quantum); the gate bar of the reference's
test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from horovod_tpu import spmd as rspmd
from horovod_tpu.ops import adaptive as radaptive
from horovod_tpu.parallel import expert as repar
from horovod_tpu_torch import testing
from horovod_tpu_torch.models.convert import (moe_params_from_jax,
                                              moe_state_dict_from_flax)
from horovod_tpu_torch.ops import adaptive
from horovod_tpu_torch.ops import compression as comp
from horovod_tpu_torch.parallel import expert as epar
from torch_moe_workers import moe_worker

E, D, HM = 8, 16, 2
N = 256
W = 4
AXES = ("dp", "ep")


def _mesh():
    return repar.make_dp_ep_mesh(2, 2, devices=jax.devices()[:W])


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _sm(fn, mesh):
    return jax.jit(rspmd._shard_map(fn, mesh, in_specs=(P(AXES),),
                                    out_specs=P(AXES)))


def _ref_a2a(x, wire, block, mesh):
    return np.asarray(_sm(lambda z: rspmd.quantized_all_to_all(
        z, "ep", wire, block), mesh)(jnp.asarray(x)))


def _ref_capacity(params, xb, yb, wire, steps, cf, block, tx):
    mesh = _mesh()
    p = repar.shard_params_ep(jax.tree_util.tree_map(jnp.asarray, params),
                              mesh)
    st = repar.moe_opt_state(tx, p, mesh, N, cf)

    def loss_fn(pp, batch, moe):
        x, y = batch
        out, aux = moe(pp, x)
        return jnp.mean((out - y) ** 2) + 0.01 * aux

    step = repar.make_ep_train_step(loss_fn, tx, mesh, dispatch="capacity",
                                    capacity_factor=cf, wire=wire or "off",
                                    block=block).jitted
    sh = NamedSharding(mesh, P(AXES))
    batch = (jax.device_put(jnp.asarray(xb), sh),
             jax.device_put(jnp.asarray(yb), sh))
    losses = []
    for _ in range(steps):
        p, st, loss, stats = step(p, st, batch)
        losses.append(float(loss))
    return dict(losses=losses, params=_np_tree(p),
                ef=np.asarray(st[1]), load=np.asarray(stats["load"]),
                dropped=float(stats["dropped"]))


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    mesh = _mesh()
    c = {"a2a_x": rng.randn(32, 300).astype(np.float32),
         "a2a_w": rng.randn(32, 300).astype(np.float32),
         "a2a_int32": np.arange(32 * 64, dtype=np.int32).reshape(32, 64),
         "a2a_small": rng.randn(32, 8).astype(np.float32),
         "ef_x": rng.randn(32, 256).astype(np.float32)}
    params = _np_tree(repar.init_moe_params(jax.random.PRNGKey(0), D, E,
                                            hidden_mult=HM))
    xb = rng.randn(N, D).astype(np.float32)
    yb = xb @ (0.1 * rng.randn(D, D)).astype(np.float32)
    c.update(params=params, xb=xb, yb=yb.astype(np.float32))

    ref = {}
    for wire in ("int8", "int4", ""):
        ref[f"a2a_{wire or 'exact'}"] = _ref_a2a(c["a2a_x"], wire, 256, mesh)
    for name in ("int32", "small"):
        ref[f"a2a_{name}"] = _ref_a2a(c[f"a2a_{name}"], "int8", 256, mesh)
        ref[f"a2a_{name}_exact"] = np.asarray(_sm(
            lambda z: jax.lax.all_to_all(z, "ep", 0, 0, tiled=True),
            mesh)(jnp.asarray(c[f"a2a_{name}"])))
    # the gradient of sum over ranks of <a2a(x), w>: per-rank partial sums
    # out, summed outside, so the cotangent is one on every rank
    part = rspmd._shard_map(
        lambda z, w: jnp.sum(rspmd.quantized_all_to_all(
            z, "ep", "int8", 256) * w)[None], mesh,
        in_specs=(P(AXES), P(AXES)), out_specs=P(AXES))
    ref["a2a_grad"] = np.asarray(jax.jit(jax.grad(
        lambda z: part(z, jnp.asarray(c["a2a_w"])).sum()))(
            jnp.asarray(c["a2a_x"])))
    ef_sm = jax.jit(rspmd._shard_map(
        lambda z, e: rspmd.quantized_all_to_all(z, "ep", "int8", 64, ef=e),
        mesh, in_specs=(P(AXES), P(AXES)), out_specs=(P(AXES), P(AXES))))
    xe = jnp.asarray(c["ef_x"])
    y1, ef1 = ef_sm(xe, jnp.zeros_like(xe))
    y2, ef2 = ef_sm(xe, ef1)
    ref["ef"] = [np.asarray(a) for a in (y1, ef1, y2, ef2)]
    c["ef_ref1"] = ref["ef"][1]

    # capacity with ample CF; the dense math
    cap_sm = jax.jit(rspmd._shard_map(
        lambda pp, xx: repar.SwitchDispatch("dp", "ep", 8.0, "", None,
                                            None)(pp, xx), mesh,
        in_specs=(repar.ep_specs(params), P(AXES)),
        out_specs=(P(AXES), P())))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    y_cap, aux_cap = cap_sm(repar.shard_params_ep(jp, mesh), jnp.asarray(xb))
    ref["ample"] = (np.asarray(y_cap), float(aux_cap))
    y_d, aux_d = repar.dense_moe_apply(jp, jnp.asarray(xb))
    ref["dense"] = (np.asarray(y_d), float(aux_d))

    sgd = optax.sgd(0.1)
    ref["cap_off"] = _ref_capacity(params, xb, yb, "", 3, 2.0, 64, sgd)
    ref["cap_int8"] = _ref_capacity(params, xb, yb, "int8", 3, 2.0, 64, sgd)
    ref["cap_tight"] = _ref_capacity(params, xb, yb, "", 1, 0.25, 64, sgd)
    ref["conv_int8"] = _ref_capacity(params, xb, yb, "int8", 30, 2.0, 64,
                                     optax.adam(1e-2))["losses"]

    # the exact-dispatch step (tests/test_expert_parallel.py's case)
    model = repar.MoEMLP(num_experts=4, dtype=jnp.float32)
    xm = rng.randn(2, 6, 8).astype(np.float32)
    mp = model.init(jax.random.PRNGKey(0), jnp.asarray(xm))["params"]

    def exact_loss(p, xx):
        y, aux = model.apply({"params": p}, xx)
        return (y ** 2).mean() + 0.01 * aux

    tx = optax.sgd(0.05)
    ep_params = repar.shard_params_ep(mp, mesh)
    ep_opt = tx.init(ep_params)
    step = repar.make_ep_train_step(exact_loss, tx, mesh)
    xs = jax.device_put(jnp.asarray(xm), NamedSharding(mesh, P("dp")))
    ex_losses = []
    for _ in range(3):
        ep_params, ep_opt, loss = step(ep_params, ep_opt, xs)
        ex_losses.append(float(loss))
    ref["exact_losses"] = ex_losses
    ref["exact_params"] = _np_tree(ep_params)
    c["exact"] = dict(params=_np_tree(mp), x=xm)

    # lm_bench's MoE block at small widths, the reference's step for 2
    # steps of each dispatch
    widths = dict(d_model=16, hidden_mult=2, vocab=64, experts=8,
                  tokens=512, capacity_factor=1.25, ep=2)
    c["trainer"] = dict(widths=widths, params=_trainer_params(widths))
    ref["trainer"] = _ref_trainer(c["trainer"]["params"], widths)

    ranks = testing.run_cluster(moe_worker, np=W, device="cpu", args=(c,),
                                timeout=300)
    return dict(c=c, ref=ref, ranks=ranks)


def _trainer_params(widths):
    p = dict(repar.init_moe_params(jax.random.PRNGKey(0), widths["d_model"],
                                   widths["experts"],
                                   hidden_mult=widths["hidden_mult"]))
    p["emb"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), (widths["vocab"], widths["d_model"]),
        jnp.float32)
    return _np_tree(p)


def _ref_trainer(params, widths):
    """``lm_bench.run_moe``'s model and steps (Adam 1e-2), 2 steps of the
    exact and the capacity-int8 dispatch on the 2 x 2 mesh."""
    mesh = _mesh()
    n, vocab = widths["tokens"], widths["vocab"]
    toks = jnp.asarray(np.random.RandomState(0).randint(0, vocab, (n + 1,)))
    tokens, targets = toks[:-1], toks[1:]

    def head(p, h, y, tgt, aux):
        logits = (h + y) @ p["emb"].T
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tgt).mean() + 0.01 * aux

    def dense_loss(p, batch):
        tok, tgt = batch
        h = p["emb"][tok]
        y, aux = repar.dense_moe_apply(p, h)
        return head(p, h, y, tgt, aux)

    def cap_loss(p, batch, moe):
        tok, tgt = batch
        h = p["emb"][tok]
        y, aux = moe(p, h)
        return head(p, h, y, tgt, aux)

    tx = optax.adam(1e-2)
    out = {}
    for name in ("exact", "capacity-int8"):
        p = repar.shard_params_ep(jax.tree_util.tree_map(jnp.asarray,
                                                         params), mesh)
        if name == "exact":
            step = repar.make_ep_train_step(dense_loss, tx, mesh)
            opt = repar.shard_params_ep(tx.init(p), mesh)
            sh = NamedSharding(mesh, P("dp"))
        else:
            step = repar.make_ep_train_step(
                cap_loss, tx, mesh, dispatch="capacity",
                capacity_factor=widths["capacity_factor"], wire="int8").jitted
            opt = repar.moe_opt_state(tx, p, mesh, n,
                                      widths["capacity_factor"])
            sh = NamedSharding(mesh, P(AXES))
        batch = (jax.device_put(tokens, sh), jax.device_put(targets, sh))
        losses = []
        for _ in range(2):
            res = step(p, opt, batch)
            p, opt = res[0], res[1]
            losses.append(float(res[2]))
        out[name] = losses
    return out


def _gather(case, key):
    """The ranks' blocks of a sharded result, in grid order."""
    return np.concatenate([r[key] for r in case["ranks"]])


def _assert_tree_close(got, want, rtol, atol, what):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_tree_close(got[k], v, rtol, atol, f"{what}/{k}")
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                       err_msg=f"{what}/{k}")


# ------------------------------------------------------------- the grid
def test_grid_places_ranks(case):
    assert [r["grid"] for r in case["ranks"]] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    assert [r["rank"] for r in case["ranks"]] == [0, 1, 2, 3]


# ------------------------------------------------ quantized all_to_all
@pytest.mark.parametrize("wire", ["int8", "int4", "exact"])
def test_quantized_all_to_all_bit_equal(case, wire):
    got = _gather(case, f"a2a_{wire}")
    np.testing.assert_array_equal(got, case["ref"][f"a2a_{wire}"])


@pytest.mark.parametrize("wire,tol", [("int8", 0.02), ("int4", 0.2)])
def test_quantized_all_to_all_accuracy(case, wire, tol):
    got, exact = _gather(case, f"a2a_{wire}"), _gather(case, "a2a_exact")
    rel = np.abs(got - exact).max() / np.abs(exact).max()
    assert 0 < rel < tol, (wire, rel)


@pytest.mark.parametrize("name", ["int32", "small"])
def test_quantized_all_to_all_fallbacks(case, name):
    got = _gather(case, f"a2a_{name}")
    np.testing.assert_array_equal(got, case["ref"][f"a2a_{name}"])
    np.testing.assert_array_equal(got, case["ref"][f"a2a_{name}_exact"])


def test_quantized_all_to_all_hop_bytes(case):
    """Each rank sent one peer's packed rows a wire: 1200 values pad to 5
    blocks of 256, int8 rows of 260 bytes, int4 rows of 132."""
    for r in case["ranks"]:
        assert r["a2a_hop_bytes"] == 5 * 260 + 5 * 132


def test_quantized_all_to_all_straight_through_grad(case):
    got = _gather(case, "a2a_grad")
    np.testing.assert_allclose(got, case["ref"]["a2a_grad"], rtol=1e-6,
                               atol=1e-7)


def test_quantized_all_to_all_ef_residual(case):
    """y bit for bit; the residual ``x - q * scale`` to one ulp of the
    product; the second exchange (given the reference's residual) bit for
    bit."""
    ref = case["ref"]["ef"]
    got = [np.concatenate([r["ef"][i] for r in case["ranks"]])
           for i in range(4)]
    x = case["c"]["ef_x"]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    for ef_got, ef_ref, corrected in ((got[1], ref[1], x),
                                      (got[3], ref[3], x + ref[1])):
        product = np.abs(corrected - ef_ref).astype(np.float32)
        assert np.all(np.abs(ef_got - ef_ref) <= np.spacing(product))
        assert np.abs(ef_got).max() > 0
    assert all(r["ef_none_equal"] and r["ef_fallback_zero"]
               for r in case["ranks"])


def test_quantized_all_to_all_rejects_indivisible(case):
    assert all("not divisible by axis size 2" in r["a2a_indivisible"]
               for r in case["ranks"])


# ------------------------------------------------------------ the knobs
def test_moe_wire_knob(monkeypatch):
    for raw, want in [("", ""), ("off", ""), ("0", ""), ("none", ""),
                      ("int8", "int8"), ("INT8", "int8")]:
        monkeypatch.setenv("HOROVOD_MOE_WIRE", raw)
        assert epar.moe_wire() == want == repar.moe_wire()
    monkeypatch.delenv("HOROVOD_MOE_WIRE")
    assert epar.moe_wire() == ""
    assert epar.moe_wire("int8") == "int8"
    with pytest.raises(ValueError, match="HOROVOD_MOE_WIRE"):
        epar.moe_wire("fp8")


@pytest.mark.parametrize("allows", [False, True])
def test_moe_wire_int4_gate_admission(monkeypatch, allows):
    for mod in (adaptive, radaptive):
        monkeypatch.setattr(mod.ConvergenceGate, "_shared", None)
        monkeypatch.setattr(mod.ConvergenceGate, "allows",
                            lambda self, m: allows)
    want = "int4" if allows else "int8"
    assert epar.moe_wire("int4") == repar.moe_wire("int4") == want
    assert epar.moe_wire("int8") == "int8"


# ------------------------------------------------------- dispatch math
@pytest.mark.parametrize("n,e,cf", [(256, 8, 1.0), (256, 8, 1.25),
                                    (10, 4, 1.0), (1, 64, 0.01),
                                    (65536, 8, 1.25)])
def test_expert_capacity(n, e, cf):
    assert epar.expert_capacity(n, e, cf) == repar.expert_capacity(n, e, cf)


def test_expert_capacity_errors():
    with pytest.raises(ValueError, match="positive"):
        epar.expert_capacity(0, 8, 1.0)
    with pytest.raises(ValueError, match="capacity_factor"):
        epar.expert_capacity(8, 8, -1.0)


@pytest.mark.parametrize("capacity", [1, 2, 3])
def test_dispatch_mask_positions_and_drops(capacity):
    import torch

    onehot = np.asarray([[1, 0], [1, 0], [1, 0], [0, 1], [1, 0], [0, 1]],
                        np.float32)
    dm, keep = epar.dispatch_mask(torch.from_numpy(onehot), capacity)
    rdm, rkeep = repar.dispatch_mask(jnp.asarray(onehot), capacity)
    np.testing.assert_array_equal(dm.numpy(), np.asarray(rdm))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))


def test_capacity_with_ample_cf_matches_dense(case):
    """Capacity dispatch with ample CF and the exact wire is the dense
    one-hot math: the port against the reference's and against the dense
    ``dense_moe_apply`` of both."""
    ref = case["ref"]
    y = np.concatenate([r["ample"][0] for r in case["ranks"]])
    np.testing.assert_allclose(y, ref["ample"][0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y, ref["dense"][0], rtol=1e-6, atol=1e-6)
    port_dense = case["ranks"][0]["dense"]
    np.testing.assert_allclose(port_dense[0], ref["dense"][0], rtol=1e-6,
                               atol=1e-6)
    for r in case["ranks"]:
        np.testing.assert_allclose(r["ample"][1], ref["ample"][1], rtol=1e-6)
        np.testing.assert_allclose(r["ample"][1], ref["dense"][1], rtol=1e-6)
        load, dropped = r["ample_stats"]
        assert load.sum() == N and dropped == 0


# -------------------------------------------------- the capacity step
def _assert_run(case, key, rtol, atol):
    ref = case["ref"][key]
    for i, r in enumerate(case["ranks"]):
        got = r[key]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=rtol)
        np.testing.assert_array_equal(got["load"], ref["load"])
        assert got["dropped"] == ref["dropped"]
        e_loc = E // 2
        t = i % 2  # the rank's place on ep
        for name in ("w_in", "w_out"):
            np.testing.assert_allclose(
                got["params"][name],
                ref["params"][name][t * e_loc:(t + 1) * e_loc],
                rtol=rtol, atol=atol, err_msg=name)
        _assert_tree_close(got["params"]["router"], ref["params"]["router"],
                           rtol, atol, "router")
        if key != "cap_off":
            np.testing.assert_allclose(got["ef"], ref["ef"][i], rtol=rtol,
                                       atol=atol * 10)


def test_capacity_step_matches_reference(case):
    _assert_run(case, "cap_off", 1e-5, 1e-7)


def test_capacity_int8_step_matches_reference(case):
    _assert_run(case, "cap_int8", 1e-4, 1e-6)


def test_capacity_drops_past_capacity_and_counts(case):
    _assert_run(case, "cap_tight", 1e-5, 1e-7)
    for r in case["ranks"]:
        got = r["cap_tight"]
        assert got["load"].sum() == N and got["dropped"] > 0
        assert N - got["dropped"] <= W * E * got["capacity"]


def test_capacity_banks_ef_both_directions(case):
    for r in case["ranks"]:
        ef = r["cap_int8"]["ef"]
        assert np.abs(ef[0]).max() > 0 and np.abs(ef[1]).max() > 0
        assert np.abs(r["cap_off"]["ef"]).max() == 0


def test_parameters_agree_across_the_grid(case):
    """Replicated leaves are bit-identical on all four ranks; each expert
    shard on the two ranks of its dp group."""
    for key in ("cap_off", "cap_int8"):
        ps = [r[key]["params"] for r in case["ranks"]]
        for leaf in ("kernel", "bias"):
            assert all(np.array_equal(ps[0]["router"][leaf],
                                      p["router"][leaf]) for p in ps)
        for name in ("w_in", "w_out"):
            for i, j in ((0, 2), (1, 3)):
                assert np.array_equal(ps[i][name], ps[j][name])
            assert not np.array_equal(ps[0][name], ps[1][name])


def test_gate_parity_quantized_capacity_vs_exact(case):
    """30 Adam steps: the int8 wire within 1.05 of the exact one-hot
    reference's final loss (here the capacity step on the exact wire with
    ample CF 2, which the tests above hold to the dense math), int4 within
    1.25, both converging; int8 near the reference's own run."""
    r = case["ranks"][0]
    exact, int8, int4 = r["conv_off"], r["conv_int8"], r["conv_int4"]
    assert exact[-1] < 0.5 * exact[0]
    assert int8[-1] <= 1.05 * exact[-1]
    assert int4[-1] < 0.5 * int4[0] and int4[-1] <= 1.25 * exact[-1]
    np.testing.assert_allclose(int8, case["ref"]["conv_int8"], rtol=1e-2)


def test_capacity_step_requires_moe_call(case):
    assert all("call moe" in r["no_moe_call"] for r in case["ranks"])


def test_make_ep_train_step_rejects_unknown_dispatch():
    mesh = epar.DpEpMesh(2, 2, 0, 0, None, None)
    with pytest.raises(ValueError, match="dispatch must be"):
        epar.make_ep_train_step(lambda p, b, m: 0, mesh, dispatch="topk")


# ----------------------------------------------------- the exact step
def test_exact_step_matches_reference(case):
    ref = case["ref"]
    for i, r in enumerate(case["ranks"]):
        np.testing.assert_allclose(r["exact_losses"], ref["exact_losses"],
                                   rtol=1e-5)
        t = i % 2
        for name in ("w_in", "w_out"):
            np.testing.assert_allclose(
                r["exact_params"][name],
                ref["exact_params"][name][t * 2:(t + 1) * 2],
                rtol=1e-5, atol=1e-7, err_msg=name)
        _assert_tree_close(r["exact_params"]["router"],
                           ref["exact_params"]["router"], 1e-5, 1e-7,
                           "router")


# ------------------------------------------ specs, shards, opt state
def test_ep_specs_match_reference(case):
    params = case["c"]["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        names = [p.key for p in path]
        assert epar.ep_param_spec(names) == tuple(
            repar.ep_param_spec(names, leaf))
    moments = {"mu": moe_params_from_jax(params),
               "nu": moe_params_from_jax(params)}
    flat = []
    epar.tree_map_with_path(lambda p, s: flat.append(s),
                            epar.ep_specs(moments))
    assert sum(1 for s in flat if s == ("ep",)) == 4  # w_in/w_out x mu/nu


def test_shard_params_ep_error_names_the_leaf():
    import torch

    mesh = epar.DpEpMesh(2, 4, 0, 0, None, None)
    with pytest.raises(ValueError,
                       match=r"^nested/w_in: expert dim 3 not divisible "
                             r"by ep=4$"):
        epar.shard_params_ep({"nested": {"w_in": torch.zeros(3, 4, 8)}},
                             mesh)


def test_shard_params_ep_slices_experts(case):
    import torch

    params = moe_params_from_jax(case["c"]["params"])
    for ep_rank in range(2):
        mesh = epar.DpEpMesh(2, 2, 1, ep_rank, None, None)
        got = epar.shard_params_ep(params, mesh)
        assert torch.equal(got["w_in"], params["w_in"][ep_rank * 4:
                                                       (ep_rank + 1) * 4])
        assert torch.equal(got["router"]["kernel"],
                           params["router"]["kernel"])


def test_moe_opt_state_shapes_and_errors(case):
    cap = epar.expert_capacity(N // W, E, 1.25)
    for r in case["ranks"]:
        assert r["opt_state_shape"] == (2, E, cap, D)
        assert "not divisible" in r["opt_state_indivisible"]


# ----------------------------------------------------- the record
def test_moe_record_matches_catalog(case):
    cap = epar.expert_capacity(N // W, E, 2.0)
    per = (E // 2) * cap * D
    for r in case["ranks"]:
        rec, load, dropped = r["record"]
        assert rec["wire_bytes"] == comp.moe_wire_footprint(per, "int8", 2,
                                                            64)
        assert rec["wire_bytes_exact"] == comp.moe_wire_footprint(
            per, "none", 2, 64)
        assert rec["dropped_tokens"] == dropped
        np.testing.assert_array_equal(rec["expert_load"], load)
        assert rec["imbalance"] == pytest.approx(load.max() / load.mean())
        assert rec["capacity_factor"] == 2.0


# ------------------------------------------------------- MoEMLP
def test_moe_mlp_through_state_dict():
    import torch

    model = repar.MoEMLP(num_experts=4, dtype=jnp.float32)
    x = np.random.RandomState(3).randn(2, 6, 8).astype(np.float32)
    params = _np_tree(model.init(jax.random.PRNGKey(0), jnp.asarray(x))
                      ["params"])
    y_ref, aux_ref = model.apply({"params": params}, jnp.asarray(x))
    net = epar.MoEMLP(8, 4)
    net.load_state_dict(moe_state_dict_from_flax(params))
    y, aux = net(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux.detach()), float(aux_ref),
                               rtol=1e-6)
    # the router spreads the tokens over several experts, the loss > 0
    logits = net.router(torch.from_numpy(x).reshape(-1, 8))
    assert len(set(logits.argmax(-1).tolist())) > 1 and float(aux.detach()) > 0


def test_moe_mlp_seeded_init_is_reproducible():
    import torch

    a, b = epar.MoEMLP(16, 4, seed=5), epar.MoEMLP(16, 4, seed=5)
    for (n, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), n
    assert float(a.router.weight.detach().std()) == pytest.approx(0.25,
                                                                 rel=0.2)


# ------------------------------------------------- the whole slice
@pytest.mark.parametrize("dispatch", ["exact", "capacity-int8"])
def test_trainer_matches_lm_bench_step(case, dispatch):
    """``synthetic_moe_train`` at small widths against ``lm_bench.run_moe``'s
    model and step on the reference: 2 Adam steps on a dp=2 x ep=2 grid
    (``ep=2`` given: gcd(4, 8) would be 4), loss to 1e-5 (exact) or 1e-4
    (int8)."""
    want = case["ref"]["trainer"][dispatch]
    for r in case["ranks"]:
        losses, drop, imb, dp, ep = r[f"trainer_{dispatch}"]
        np.testing.assert_allclose(
            losses, want, rtol=1e-5 if dispatch == "exact" else 1e-4)
        if dispatch == "exact":
            assert drop is None and imb is None
        else:
            assert 0 <= drop < 1 and imb >= 1


def test_no_kernel_launches_on_the_cpu(case):
    for r in case["ranks"]:
        assert not any(r["launches"].values())
