"""The port's Adasum slice against the reference on the CPU.

* ``adasum_combine_pairs_plain`` (the twin of the CUDA kernel K4) against
  the Pallas ``adasum_combine_pairs`` in interpret mode;
* ``Executor.adasum`` on 2 and 4 gloo ranks against the reference's
  ``allreduce(op=Adasum)`` on ``horovod_tpu.testing.run_cluster``;
* ``spmd.adasum_tree`` / ``spmd.adasum`` against the reference's
  ``spmd.adasum`` under ``shard_map``;
* the config-5 dry run, the delta-flow optimizer (the torch cases of
  ``tests/test_adasum_optimizer.py``), and a reduced ResNet-18 trained two
  steps on 2 ranks against the Flax model under the reference's Adasum
  ``DistributedOptimizer``.

Every reference cluster runs with ``HOROVOD_FUSION_THRESHOLD=0``: with
fusion on, the reference combines fused leaves with bucket-wide
coefficients (pinned below), while the port combines per tensor, as
upstream Horovod does.

Tolerances. The twin and the reference reduce ``dot``, ``|a|^2`` and
``|b|^2`` in different orders, so an output element differs by a few f32
rounding steps of its pair's scale ``max_j |ac a_j| + |bc b_j|``: the f32
bound is ``4e-6`` of that scale (measured: at most ``2.0e-7``). A bf16 or
f16 output can then round to the neighbouring value, so those add one unit
in the last place of the element, and one of the scale for each
intermediate tree level the executor casts back to that dtype. Training on
2 ranks agrees to rtol ``1e-5`` on the losses and atol ``1e-5`` on the
parameters (measured: ``2.9e-7`` and ``1.2e-7``, with parameters moving by
``3.3e-2``): the frameworks sum convolutions in different orders, and
Adasum is continuous in its inputs.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

import horovod_tpu as ref_hvd
from horovod_tpu import basics as ref_basics
from horovod_tpu import spmd as ref_spmd
from horovod_tpu import testing as ref_testing
from horovod_tpu.models import resnet as ref_resnet
from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch import testing
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import cuda_kernels as ck
from tests_adasum_ref import numpy_adasum, numpy_adasum_pair

F32_TOL = 4e-6
ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}  # of |x|, at most


def _scale(a, b):
    """Per pair, max_j |ac a_j| + |bc b_j| with the oracle's f64
    coefficients: the size an output element's error is measured by."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    out = []
    for x, y in zip(a.reshape(len(a), -1), b.reshape(len(b), -1)):
        dot, na, nb = x @ y, x @ x, y @ y
        ac = 1.0 if na == 0 else 1.0 - dot / (2 * na)
        bc = 1.0 if nb == 0 else 1.0 - dot / (2 * nb)
        out.append(np.max(np.abs(ac * x) + np.abs(bc * y)))
    return np.asarray(out)


def assert_adasum_close(got, want, scale, dtype="float32", levels=0):
    """Per row, |got - want| <= F32_TOL * scale + one unit in the last
    place of ``dtype`` (none for f32) at the element, and one more at the
    scale for each of ``levels`` intermediate casts to ``dtype``."""
    got = np.asarray(got, np.float64).reshape(len(scale), -1)
    want = np.asarray(want, np.float64).reshape(len(scale), -1)
    ulp = 0.0 if dtype == "float32" else ULP[dtype]
    scale = np.asarray(scale, np.float64)[:, None]
    bound = F32_TOL * scale + ulp * (np.abs(want) + levels * scale)
    err = np.abs(got - want)
    worst = float(np.max(err / np.maximum(bound, 1e-30)))
    assert np.all(err <= bound), (worst, float(err.max()))


def _pairs(m, n, seed):
    """Correlated pairs (dot far from 0) with per-pair magnitudes."""
    rng = np.random.RandomState(seed)
    a = rng.randn(m, n) * 10.0 ** rng.uniform(-2, 2, (m, 1))
    b = 0.7 * a * rng.uniform(-2, 2, (m, 1)) + rng.randn(m, n)
    return a.astype(np.float32), b.astype(np.float32)


# ------------------------------------------------------- twin vs Pallas
@pytest.fixture
def _interpret(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    ck.reset_launch_counts()


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("n", [128, 896, 4096])
def test_plain_twin_matches_pallas(m, n, _interpret):
    a, b = _pairs(m, n, 31 * m + n)
    got = ck.adasum_combine_pairs(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    want = pk.adasum_combine_pairs(jnp.asarray(a), jnp.asarray(b))
    assert_adasum_close(got.numpy(), np.asarray(want), _scale(a, b))
    oracle = [numpy_adasum_pair(a[i].astype(np.float64),
                                b[i].astype(np.float64)) for i in range(m)]
    assert_adasum_close(got.numpy(), np.stack(oracle), _scale(a, b))
    assert ck.launch_counts()["adasum_combine_pairs"] == 0


def test_plain_twin_matches_pallas_bf16(_interpret):
    a, b = _pairs(2, 1024, 5)
    at = torch.from_numpy(a).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16)
    got = ck.adasum_combine_pairs(at, bt)
    assert got.dtype == torch.bfloat16
    want = pk.adasum_combine_pairs(jnp.asarray(a).astype(jnp.bfloat16),
                                   jnp.asarray(b).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    # both reduce the same bf16 values, widened to f32
    assert_adasum_close(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)),
                        _scale(at.float().numpy(), bt.float().numpy()),
                        "bfloat16")


def test_plain_twin_zero_norm_guard(_interpret):
    """A coefficient is 1 where its norm is 0: (0, b) -> b, (a, 0) -> a,
    (0, 0) -> 0, exactly, as in the Pallas kernel."""
    rng = np.random.RandomState(9)
    a = rng.randn(3, 256).astype(np.float32)
    b = rng.randn(3, 256).astype(np.float32)
    a[0] = 0.0
    b[1] = 0.0
    a[2] = b[2] = 0.0
    got = ck.adasum_combine_pairs(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(pk.adasum_combine_pairs(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), b[0])
    np.testing.assert_array_equal(got[1].numpy(), a[1])
    assert not got[2].any()


def test_plain_twin_propagates_nan():
    a, b = _pairs(2, 64, 4)
    a[1, 3] = np.nan
    got = ck.adasum_combine_pairs(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isnan(got[1]).all() and torch.isfinite(got[0]).all()


def test_wrapper_takes_strided_rows_and_launches_nothing_on_cpu():
    """A tree level's rows (2i, 2i+1) go in as views, without a copy; a CPU
    tensor takes the twin and counts no launch."""
    ck.reset_launch_counts()
    rng = np.random.RandomState(3)
    buf = torch.from_numpy(rng.randn(8, 33).astype(np.float32))
    got = ck.adasum_combine_pairs(buf[0::2], buf[1::2])
    want = ck.adasum_combine_pairs_plain(buf[0::2].contiguous(),
                                         buf[1::2].contiguous())
    assert torch.equal(got, want) and got.is_contiguous()
    assert ck.launch_counts()["adasum_combine_pairs"] == 0
    assert "adasum" not in _build._libs


@pytest.mark.parametrize("bad", ["dtype", "rank", "row_stride", "mismatch"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 8)
    if bad == "dtype":
        with pytest.raises(TypeError):
            ck.adasum_combine_pairs(x.double(), x.double())
    elif bad == "rank":
        with pytest.raises(ValueError, match="2-D"):
            ck.adasum_combine_pairs(x.reshape(-1), x.reshape(-1))
    elif bad == "row_stride":
        with pytest.raises(ValueError, match="contiguous"):
            ck.adasum_combine_pairs(torch.zeros(8, 4).t(), x)
    else:
        with pytest.raises(ValueError, match="does not match"):
            ck.adasum_combine_pairs(x, torch.zeros(4, 9))


# ------------------------------------------------------ the port's clusters
# executor cases: (dtype on the wire, elements)
EX_CASES = [("float32", 257), ("float32", 4096), ("bfloat16", 257),
            ("bfloat16", 4096), ("fp16", 257), ("fp16", 4096)]
# Sum / Average with scale factors, checked bit for bit
SCALED = [("none", "Sum", 0.5, 3.0), ("none", "Average", 2.0, 0.25),
          ("int8", "Average", 0.5, 3.0)]
SCALED_N = 5000
LR = 0.5
P0 = np.arange(4, dtype=np.float32) / 2.0


def _ex_input(world, i, rank):
    """Per-rank input: a shared component plus a rank's own, so that the
    dot products are far from 0."""
    n = EX_CASES[i][1]
    shared = np.random.RandomState(1000 * world + i).randn(n)
    own = np.random.RandomState(1000 * world + 10 * i + rank + 1).randn(n)
    return (0.6 * shared + own * (rank + 1)).astype(np.float32)


def _scaled_input(i, rank):
    rng = np.random.RandomState(500 + 10 * i + rank)
    return (rng.randn(SCALED_N) * (i + 1)).astype(np.float32)


def _two_leaf_grads(rank):
    """Two leaves of different size and scale: per-leaf and fused (bucket-
    wide) Adasum coefficients differ on them."""
    return (np.full(4, float(rank + 1), np.float32) * np.arange(1, 5),
            np.full(3, 10.0 * (2 - rank), np.float32) * np.array([1, -2, 3]))


def _port_optimizer_cases(hvd, world):
    """The delta-flow optimizer's cases at this world size."""
    r = hvd.rank()
    out = {}
    # matches numpy (test_adasum_optimizer.py's torch case)
    p = torch.nn.Parameter(torch.tensor(P0))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=LR),
                                   named_parameters=[("w", p)], op=hvd.Adasum)
    out["type"] = type(opt).__name__
    (p * float(r + 1)).sum().backward()
    opt.step()
    out["numpy"] = p.detach().numpy().copy()
    if world != 2:
        return out

    # two leaves, lr 1: the deltas are the negated gradients
    pa = torch.nn.Parameter(torch.zeros(4))
    pb = torch.nn.Parameter(torch.zeros(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([pa, pb], lr=1.0),
                                   named_parameters=[("a", pa), ("b", pb)],
                                   op=hvd.Adasum)
    ga, gb = _two_leaf_grads(r)
    ((pa * torch.from_numpy(ga)).sum()
     + (pb * torch.from_numpy(gb)).sum()).backward()
    opt.step()
    out["two_leaf"] = (pa.detach().numpy().copy(), pb.detach().numpy().copy())

    # skip_synchronize is refused
    try:
        with opt.skip_synchronize():
            pass
        out["skip"] = None
    except AssertionError as e:
        out["skip"] = str(e)

    # momentum state advances from the local step and stays local
    p = torch.nn.Parameter(torch.ones(3))
    inner = torch.optim.SGD([p], lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(inner, named_parameters=[("w", p)],
                                   op=hvd.Adasum)
    for _ in range(2):
        opt.zero_grad()
        (p * float(r + 1)).sum().backward()
        opt.step()
    out["momentum"] = (p.detach().numpy().copy(),
                       inner.state[p]["momentum_buffer"].numpy().copy())

    # a parameter unused on one rank: every rank still submits its delta
    p1 = torch.nn.Parameter(torch.ones(2))
    p2 = torch.nn.Parameter(torch.ones(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p1, p2], lr=0.1),
                                   named_parameters=[("w1", p1), ("w2", p2)],
                                   op=hvd.Adasum)
    ((p1 * 2.0).sum() if r else (p1 + p2).sum()).backward()
    opt.step()
    out["unused"] = (p1.detach().numpy().copy(), p2.detach().numpy().copy())

    # backward_passes_per_step=2: the local update is taken on the second
    # backward, from the accumulated gradient; zero_grad before step raises
    p = torch.nn.Parameter(torch.ones(3))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1),
                                   named_parameters=[("w", p)],
                                   op=hvd.Adasum, backward_passes_per_step=2)
    pending = []
    for k in (1, 2):
        (p * float(k * (r + 1))).sum().backward()
        pending.append(len(opt._deltas))
    try:
        opt.zero_grad()
        out["zero_grad"] = None
    except AssertionError as e:
        out["zero_grad"] = str(e)
    opt.step()
    out["bpps"] = (pending, p.detach().numpy().copy())
    return out


def _port_slice(hvd, state_dict, batch, steps):
    """Reduced ResNet-18 trained through DistributedOptimizer(op=Adasum)."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.train import params_sha256, synthetic_batch

    net = resnet.ResNet18(num_filters=8, num_classes=10)
    net.load_state_dict(state_dict)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9),
        named_parameters=net.named_parameters(), op=hvd.Adasum)
    images, labels = synthetic_batch(batch, 32, 10, hvd.rank(), hvd.size())
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    net.train()
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return {"losses": losses, "sha": params_sha256(net),
            "params": {k: v.detach().numpy().copy()
                       for k, v in net.named_parameters()}}


def port_worker(world, state_dict=None):
    """One rank of the port's cluster: every executor case, spmd, the
    scaled Sum/Average cases, the dry run, the optimizer cases and (at
    world 2) the training slice."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, spmd

    torch.set_num_threads(1)  # ranks beside other test workers
    r = hvd.rank()
    ex = basics._executor()
    out = {"cases": [], "ck": None}
    for i, (dt, _) in enumerate(EX_CASES):
        x = torch.from_numpy(_ex_input(world, i, r))
        if dt == "fp16":
            y = hvd.allreduce(x, op=hvd.Adasum, name=f"a{i}",
                              compression=hvd.Compression.fp16)
        else:
            y = hvd.allreduce(x.to(getattr(torch, dt)), op=hvd.Adasum,
                              name=f"a{i}")
        out["cases"].append((y.float().numpy(), str(y.dtype),
                             ex.last_wire_mode, ex.last_wire_bytes))
    # int8 wire under Adasum: bypassed, exact
    x = torch.from_numpy(_ex_input(world, 1, r))
    out["int8_bypass"] = (
        torch.equal(hvd.allreduce(x, op=hvd.Adasum,
                                  compression=hvd.Compression.int8),
                    hvd.allreduce(x, op=hvd.Adasum)),
        ex.last_wire_mode, ex.last_wire_bytes)
    # spmd: f32 equals the executor's bits; bf16 stays f32 through the tree
    out["spmd_f32"] = torch.equal(spmd.adasum(x), hvd.allreduce(
        x, op=hvd.Adasum))
    xb = torch.from_numpy(_ex_input(world, 3, r)).to(torch.bfloat16)
    yb = spmd.allreduce(xb, op=hvd.Adasum)
    out["spmd_bf16"] = (yb.float().numpy(), str(yb.dtype))
    out["spmd_average"] = torch.equal(spmd.allreduce(x), hvd.allreduce(x))
    out["optimizer"] = _port_optimizer_cases(hvd, world)
    if world == 2:
        out["scaled"] = [
            hvd.allreduce(torch.from_numpy(_scaled_input(i, r)),
                          op=getattr(hvd, op), name=f"s{i}",
                          compression=getattr(hvd.Compression, mode),
                          prescale_factor=pre,
                          postscale_factor=post).numpy()
            for i, (mode, op, pre, post) in enumerate(SCALED)]
        out["dryrun"] = testing.adasum_dryrun_worker()
        out["slice"] = _port_slice(hvd, state_dict, SLICE_BATCH, SLICE_STEPS)
    out["ck"] = ck.launch_counts()
    return out


# ---------------------------------------------------- the training slice
SLICE_BATCH = 8
SLICE_STEPS = 2


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


_FLAX = {}


def _flax_model():
    """The reduced Flax ResNet-18, its initial variables (numpy) and its
    jitted loss gradient over a batch (compiled once per module)."""
    if not _FLAX:
        model = ref_resnet.ResNet18(num_filters=8, num_classes=10,
                                    dtype=jnp.float32)
        variables = model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3), jnp.float32),
                               train=True)

        def loss_fn(p, bs, x, y):
            logits, new = model.apply({"params": p, "batch_stats": bs}, x,
                                      train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            return loss, new["batch_stats"]

        _FLAX.update(params=_np_tree(variables["params"]),
                     stats=_np_tree(variables["batch_stats"]),
                     grad=jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))
    return _FLAX


@pytest.fixture(scope="module")
def port2():
    from horovod_tpu_torch.models.convert import resnet_state_dict_from_flax

    fm = _flax_model()
    sd = resnet_state_dict_from_flax(fm["params"], fm["stats"])
    return testing.run_cluster(port_worker, np=2, device="cpu",
                               args=(2, sd), timeout=300)


@pytest.fixture(scope="module")
def port4():
    return testing.run_cluster(port_worker, np=4, device="cpu", args=(4,),
                               timeout=300)


@pytest.fixture
def ref_cluster(monkeypatch):
    """``horovod_tpu.testing.run_cluster`` with fusion off."""
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")

    def run(fn, np):
        if ref_hvd.is_initialized():
            ref_hvd.shutdown()
        return ref_testing.run_cluster(fn, np=np)

    return run


def _port(world, port2, port4):
    return port2 if world == 2 else port4


# --------------------------------------------------------------- executor
@pytest.mark.parametrize("world", [2, 4])
def test_executor_adasum_matches_reference(world, port2, port4, ref_cluster):
    port = _port(world, port2, port4)

    def fn():
        r = ref_hvd.rank()
        ex = ref_basics._engine()._executor
        res = []
        for i, (dt, _) in enumerate(EX_CASES):
            x = _ex_input(world, i, r)
            if dt == "fp16":
                y = ref_hvd.allreduce(x, name=f"a{i}", op=ref_hvd.Adasum,
                                      compression=ref_hvd.Compression.fp16)
            else:
                y = ref_hvd.allreduce(jnp.asarray(x).astype(getattr(jnp, dt)),
                                      name=f"a{i}",
                                      op=ref_hvd.Adasum)
            res.append((np.asarray(jnp.asarray(y, jnp.float32)),
                        str(y.dtype), ex.last_wire_mode, ex.last_wire_bytes))
        return res

    ref = ref_cluster(fn, world)
    for i, (dt, n) in enumerate(EX_CASES):
        # the wire dtype's values, as both sides combined them
        wdt = torch.float16 if dt == "fp16" else getattr(torch, dt)
        xs = [torch.from_numpy(_ex_input(world, i, r)).to(wdt).float().numpy()
              for r in range(world)]
        y0, dtype, mode, nbytes = port[0]["cases"][i]
        for rank in range(world):
            y, dtype_r, mode_r, nbytes_r = port[rank]["cases"][i]
            assert (dtype_r, mode_r, nbytes_r) == (dtype, mode, nbytes)
            np.testing.assert_array_equal(y, y0)  # the root, on every rank
            yr, dtype_ref, mode_ref, bytes_ref = ref[rank][i]
            assert dtype_ref == str(dtype).replace("torch.", "")
            assert (mode, nbytes) == (mode_ref, bytes_ref) == (
                "", 2 * n * wdt.itemsize)
        # each level casts back to the wire dtype, so each intermediate
        # level can round once more
        scale = [np.max(np.abs(np.asarray(xs)).sum(0))]
        wire = str(wdt).replace("torch.", "")
        levels = world.bit_length() - 2
        assert_adasum_close(y0[None], ref[0][i][0][None], scale, wire,
                            levels)
        assert_adasum_close(y0[None], numpy_adasum(
            [x.astype(np.float64) for x in xs])[None], scale, wire, levels)


def test_executor_refuses_a_world_that_is_not_a_power_of_2(ref_cluster):
    from horovod_tpu_torch.exceptions import HorovodInternalError
    from horovod_tpu_torch.runtime.executor import Executor

    with pytest.raises(HorovodInternalError) as port_err:
        Executor(3, "gloo").adasum(torch.zeros(4))

    def fn():
        try:
            ref_hvd.allreduce(np.zeros(4, np.float32), name="p3",
                              op=ref_hvd.Adasum)
        except ref_hvd.HorovodInternalError as e:
            return str(e)
        return None

    assert set(ref_cluster(fn, 3)) == {str(port_err.value)}


def test_int8_wire_is_bypassed_under_adasum(port2, port4):
    for port in (port2, port4):
        for r in port:
            same, mode, nbytes = r["int8_bypass"]
            assert same and mode == "" and nbytes == 2 * 4096 * 4


@pytest.mark.parametrize("case", range(len(SCALED)))
def test_scale_factors_match_reference(case, port2, ref_cluster):
    mode, op, pre, post = SCALED[case]

    def fn():
        return np.asarray(ref_hvd.allreduce(
            _scaled_input(case, ref_hvd.rank()), name=f"s{case}",
            op=getattr(ref_hvd, op),
            compression=getattr(ref_hvd.Compression, mode),
            prescale_factor=pre, postscale_factor=post), np.float32)

    for rank, want in enumerate(ref_cluster(fn, 2)):
        np.testing.assert_array_equal(port2[rank]["scaled"][case], want)


def test_adasum_refuses_scale_factors_as_the_reference_does():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError) as port_err:
            hvd.allreduce(torch.ones(3), op=hvd.Adasum, prescale_factor=2.0)
    finally:
        hvd.shutdown()
    ref_hvd.init()
    with pytest.raises(ValueError) as ref_err:
        ref_hvd.allreduce(np.ones(3, np.float32), op=ref_hvd.Adasum,
                          postscale_factor=2.0)
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------------- spmd
def _ref_spmd_adasum(rows, n_dev):
    """The reference ``spmd.adasum`` of ``rows[i]`` on device ``i`` of an
    ``n_dev`` mesh, under shard_map with check_vma=False (its Pallas path,
    here in interpret mode)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("hvd",))
    k = rows.shape[1]
    g = jax.device_put(rows.reshape(n_dev, 1, k),
                       NamedSharding(mesh, P("hvd")))
    fn = jax.shard_map(lambda v: ref_spmd.adasum(v[0])[None], mesh=mesh,
                       in_specs=P("hvd"), out_specs=P("hvd"), check_vma=False)
    out = np.asarray(jnp.asarray(jax.jit(fn)(g), jnp.float32)).reshape(n_dev,
                                                                       k)
    assert (out == out[0]).all()
    return out[0]


@pytest.mark.parametrize("n", [37, 1024])
def test_spmd_adasum_tree_matches_reference(n, _interpret):
    from horovod_tpu_torch import spmd

    rng = np.random.RandomState(n)
    rows = (0.5 * rng.randn(1, n) + rng.randn(8, n)).astype(np.float32)
    got = spmd.adasum_tree(torch.from_numpy(rows))
    assert got.dtype == torch.float32 and got.shape == (n,)
    scale = [np.abs(rows).sum(0).max()]
    assert_adasum_close(got.numpy()[None], _ref_spmd_adasum(rows, 8)[None],
                        scale)
    assert_adasum_close(got.numpy()[None], numpy_adasum(
        [r.astype(np.float64) for r in rows])[None], scale)
    with pytest.raises(ValueError, match="power-of-2"):
        spmd.adasum_tree(torch.from_numpy(rows[:6]))


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_adasum_in_cluster_matches_reference(world, port2, port4,
                                                  _interpret):
    """Over the process group: f32 equals the executor's bits; bf16 stays
    f32 through the tree and casts once, as the reference's spmd.adasum."""
    port = _port(world, port2, port4)
    rows = np.stack([torch.from_numpy(_ex_input(world, 3, r)).to(
        torch.bfloat16).float().numpy() for r in range(world)])
    want = _ref_spmd_adasum(jnp.asarray(rows).astype(jnp.bfloat16), world)
    for r in port:
        assert r["spmd_f32"] and r["spmd_average"]
        y, dtype = r["spmd_bf16"]
        assert dtype == "torch.bfloat16"
        np.testing.assert_array_equal(y, port[0]["spmd_bf16"][0])
    assert_adasum_close(port[0]["spmd_bf16"][0][None], want[None],
                        [np.abs(rows).sum(0).max()], "bfloat16")


# --------------------------------------------------------------- config 5
def test_dryrun_matches_reference_and_oracle(port2, ref_cluster):
    ref = ref_cluster(ref_testing.adasum_dryrun_worker, 2)
    port = [r["dryrun"] for r in port2]
    assert [p[0] for p in port] == [0, 1]
    xs = [np.asarray(p[1], np.float32) for p in port]
    for p, q in zip(port, ref):
        np.testing.assert_array_equal(p[1], q[1])  # same seeded inputs
    want = testing.numpy_adasum([x.astype(np.float64) for x in xs])
    want16 = testing.numpy_adasum([x.astype(np.float16).astype(np.float64)
                                   for x in xs])
    for p, q in zip(port, ref):
        for got in (p[2], q[2]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        for got in (p[3], q[3]):
            np.testing.assert_allclose(got, want16, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(p[2], q[2], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p[3], q[3], rtol=5e-3, atol=5e-3)
    assert port[0][2] == port[1][2] and port[0][3] == port[1][3]
    # the port's oracle is the reference tests' oracle
    np.testing.assert_array_equal(want, numpy_adasum(
        [x.astype(np.float64) for x in xs]))


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("world", [2, 4])
def test_adasum_optimizer_matches_numpy(world, port2, port4):
    grads = [np.full(4, float(r + 1), np.float32) for r in range(world)]
    want = P0 + numpy_adasum([-LR * g for g in grads])
    for r in _port(world, port2, port4):
        assert r["optimizer"]["type"] == "_DistributedAdasumOptimizer"
        np.testing.assert_allclose(r["optimizer"]["numpy"], want, rtol=1e-5)


def test_adasum_optimizer_skip_synchronize_and_zero_grad_raise(port2):
    for r in port2:
        assert "not supported when using Adasum optimizer" in \
            r["optimizer"]["skip"]
        assert "before optimizer.step()" in r["optimizer"]["zero_grad"]


def test_adasum_momentum_state_stays_local(port2):
    (p0, m0), (p1, m1) = (r["optimizer"]["momentum"] for r in port2)
    np.testing.assert_array_equal(p0, p1)
    # two local steps of a constant gradient (r + 1): buf = 1.9 (r + 1)
    np.testing.assert_allclose(m0, np.full(3, 1.9), rtol=1e-6)
    np.testing.assert_allclose(m1, np.full(3, 3.8), rtol=1e-6)


def test_adasum_unused_param_no_deadlock(port2):
    (a0, b0), (a1, b1) = (r["optimizer"]["unused"] for r in port2)
    np.testing.assert_array_equal(a0, a1)
    np.testing.assert_array_equal(b0, b1)
    # rank 1 sent a zero delta for w2: the combine returns rank 0's
    np.testing.assert_allclose(b0, np.full(2, 0.9), rtol=1e-6)


def test_adasum_backward_passes_per_step(port2):
    grads = [np.full(3, 3.0 * (r + 1), np.float32) for r in range(2)]
    want = 1.0 + numpy_adasum([-0.1 * g for g in grads])
    for r in port2:
        pending, p = r["optimizer"]["bpps"]
        assert pending == [0, 1]
        np.testing.assert_allclose(p, want, rtol=1e-5)


def test_adasum_error_feedback_raises():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="error_feedback"):
            hvd.DistributedOptimizer(
                torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=0.1),
                op=hvd.Adasum, compression=hvd.Compression.int8,
                error_feedback=True)
    finally:
        hvd.shutdown()


def test_reference_may_fuse_adasum_leaves_the_port_does_not(
        port2, ref_cluster, monkeypatch):
    """With its default threshold the reference may fuse the leaves of one
    update, when they reach one negotiation cycle together, and then
    combines them with bucket-wide coefficients: whether it does depends on
    timing. With fusion off it combines per leaf, as the port always
    does."""
    per_leaf = np.concatenate(
        [numpy_adasum([-g[k] for g in map(_two_leaf_grads, (0, 1))])
         for k in (0, 1)])
    fused = numpy_adasum([-np.concatenate(_two_leaf_grads(r))
                          for r in (0, 1)])
    assert not np.allclose(per_leaf, fused, rtol=1e-2)

    def fn():
        tx = ref_hvd.DistributedOptimizer(optax.sgd(1.0), op=ref_hvd.Adasum)
        p = {"a": np.zeros(4, np.float32), "b": np.zeros(3, np.float32)}
        ga, gb = _two_leaf_grads(ref_hvd.rank())
        u, _ = tx.update({"a": ga, "b": gb}, tx.init(p), p)
        return np.concatenate([np.asarray(u["a"]), np.asarray(u["b"])])

    off = ref_cluster(fn, 2)
    monkeypatch.delenv("HOROVOD_FUSION_THRESHOLD")
    on = ref_cluster(fn, 2)
    np.testing.assert_array_equal(on[0], on[1])
    assert (np.allclose(on[0], per_leaf, rtol=1e-6)
            or np.allclose(on[0], fused, rtol=1e-6)), on[0]
    for r in range(2):
        np.testing.assert_allclose(off[r], per_leaf, rtol=1e-6)
        np.testing.assert_allclose(
            np.concatenate(port2[r]["optimizer"]["two_leaf"]), per_leaf,
            rtol=1e-6)


# ------------------------------------------------------------ whole slice
def test_two_rank_adasum_training_matches_reference(port2, ref_cluster):
    """Reduced ResNet-18, 2 ranks, 2 steps of SGD(0.01, momentum 0.9)
    under Adasum: the port against the Flax model under the reference's
    Adasum DistributedOptimizer, on the same weights and batches."""
    from horovod_tpu_torch.models.convert import resnet_state_dict_from_flax
    from horovod_tpu_torch.train import synthetic_batch

    fm = _flax_model()

    def fn():
        r = ref_hvd.rank()
        images, labels = synthetic_batch(SLICE_BATCH, 32, 10, r, 2)
        x, y = jnp.asarray(images), jnp.asarray(labels)
        tx = ref_hvd.DistributedOptimizer(optax.sgd(0.01, momentum=0.9),
                                          op=ref_hvd.Adasum)
        params = jax.tree_util.tree_map(jnp.asarray, fm["params"])
        bs = jax.tree_util.tree_map(jnp.asarray, fm["stats"])
        state = tx.init(params)
        losses = []
        for _ in range(SLICE_STEPS):
            (loss, bs), grads = fm["grad"](params, bs, x, y)
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
            losses.append(float(loss))
        return losses, _np_tree(params)

    ref = ref_cluster(fn, 2)
    assert port2[0]["slice"]["sha"] == port2[1]["slice"]["sha"]
    expect = resnet_state_dict_from_flax(ref[0][1], fm["stats"])
    start = resnet_state_dict_from_flax(fm["params"], fm["stats"])
    for rank in range(2):
        got = port2[rank]["slice"]
        np.testing.assert_allclose(got["losses"], ref[rank][0], rtol=1e-5)
        assert sorted(got["params"]) == sorted(
            k for k in expect if "running" not in k)
        moved = 0.0
        for k, v in got["params"].items():
            np.testing.assert_allclose(v, expect[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
            moved = max(moved, float(np.abs(v - start[k].numpy()).max()))
        assert moved > 1e-4  # the steps really moved the parameters
    # no kernel launched on the CPU
    assert all(v == 0 for r in port2 for v in r["ck"].values())
