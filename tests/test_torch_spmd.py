"""The port's compiled data-parallel plane (``horovod_tpu_torch.spmd``, the
copied ``ops/adaptive.py`` gate and catalogs, ``optim/zero.py``) against the
reference (``horovod_tpu.spmd``) on the same inputs.

* Knobs, the convergence gate, the byte catalogs and ZeRO-1's chunk rules:
  equal values (the gate's losses bit for bit; the catalogs' integers).
* The in-step primitives at worlds 2 and 4 (spawned gloo processes, one
  cluster a world) against the reference's under ``spmd._shard_map`` on as
  many JAX CPU devices (``tests/test_spmd.py:18-145``): equal to 1e-6
  (the backend's sums against XLA's, another order at world 4).
* ``make_train_step`` at world 1 (exact, int8, int4) against the
  reference's over 3 SGD-with-momentum steps of a small MLP: losses and
  parameters within 2e-6 relative (the products run in torch and in XLA:
  last-bit differences); 99% of the error-feedback residual's elements
  within 1e-4 of its largest (XLA fuses ``corrected - q * scale`` into one
  FMA, the port rounds ``q * scale`` from #2 first), the rest within one
  quantization step (a rounding that flips). The world-1 residual is
  pinned: carried although no wire is crossed, and applied the next
  step.
* At world 2, the int8 step with and without ZeRO-1 against the
  reference's: parameters bit-identical on both ranks, within 2e-5 of the
  reference; the ZeRO-1 state 1/2 a rank; on the exact wire ZeRO-1's
  update equals the replicated one bit for bit (SGD and AdamW).
* The trainers (``train.py``) on the compiled plane at world 1 on the
  exact wire equal the engine plane's bit for bit.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import testing

BLOCK = 256
I, H, O, B = 8, 64, 4, 16        # the MLP: 836 parameters, 4 leaves
LR, MOMENTUM, STEPS = 0.05, 0.9, 3
KEYS = ("b1", "b2", "w1", "w2")  # the reference's leaf order (sorted)


# ------------------------------------------------------------- helpers
def _mlp_params(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"b1": (0.1 * rng.randn(H)).astype(np.float32),
            "b2": (0.1 * rng.randn(O)).astype(np.float32),
            "w1": (rng.randn(I, H) / np.sqrt(I)).astype(np.float32),
            "w2": (rng.randn(H, O) / np.sqrt(H)).astype(np.float32)}


def _batch(world: int):
    rng = np.random.RandomState(5)
    x = rng.randn(B * world, I).astype(np.float32)
    y = rng.randn(B * world, O).astype(np.float32)
    return x, y


def _port_mlp(seed: int = 0):
    """The MLP's parameters (in KEYS order) and its loss function."""
    ps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
          for v in (_mlp_params(seed)[k] for k in KEYS)]
    b1, b2, w1, w2 = ps

    def loss_fn(x, y):
        h = torch.tanh(x @ w1 + b1)
        return ((h @ w2 + b2 - y) ** 2).mean()

    return ps, loss_fn


def _ref_loss(params, batch):
    import jax.numpy as jnp

    x, y = batch
    h = jnp.tanh(x @ params["w1"] + params["b1"])
    return jnp.mean((h @ params["w2"] + params["b2"] - y) ** 2)


def _ref_steps(world: int, wire, zero1: bool = False, tx=None):
    """The reference's make_train_step over ``world`` CPU devices:
    (losses, final params, final residual rows or None)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from horovod_tpu import spmd as ref
    from horovod_tpu.basics import MESH_AXIS

    mesh = Mesh(np.array(jax.devices()[:world]), (MESH_AXIS,))
    tx = tx or optax.sgd(LR, momentum=MOMENTUM)
    params = {k: jnp.asarray(v) for k, v in _mlp_params().items()}
    x, y = _batch(world)
    batch = ref.shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    step = ref.make_train_step(_ref_loss, tx, mesh=mesh, donate=False,
                               zero1=zero1, compression=wire)
    if wire:
        state = ref.quantized_opt_state(tx, params, mesh=mesh, zero1=zero1)
    else:
        state = ref.replicate(tx.init(params), mesh)
    params = ref.replicate(params, mesh)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    ef = np.asarray(state[1]) if wire else None
    return losses, {k: np.asarray(v) for k, v in params.items()}, ef


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (
        np.abs(got - want).max(), rel * scale)


@pytest.fixture
def port_cpu():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    for k in ("HOROVOD_GSPMD_WIRE", "HOROVOD_GSPMD_ALGO",
              "HOROVOD_MESH_HOSTS", "HOROVOD_ADAPTIVE_GATE",
              "HOROVOD_INT8_BLOCK"):
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------------ the knobs
WIRE_VALUES = ["", "0", "off", "none", "OFF", " None ", "int8", "INT8",
               " int4 ", "Int4"]


@pytest.mark.parametrize("via_env", [False, True])
@pytest.mark.parametrize("value", WIRE_VALUES)
def test_gspmd_wire_parses_as_reference(monkeypatch, via_env, value):
    from horovod_tpu import spmd as ref
    from horovod_tpu_torch import spmd

    if via_env:
        monkeypatch.setenv("HOROVOD_GSPMD_WIRE", value)
        assert spmd.gspmd_wire() == ref.gspmd_wire()
    else:
        assert spmd.gspmd_wire(value) == ref.gspmd_wire(value)


@pytest.mark.parametrize("value", ["int2", "fp8", "bf16"])
def test_gspmd_wire_rejects_as_reference(value):
    from horovod_tpu import spmd as ref
    from horovod_tpu_torch import spmd

    with pytest.raises(ValueError) as ours:
        spmd.gspmd_wire(value)
    with pytest.raises(ValueError) as theirs:
        ref.gspmd_wire(value)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("value", ["", "0", "off", "ring", "TREE", " hier ",
                                   "auto", "butterfly", "nccl"])
def test_gspmd_algo_parses_as_reference(monkeypatch, value):
    from horovod_tpu import spmd as ref
    from horovod_tpu_torch import spmd

    for via_env in (False, True):
        if via_env:
            monkeypatch.setenv("HOROVOD_GSPMD_ALGO", value)
            args = ()
        else:
            args = (value,)
        try:
            want = ref.gspmd_algo(*args)
        except ValueError as e:
            with pytest.raises(ValueError, match="ring|tree|hier|auto"):
                spmd.gspmd_algo(*args)
            assert str(e).startswith("HOROVOD_GSPMD_ALGO must be")
            continue
        assert spmd.gspmd_algo(*args) == want


@pytest.mark.parametrize("env", ["", "1", "2", "3", "4", "8"])
def test_mesh_hosts_as_reference(monkeypatch, env):
    from horovod_tpu import spmd as ref
    from horovod_tpu_torch import spmd

    if env:
        monkeypatch.setenv("HOROVOD_MESH_HOSTS", env)
    for world in range(1, 17):
        try:
            want = ref.mesh_hosts(world)
        except ValueError as e:
            with pytest.raises(ValueError) as ours:
                spmd.mesh_hosts(world)
            assert str(ours.value) == str(e)
            continue
        assert spmd.mesh_hosts(world) == want, world


@pytest.mark.parametrize("tuned", ["", "ring", "tree", "hier"])
def test_resolve_algorithm_as_reference(tuned):
    from horovod_tpu import spmd as ref
    from horovod_tpu.ops import adaptive as ref_ad
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.ops import adaptive

    for mod in (ref_ad, adaptive):
        mod.reset()
        if tuned:
            mod.set_autotuned_algorithm(tuned)
    try:
        for algo in ("ring", "tree", "hier", "auto", None):
            for world in (1, 2, 3, 4, 6, 7, 8, 16):
                for total in (1, 1024, 1 << 16, (1 << 16) + 1, 1 << 22):
                    assert (spmd.resolve_algorithm(total, world, algo)
                            == ref.resolve_algorithm(total, world, algo)), (
                        algo, world, total)
    finally:
        ref_ad.reset()
        adaptive.reset()


def test_wire_rules_as_reference():
    import jax.numpy as jnp

    from horovod_tpu import spmd as ref
    from horovod_tpu_torch import spmd

    pairs = ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float16, jnp.float16), (torch.int32, jnp.int32))
    for n in (1, 255, 256, 257, 4096):
        for block in (2, 3, 256):
            for wire in ("", "int8", "int4"):
                for tdt, jdt in pairs:
                    assert (spmd._wire_eligible(n, tdt, wire, block)
                            == ref._wire_eligible(n, jdt, wire, block))
            for world in (1, 2, 3, 4, 8):
                assert (spmd._ring_chunk(n, world, block)
                        == ref._ring_chunk(n, world, block))


# ------------------------------------------------------------- the gate
@pytest.mark.parametrize("mode", ["int4", "int8"])
def test_gate_losses_and_verdicts_bit_equal(mode):
    from horovod_tpu.ops import adaptive as ref_ad
    from horovod_tpu_torch.ops import adaptive

    ours, theirs = adaptive.ConvergenceGate(), ref_ad.ConvergenceGate()
    a, b = ours.losses(mode), theirs.losses(mode)
    assert np.float64(a[0]).tobytes() == np.float64(b[0]).tobytes()
    assert np.float64(a[1]).tobytes() == np.float64(b[1]).tobytes()
    assert ours.allows(mode) == theirs.allows(mode)


@pytest.mark.parametrize("gate", ["1", "0"])
def test_admit_wire_as_reference(monkeypatch, gate):
    from horovod_tpu.ops import adaptive as ref_ad
    from horovod_tpu_torch.ops import adaptive

    monkeypatch.setenv("HOROVOD_ADAPTIVE_GATE", gate)
    for mod in (ref_ad, adaptive):
        mod.reset()
    for wire in ("int4", "int8", ""):
        assert adaptive.admit_wire(wire) == ref_ad.admit_wire(wire)
    for nbytes in (0, 1, 1 << 16, (1 << 16) + 1, 1 << 22, (1 << 22) + 1):
        assert adaptive.size_class(nbytes) == ref_ad.size_class(nbytes)
    assert adaptive.ALGO_CODES == ref_ad.ALGO_CODES
    assert adaptive.SIZE_CLASSES == ref_ad.SIZE_CLASSES


# --------------------------------------------------------- the catalogs
SIZES = (1, 255, 256, 3000, 16384, (1 << 20) + 3)
WORLDS = (1, 2, 3, 4, 6, 7, 8, 12, 16)
BLOCKS = (2, 64, 256, 1000)
MODES = ("none", "fp32", "fp16", "bf16", "int8", "int4")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("algorithm", ["ring", "tree", "hier"])
def test_gspmd_wire_footprint_equal_integers(algorithm, mode):
    from horovod_tpu.ops import compression as ref_comp
    from horovod_tpu_torch.ops import compression as comp

    for n in SIZES:
        for world in WORLDS:
            for block in BLOCKS:
                for hosts in (None, 1, 2, 3, 4, 8):
                    args = (n, mode, world, block)
                    kw = dict(algorithm=algorithm, hosts=hosts)
                    assert (comp.gspmd_wire_footprint(*args, **kw)
                            == ref_comp.gspmd_wire_footprint(*args, **kw))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("algorithm", ["ring", "tree", "hier"])
def test_cross_host_footprint_equal_integers(algorithm, mode):
    from horovod_tpu.ops import compression as ref_comp
    from horovod_tpu_torch.ops import compression as comp

    for n in SIZES:
        for world in WORLDS:
            for hosts in (1, 2, 3, 4, 8):
                for block in BLOCKS:
                    args = (n, mode, world, hosts, block, algorithm)
                    assert (comp.gspmd_cross_host_footprint(*args)
                            == ref_comp.gspmd_cross_host_footprint(*args))


def test_two_hosts_by_four_chips_cross_host_bytes():
    """ROADMAP's simulated 2-host x 4-chip case: 33280 cross-host bytes
    for the hierarchical schedule against the ring's 58240."""
    from horovod_tpu_torch.ops import compression as comp

    assert comp.gspmd_cross_host_footprint(16384, "int8", 8, 2, 256,
                                           "hier") == 33280
    assert comp.gspmd_cross_host_footprint(16384, "int8", 8, 2, 256,
                                           "ring") == 58240


@pytest.mark.parametrize("mode", MODES)
def test_moe_footprint_equal_integers(mode):
    from horovod_tpu.ops import compression as ref_comp
    from horovod_tpu_torch.ops import compression as comp

    for n in SIZES:
        for world in WORLDS:
            for block in BLOCKS + (None,):
                assert (comp.moe_wire_footprint(n, mode, world, block)
                        == ref_comp.moe_wire_footprint(n, mode, world, block))


def test_catalogs_reject_unknown_modes_as_reference():
    from horovod_tpu.ops import compression as ref_comp
    from horovod_tpu_torch.ops import compression as comp

    for fn in ("gspmd_wire_footprint", "moe_wire_footprint"):
        with pytest.raises(ValueError) as ours:
            getattr(comp, fn)(100, "int2", 2, 256)
        with pytest.raises(ValueError) as theirs:
            getattr(ref_comp, fn)(100, "int2", 2, 256)
        assert str(ours.value) == str(theirs.value)


# --------------------------------------------------------------- ZeRO-1
def test_zero_chunk_rules_as_reference():
    from horovod_tpu.optim import zero as ref_zero
    from horovod_tpu_torch.optim import zero

    for total in (0, 1, 255, 836, 3000, 16384, 25557032):
        for world in (1, 2, 3, 4, 8):
            for block in (1, 2, 256):
                assert (zero.ring_chunk(total, world, block)
                        == ref_zero.ring_chunk(total, world, block))
                for index in range(world + 1):
                    assert (zero.shard_bounds(total, world, index, block)
                            == ref_zero.shard_bounds(total, world, index,
                                                     block))


def test_zero_leaf_rule_as_reference():
    from horovod_tpu.optim import zero as ref_zero
    from horovod_tpu_torch.optim import zero

    shapes = [(), (5,), (8,), (3, 8), (3, 5), (0, 8), (7, 7, 16), (16, 3)]
    for world in (1, 2, 4, 8):
        for shape in shapes:
            spec = tuple(ref_zero._leaf_spec(np.zeros(shape), world, "hvd"))
            dim = zero.leaf_shard_dim(shape, world)
            want = None if "hvd" not in spec else spec.index("hvd")
            assert dim == want, (world, shape, spec)


def test_zero1_rejects_non_elementwise_optimizers(port_cpu):
    from horovod_tpu_torch import spmd

    ps, loss_fn = _port_mlp()
    for opt in (torch.optim.LBFGS(ps), torch.optim.Adagrad(ps)):
        with pytest.raises(ValueError, match="elementwise"):
            spmd.make_train_step(loss_fn, opt, ps, zero1=True)
    two = torch.optim.SGD([{"params": ps[:2]}, {"params": ps[2:],
                                                "lr": 0.1}], lr=0.01)
    with pytest.raises(ValueError, match="one parameter group"):
        spmd.make_train_step(loss_fn, two, ps, zero1=True)


def test_adasum_raises_as_reference(port_cpu):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd

    x = torch.ones(1024)
    for fn in (spmd.quantized_allreduce, spmd.quantized_allreduce_tree,
               spmd.quantized_allreduce_hier):
        with pytest.raises(NotImplementedError, match="Adasum"):
            fn(x, hvd.Adasum, "int8")


def test_graph_true_raises_on_the_cpu(port_cpu):
    from horovod_tpu_torch import spmd

    ps, loss_fn = _port_mlp()
    with pytest.raises(ValueError, match="CUDA"):
        spmd.make_train_step(loss_fn, torch.optim.SGD(ps, lr=0.1), ps,
                             graph=True)
    step = spmd.make_train_step(loss_fn, torch.optim.SGD(ps, lr=0.1), ps)
    assert step.graphed is False


# ---------------------------------------------------- the step, world 1
def _port_steps_world1(wire, momentum=MOMENTUM):
    from horovod_tpu_torch import spmd

    ps, loss_fn = _port_mlp()
    opt = torch.optim.SGD(ps, lr=LR, momentum=momentum)
    step = spmd.make_train_step(loss_fn, opt, ps, compression=wire)
    x, y = (torch.from_numpy(a) for a in _batch(1))
    losses = [float(step(x, y)) for _ in range(STEPS)]
    return losses, ps, step


@pytest.mark.parametrize("wire", [None, "int8", "int4"])
def test_world1_step_matches_reference(port_cpu, wire):
    from horovod_tpu_torch import spmd

    spmd.reset_accounting()
    losses, ps, step = _port_steps_world1(wire)
    ref_losses, ref_params, ref_ef = _ref_steps(1, wire)
    _rel_close(losses, ref_losses, 2e-6)
    for k, p in zip(KEYS, ps):
        _rel_close(p.detach().numpy(), ref_params[k], 2e-6)
    if wire is None:
        assert step.ef is None
        return
    ef, ref_row = step.ef.numpy(), ref_ef[0]
    assert ef.shape == ref_row.shape == (sum(p.numel() for p in ps),)
    # XLA fuses the reference's corrected - q * scale into one FMA; the
    # port takes q * scale from #2 and subtracts (two roundings): 1e-4 of
    # the largest residual; a flipped rounding moves an element by one
    # quantization step (about twice the largest residual)
    scale = np.abs(ref_row).max() + 1e-30
    close = np.abs(ef - ref_row) <= 1e-4 * scale
    assert close.mean() >= 0.99, close.mean()
    assert np.abs(ef - ref_row).max() <= 2.5 * scale
    assert np.abs(ef).max() > 0  # carried at world 1
    # world 1: the byte catalog counts nothing, the ring is recorded
    assert spmd.gspmd_bytes() == {"wire": 0, "exact": 0}
    assert spmd.gspmd_algorithms() == {"small": "ring"}


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_world1_residual_is_carried_and_applied(port_cpu, wire):
    """At world 1 the wire is not crossed, so the step applies ``g + ef``
    unquantized, yet banks ``ef = corrected - roundtrip(corrected)``, as the
    reference does (``horovod_tpu/spmd.py:237-238, 1026-1027``)."""
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.ops import compression as comp

    ps, loss_fn = _port_mlp()
    opt = torch.optim.SGD(ps, lr=LR)
    step = spmd.make_train_step(loss_fn, opt, ps, compression=wire)
    x, y = (torch.from_numpy(a) for a in _batch(1))
    bits = 4 if wire == "int4" else 8
    for _ in range(STEPS):
        before = [p.detach().clone() for p in ps]
        ef = step.ef.clone()
        for p in ps:
            p.grad = None
        loss_fn(x, y).backward()
        g = torch.cat([p.grad.reshape(-1) for p in ps])
        corrected = g + ef
        step(x, y)
        want = corrected - comp.quantize_roundtrip(corrected, BLOCK,
                                                   bits=bits)
        assert torch.equal(step.ef, want)
        off = 0
        for p, b in zip(ps, before):
            n = p.numel()
            applied = corrected[off:off + n].view(p.shape)
            assert torch.equal(p.detach(), b.add(applied, alpha=-LR))
            off += n
    assert float(step.ef.abs().max()) > 0


# ------------------------------------------------- the primitives, worlds
def primitives_worker() -> dict:
    """One rank: the in-step primitives on seeded rows."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd

    torch.set_num_threads(1)
    n, r = hvd.size(), hvd.rank()
    rows = np.random.RandomState(3).randn(n, 4 * n).astype(np.float32)
    x = torch.from_numpy(rows[r])
    out = {
        "sum": spmd.allreduce(x, hvd.Sum).numpy(),
        "avg": spmd.allreduce(x, hvd.Average).numpy(),
        "pmean": spmd.pmean(x).numpy(),
        "bcast": spmd.broadcast(x, root_rank=n - 1).numpy(),
        "gather": spmd.allgather(x).numpy(),
        "rs": spmd.reduce_scatter(x).numpy(),
        "a2a": spmd.alltoall(x).numpy(),
        "rs_ag": spmd.allgather(spmd.reduce_scatter(x)).numpy(),
        "ints": spmd.allreduce(torch.arange(5, dtype=torch.int64) * (r + 2),
                               hvd.Average).numpy(),
    }
    return out


def _ref_primitives(n: int) -> dict:
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu import spmd as ref
    from horovod_tpu.basics import MESH_AXIS, Average, Sum

    mesh = Mesh(np.array(jax.devices()[:n]), (MESH_AXIS,))
    rows = np.random.RandomState(3).randn(n, 4 * n).astype(np.float32)
    fns = {"sum": lambda v: ref.allreduce(v, Sum),
           "avg": lambda v: ref.allreduce(v, Average),
           "pmean": ref.pmean,
           "bcast": lambda v: ref.broadcast(v, n - 1),
           "gather": ref.allgather, "rs": ref.reduce_scatter,
           "a2a": ref.alltoall,
           "rs_ag": lambda v: ref.allgather(ref.reduce_scatter(v))}
    out = {}
    for k, f in fns.items():
        sm = ref._shard_map(lambda row, f=f: f(row[0])[None], mesh,
                            in_specs=P(MESH_AXIS), out_specs=P(MESH_AXIS))
        out[k] = np.asarray(jax.jit(sm)(rows))
    return out


@pytest.fixture(scope="module")
def primitives4():
    return testing.run_cluster(primitives_worker, np=4, device="cpu",
                               timeout=300)


@pytest.mark.parametrize("name", ["sum", "avg", "pmean", "bcast", "gather",
                                  "rs", "a2a", "rs_ag"])
@pytest.mark.parametrize("world", [2, 4])
def test_primitives_match_reference(request, world, name):
    ranks = request.getfixturevalue(
        "world2" if world == 2 else "primitives4")
    ranks = [r["primitives"] if "primitives" in r else r for r in ranks]
    want = _ref_primitives(world)[name]
    for p, r in enumerate(ranks):
        np.testing.assert_allclose(r[name], want[p], rtol=1e-6, atol=1e-6)
    ints = sum(np.arange(5) * (q + 2) for q in range(world)) // world
    for r in ranks:
        np.testing.assert_array_equal(r["ints"], ints)


# ---------------------------------------------------- the step, world 2
def step_worker() -> dict:
    """One rank at world 2: the primitives; the int8 step with and without
    ZeRO-1; the exact step with and without ZeRO-1 under SGD and AdamW."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.optim import zero

    torch.set_num_threads(1)
    r = hvd.rank()
    x, y = _batch(2)
    xb = torch.from_numpy(x[r * B:(r + 1) * B])
    yb = torch.from_numpy(y[r * B:(r + 1) * B])
    out = {"primitives": primitives_worker(), "runs": {}}
    cases = [("int8", False, "sgd"), ("int8", True, "sgd"),
             ("int4", True, "sgd"), (None, False, "sgd"),
             (None, True, "sgd"), (None, False, "adamw"),
             (None, True, "adamw")]
    for wire, z, kind in cases:
        ps, loss_fn = _port_mlp()
        opt = (torch.optim.SGD(ps, lr=LR, momentum=MOMENTUM) if kind == "sgd"
               else torch.optim.AdamW(ps, lr=1e-2))
        spmd.reset_accounting()
        spmd.reset_hop_bytes()
        step = spmd.make_train_step(loss_fn, opt, ps, compression=wire,
                                    zero1=z)
        losses = [float(step(xb, yb)) for _ in range(STEPS)]
        out["runs"][(wire, z, kind)] = dict(
            losses=losses, params=[p.detach().numpy().copy() for p in ps],
            ef=None if step.ef is None else step.ef.numpy().copy(),
            state=(step.zero1_state_numel() if z
                   else zero.state_numel(opt)),
            bytes=spmd.gspmd_bytes(), hops=spmd.hop_bytes(),
            graphed=step.graphed)
    return out


@pytest.fixture(scope="module")
def world2():
    return testing.run_cluster(step_worker, np=2, device="cpu", timeout=300)


def _params(run) -> dict:
    return dict(zip(KEYS, run["params"]))


@pytest.mark.parametrize("zero1", [False, True])
def test_world2_int8_step_matches_reference(world2, zero1):
    from horovod_tpu_torch.ops import compression as comp
    from horovod_tpu_torch.optim import zero

    runs = [r["runs"][("int8", zero1, "sgd")] for r in world2]
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        np.testing.assert_array_equal(a, b)  # the ranks agree bit for bit
    assert runs[0]["losses"] == runs[1]["losses"]
    assert not runs[0]["graphed"]
    ref_losses, ref_params, ref_ef = _ref_steps(2, "int8", zero1=zero1)
    _rel_close(runs[0]["losses"], ref_losses, 2e-5)
    for k, v in _params(runs[0]).items():
        _rel_close(v, ref_params[k], 2e-5)
    total = H + O + I * H + H * O
    for rank, run in enumerate(runs):
        assert run["ef"].shape == (total,)
        assert np.abs(run["ef"]).max() > 0
        _rel_close(run["ef"], ref_ef[rank], 0.05)
    # bytes: the catalog's ring row a step, and the hops' own count
    row = comp.gspmd_wire_footprint(total, "int8", 2, BLOCK)
    assert runs[0]["bytes"]["wire"] == STEPS * row
    assert runs[0]["bytes"]["exact"] == STEPS * comp.gspmd_wire_footprint(
        total, "none", 2, BLOCK)
    assert runs[0]["hops"] == STEPS * row
    if zero1:  # the flat optimizer's state: one chunk, 1/2 of the padded
        chunk = zero.ring_chunk(total, 2, BLOCK)
        assert runs[0]["state"] == chunk and 2 * chunk < total + 2 * BLOCK


@pytest.mark.parametrize("kind", ["sgd", "adamw"])
def test_world2_exact_zero1_equals_replicated(world2, kind):
    """On the exact wire ZeRO-1's update equals the replicated one bit for
    bit, with the state 1/2 a rank (``tests/test_spmd.py:145``)."""
    from horovod_tpu_torch.optim import zero

    total = H + O + I * H + H * O
    for r in world2:
        rep = r["runs"][(None, False, kind)]
        z = r["runs"][(None, True, kind)]
        for a, b in zip(rep["params"], z["params"]):
            np.testing.assert_array_equal(a, b)
        assert rep["losses"] == z["losses"]
        tensors = 1 if kind == "sgd" else 2
        assert rep["state"] == tensors * total
        assert z["state"] == tensors * zero.ring_chunk(total, 2, BLOCK)
    a, b = (r["runs"][(None, True, kind)]["params"] for r in world2)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


def test_world2_int4_zero1_ranks_agree(world2):
    runs = [r["runs"][("int4", True, "sgd")] for r in world2]
    for a, b in zip(runs[0]["params"], runs[1]["params"]):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(v) for v in runs[0]["losses"])
    ref_losses, ref_params, _ = _ref_steps(2, "int4", zero1=True)
    _rel_close(runs[0]["losses"], ref_losses, 2e-5)
    for k, v in _params(runs[0]).items():
        _rel_close(v, ref_params[k], 2e-5)


def test_world2_exact_step_matches_reference(world2):
    run = world2[0]["runs"][(None, False, "sgd")]
    ref_losses, ref_params, _ = _ref_steps(2, None)
    _rel_close(run["losses"], ref_losses, 2e-6)
    for k, v in _params(run).items():
        _rel_close(v, ref_params[k], 2e-6)


# ------------------------------------------- the trainers on the CPU
def test_compiled_resnet_trainer_matches_the_engine_plane_exactly(port_cpu):
    """At world 1 on the exact wire the compiled plane's ResNet step is the
    engine plane's (the same SGD on the same gradients), bit for bit; the
    int8 wire carries a residual; a cast wire raises."""
    from horovod_tpu_torch.train import synthetic_train

    kw = dict(batch=2, image=32, steps=2, warmup=1, device="cpu",
              num_classes=10, num_filters=8)
    engine = synthetic_train("ResNet18", compression="none",
                             error_feedback=False, **kw)
    compiled = synthetic_train("ResNet18", compression="none",
                               plane="compiled", **kw)
    assert compiled["losses"] == engine["losses"]
    assert compiled["params_sha256"] == engine["params_sha256"]
    assert compiled["graphed"] is False
    int8 = synthetic_train("ResNet18", compression="int8", plane="compiled",
                           zero1=True, **kw)
    assert all(np.isfinite(int8["losses"]))
    assert int8["zero1_state_numel"] > 0
    with pytest.raises(ValueError, match="compiled plane's wire"):
        synthetic_train("ResNet18", compression="fp16", plane="compiled",
                        **kw)


@pytest.mark.parametrize("fused", [False, True])
def test_compiled_lm_trainer_matches_the_engine_plane_exactly(port_cpu, fused):
    from horovod_tpu_torch.train import synthetic_lm_train

    kw = dict(preset="tiny", device="cpu", vocab=256, steps=1, warmup=1,
              fused_ln=fused, fused_opt=fused)
    engine = synthetic_lm_train(**kw)
    compiled = synthetic_lm_train(compiled=True, **kw)
    assert compiled["losses"] == engine["losses"]
    assert compiled["params_sha256"] == engine["params_sha256"]
    assert compiled["compiled"] and not compiled["graphed"]
