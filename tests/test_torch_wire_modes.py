"""The port's wire modes against the reference's: the names and catalogs of
``ops/compression.py`` (int8-dcn and the adaptive wire), and the adaptive
wire's selector, tuners and error-feedback roundtrip (``ops/adaptive.py``).

The selector and the tuners are numpy in both packages, fed the same
seeded streams: their decisions, caps and algorithms must be the same at
every step. Roundtrips are held byte-equal to the reference's (Pallas
kernels in interpret mode where the reference takes them).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adaptive as ref_ad
from horovod_tpu.ops import compression as ref_comp
from horovod_tpu_torch.ops import adaptive as ad
from horovod_tpu_torch.ops import compression as comp
from horovod_tpu_torch.runtime.executor import Executor


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("HVD_PALLAS", "interpret")
    for k in ("HOROVOD_INT8_BLOCK", "HOROVOD_COMPRESSION",
              "HOROVOD_ADAPTIVE_TOL", "HOROVOD_ADAPTIVE_INTERVAL",
              "HOROVOD_ADAPTIVE_GATE"):
        monkeypatch.delenv(k, raising=False)
    for m in (ad, ref_ad):
        m.reset()
    comp.AdaptiveCompressor.reset()
    ref_comp.AdaptiveCompressor.reset()
    yield
    for m in (ad, ref_ad):
        m.reset()
    comp.AdaptiveCompressor.reset()
    ref_comp.AdaptiveCompressor.reset()


# -------------------------------------------------------- names, catalogs
@pytest.mark.parametrize("name", sorted(ref_comp._BY_NAME) + [" INT8-DCN ",
                                                              "Adaptive"])
def test_by_name_and_from_env_every_reference_name(name, monkeypatch):
    mine, ref = comp.by_name(name), ref_comp.by_name(name)
    assert mine.__name__ == ref.__name__ and mine.wire == ref.wire
    monkeypatch.setenv("HOROVOD_COMPRESSION", name)
    if name.strip():
        assert comp.from_env().__name__ == ref_comp.from_env().__name__
    else:  # an empty knob is the default
        assert comp.from_env() is comp.NoneCompressor


def test_unknown_name_error_and_namespaces():
    with pytest.raises(ValueError) as mine:
        comp.by_name("int3")
    with pytest.raises(ValueError) as ref:
        ref_comp.by_name("int3")
    assert str(mine.value) == str(ref.value)
    assert comp.Compression.int8_dcn is comp.Int8DcnCompressor
    assert comp.Compression.adaptive is comp.AdaptiveCompressor
    assert {k: v.__name__ for k, v in comp.BY_WIRE.items()} == \
        {k: v.__name__ for k, v in ref_comp.BY_WIRE.items()}


@pytest.mark.parametrize("mode", ["int8-dcn", "int8_dcn", "adaptive",
                                  "adaptive:int4", "adaptive:int8",
                                  "adaptive:bf16", "adaptive:none"])
def test_wire_footprint_new_modes_equal_reference(mode):
    for n, block in itertools.product([1, 255, 256, 5000, 65537],
                                      [None, 2, 100, 256]):
        assert comp.wire_footprint(n, mode, block) == \
            ref_comp.wire_footprint(n, mode, block), (n, mode, block)
    with pytest.raises(ValueError):
        comp.wire_footprint(10, "adaptive:int3")


def test_effective_wire_new_modes(monkeypatch):
    ex = Executor(4, "gloo")
    assert ex.effective_wire("int8-dcn", torch.float32, 5000) == "int8-dcn"
    assert ex.effective_wire("adaptive:bf16", torch.float32, 5000) == "bf16"
    assert ex.effective_wire("adaptive:int4", torch.float32, 5000) == "int4"
    assert ex.effective_wire("bf16", torch.int32, 5000) == ""
    assert ex.effective_wire("int8-dcn", torch.float32, 5000,
                             adasum=True) == ""
    assert ex.effective_wire("adaptive:int8", torch.float32, 100) == ""
    monkeypatch.setenv("HOROVOD_INT8_BLOCK", "255")
    assert ex.effective_wire("adaptive:int4", torch.float32, 5000) == "int8"


# ------------------------------------------------------------ numerics
def _rows(seed, n=4096):
    rng = np.random.RandomState(seed)
    return {"gauss": rng.randn(n).astype(np.float32),
            "heavy": (rng.randn(n) ** 3).astype(np.float32),
            "scaled": (rng.randn(n) * 1e-3).astype(np.float32),
            "zeros": np.zeros(n, np.float32),
            "ragged": rng.randn(1000).astype(np.float32)}


@pytest.mark.parametrize("mode", ["int4", "int8", "bf16"])
def test_relative_residual_equals_reference(mode):
    for seed in range(3):
        for label, x in _rows(seed).items():
            assert ad.relative_residual(x, mode) == \
                ref_ad.relative_residual(x, mode), (mode, label)
    x = _rows(0)["gauss"]
    r = [ad.relative_residual(x, m) for m in ("bf16", "int8", "int4")]
    assert r[0] < r[1] < r[2] < 0.2


def _prime(selector_owner, mode):
    """Make the compressor's selector's most aggressive grid ``mode``."""
    g = np.random.RandomState(7).randn(4096).astype(np.float32)
    sample = g ** 3 if mode == "int8" else g
    selector_owner.observe("b", sample)


@pytest.mark.parametrize("mode,bits", [("int4", 4), ("int8", 8),
                                       ("bf16", 16)])
def test_adaptive_roundtrip_equals_reference(mode, bits, monkeypatch):
    """``AdaptiveCompressor.roundtrip`` at the selector's most aggressive
    grid (4 / 8 / 16 bits), and ``roundtrip_many`` (the one grouped call
    error feedback makes) with the same bits."""
    monkeypatch.setenv("HOROVOD_ADAPTIVE_INTERVAL", "1")
    if mode == "bf16":
        monkeypatch.setenv("HOROVOD_ADAPTIVE_TOL", "0.001")
    for c in (comp.AdaptiveCompressor, ref_comp.AdaptiveCompressor):
        _prime(c, mode)
    assert comp.AdaptiveCompressor.selector().min_active_bits() == bits
    assert ref_comp.AdaptiveCompressor.selector().min_active_bits() == bits
    xs = [(np.random.RandomState(s).randn(n) * 10.0 ** (s - 2)).astype(
        np.float32) for s, n in ((1, 5000), (2, 256), (3, 77))]
    mine = [comp.AdaptiveCompressor.roundtrip(torch.from_numpy(x))
            for x in xs]
    many = comp.AdaptiveCompressor.roundtrip_many(
        [torch.from_numpy(x) for x in xs])
    for x, y, z in zip(xs, mine, many):
        ref = np.asarray(ref_comp.AdaptiveCompressor.roundtrip(
            jnp.asarray(x)))
        np.testing.assert_array_equal(y.numpy(), ref)
        np.testing.assert_array_equal(z.numpy(), ref)
    ints = torch.arange(10, dtype=torch.int32)
    assert comp.AdaptiveCompressor.roundtrip_many([ints])[0] is ints


# -------------------------------------------------------------- selector
def _feed(streams, steps, monkeypatch=None, cap=None):
    """Both selectors fed ``streams(step)`` (``{name: row}``); the decision
    of every name after every step, from each."""
    mine, ref = ad.BitwidthSelector(), ref_ad.BitwidthSelector()
    got, want = [], []
    for step in range(steps):
        if cap is not None and step == cap[0]:
            ad.set_autotuned_cap(cap[1])
            ref_ad.set_autotuned_cap(cap[1])
        for name, row in streams(step).items():
            mine.observe(name, row)
            ref.observe(name, row.copy())
        got.append(mine.decisions())
        want.append(ref.decisions())
        assert mine.min_active_bits() == ref.min_active_bits()
    assert got == want
    return got


def test_selector_gaussian_goes_int4():
    rng = np.random.RandomState(0)
    seq = _feed(lambda s: {"g": rng.randn(8192).astype(np.float32) * .01},
                ad.interval())
    assert seq[-1] == {"g": "int4"}
    assert [s["g"] for s in seq[:-1]] == ["int8"] * (ad.interval() - 1)


def test_selector_heavy_tails_not_int4():
    rng = np.random.RandomState(1)
    seq = _feed(lambda s: {"h": (rng.randn(4096) ** 3).astype(np.float32)},
                2 * ad.interval())
    assert all(d["h"] != "int4" for d in seq)


def test_selector_holds_between_intervals_and_switches(monkeypatch):
    """Decisions change only on the interval, with the reference's
    hysteresis, over a stream that turns heavy-tailed half way."""
    monkeypatch.setenv("HOROVOD_ADAPTIVE_INTERVAL", "3")
    rng = np.random.RandomState(2)

    def stream(s):
        g = rng.randn(4096).astype(np.float32)
        return {"w": g if s < 9 else g ** 5, "v": g * 1e-4}

    seq = _feed(stream, 21)
    modes = [d["w"] for d in seq]
    assert modes[:2] == ["int8", "int8"]
    changes = [i for i in range(1, len(modes)) if modes[i] != modes[i - 1]]
    assert changes and all((i + 1) % 3 == 0 for i in changes)


def test_selector_honours_cap():
    rng = np.random.RandomState(4)
    seq = _feed(lambda s: {"c": rng.randn(4096).astype(np.float32)},
                3 * ad.interval(), cap=(0, "int8"))
    assert {d["c"] for d in seq} == {"int8"}
    seq = _feed(lambda s: {"c": rng.randn(4096).astype(np.float32)},
                2 * ad.interval(), cap=(ad.interval(), "int4"))
    assert seq[-1] == {"c": "int4"}
    ad.set_autotuned_cap("bf16")
    ref_ad.set_autotuned_cap("bf16")
    seq = _feed(lambda s: {"c": rng.randn(4096).astype(np.float32)},
                ad.interval())
    assert seq[-1] == {"c": "bf16"}
    ad.set_autotuned_cap("int2")  # unknown: ignored, as the reference does
    assert ad.autotuned_cap() == "bf16"


@pytest.mark.parametrize("gate", ["on", "off", "refuses"])
def test_selector_gate(gate, monkeypatch):
    """The convergence gate on (int4 admitted at measured parity), off
    (``HOROVOD_ADAPTIVE_GATE=0``), or refusing int4: the same decisions."""
    if gate == "off":
        monkeypatch.setenv("HOROVOD_ADAPTIVE_GATE", "0")
    if gate == "refuses":
        for g in (ad.ConvergenceGate.shared(),
                  ref_ad.ConvergenceGate.shared()):
            monkeypatch.setattr(g, "allows", lambda mode: mode != "int4")
    rng = np.random.RandomState(5)
    seq = _feed(lambda s: {"q": rng.randn(4096).astype(np.float32)},
                ad.interval())
    assert seq[-1] == {"q": "int8" if gate == "refuses" else "int4"}


def test_selector_records_changes_and_skips_bf16_tensors(monkeypatch):
    monkeypatch.setenv("HOROVOD_ADAPTIVE_INTERVAL", "1")
    sel = ad.BitwidthSelector()
    sel.observe("t", torch.randn(5000, generator=torch.Generator()
                                 .manual_seed(0)))
    assert ad.bitwidth_decisions() == [("t", "int8", "int4")]
    sel.observe("b", torch.randn(5000).bfloat16())
    sel.observe("i", torch.arange(5000))
    assert sel.decisions() == {"t": "int4"}  # as np.asarray of bf16 / ints
    ad.reset()
    assert ad.bitwidth_decisions() == []


# ---------------------------------------------------------------- tuners
def _feed_tuner(make, feed, rounds):
    mine, ref = make(ad), make(ref_ad)
    seen = []
    for k in range(rounds):
        b, t = feed(k, mine)
        mine.observe(b, t)
        ref.observe(b, t)
        pair = (mine.cap(), getattr(mine, "algorithm", lambda: None)())
        assert pair == (ref.cap(), getattr(ref, "algorithm",
                                           lambda: None)()), k
        assert mine.active() == ref.active()
        seen.append(pair)
    return seen, mine


def test_bitwidth_tuner_same_caps():
    cost = {"bf16": 1000, "int8": 600, "int4": 300}
    seen, t = _feed_tuner(lambda m: m.BitwidthTuner(episode_rounds=2),
                          lambda k, t: (cost[t.cap()], 1.0), 10)
    assert {c for c, _ in seen} == {"bf16", "int8", "int4"}
    assert not t.active() and t.cap() == "int4"


def test_bitwidth_tuner_skips_gated_int4(monkeypatch):
    for g in (ad.ConvergenceGate.shared(), ref_ad.ConvergenceGate.shared()):
        monkeypatch.setattr(g, "allows", lambda mode: mode != "int4")
    seen, t = _feed_tuner(lambda m: m.BitwidthTuner(episode_rounds=1),
                          lambda k, t: (100 + k, 1.0), 5)
    assert "int4" not in {c for c, _ in seen} and t.cap() == "bf16"


def test_joint_tuner_same_algorithms_and_caps():
    """Rounds of three payload-size classes, each scored by a step time
    that depends on (algorithm, cap): every class settles on the same pair
    as the reference's, the small one on the tree."""
    times = {"ring": 3.0, "tree": 1.0, "hier": 2.0}
    caps = {"bf16": 0.3, "int8": 0.2, "int4": 0.1}
    sizes = (1 << 10, 1 << 20, 1 << 24)

    def feed(k, t):
        b = sizes[k % 3]
        a, c = t.choice(ad.size_class(b))
        scale = 1.0 if b == sizes[0] else 1.0 + (a == "tree") * 5
        return b, times[a] * scale + caps[c]

    seen, t = _feed_tuner(lambda m: m.JointTuner(episode_rounds=2), feed,
                          3 * 2 * 9 + 6)
    assert not t.active()
    assert t.choice("small") == ("tree", "int4")
    assert t.choice("large") == ("hier", "int4")
    assert len({p for p in seen}) > 3
