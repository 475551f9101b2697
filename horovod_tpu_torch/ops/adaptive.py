"""Per-bucket bitwidth selection for the mixed-precision wire (a copy of
``horovod_tpu/ops/adaptive.py``, in numpy only, so that it never touches
the card from the engine's thread):

* :class:`BucketStats` / :class:`BitwidthSelector`: running statistics of
  each reduced bucket (absmax and variance EMAs, the relative residual at
  each candidate grid) decide int4, int8 or bf16 every
  ``HOROVOD_ADAPTIVE_INTERVAL`` observations, with hysteresis. The
  statistics come from the reduced bucket, the same bytes on every rank,
  so every rank makes the same decisions; negotiation resolves a race to
  the least aggressive grid.
* :func:`admit_wire` and the :class:`ConvergenceGate` behind it: int4 must
  first pass an A/B convergence run of a seeded proxy problem (exact
  gradients against int4 + error feedback); a refusal downgrades to int8.
  ``HOROVOD_ADAPTIVE_GATE=0`` turns the gate off.
* :class:`BitwidthTuner` and :class:`JointTuner`: the bitwidth cap, and the
  (algorithm, cap) pair per payload-size class, explored in episodes and
  settled on the cheapest. Their winners reach every rank through
  :func:`set_autotuned_cap` / :func:`set_autotuned_algorithm`; what drives
  them (the coordinator's scored rounds) is not ported yet.
* the algorithm codes and payload-size classes (:data:`ALGO_CODES`,
  :data:`SIZE_CLASSES`, :func:`size_class`).

A decision change is kept as a plain per-process record
(:func:`bitwidth_decisions`), where the reference writes a flight-recorder
event and two metrics instruments.

Knobs, read per call: ``HOROVOD_ADAPTIVE_TOL`` (relative residual
tolerance, default 0.2), ``HOROVOD_ADAPTIVE_INTERVAL`` (observations
between decisions, default 10), ``HOROVOD_ADAPTIVE_GATE``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: candidate wire modes, cheapest first, and their bits
MODES = ("int4", "int8", "bf16")
BITS = {"int4": 4, "int8": 8, "bf16": 16}

#: the compiled plane's collective algorithms, in the reference's
#: exploration order
ALGORITHMS = ("ring", "tree", "hier")
#: gauge encoding of an algorithm
ALGO_CODES = {"ring": 0, "tree": 1, "hier": 2}

#: payload-size classes, upper bounds in wire bytes (inclusive)
SIZE_CLASSES = (("small", 1 << 16), ("medium", 1 << 22), ("large", None))


def size_class(nbytes: int) -> str:
    """Class name for one round's payload bytes (upper bounds inclusive)."""
    for name, bound in SIZE_CLASSES:
        if bound is None or nbytes <= bound:
            return name
    return SIZE_CLASSES[-1][0]


#: elements of the reduced bucket sampled per observation (a prefix, the
#: same on every rank)
SAMPLE = 4096

_QMAX = {4: 7.0, 8: 127.0}


def tolerance() -> float:
    """Relative residual tolerance (``HOROVOD_ADAPTIVE_TOL``, default 0.2:
    a Gaussian block measures about 0.14 at int4, heavy tails more)."""
    v = float(os.environ.get("HOROVOD_ADAPTIVE_TOL", 0.2))
    if v <= 0:
        raise ValueError(f"HOROVOD_ADAPTIVE_TOL={v}: must be positive")
    return v


def interval() -> int:
    """Observations between decisions (``HOROVOD_ADAPTIVE_INTERVAL``)."""
    v = int(os.environ.get("HOROVOD_ADAPTIVE_INTERVAL", 10))
    if v <= 0:
        raise ValueError(f"HOROVOD_ADAPTIVE_INTERVAL={v}: must be positive")
    return v


def gate_enabled() -> bool:
    return os.environ.get("HOROVOD_ADAPTIVE_GATE", "1").strip() not in (
        "0", "false", "False", "off")


# The tuner's floor on the wire grid (a cap on aggressiveness): decisions
# may not go below cap bits. "int4" is no restriction; "bf16" forbids the
# integer grids. And the winning algorithm a tuner broadcast ("" when none
# has arrived; then spmd.resolve_algorithm falls back to its static rule).
_lock = threading.Lock()
_autotuned_cap = "int4"
_autotuned_algo = ""
# (name, old, new) of each bitwidth decision change, in order
_decisions: List[Tuple[str, str, str]] = []


def set_autotuned_cap(cap: str) -> None:
    global _autotuned_cap
    if cap not in MODES:
        return  # an unknown mode: ignored, as the reference does
    with _lock:
        _autotuned_cap = cap


def autotuned_cap() -> str:
    with _lock:
        return _autotuned_cap


def set_autotuned_algorithm(algo: str) -> None:
    global _autotuned_algo
    if algo not in ALGORITHMS:
        return  # an unknown member: ignored, as the reference does
    with _lock:
        _autotuned_algo = algo


def autotuned_algorithm() -> str:
    with _lock:
        return _autotuned_algo


def bitwidth_decisions() -> List[Tuple[str, str, str]]:
    """``(bucket name, old mode, new mode)`` of every decision change this
    process made, in order."""
    with _lock:
        return list(_decisions)


def reset() -> None:
    """Test hook: forget the tuned cap and algorithm, the decision record
    and the gate's verdicts."""
    global _autotuned_cap, _autotuned_algo
    with _lock:
        _autotuned_cap = "int4"
        _autotuned_algo = ""
        _decisions.clear()
    ConvergenceGate.shared().forget()


def admit_wire(wire: str) -> str:
    """Gate admission for an integer wire grid: int4 must pass the
    :class:`ConvergenceGate`, and a refusal downgrades to int8; int8 (and
    anything else) passes unchanged."""
    if wire == "int4" and not ConvergenceGate.shared().allows("int4"):
        return "int8"
    return wire


def _block_roundtrip(x: np.ndarray, bits: int, block: int = 256) -> np.ndarray:
    """Quantize then dequantize ``x`` block by block (scale = absmax/qmax,
    round half to even), zero-padded to whole blocks and cut back."""
    qmax = _QMAX[bits]
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = np.pad(x, (0, pad))
    x2 = x.reshape(-1, block).astype(np.float32)
    absmax = np.max(np.abs(x2), axis=1, keepdims=True)
    scale = absmax * (1.0 / qmax)
    safe = np.where(scale > 0.0, scale, 1.0)
    q = np.clip(np.round(x2 / safe), -qmax, qmax)
    y = (q * scale).reshape(-1)
    return y[:n] if pad else y


def _bf16_roundtrip(x: np.ndarray) -> np.ndarray:
    """The bf16 cast's loss: the mantissa cut to 8 bits, rounded through the
    +0x8000 carry (the reference's formula, kept for its numbers)."""
    u = x.astype(np.float32).view(np.uint32)
    u = (u + 0x8000 + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def relative_residual(x: np.ndarray, mode: str) -> float:
    """``|x - wire(x)| / |x|`` for one candidate grid: what error feedback
    would carry if the bucket rode that wire."""
    xf = np.asarray(x, dtype=np.float32).reshape(-1)
    norm = float(np.linalg.norm(xf))
    if norm == 0.0:
        return 0.0
    if mode == "bf16":
        y = _bf16_roundtrip(xf)
    else:
        y = _block_roundtrip(xf, BITS[mode])
    return float(np.linalg.norm(xf - y)) / norm


class BucketStats:
    """Running statistics of one bucket name (EMAs, decay 0.8)."""

    __slots__ = ("count", "absmax", "var", "err", "mode")

    def __init__(self):
        self.count = 0
        self.absmax = 0.0
        self.var = 0.0
        self.err: Dict[str, float] = {}
        self.mode = "int8"  # before any decision: the static wire's

    def update(self, sample: np.ndarray) -> None:
        a = float(np.max(np.abs(sample))) if sample.size else 0.0
        v = float(np.var(sample)) if sample.size else 0.0
        d = 0.8
        self.absmax = a if self.count == 0 else d * self.absmax + (1 - d) * a
        self.var = v if self.count == 0 else d * self.var + (1 - d) * v
        for m in MODES:
            e = relative_residual(sample, m)
            prev = self.err.get(m)
            self.err[m] = e if prev is None else d * prev + (1 - d) * e
        self.count += 1


class BitwidthSelector:
    """Per-bucket int4 / int8 / bf16 choice from running statistics.

    ``observe(name, flat)`` feeds a reduced bucket after its drain (its
    first :data:`SAMPLE` elements, copied to the host); ``decide(name)`` is
    the mode the next enqueue requests. Decisions change only every
    :func:`interval` observations, so every rank requests the same mode
    for the same step. Hysteresis: a mode other than the current one must
    measure under 0.8 x tolerance, the incumbent under the tolerance.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, BucketStats] = {}
        self._gate = ConvergenceGate.shared()

    def observe(self, name: str, flat) -> None:
        x = _host_sample(flat)
        if not np.issubdtype(x.dtype, np.floating):
            return
        with self._lock:
            st = self._stats.setdefault(name, BucketStats())
            st.update(x.astype(np.float32))
            if st.count % interval() == 0:
                self._redecide(name, st)

    def decide(self, name: str) -> str:
        with self._lock:
            st = self._stats.get(name)
            return st.mode if st is not None else "int8"

    def min_active_bits(self) -> int:
        """Bits of the most aggressive grid chosen across buckets (8 before
        any decision): what error feedback measures against."""
        with self._lock:
            if not self._stats:
                return 8
            return min(BITS[st.mode] for st in self._stats.values())

    def decisions(self) -> Dict[str, str]:
        with self._lock:
            return {n: st.mode for n, st in self._stats.items()}

    def _redecide(self, name: str, st: BucketStats) -> None:
        tol = tolerance()
        cap_bits = BITS[autotuned_cap()]
        pick = "bf16"
        for m in MODES:  # cheapest first
            if BITS[m] < cap_bits:
                continue
            if m == "int4" and not self._gate.allows("int4"):
                continue
            margin = tol if m == st.mode else 0.8 * tol
            if m == "bf16" or st.err.get(m, np.inf) <= margin:
                pick = m
                break
        if pick != st.mode:
            old, st.mode = st.mode, pick
            self._record(name, old, pick)

    @staticmethod
    def _record(name: str, old: str, new: str) -> None:
        with _lock:
            _decisions.append((name, old, new))


def _host_sample(flat) -> np.ndarray:
    """The first :data:`SAMPLE` elements of ``flat`` as a numpy array: only
    the sample is copied off the card. A bf16 tensor gives no numpy float
    (the reference's ``np.asarray`` of a bf16 array is not
    ``np.floating`` either), so it is not observed."""
    if isinstance(flat, torch.Tensor):
        x = flat.detach().reshape(-1)[:SAMPLE]
        if not x.dtype.is_floating_point or x.dtype == torch.bfloat16:
            return np.zeros(0, np.int8)
        return x.cpu().numpy()
    return np.asarray(flat).reshape(-1)[:SAMPLE]


class ConvergenceGate:
    """A/B convergence harness gating aggressive bitwidths.

    Trains one seeded least-squares problem twice with plain gradient
    descent: with exact gradients, and with gradients pushed through the
    candidate grid plus error feedback. A grid is admitted only if its
    final loss is within ``rel_tol`` of the exact run's. Seeded numpy end to
    end, so the verdict is the same on every rank, and cached.
    """

    _shared: Optional["ConvergenceGate"] = None

    @classmethod
    def shared(cls) -> "ConvergenceGate":
        if cls._shared is None:
            cls._shared = ConvergenceGate()
        return cls._shared

    def __init__(self, steps: int = 150, dim: int = 256, lr: float = 0.05,
                 rel_tol: float = 0.05, seed: int = 1234):
        self.steps = steps
        self.dim = dim
        self.lr = lr
        self.rel_tol = rel_tol
        self.seed = seed
        self._lock = threading.Lock()
        self._verdicts: Dict[str, bool] = {}
        self._losses: Dict[str, Tuple[float, float]] = {}

    def forget(self) -> None:
        with self._lock:
            self._verdicts.clear()
            self._losses.clear()

    def allows(self, mode: str) -> bool:
        if mode != "int4":
            return True  # int8 / bf16 need no gate
        if not gate_enabled():
            return True
        with self._lock:
            v = self._verdicts.get(mode)
            if v is None:
                exact, quant = self._ab_losses(BITS[mode])
                v = quant <= exact * (1.0 + self.rel_tol)
                self._verdicts[mode] = v
                self._losses[mode] = (exact, quant)
            return v

    def losses(self, mode: str) -> Tuple[float, float]:
        """(exact loss, quantized loss) of the A/B pair; runs it if needed."""
        with self._lock:
            if mode not in self._losses:
                self._losses[mode] = self._ab_losses(BITS[mode])
            return self._losses[mode]

    def _ab_losses(self, bits: int) -> Tuple[float, float]:
        return (self._train(None), self._train(bits))

    def _train(self, bits: Optional[int]) -> float:
        rng = np.random.RandomState(self.seed)
        n, d = 4 * self.dim, self.dim
        x = rng.randn(n, d).astype(np.float32)
        w_true = rng.randn(d).astype(np.float32)
        y = x @ w_true + 0.01 * rng.randn(n).astype(np.float32)
        w = np.zeros(d, dtype=np.float32)
        residual = np.zeros(d, dtype=np.float32)
        for _ in range(self.steps):
            g = (2.0 / n) * (x.T @ (x @ w - y))
            if bits is not None:
                corrected = g + residual
                g_wire = _block_roundtrip(corrected, bits)
                residual = corrected - g_wire
                g = g_wire
            w -= self.lr * g
        return float(np.mean((x @ w - y) ** 2))


class BitwidthTuner:
    """Bitwidth-cap search over scored rounds: each gate-admitted cap, least
    aggressive first, runs for ``episode_rounds`` rounds, accumulating the
    wire bytes of each; after the sweep the cap with the fewest mean bytes a
    round wins (a tie goes to the more aggressive cap) and the tuner
    settles."""

    def __init__(self, episode_rounds: int = 8):
        self.episode_rounds = episode_rounds
        gate = ConvergenceGate.shared()
        self._candidates = [m for m in reversed(MODES)
                            if m != "int4" or gate.allows("int4")]
        self._idx = 0
        self._rounds = 0
        self._bytes: Dict[str, list] = {m: [] for m in self._candidates}
        self._settled: Optional[str] = None

    def active(self) -> bool:
        return self._settled is None

    def cap(self) -> str:
        if self._settled is not None:
            return self._settled
        return self._candidates[self._idx]

    def observe(self, round_bytes: int, round_seconds: float) -> None:
        """One scored round under the current cap."""
        if self._settled is not None or round_bytes <= 0:
            return
        cur = self._candidates[self._idx]
        self._bytes[cur].append(float(round_bytes))
        self._rounds += 1
        if self._rounds >= self.episode_rounds:
            self._rounds = 0
            self._idx += 1
            if self._idx >= len(self._candidates):
                self._settle()

    def _settle(self) -> None:
        best, best_mean = None, None
        for m in self._candidates:
            vals = self._bytes[m]
            if not vals:
                continue
            mean = sum(vals) / len(vals)
            if best_mean is None or mean < best_mean:
                best, best_mean = m, mean
        self._settled = best or self._candidates[-1]


class _ClassSearch:
    """The episode walk over (algorithm, cap) pairs of one payload-size
    class (:class:`JointTuner`'s state)."""

    __slots__ = ("combos", "idx", "rounds", "seconds", "settled")

    def __init__(self, combos):
        self.combos = combos
        self.idx = 0
        self.rounds = 0
        self.seconds: Dict[Tuple[str, str], list] = {c: [] for c in combos}
        self.settled: Optional[Tuple[str, str]] = None

    def current(self) -> Tuple[str, str]:
        return self.settled if self.settled is not None \
            else self.combos[self.idx]


class JointTuner:
    """Joint ``(algorithm, bitwidth cap)`` search per payload-size class:
    every gate-admitted pair, least aggressive first, runs for
    ``episode_rounds`` scored rounds of its class (:func:`size_class` of the
    round's wire bytes), scored by step time; after the walk the class
    settles on its least mean time (a tie goes to the later pair).
    :meth:`cap` and :meth:`algorithm` give the pair of the class of the
    round observed last."""

    def __init__(self, episode_rounds: int = 8):
        self.episode_rounds = episode_rounds
        gate = ConvergenceGate.shared()
        caps = [m for m in reversed(MODES)
                if m != "int4" or gate.allows("int4")]
        self._combos = [(a, c) for a in ALGORITHMS for c in caps]
        self._cls: Dict[str, _ClassSearch] = {
            name: _ClassSearch(list(self._combos))
            for name, _ in SIZE_CLASSES}
        self._last_cls = SIZE_CLASSES[0][0]

    def active(self) -> bool:
        return any(s.settled is None for s in self._cls.values())

    def choice(self, cls: Optional[str] = None) -> Tuple[str, str]:
        return self._cls[cls or self._last_cls].current()

    def cap(self) -> str:
        return self.choice()[1]

    def algorithm(self) -> str:
        return self.choice()[0]

    def observe(self, round_bytes: int, round_seconds: float) -> None:
        """One scored round under its class's current pair."""
        if round_bytes <= 0 or round_seconds <= 0:
            return
        cls = size_class(int(round_bytes))
        self._last_cls = cls
        s = self._cls[cls]
        if s.settled is not None:
            return
        s.seconds[s.combos[s.idx]].append(float(round_seconds))
        s.rounds += 1
        if s.rounds >= self.episode_rounds:
            s.rounds = 0
            s.idx += 1
            if s.idx >= len(s.combos):
                self._settle(s)

    @staticmethod
    def _settle(s: _ClassSearch) -> None:
        best, best_mean = None, None
        for c in s.combos:
            vals = s.seconds[c]
            if not vals:
                continue
            mean = sum(vals) / len(vals)
            if best_mean is None or mean <= best_mean:
                best, best_mean = c, mean
        s.settled = best or s.combos[-1]
