"""What the compiled data-parallel plane (``spmd.py``) needs of the
reference's adaptive wire (``horovod_tpu/ops/adaptive.py``), copied, in
numpy only:

* :func:`admit_wire` and the :class:`ConvergenceGate` behind it: int4 on the
  compiled wire must first pass an A/B convergence run of a seeded proxy
  problem (exact gradients against int4 + error feedback); a refusal
  downgrades to int8. ``HOROVOD_ADAPTIVE_GATE=0`` turns the gate off.
* the tuned collective algorithm (:func:`set_autotuned_algorithm`,
  :func:`autotuned_algorithm`), which ``spmd.resolve_algorithm`` follows
  for ``"auto"``; :func:`reset` forgets it and the gate's verdicts;
* the algorithm codes and payload-size classes (:data:`ALGO_CODES`,
  :data:`SIZE_CLASSES`, :func:`size_class`).

The per-bucket bitwidth selector and the tuners are not here yet.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

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


_QMAX = {4: 7.0, 8: 127.0}


def gate_enabled() -> bool:
    return os.environ.get("HOROVOD_ADAPTIVE_GATE", "1").strip() not in (
        "0", "false", "False", "off")


# The winning algorithm a tuner broadcast ("" when none has arrived; then
# spmd.resolve_algorithm falls back to its static size/topology rule).
_lock = threading.Lock()
_autotuned_algo = ""


def set_autotuned_algorithm(algo: str) -> None:
    global _autotuned_algo
    if algo not in ALGORITHMS:
        return  # an unknown member: ignored, as the reference does
    with _lock:
        _autotuned_algo = algo


def autotuned_algorithm() -> str:
    with _lock:
        return _autotuned_algo


def reset() -> None:
    """Test hook: forget the tuned algorithm and the gate's verdicts."""
    global _autotuned_algo
    with _lock:
        _autotuned_algo = ""
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
