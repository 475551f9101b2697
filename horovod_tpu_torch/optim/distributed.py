"""DistributedOptimizer: a ``torch.optim.Optimizer`` wrapper whose
``step()`` averages gradients across ranks first (the surface of
``horovod_tpu/torch/__init__.py``'s ``DistributedOptimizer``, with the
error feedback of ``horovod_tpu/optim/distributed.py``).

Gradients are allreduced synchronously in ``synchronize()`` (which ``step()``
calls) and stay on the device. The async per-parameter hooks of the
reference arrive with the eager engine in a later slice.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Tuple

import torch

from .. import basics
from ..basics import Adasum, Average
from ..ops import collective_ops as ops
from ..ops.compression import Compression


def _named(optimizer, named_parameters) -> List[Tuple[str, torch.Tensor]]:
    if named_parameters is not None:
        named = list(named_parameters)
    else:
        named = [(f"param.{i}.{j}", p)
                 for i, g in enumerate(optimizer.param_groups)
                 for j, p in enumerate(g["params"])]
    counts = collections.Counter(n for n, _ in named)
    dups = sorted(n for n, c in counts.items() if c > 1)
    if dups:
        raise ValueError(f"duplicate parameter names: {dups} "
                         "(named_parameters must be unique)")
    return named


class _DistributedOptimizer:
    """See :func:`DistributedOptimizer`."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1, op: int = Average,
                 error_feedback: bool = False):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self.backward_passes_per_step = backward_passes_per_step
        self._error_feedback = error_feedback
        self._ef_residual: Dict[str, torch.Tensor] = {}
        self._named = _named(optimizer, named_parameters)
        self._should_sync = True

    def _apply_error_feedback(self, name: str, grad: torch.Tensor):
        """corrected = grad + residual; the new residual is the part of
        ``corrected`` the lossy wire drops this step."""
        res = self._ef_residual.get(name)
        corrected = grad if res is None else grad + res
        self._ef_residual[name] = corrected - self._compression.roundtrip(
            corrected)
        return corrected

    def synchronize(self) -> None:
        """Error feedback (if on), then the allreduce of every gradient,
        written back into ``.grad``. At world size 1 the allreduce is
        skipped, as in the reference; error feedback still runs."""
        world = basics.size()
        with torch.no_grad():
            for name, p in self._named:
                if p.grad is None:
                    continue
                g = p.grad
                if self._error_feedback:
                    g = self._apply_error_feedback(name, g)
                if world > 1:
                    g = ops.allreduce(g, op=self._op, name=f"grad.{name}",
                                      compression=self._compression)
                if g is not p.grad:
                    p.grad.copy_(g)

    @contextlib.contextmanager
    def skip_synchronize(self):
        """Use after a manual ``synchronize()`` (e.g. for gradient clipping)
        so ``step()`` does not reduce again."""
        self._should_sync = False
        try:
            yield
        finally:
            self._should_sync = True

    def step(self, closure=None):
        if self._should_sync:
            self.synchronize()
        return self._opt.step(closure)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: int = Average, error_feedback: bool = False):
    """Wrap ``optimizer`` so that ``step()`` first averages (``op=Average``)
    or sums (``op=Sum``) every gradient across ranks.

    ``compression``: ``Compression.none/fp16/bf16/int8/int4``.
    ``error_feedback=True`` (for a lossy compression): each step sends
    ``grad + residual`` and keeps as the new residual what the wire dropped,
    ``corrected - compression.roundtrip(corrected)``; the residual is
    rank-local and stays on the device. ``backward_passes_per_step``: the
    number of backward passes accumulated into ``.grad`` per step (the raw
    accumulated sum goes on the wire, as in the reference).
    """
    if op == Adasum:
        raise NotImplementedError(
            "op=Adasum (the delta-flow optimizer) is not ported yet")
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, op, error_feedback)
