"""DistributedOptimizer: a ``torch.optim.Optimizer`` wrapper whose
``step()`` averages gradients across ranks first (the surface of
``horovod_tpu/torch/__init__.py``'s ``DistributedOptimizer``, with the
error feedback of ``horovod_tpu/optim/distributed.py``), or, with
``op=Adasum``, combines the local updates (the delta flow of the same
file's ``_DistributedAdasumOptimizer``).

Gradients are allreduced synchronously in ``synchronize()`` (which ``step()``
calls) and stay on the device. The async per-parameter allreduce hooks of
the reference arrive with the eager engine in a later slice.
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

    def _apply_error_feedback(self, names, grads) -> List[torch.Tensor]:
        """corrected = grad + residual for each named gradient; the new
        residual is the part of ``corrected`` the lossy wire drops this
        step, measured for every leaf in one ``roundtrip_many`` call."""
        corrected = []
        for name, g in zip(names, grads):
            res = self._ef_residual.get(name)
            corrected.append(g if res is None else g + res)
        sent = self._compression.roundtrip_many(corrected)
        for name, c, y in zip(names, corrected, sent):
            self._ef_residual[name] = c - y
        return corrected

    def synchronize(self) -> None:
        """Error feedback (if on), then the allreduce of every gradient,
        written back into ``.grad``. At world size 1 the allreduce is
        skipped, as in the reference; error feedback still runs. Error
        feedback corrects every gradient first, then measures what the
        wire drops from all of them in one ``roundtrip_many`` call (one
        grouped quantize and one dequantize on the int8 wire).

        Above world size 1 every parameter that requires a gradient takes
        part, in ``named_parameters`` order, with zeros where its ``.grad``
        is None (a parameter this rank's loss left unused), and gets the
        result as its ``.grad``: ranks that leave different parameters
        unused still reduce the same tensors together, and the replicas
        stay equal. The ranks' tensors are checked against each other in
        one gather first."""
        if basics.size() == 1:
            if self._error_feedback:
                with torch.no_grad():
                    named = [(n, p) for n, p in self._named
                             if p.grad is not None]
                    corrected = self._apply_error_feedback(
                        [n for n, _ in named], [p.grad for _, p in named])
                    for (_, p), c in zip(named, corrected):
                        p.grad.copy_(c)
            return
        comp = self._compression
        wire = comp.wire
        with torch.no_grad():
            named = [(n, p) for n, p in self._named if p.requires_grad]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for _, p in named]
            if self._error_feedback:
                grads = self._apply_error_feedback([n for n, _ in named],
                                                   grads)
            todo = [(name, p, *comp.compress(g))
                    for (name, p), g in zip(named, grads)]
            ops.check_signatures([
                ops.signature("allreduce", c, f"grad.{name}", self._op,
                              wire=wire) for name, _, c, _ in todo])
            for name, p, c, ctx in todo:
                g = comp.decompress(ops.allreduce_unchecked(c, self._op, wire),
                                    ctx)
                if p.grad is None:
                    p.grad = g.to(p.dtype)
                else:
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


class _DistributedAdasumOptimizer:
    """Delta-flow Adasum: once a parameter's gradient has accumulated
    ``backward_passes_per_step`` times, a hook runs the inner optimizer on
    that parameter alone, keeps the local update ``delta = p_after -
    p_before`` (compressed) and restores ``p``; ``step()`` combines every
    delta across ranks with ``op=Adasum`` and adds the result to ``p``.
    The inner optimizer's state (momentum, ...) advances from the local
    step and stays rank-local.

    The hooks compute only; every allreduce runs in ``step()``, in
    ``named_parameters`` order, so ranks whose backward fires hooks in
    another order, or whose loss leaves a parameter unused, still run the
    same collectives in the same order.
    """

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        self._opt = optimizer
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._named = _named(optimizer, named_parameters)
        self._counts: Dict[str, int] = {}
        self._deltas: Dict[str, tuple] = {}
        for name, p in self._named:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._hook(name))

    def _hook(self, name: str):
        def hook(p):
            self._counts[name] = self._counts.get(name, 0) + 1
            if self._counts[name] == self.backward_passes_per_step:
                self._counts[name] = 0
                self._local_delta(name, p)
        return hook

    def _local_delta(self, name: str, p: torch.Tensor) -> None:
        """Run the inner optimizer on ``p`` alone (the other parameters are
        hidden from its groups for the call), keep the compressed delta and
        restore ``p``."""
        start = p.detach().clone()
        groups = self._opt.param_groups
        stash = [g["params"] for g in groups]
        try:
            for g in groups:
                g["params"] = [v for v in g["params"] if v is p]
            self._opt.step()
        finally:
            for g, params in zip(groups, stash):
                g["params"] = params
        with torch.no_grad():
            delta = p.detach() - start
            p.copy_(start)
        self._deltas[name] = self._compression.compress(delta)

    def synchronize(self) -> None:
        """A no-op: the deltas are combined in ``step()``."""

    def skip_synchronize(self):
        raise AssertionError("Skipping synchronization is not supported "
                             "when using Adasum optimizer.")

    def step(self, closure=None):
        """Compute the delta of every hooked parameter that has none yet
        (zero when it has no gradient), Adasum-combine every delta across
        ranks and apply it."""
        loss = closure() if closure is not None else None
        for name, p in self._named:
            if p.requires_grad and name not in self._deltas:
                self._counts[name] = 0
                self._local_delta(name, p)
        todo = [(name, p, *self._deltas.pop(name)) for name, p in self._named
                if name in self._deltas]
        ops.check_signatures([ops.signature("adasum", comp, f"adasum.{name}",
                                            Adasum)
                              for name, _, comp, _ in todo])
        with torch.no_grad():
            for name, p, comp, ctx in todo:
                combined = ops.allreduce_unchecked(comp, Adasum)
                p.add_(self._compression.decompress(combined, ctx).to(p.dtype))
        return loss

    def zero_grad(self, *args, **kwargs):
        if self._deltas:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step()")
        return self._opt.zero_grad(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: int = Average, error_feedback: bool = False):
    """Wrap ``optimizer`` so that ``step()`` first averages (``op=Average``)
    or sums (``op=Sum``) every gradient across ranks, or, with
    ``op=Adasum`` at a world size above 1, so that it combines the local
    updates across ranks (the delta flow; a power-of-2 world). At world
    size 1 ``op=Adasum`` is the plain inner step.

    ``compression``: ``Compression.none/fp16/bf16/int8/int4``; under Adasum
    the fp16/bf16 casts compose and int8/int4 ride the exact wire.
    ``error_feedback=True`` (for a lossy compression, not with Adasum): each
    step sends ``grad + residual`` and keeps as the new residual what the
    wire dropped, ``corrected - compression.roundtrip(corrected)``; the
    residual is rank-local and stays on the device.
    ``backward_passes_per_step``: the number of backward passes accumulated
    into ``.grad`` per step (the raw accumulated sum goes on the wire, as in
    the reference); under Adasum, the number after which a parameter's
    local update is taken.
    """
    if op == Adasum and error_feedback:
        raise ValueError(
            "error_feedback is not supported with op=Adasum (the "
            "delta-flow optimizer communicates updates, not gradients)")
    if op == Adasum and basics.size() > 1:
        return _DistributedAdasumOptimizer(optimizer, named_parameters,
                                           compression,
                                           backward_passes_per_step)
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, op, error_feedback)
