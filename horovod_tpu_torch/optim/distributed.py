"""DistributedOptimizer: a ``torch.optim.Optimizer`` wrapper whose
``step()`` averages gradients across ranks first (the surface of
``horovod_tpu/torch/__init__.py``'s ``DistributedOptimizer``, with the
error feedback and gradient buckets of ``horovod_tpu/optim/distributed.py``),
or, with ``op=Adasum``, combines the local updates (the delta flow of the
same file's ``_DistributedAdasumOptimizer``).

Above world size 1 a post-accumulate hook on every parameter that requires
a gradient counts ``backward_passes_per_step`` and, on the last pass, marks
the parameter ready. The allreduces then go to the engine as async handles
in one fixed order, the same on every rank: reverse ``named_parameters``
order (the order in which backward produces gradients, and the order of
:func:`partition_buckets`), one tensor a request, or under
``HOROVOD_BUCKET_MB`` one flat bucket a request (``fusable=False``). The
hooks enqueue the longest ready prefix of that order during backward;
``synchronize()`` (which ``step()`` calls) enqueues the rest, with zeros
where ``.grad`` is None, and drains every handle into ``.grad``. Ranks
whose backward fires hooks in another order, or leaves other parameters
unused, still pair the same tensors.

Under ``Compression.adaptive`` every reduced tensor or bucket is fed to the
bitwidth selector (``observe``) after the drain, on every rank, and error
feedback measures its residual at the most aggressive grid in use.

A sparse COO gradient (``nn.Embedding(sparse=True)``) goes on the wire as
two allgathers (``ops/sparse.py``) and comes back densified into
``.grad``, as the reference's optimizer densifies the gathered slices;
``sparse_as_dense=True`` densifies it before the allreduce instead.
Accumulation and error feedback take sparse gradients only densified.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Dict, List, Tuple

import torch

from .. import basics
from ..basics import Adasum, Average
from ..ops import collective_ops as ops
from ..ops import sparse as _sparse
from ..ops.compression import Compression


def _bucket_bytes() -> int:
    """``HOROVOD_BUCKET_MB`` resolved to bytes (0 = buckets off). Read per
    call, like every other knob."""
    v = os.environ.get("HOROVOD_BUCKET_MB", "")
    if not v:
        return 0
    try:
        return int(float(v) * 2 ** 20)
    except ValueError:
        raise ValueError(
            f"HOROVOD_BUCKET_MB={v!r}: expected a number of MiB "
            "(0 = disabled)") from None


def partition_buckets(sizes_bytes, dtypes, bucket_bytes: int):
    """Partition leaf indices into reverse-order buckets of <= bucket_bytes
    (a copy of the reference's ``partition_buckets``).

    ``sizes_bytes``/``dtypes`` are per-leaf, in tree order; the result
    walks the leaves in REVERSE tree order (the approximation of
    backward-pass production order) and closes a bucket when the byte
    budget would overflow or the dtype changes (a fused buffer is one
    typed concat). Every bucket holds at least one leaf, so oversized
    leaves ride alone. Deterministic by construction: same tree + same
    knob -> same buckets on every rank.
    """
    buckets, cur, cur_bytes = [], [], 0
    for i in reversed(range(len(sizes_bytes))):
        if cur and (dtypes[i] != dtypes[cur[-1]]
                    or cur_bytes + sizes_bytes[i] > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += sizes_bytes[i]
    if cur:
        buckets.append(cur)
    return buckets


def gradient_units(named, compression) -> Tuple[List[list], bool]:
    """The fixed order in which a step's gradients go on the wire:
    ``(units, bucketed)``, each unit a list of ``(name, param)``. Under
    ``HOROVOD_BUCKET_MB`` the units are :func:`partition_buckets`'s buckets
    of the parameters that require a gradient, sized in the wire dtype of
    ``compression``; otherwise one parameter each, in reverse order."""
    params = [(n, p) for n, p in named if p.requires_grad]
    bucket_bytes = _bucket_bytes()
    if not bucket_bytes:
        return [[np_] for np_ in reversed(params)], False
    dtypes = [compression.compress(torch.empty(0, dtype=p.dtype))[0].dtype
              for _, p in params]
    sizes = [p.numel() * dt.itemsize for (_, p), dt in zip(params, dtypes)]
    return [[params[i] for i in b]
            for b in partition_buckets(sizes, dtypes, bucket_bytes)], True


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _views(flat: torch.Tensor, like) -> list:
    """``flat`` cut into views of the shapes of ``like``, in order."""
    flat, outs, off = flat.reshape(-1), [], 0
    for t in like:
        outs.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return outs


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


class _StepOrder:
    """A step's units in their fixed order (:func:`gradient_units`, built
    at the step's first use), the first unit not enqueued yet, and the
    handles in flight."""

    def _reset_order(self) -> None:
        self._units, self._bucketed, self._next = None, False, 0
        self._handles: List[tuple] = []

    def _step_units(self) -> List[list]:
        if self._units is None:
            self._units, self._bucketed = gradient_units(self._named,
                                                         self._compression)
        return self._units


class _DistributedOptimizer(_StepOrder):
    """See :func:`DistributedOptimizer`."""

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1, op: int = Average,
                 error_feedback: bool = False,
                 sparse_as_dense: bool = False):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self.backward_passes_per_step = backward_passes_per_step
        self._error_feedback = error_feedback
        self._sparse_as_dense = sparse_as_dense
        self._ef_residual: Dict[str, torch.Tensor] = {}
        self._named = _named(optimizer, named_parameters)
        self._should_sync = True
        self._counts: Dict[str, int] = {}
        self._ready: set = set()  # hooked this step, on the last pass
        self._reset_order()
        if basics.size() > 1:
            for name, p in self._named:
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._hook(name))

    def _check_sparse(self, grads) -> None:
        """Refuse sparse gradients where the reference refuses them: under
        accumulation or error feedback, unless ``sparse_as_dense``."""
        if self._sparse_as_dense or not any(
                g is not None and g.is_sparse for g in grads):
            return
        if self.backward_passes_per_step > 1:
            raise NotImplementedError(
                "backward_passes_per_step > 1 with sparse gradient leaves "
                "requires sparse_as_dense=True")
        if self._error_feedback:
            raise NotImplementedError(
                "error_feedback with sparse gradient leaves requires "
                "sparse_as_dense=True")

    def _hook(self, name: str):
        def hook(p):
            self._check_sparse([p.grad])
            self._counts[name] = self._counts.get(name, 0) + 1
            if self._counts[name] < self.backward_passes_per_step:
                return
            self._counts[name] = 0
            self._ready.add(name)
            if not self._error_feedback:  # else synchronize() corrects first
                units = self._step_units()
                while (self._next < len(units)
                       and all(n in self._ready for n, _ in units[self._next])):
                    self._enqueue([q.grad for _, q in units[self._next]])
        return hook

    def _enqueue(self, grads) -> None:
        """Enqueue the next unit's gradients ``grads`` (compressed; a bucket
        as one flat concat). A sparse gradient goes on its own, as two
        allgathers, unless ``sparse_as_dense``. ``self._handles`` gets
        ``(handles, members, comps, name)``: comps None for a sparse one."""
        k, unit = self._next, self._units[self._next]
        self._next += 1
        dense = []
        for (n, p), g in zip(unit, grads):
            if g.is_sparse and not self._sparse_as_dense:
                pair = _sparse.allreduce_sparse_async(
                    _sparse.from_sparse_coo(g), name=f"grad.{n}")
                self._handles.append((list(pair), [(n, p)], None, None))
            else:
                dense.append(((n, p), g.to_dense() if g.is_sparse else g))
        if not dense:
            return
        with torch.no_grad():
            comps = [self._compression.compress(g) for _, g in dense]
            if self._bucketed:
                flat, name = _flat([c for c, _ in comps]), f"grad.bucket.{k}"
            else:
                flat, name = comps[0][0], f"grad.{unit[0][0]}"
        h = ops.allreduce_async(flat, name=name, op=self._op,
                                compression=self._compression,
                                fusable=not self._bucketed)
        self._handles.append(([h], [m for m, _ in dense], comps, name))

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
        feedback corrects every gradient first, then measures what the wire
        drops from all of them in one ``roundtrip_many`` call (one grouped
        quantize and one dequantize on the int8 wire), leaf by leaf as the
        reference does, whether or not the wire takes buckets.

        Above world size 1 the units the hooks have not enqueued go now, in
        the step's order, with zeros where ``.grad`` is None (a parameter
        this rank's loss left unused); then every handle is drained and
        each parameter that requires a gradient gets its result as
        ``.grad``. A refused or failed request raises once every handle has
        completed, and the next step starts clean."""
        if basics.size() == 1:
            with torch.no_grad():
                self._check_sparse([p.grad for _, p in self._named])
                for _, p in self._named:  # the reference densifies
                    if p.grad is not None and p.grad.is_sparse:
                        p.grad = p.grad.to_dense()
                if self._error_feedback:
                    named = [(n, p) for n, p in self._named
                             if p.grad is not None]
                    corrected = self._apply_error_feedback(
                        [n for n, _ in named], [p.grad for _, p in named])
                    for (_, p), c in zip(named, corrected):
                        p.grad.copy_(c)
            return
        try:
            units = self._step_units()
            with torch.no_grad():
                grads = {n: p.grad if p.grad is not None
                         else torch.zeros_like(p)
                         for unit in units[self._next:] for n, p in unit}
                self._check_sparse(grads.values())
                if self._error_feedback:
                    names = [n for n, p in self._named if n in grads]
                    grads = dict(zip(names, self._apply_error_feedback(
                        names, [grads[n].to_dense() if grads[n].is_sparse
                                else grads[n] for n in names])))
                while self._next < len(units):
                    self._enqueue([grads[n] for n, _ in units[self._next]])
            handles = self._handles
            results = ops.synchronize_all([h for hs, _, _, _ in handles
                                           for h in hs])
        finally:
            self._reset_order()
            self._ready, self._counts = set(), {}
        observe = getattr(self._compression, "observe", None)
        results = iter(results)
        with torch.no_grad():
            for _, members, comps, name in handles:
                if comps is None:  # two allgathers, densified
                    (_, p), = members
                    outs = [_sparse.to_dense(_sparse.gathered(
                        next(results), next(results), self._op,
                        tuple(p.shape)))]
                    ctxs = [None]
                else:
                    out = next(results)
                    if observe is not None:  # the reduced bucket, on
                        observe(name, out)  # every rank
                    outs = _views(out, [c for c, _ in comps])
                    ctxs = [ctx for _, ctx in comps]
                for (_, p), ctx, o in zip(members, ctxs, outs):
                    g = self._compression.decompress(o, ctx)
                    if p.grad is None or p.grad.is_sparse:
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

    def zero_grad(self, *args, **kwargs):
        if self._handles or self._ready:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize()")
        return self._opt.zero_grad(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._opt, item)


class _DistributedAdasumOptimizer(_StepOrder):
    """Delta-flow Adasum: once a parameter's gradient has accumulated
    ``backward_passes_per_step`` times, a hook runs the inner optimizer on
    that parameter alone, keeps the local update ``delta = p_after -
    p_before`` (compressed) and restores ``p``; ``step()`` combines every
    delta across ranks with ``op=Adasum`` and adds the result to ``p``.
    The inner optimizer's state (momentum, ...) advances from the local
    step and stays rank-local.

    The deltas go to the engine in the fixed order of
    :class:`_DistributedOptimizer`. One tensor a request: ``step()``
    enqueues them all in one batch (``enqueue_together``), each gathered on
    its own and every tree level of all of them combined in one kernel
    launch on the card. Under ``HOROVOD_BUCKET_MB`` a bucket of deltas is
    one flat request, gathered as one buffer and combined member by member
    with each member's own coefficients (the same bits); the hooks enqueue
    each bucket as soon as it and the buckets before it are complete, and
    ``step()`` the rest one by one (which buckets are left differs between
    ranks whose losses leave different parameters unused).
    """

    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1):
        self._opt = optimizer
        self._compression = compression
        self.backward_passes_per_step = backward_passes_per_step
        self._named = _named(optimizer, named_parameters)
        self._counts: Dict[str, int] = {}
        self._deltas: Dict[str, tuple] = {}  # computed, not yet enqueued
        self._taken: set = set()  # names whose delta this step has
        self._reset_order()
        for name, p in self._named:
            if p.requires_grad:
                p.register_post_accumulate_grad_hook(self._hook(name))

    def _hook(self, name: str):
        def hook(p):
            self._counts[name] = self._counts.get(name, 0) + 1
            if self._counts[name] == self.backward_passes_per_step:
                self._counts[name] = 0
                self._local_delta(name, p)
                self._step_units()
                if self._bucketed:
                    self._enqueue_ready()
        return hook

    def _enqueue_ready(self) -> None:
        units = self._step_units()
        while (self._next < len(units)
               and all(n in self._deltas for n, _ in units[self._next])):
            k, unit = self._next, units[self._next]
            self._next += 1
            deltas = [self._deltas.pop(n) for n, _ in unit]
            comps = [c for c, _ in deltas]
            if self._bucketed:
                h = ops.allreduce_async(
                    _flat(comps), name=f"adasum.bucket.{k}", op=Adasum,
                    fusable=False, parts=tuple(c.numel() for c in comps))
            else:
                h = ops.allreduce_async(comps[0], name=f"adasum.{unit[0][0]}",
                                        op=Adasum)
            self._handles.append((h, unit, deltas))

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
        self._taken.add(name)

    def synchronize(self) -> None:
        """A no-op: the deltas are combined in ``step()``."""

    def skip_synchronize(self):
        raise AssertionError("Skipping synchronization is not supported "
                             "when using Adasum optimizer.")

    def step(self, closure=None):
        """Compute the delta of every hooked parameter that has none yet
        (zero when it has no gradient), enqueue what the hooks have not,
        Adasum-combine every delta across ranks and apply it."""
        loss = closure() if closure is not None else None
        try:
            for name, p in self._named:
                if p.requires_grad and name not in self._taken:
                    self._counts[name] = 0
                    self._local_delta(name, p)
            if self._bucketed:  # the ranks' hooks left different buckets
                self._enqueue_ready()
            else:  # every delta: the same batch on every rank
                with ops.enqueue_together():
                    self._enqueue_ready()
            handles = self._handles
            results = ops.synchronize_all([h for h, _, _ in handles])
        finally:
            self._reset_order()
            self._deltas, self._taken = {}, set()
        with torch.no_grad():
            for (_, unit, deltas), out in zip(handles, results):
                outs = _views(out, [c for c, _ in deltas])
                for (_, p), (_, ctx), o in zip(unit, deltas, outs):
                    p.add_(self._compression.decompress(o, ctx).to(p.dtype))
        return loss

    def zero_grad(self, *args, **kwargs):
        if self._deltas or self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step()")
        return self._opt.zero_grad(*args, **kwargs)

    def __getattr__(self, item):
        return getattr(self._opt, item)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: int = Average, error_feedback: bool = False,
                         sparse_as_dense: bool = False):
    """Wrap ``optimizer`` so that ``step()`` first averages (``op=Average``)
    or sums (``op=Sum``) every gradient across ranks, or, with
    ``op=Adasum`` at a world size above 1, so that it combines the local
    updates across ranks (the delta flow; a power-of-2 world). At world
    size 1 ``op=Adasum`` is the plain inner step.

    ``compression``: ``Compression.none/fp16/bf16/int8/int8_dcn/int4/
    adaptive``; under Adasum the fp16/bf16 casts compose and the wires
    ride the exact one.
    ``error_feedback=True`` (for a lossy compression, not with Adasum): each
    step sends ``grad + residual`` and keeps as the new residual what the
    wire dropped, ``corrected - compression.roundtrip(corrected)``; the
    residual is rank-local and stays on the device.
    ``backward_passes_per_step``: the number of backward passes accumulated
    into ``.grad`` per step (the raw accumulated sum goes on the wire, as in
    the reference); under Adasum, the number after which a parameter's
    local update is taken. ``sparse_as_dense``: densify sparse gradients
    before the allreduce (else two allgathers, densified after).
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
                                 backward_passes_per_step, op, error_feedback,
                                 sparse_as_dense)
