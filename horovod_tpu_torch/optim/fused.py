"""Fused AdamW (counterpart of ``horovod_tpu/optim/fused.py``): the whole
moment and parameter update of every leaf in one pass, the K9 kernel of
``csrc/adamw.cu``.

A ``torch.optim.Optimizer``, so ``DistributedOptimizer`` wraps it like any
other. The reference's numerics:

* the step's scalars ``[lr, 1/(1-b1^t), 1/(1-b2^t)]`` in f32, with ``t``
  the count after this step and an lr schedule (a callable) evaluated at
  the count before it, as optax indexes schedules;
* decoupled weight decay on every leaf;
* ``nu`` always f32, ``mu`` in ``mu_dtype`` (default: the parameter's).

The reference sends leaves under 65536 elements to a jnp formula because
of the TPU's custom-call cost; here every leaf on the card goes through the
kernel, in one launch per (p dtype, mu dtype) group. Parameters, ``mu`` and
``nu`` are updated in place.

``capturable=True`` makes the step a CUDA graph may capture: the step's
scalars ride in a device buffer per parameter group, which the kernel reads
when it runs. Outside a capture ``step()`` writes them there itself; a
captured step leaves that, and advancing the counts, to
:meth:`FusedAdamW.prepare_replay`, called before each replay
(``spmd.make_train_step`` does). The values, and so the bits, are those of
the host-scalar step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_kernels as ck

_MU_DTYPES = {None: None, "bf16": torch.bfloat16, "f32": torch.float32,
              torch.bfloat16: torch.bfloat16, torch.float32: torch.float32}


def adamw_scalars(count: int, learning_rate, b1: float, b2: float):
    """``(lr, 1/(1-b1^t), 1/(1-b2^t))`` as f32 values for the step taken at
    ``count`` (``t = count + 1``); a callable ``learning_rate`` is evaluated
    at ``count``."""
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    t = np.float32(count + 1)
    one = np.float32(1.0)
    ibc1 = one / (one - np.float32(b1) ** t)
    ibc2 = one / (one - np.float32(b2) ** t)
    return float(np.float32(lr)), float(ibc1), float(ibc2)


class FusedAdamW(torch.optim.Optimizer):
    """AdamW with the update of every leaf in one fused pass.

    ``lr`` may be a float or a schedule (a callable of the step count).
    ``mu_dtype``: ``None`` (the parameter's dtype), ``"bf16"`` / ``"f32"``
    or a torch dtype. State per parameter: ``count``, ``mu``, ``nu``.
    Parameters without a gradient are skipped and their count does not
    advance. ``capturable``: see the module's docstring."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, mu_dtype=None, capturable=False):
        if mu_dtype not in _MU_DTYPES:
            raise ValueError(f"mu_dtype {mu_dtype!r}: expected None, 'bf16', "
                             "'f32', torch.bfloat16 or torch.float32")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      mu_dtype=_MU_DTYPES[mu_dtype],
                                      capturable=capturable))
        self._scalars = {}   # group index -> device f32 [lr, ibc1, ibc2]
        self._captured = {}  # group index -> the parameters a capture took

    def _stage(self, index: int, count: int, device) -> torch.Tensor:
        """Group ``index``'s scalars for the step taken at ``count``,
        written to its device buffer (asynchronously on the card, from
        pinned memory); returns the buffer."""
        group = self.param_groups[index]
        buf = self._scalars.get(index)
        if buf is None or buf.device != device:
            buf = torch.zeros(3, dtype=torch.float32, device=device)
            self._scalars[index] = buf
        vals = torch.tensor(adamw_scalars(count, group["lr"],
                                          *group["betas"]),
                            dtype=torch.float32)
        if device.type == "cuda":
            vals = vals.pin_memory()
        buf.copy_(vals, non_blocking=True)
        return buf

    def prepare_replay(self) -> None:
        """Before a replay of a captured step: stage each captured group's
        scalars for its parameters' count, then advance the count, as an
        eager step does."""
        for index, ps in self._captured.items():
            count = self.state[ps[0]]["count"]
            self._stage(index, count, ps[0].device)
            for p in ps:
                self.state[p]["count"] = count + 1

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for index, group in enumerate(self.param_groups):
            b1, b2 = group["betas"]
            by_count = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    st["mu"] = torch.zeros_like(
                        p, dtype=group["mu_dtype"] or p.dtype,
                        memory_format=torch.contiguous_format)
                    st["nu"] = torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.contiguous_format)
                by_count.setdefault(st["count"], []).append(p)
            if group.get("capturable"):
                self._capturable_step(index, group, by_count)
                continue
            for count, ps in by_count.items():
                lr, ibc1, ibc2 = adamw_scalars(count, group["lr"], b1, b2)
                ck.adamw_update(
                    ps, [p.grad.contiguous() for p in ps],
                    [self.state[p]["mu"] for p in ps],
                    [self.state[p]["nu"] for p in ps], lr=lr, ibc1=ibc1,
                    ibc2=ibc2, b1=b1, b2=b2, eps=group["eps"],
                    weight_decay=group["weight_decay"])
                for p in ps:
                    self.state[p]["count"] = count + 1
        return loss

    def _capturable_step(self, index: int, group, by_count) -> None:
        """One group's step from its device scalars. Under a capture the
        host does nothing else (:meth:`prepare_replay` stages and counts
        before each replay); outside one it stages and counts here."""
        if len(by_count) > 1:
            raise ValueError(
                f"FusedAdamW(capturable=True): the parameters of group "
                f"{index} are at different step counts {sorted(by_count)}")
        for count, ps in by_count.items():
            dev = ps[0].device
            capturing = (dev.type == "cuda"
                         and torch.cuda.is_current_stream_capturing())
            if capturing:
                buf = self._scalars.get(index)
                if buf is None:
                    raise RuntimeError(
                        "FusedAdamW(capturable=True): take one step before "
                        "a capture (its scalar buffer is made then)")
                self._captured[index] = ps
            else:
                buf = self._stage(index, count, dev)
            b1, b2 = group["betas"]
            ck.adamw_update(
                ps, [p.grad.contiguous() for p in ps],
                [self.state[p]["mu"] for p in ps],
                [self.state[p]["nu"] for p in ps], scalars=buf, b1=b1,
                b2=b2, eps=group["eps"], weight_decay=group["weight_decay"])
            if not capturing:
                for p in ps:
                    self.state[p]["count"] = count + 1

    def load_state_dict(self, state_dict) -> None:
        """As ``torch.optim.Optimizer.load_state_dict``, which casts floating
        state to its parameter's dtype: mu gets its ``mu_dtype`` back and nu
        f32 (both casts exact)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if st:
                    st["mu"] = st["mu"].to(group["mu_dtype"] or p.dtype)
                    st["nu"] = st["nu"].to(torch.float32)


def fused_adamw(params, learning_rate, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0,
                mu_dtype=None, capturable: bool = False) -> FusedAdamW:
    """The reference's ``fused_adamw(learning_rate, b1, b2, eps,
    weight_decay, mu_dtype)`` over ``params``."""
    return FusedAdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                      weight_decay=weight_decay, mu_dtype=mu_dtype,
                      capturable=capturable)
