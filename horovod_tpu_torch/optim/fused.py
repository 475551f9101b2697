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
    advance."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, mu_dtype=None):
        if mu_dtype not in _MU_DTYPES:
            raise ValueError(f"mu_dtype {mu_dtype!r}: expected None, 'bf16', "
                             "'f32', torch.bfloat16 or torch.float32")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      mu_dtype=_MU_DTYPES[mu_dtype]))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
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
                mu_dtype=None) -> FusedAdamW:
    """The reference's ``fused_adamw(learning_rate, b1, b2, eps,
    weight_decay, mu_dtype)`` over ``params``."""
    return FusedAdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                      weight_decay=weight_decay, mu_dtype=mu_dtype)
