"""Training-loop callbacks (counterpart of ``horovod_tpu/callbacks.py``,
the Keras callbacks of the reference's ``_keras/callbacks.py``).

Callbacks act on a mutable ``state`` dict that the training loop owns, with
hooks named as Keras names them: ``on_train_begin``, ``on_epoch_begin``,
``on_batch_end`` and ``on_epoch_end``. By convention ``state["params"]`` is
an ``nn.Module``, a ``state_dict()`` or an iterable of ``(name, tensor)``,
``state["optimizer"]`` a ``torch.optim.Optimizer`` and ``state["lr"]`` the
learning rate the loop applies to its optimizer before each step.

* :class:`BroadcastGlobalVariablesCallback` -- the parameters and optimizer
  state from a root rank, in place, at train start.
* :class:`MetricAverageCallback` -- epoch metrics averaged over the ranks.
* :class:`LearningRateScheduleCallback`, :class:`LearningRateWarmupCallback`
  -- multiplier schedules, with the reference's lr at every epoch and
  batch.

The reference's ``CommitStateCallback`` (elastic state), ``MetricsCallback``
and ``ConsistencyCheckCallback`` (metrics, integrity) wait for the port of
the modules they drive.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional

import torch

from . import basics
from .ops import collective_ops as ops
from .optim.broadcast import broadcast_optimizer_state, broadcast_parameters


class Callback:
    def on_train_begin(self, state: Dict[str, Any]) -> None: ...

    def on_epoch_begin(self, epoch: int, state: Dict[str, Any]) -> None: ...

    def on_batch_end(self, batch: int, state: Dict[str, Any]) -> None: ...

    def on_epoch_end(self, epoch: int, state: Dict[str, Any],
                     metrics: Optional[Dict[str, float]] = None) -> None: ...


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast ``state["params"]`` and, with ``broadcast_opt_state``,
    ``state["optimizer"]``'s state from ``root_rank`` at train start, in
    place (the restore-on-rank-0 pattern)."""

    def __init__(self, root_rank: int = 0, broadcast_opt_state: bool = True):
        self.root_rank = root_rank
        self.broadcast_opt_state = broadcast_opt_state

    def on_train_begin(self, state):
        params = state["params"]
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        broadcast_parameters(params, self.root_rank)
        if self.broadcast_opt_state and state.get("optimizer") is not None:
            broadcast_optimizer_state(state["optimizer"], self.root_rank)


class MetricAverageCallback(Callback):
    """Average the epoch's metrics over the ranks before they are reported:
    one allreduce (op Average, f64) a metric, named ``metric.{k}.e{epoch}``,
    in sorted key order on every rank."""

    def on_epoch_end(self, epoch, state, metrics=None):
        if not metrics or basics.size() == 1:
            return
        for k in sorted(metrics):
            t = torch.tensor([float(metrics[k])], dtype=torch.float64,
                             device=basics.device())
            avg = ops.allreduce(t, name=f"metric.{k}.e{epoch}",
                                op=basics.Average)
            metrics[k] = float(avg[0])


class LearningRateScheduleCallback(Callback):
    """``state["lr"] = base_lr * multiplier(epoch)`` within ``[start_epoch,
    end_epoch)``: at each epoch's start (``staircase``), or after each batch
    at the fractional epoch ``epoch + (batch + 1) / steps_per_epoch``. The
    steps come from the argument, ``state["steps_per_epoch"]`` or, after the
    first epoch, the batches it counted; until then the lr holds, with one
    warning. ``base_lr`` is ``initial_lr`` or the state's first lr."""

    def __init__(self, multiplier, start_epoch: int = 0,
                 end_epoch: Optional[int] = None, staircase: bool = True,
                 initial_lr: Optional[float] = None,
                 steps_per_epoch: Optional[int] = None):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.initial_lr = initial_lr
        self.steps_per_epoch = steps_per_epoch
        if not callable(multiplier):
            self._mult = lambda epoch: multiplier
        else:
            self._mult = multiplier
        self._current_epoch = 0
        self._batches_this_epoch = 0
        self._learned_steps: Optional[int] = None
        self._warned_no_steps = False

    def _in_range(self, epoch):
        return (epoch >= self.start_epoch
                and (self.end_epoch is None or epoch < self.end_epoch))

    def on_epoch_begin(self, epoch, state):
        if self._batches_this_epoch:
            self._learned_steps = self._batches_this_epoch
        self._batches_this_epoch = 0
        self._current_epoch = epoch
        base = self.initial_lr if self.initial_lr is not None else \
            state.get("base_lr", state.get("lr"))
        if base is None:
            raise ValueError("state must carry 'lr' (or pass initial_lr)")
        state.setdefault("base_lr", base)
        if self.staircase and self._in_range(epoch):
            state["lr"] = state["base_lr"] * self._mult(epoch)

    def on_batch_end(self, batch, state):
        self._batches_this_epoch += 1
        if not self.staircase and self._in_range(self._current_epoch):
            steps = (self.steps_per_epoch or state.get("steps_per_epoch")
                     or self._learned_steps)
            if not steps:
                if not self._warned_no_steps:
                    warnings.warn(
                        "smooth LR schedule has no steps_per_epoch yet "
                        "(pass it to the callback or set "
                        "state['steps_per_epoch']); lr will move at epoch "
                        "granularity until one epoch has completed")
                    self._warned_no_steps = True
                return
            frac = self._current_epoch + min(1.0, (batch + 1) / float(steps))
            state["lr"] = state["base_lr"] * self._mult(frac)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup from ``lr`` to ``lr * size()`` over ``warmup_epochs``
    (Goyal et al.'s linear scaling): ``lr * (size * p + 1 - p)`` at the
    fractional epoch's ``p = epoch / warmup_epochs``, then ``lr * size``."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 initial_lr: Optional[float] = None, verbose: bool = False,
                 steps_per_epoch: Optional[int] = None):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose
        size = basics.size() if basics.is_initialized() else 1

        def multiplier(epoch):
            if epoch >= warmup_epochs:
                return size
            p = epoch / float(warmup_epochs)
            return size * p + (1 - p)

        super().__init__(multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         initial_lr=initial_lr,
                         steps_per_epoch=steps_per_epoch)

    def on_epoch_begin(self, epoch, state):
        super().on_epoch_begin(epoch, state)
        state["lr"] = state["base_lr"] * self._mult(epoch)
        if self.verbose and epoch <= self.warmup_epochs:
            print(f"Epoch {epoch}: warmup lr = {state['lr']:.6f}")


class CallbackList:
    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def on_train_begin(self, state):
        for c in self.callbacks:
            c.on_train_begin(state)

    def on_epoch_begin(self, epoch, state):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, state)

    def on_batch_end(self, batch, state):
        for c in self.callbacks:
            c.on_batch_end(batch, state)

    def on_epoch_end(self, epoch, state, metrics=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, state, metrics)
