"""Parameter and optimizer-state broadcast (counterpart of
``broadcast_parameters`` / ``broadcast_optimizer_state`` in
``horovod_tpu/torch/__init__.py``). Both write in place."""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import basics
from ..ops.collective_ops import broadcast_async_, synchronize_all


def _broadcast_all(named, root_rank: int) -> None:
    """Broadcast each ``(name, tensor)`` from ``root_rank`` in place: all
    enqueued first, then drained in order."""
    synchronize_all([broadcast_async_(t, root_rank, name=name)
                     for name, t in named])


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a ``state_dict()`` or an iterable of ``(name, tensor)``
    from ``root_rank`` into every rank's tensors, in place."""
    items = sorted(params.items()) if isinstance(params, dict) else list(params)
    if not 0 <= root_rank < basics.size():
        raise ValueError(f"broadcast: root_rank {root_rank} outside world "
                         f"size {basics.size()}")
    _broadcast_all([(f"bp.{name}", p.data if hasattr(p, "data") else p)
                    for name, p in items if p is not None], root_rank)


def broadcast_object(obj, root_rank: int = 0):
    """A picklable object from ``root_rank``, on every rank."""
    if basics.size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    return box[0]


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Broadcast optimizer state (tensors, scalar state and the
    ``param_groups`` hyperparameters) from ``root_rank``, in place.

    A rank whose optimizer has no state yet (a fresh optimizer beside a
    restored root) first takes a zero-gradient step with its parameters
    restored afterwards, so every rank holds the same set of state tensors.
    """
    if not optimizer.state_dict().get("state"):
        restore = []
        for group in optimizer.param_groups:
            for p in group["params"]:
                restore.append((p, p.grad, p.detach().clone()))
                p.grad = torch.zeros_like(p)
        optimizer.step()
        with torch.no_grad():
            for p, g, snap in restore:
                p.copy_(snap)
                p.grad = g
    state_dict = optimizer.state_dict()
    scalars, tensors = [], []
    for pid, pstate in state_dict.get("state", {}).items():
        for k, v in sorted(pstate.items()):
            if torch.is_tensor(v):
                tensors.append((f"opt.{pid}.{k}", v))
            else:
                scalars.append((pid, k, v))
    _broadcast_all(tensors, root_rank)
    hypers = [{k: v for k, v in g.items() if k != "params"}
              for g in state_dict.get("param_groups", [])]
    synced_scalars, synced_hypers = broadcast_object(
        ([v for _, _, v in scalars], hypers), root_rank)
    for (pid, k, _), new in zip(scalars, synced_scalars):
        state_dict["state"][pid][k] = new
    for group, new_hyper in zip(state_dict.get("param_groups", []),
                                synced_hypers):
        group.update(new_hyper)
    optimizer.load_state_dict(state_dict)
