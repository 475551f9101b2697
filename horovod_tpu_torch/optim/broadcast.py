"""Parameter and optimizer-state broadcast (counterpart of
``broadcast_parameters`` / ``broadcast_optimizer_state`` in
``horovod_tpu/torch/__init__.py``). Both write in place."""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import basics
from ..ops.collective_ops import broadcast


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Broadcast a ``state_dict()`` or an iterable of ``(name, tensor)``
    from ``root_rank`` into every rank's tensors, in place."""
    items = sorted(params.items()) if isinstance(params, dict) else list(params)
    with torch.no_grad():
        for name, p in items:
            if p is None:
                continue
            t = p.data if hasattr(p, "data") else p
            t.copy_(broadcast(t, root_rank, name=f"bp.{name}"))


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
    scalars = []
    for pid, pstate in state_dict.get("state", {}).items():
        for k, v in sorted(pstate.items()):
            if torch.is_tensor(v):
                with torch.no_grad():
                    v.copy_(broadcast(v, root_rank, name=f"opt.{pid}.{k}"))
            else:
                scalars.append((pid, k, v))
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
