"""Sequence-parallel (and data-parallel) LM training over a (dp, sp) grid of
processes (counterpart of ``horovod_tpu/parallel/sp_training.py``), and the
training step that the tensor-parallel and 3D grids share.

* The grid: rank ``r`` sits at ``(dp, sp) = divmod(r, sp)``, so the sp
  ranks of a dp row are consecutive; the batch is sharded over dp, the
  sequence over sp, and every rank holds the whole model and optimizer.
* The model's attention is ring attention over the sp group
  (``ring_attention.py``: kernel K6 a hop forward, K7 a hop backward).
* Each rank's loss is the mean over its own tokens; the step averages the
  gradients over the mesh's gradient group, every rank here (the
  reference's ``pmean`` over (dp, sp)). With equal shards that is the
  gradient of the global mean loss. Under tensor parallelism the group is
  the ranks that hold the same tensor shard (``tensor.py``, ``hybrid.py``).

The parameters live in the ``nn.Module``, as PyTorch keeps them, where the
reference passes a parameter tree through pure functions::

    mesh = make_dp_sp_mesh(dp=2, sp=4)              # at world size 8
    model = sp_model(TransformerLM, mesh, vocab_size=V, ...).to(device)
    replicate_to_mesh(model)
    step = make_sp_train_step(model, torch.optim.AdamW(...), mesh)
    loss = step(tokens, targets)     # the GLOBAL [B, T] batch on every rank
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import torch

from .. import basics
from ..models.transformer import lm_loss
from ..optim.broadcast import broadcast_parameters
from ..optim.distributed import _bucket_bytes, partition_buckets
from ._comm import _exchange, axis, gather_blocks
from .ring_attention import ring_attention


def grid(shape, axis_sets):
    """This rank's coordinates on the row-major grid ``shape`` over every
    rank, and for each tuple of axes in ``axis_sets`` the process group of
    the ranks that share this rank's coordinates on the other axes (None at
    world size 1). Every rank requests every group, in the same order; a
    group is made once a process (``basics.process_group``), so a grid built
    again reuses it. Raises ``ValueError`` unless the grid spans the world."""
    world = basics.size()
    if math.prod(shape) != world:
        raise ValueError(f"need {math.prod(shape)} devices, have {world} "
                         f"(one rank a device)")

    def coords(r):
        out = []
        for n in reversed(shape):
            r, c = divmod(r, n)
            out.append(c)
        return tuple(reversed(out))

    mine = coords(basics.rank())
    if world == 1:
        return mine, [None] * len(axis_sets)
    groups = []
    for axes in axis_sets:
        members = {}
        for r in range(world):
            c = coords(r)
            key = tuple(v for i, v in enumerate(c) if i not in axes)
            members.setdefault(key, []).append(r)
        own = tuple(v for i, v in enumerate(mine) if i not in axes)
        made = {key: basics.process_group(ranks)
                for key, ranks in members.items()}
        groups.append(made[own])
    return mine, groups


@dataclass(frozen=True)
class DpSpMesh:
    """This rank's place on the (dp, sp) grid and the groups of its two
    axes (None at world size 1)."""
    dp: int
    sp: int
    dp_rank: int
    sp_rank: int
    dp_group: Any
    sp_group: Any

    @property
    def grad_group(self):
        """Every rank holds the whole model: gradients average over all."""
        return None


def make_dp_sp_mesh(dp: int, sp: int) -> DpSpMesh:
    """The (dp, sp) grid over every rank, row-major (see :func:`grid`).
    Raises ``ValueError`` unless ``dp * sp`` is the world size."""
    (dp_rank, sp_rank), (sp_group, dp_group) = grid((dp, sp), [(1,), (0,)])
    return DpSpMesh(dp, sp, dp_rank, sp_rank, dp_group, sp_group)


def sp_model(model_cls, mesh: DpSpMesh, **kwargs):
    """``model_cls(attn_fn=<causal ring attention over mesh's sp group>,
    **kwargs)``, e.g. a ``TransformerLM``."""
    return model_cls(attn_fn=partial(ring_attention, group=mesh.sp_group,
                                     causal=True), **kwargs)


def _check_global_seq_len(model, t_local: int, mesh: DpSpMesh) -> None:
    """The model checks only its local block against ``max_seq_len``, and
    only the last sp rank's block can overrun it: the others would wait in
    the ring. So every rank checks the global length here, before the
    first collective."""
    max_len = getattr(model, "max_seq_len", None)
    if max_len is not None and mesh.sp * t_local > max_len:
        raise ValueError(f"global sequence length {mesh.sp * t_local} "
                         f"({mesh.sp} sp shards x {t_local}) exceeds model "
                         f"max_seq_len={max_len}")


def _local_block(x, mesh: DpSpMesh, device) -> torch.Tensor:
    """This rank's (dp, sp) block of a global [B, T] batch."""
    x = torch.as_tensor(x)
    b, t = x.shape[:2]
    if b % mesh.dp or t % mesh.sp:
        raise ValueError(f"global batch {list(x.shape[:2])} does not split "
                         f"into a dp={mesh.dp} x sp={mesh.sp} grid")
    bl, tl = b // mesh.dp, t // mesh.sp
    return x[mesh.dp_rank * bl:(mesh.dp_rank + 1) * bl,
             mesh.sp_rank * tl:(mesh.sp_rank + 1) * tl].to(device)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _group_mean(t: torch.Tensor, group) -> torch.Tensor:
    """Mean of ``t`` over ``group`` (None: every rank), in ``t``'s dtype."""
    return _exchange("all_reduce", t, group) / axis(group)[0]


def mean_gradients(params, group) -> None:
    """Set each parameter's ``.grad`` to its mean over ``group`` (zeros
    where it is None: a parameter this rank left unused). One all-reduce a
    tensor, or under ``HOROVOD_BUCKET_MB`` one flat all-reduce a bucket of
    :func:`partition_buckets` (a dtype change closes a bucket)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    bucket_bytes = _bucket_bytes()
    if not bucket_bytes:
        for p, g in zip(params, grads):
            p.grad = _group_mean(g, group)
        return
    for bucket in partition_buckets([g.numel() * g.element_size()
                                     for g in grads],
                                    [g.dtype for g in grads], bucket_bytes):
        mean = _group_mean(torch.cat([grads[i].reshape(-1) for i in bucket]),
                           group)
        off = 0
        for i in bucket:
            n = grads[i].numel()
            params[i].grad = mean[off:off + n].reshape(grads[i].shape)
            off += n


def make_sp_train_step(model, optimizer, mesh):
    """``step(tokens, targets) -> loss``: one training step on the GLOBAL
    ``[B, T]`` batch (the same on every rank; shift the targets before
    sharding, so that they are right across block edges). The step takes
    this rank's block, runs ``lm_loss`` on it at position ``sp_rank * T /
    sp``, averages every gradient over ``mesh.grad_group``
    (:func:`mean_gradients`), steps
    ``optimizer`` and returns the loss averaged over that group.

    The tensor-parallel and 3D steps are this one on their meshes
    (``tensor.py``, ``hybrid.py``): a mesh gives ``dp``, ``dp_rank``,
    ``sp``, ``sp_rank`` and ``grad_group``."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(tokens, targets):
        dev = _device_of(model)
        tok = _local_block(tokens, mesh, dev)
        tgt = _local_block(targets, mesh, dev)
        _check_global_seq_len(model, tok.shape[1], mesh)
        optimizer.zero_grad()
        loss = lm_loss(model(tok, pos_offset=mesh.sp_rank * tok.shape[1]),
                       tgt)
        loss.backward()
        mean_gradients(params, mesh.grad_group)
        optimizer.step()
        return _group_mean(loss.detach(), mesh.grad_group)

    return step


def make_sp_forward(model, mesh: DpSpMesh):
    """``forward(tokens) -> logits``: the GLOBAL ``[B, T]`` tokens in, the
    global ``[B, T, vocab]`` logits out on every rank (no gradients)."""
    def forward(tokens):
        tok = _local_block(tokens, mesh, _device_of(model))
        _check_global_seq_len(model, tok.shape[1], mesh)
        with torch.no_grad():
            logits = model(tok, pos_offset=mesh.sp_rank * tok.shape[1])
            return gather_blocks(gather_blocks(logits, mesh.sp_group, 1),
                                 mesh.dp_group, 0)

    return forward


def replicate_to_mesh(model):
    """Rank 0's parameters and buffers on every rank, so on every rank of
    the mesh, which spans them all (in place); returns ``model``."""
    broadcast_parameters(model.state_dict(), root_rank=0)
    return model
