"""Two-level (hierarchical) collectives over process groups (a port of
``horovod_tpu/parallel/hierarchical.py``): the ranks of one host form a
row (the reference's ``"ici"`` axis), the ranks of one place on every host a
column (``"dcn"``), and an allreduce is a reduce-scatter within the row, an
allreduce within the column and an all-gather within the row, the
NCCLHierarchicalAllreduce decomposition. Ranks are host-major: rank =
host * ranks_per_host + local rank.

A sum over a group adds the members' parts in rank order, in the tensor's
dtype, or in f32 rounded once for bf16 and f16 (XLA's reduction of a bf16
collective on the CPU, which the reference's programs run). The engine's
two-level program (``runtime/executor.py``) runs :func:`two_level_sum` over
groups of its own, made at ``init``.

Left out: ``stack_contributions``, which places per-device host arrays on a
JAX mesh as the input of the reference's jitted allreduce. Here each
process holds its own contribution, so there is nothing to place.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch

from .. import basics
from ..runtime.executor import _collective


class TwoLevelMesh:
    """The host rows (global ranks, host-major) and this rank's two groups:
    ``host_group`` (its row) and ``cross_group`` (its column). ``shape`` is
    ``{"dcn": hosts, "ici": ranks a host}``, as the reference's mesh."""

    def __init__(self, rows: List[List[int]], host_group, cross_group):
        self.rows = rows
        self.host_group = host_group
        self.cross_group = cross_group

    @property
    def ici(self) -> int:
        return len(self.rows[0])

    @property
    def dcn(self) -> int:
        return len(self.rows)

    @property
    def shape(self) -> dict:
        return {"dcn": self.dcn, "ici": self.ici}

    @property
    def ranks(self) -> List[int]:
        """Every rank in mesh order (the rank order)."""
        return [r for row in self.rows for r in row]


def build_two_level_mesh(world: int, rank: int, ici: int,
                         new_group: Optional[Callable]) -> TwoLevelMesh:
    """The mesh of ``world`` ranks in rows of ``ici``. ``new_group(ranks)``
    makes a process group; every rank must call this with the same
    arguments, as it makes every row's group, then every column's, in one
    order. ``new_group=None`` (one process) makes none."""
    if ici < 1 or world % ici:
        raise ValueError(f"world size {world} is not divisible by "
                         f"ici_size={ici}")
    hosts = world // ici
    rows = [[h * ici + j for j in range(ici)] for h in range(hosts)]
    cols = [[h * ici + j for h in range(hosts)] for j in range(ici)]
    if new_group is None:
        return TwoLevelMesh(rows, None, None)
    row_groups = [new_group(r) for r in rows]
    col_groups = [new_group(c) for c in cols]
    return TwoLevelMesh(rows, row_groups[rank // ici],
                        col_groups[rank % ici])


def make_two_level_mesh(ici_size: Optional[int] = None) -> TwoLevelMesh:
    """The two-level mesh of the job, in rows of ``ici_size`` ranks (the
    local size by default). Every rank calls it; its groups are made once a
    process (``basics.process_group``), so calling it again is cheap."""
    st = basics._require_init()
    ici = st.local_size if ici_size is None else int(ici_size)
    return build_two_level_mesh(
        st.size, st.rank, ici,
        basics.process_group if st.mode == "multiprocess" else None)


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` over dim 0, in that order: in the
    parts' dtype, or for bf16 / f16 in f32, rounded once at the end."""
    acc_dtype = (torch.float32 if parts.dtype in (torch.bfloat16,
                                                  torch.float16)
                 else parts.dtype)
    acc = parts[0].to(acc_dtype)
    for j in range(1, parts.shape[0]):
        acc = acc + parts[j].to(acc_dtype)
    return acc.to(parts.dtype)


def reduce_scatter_sum(x: torch.Tensor, group, n: int,
                       backend: Optional[str]) -> torch.Tensor:
    """Member i of ``group`` (``n`` members) gets the sum of every member's
    i-th of ``n`` dim-0 chunks of ``x``: an all-to-all of the chunks, then
    :func:`ordered_sum`."""
    if n == 1:
        return x
    parts = _collective("all_to_all", x, backend, n, group=group)
    return ordered_sum(parts.reshape((n, -1) + tuple(x.shape[1:])))


def allreduce_sum(x: torch.Tensor, group, n: int,
                  backend: Optional[str]) -> torch.Tensor:
    """The sum of ``x`` over ``group``: an all-gather, then
    :func:`ordered_sum`."""
    if n == 1:
        return x
    parts = _collective("all_gather", x.unsqueeze(0), backend, n,
                        group=group)
    return ordered_sum(parts)


def two_level_sum(x: torch.Tensor, mesh: TwoLevelMesh,
                  backend: Optional[str]) -> torch.Tensor:
    """The sum of ``x`` over every rank: reduce-scatter within the host,
    allreduce across hosts, all-gather within the host. Dim 0 is padded
    with zeros to a multiple of the ranks a host, and cut back."""
    ici = mesh.ici
    d0 = x.shape[0]
    pad = (-d0) % ici
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    scattered = reduce_scatter_sum(x, mesh.host_group, ici, backend)
    reduced = allreduce_sum(scattered, mesh.cross_group, mesh.dcn, backend)
    out = (reduced if ici == 1 else
           _collective("all_gather", reduced, backend, ici,
                       group=mesh.host_group))
    return out[:d0] if pad else out


def hierarchical_allreduce(x: torch.Tensor, mesh: TwoLevelMesh,
                           average: bool = False) -> torch.Tensor:
    """Sum (or average) this rank's ``x`` over every rank of ``mesh`` by
    :func:`two_level_sum`; every rank gets the result. The average divides
    in ``x``'s dtype."""
    out = two_level_sum(x, mesh, basics.backend())
    if average:
        out = out / torch.tensor(mesh.ici * mesh.dcn, dtype=out.dtype)
    return out


def make_hierarchical_allreduce(mesh: TwoLevelMesh, average: bool = False):
    """:func:`hierarchical_allreduce` over ``mesh`` as a function of this
    rank's contribution."""
    return functools.partial(hierarchical_allreduce, mesh=mesh,
                             average=average)

