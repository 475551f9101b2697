"""Expert parallelism: a Switch (top-1) MoE layer over a (dp, ep) grid of
processes (counterpart of ``horovod_tpu/parallel/expert.py``).

The experts are stacked tensors ``w_in [E, d, h]`` / ``w_out [E, h, d]``;
a rank holds the ``E / ep`` experts of its place on the ep axis, the router
and everything else whole. Two dispatches:

* **exact** (the numerical reference): dense one-hot dispatch over the
  tokens of the rank's dp row. The reference lets GSPMD insert the
  collectives; here they are written (:class:`ExactDispatch`): the router
  runs on every rank over all E experts, the experts' input goes through
  ``copy_to_tp`` over the ep group, their partial outputs sum with
  ``reduce_from_tp``, then the gate multiplies. O(E·N·d) work.
* **capacity** (the Switch recipe, :class:`SwitchDispatch`): fixed
  per-expert buffers of ``ceil(CF · N / E)`` slots, a token's slot its
  place among the tokens routed to its expert (a cumulative sum), tokens
  past capacity dropped and counted. The buffers cross the ep axis by
  ``spmd.quantized_all_to_all``, whose int8 / int4 wire
  (``HOROVOD_MOE_WIRE``) packs the payload with #3 / #4 and banks an
  error-feedback residual a direction. The router, the gates and the
  gradients stay exact.

Design differences from the reference, which the port's idiom sets: a
process group stands for a mesh axis; parameters are dicts of this rank's
tensors, updated in place by a torch optimizer; ``loss_fn(params, batch,
moe)`` takes the dispatch object for both dispatches (the reference's
exact ``loss_fn`` calls ``dense_moe_apply`` and lets GSPMD shard it); the
capacity dispatch scatters tokens into their slots and gathers them back
by index, which gives the bits of the reference's one-hot einsums without
their ``[N, E, C]`` mask; the step keeps a plain per-process record
(:func:`moe_record`) where the reference feeds its metric instruments.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import spmd
from ..ops import adaptive
from ..ops import compression as comp
from ._comm import _exchange, axis, copy_to_tp, reduce_from_tp
from .sp_training import grid, mean_gradients

INIT_STD = 0.02


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu / Flax's nn.gelu


class MoEMLP(nn.Module):
    """Top-1 routed MLP with the Switch balance loss: ``x [b, t, d] -> (y,
    aux)``; add ``aux_weight * aux`` to the loss (``E * sum_e f_e p_e``, f
    the share of tokens routed to e, p the mean router probability).

    ``router`` is an ``nn.Linear(d, E)`` in f32 (weight ``[E, d]``: the
    transpose of Flax's kernel; lecun-normal, zero bias, as Flax's Dense);
    ``w_in`` / ``w_out`` are drawn from normal(0.02), all from a CPU
    generator seeded by ``seed``."""

    def __init__(self, d_model: int, num_experts: int, hidden_mult: int = 4,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        e, h = num_experts, hidden_mult * d_model
        self.num_experts, self.dtype = e, dtype
        self.router = nn.Linear(d_model, e)
        self.w_in = nn.Parameter(torch.empty(e, d_model, h))
        self.w_out = nn.Parameter(torch.empty(e, h, d_model))
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            # lecun_normal: truncated at 2 sigma, its std corrected for it
            std = math.sqrt(1.0 / d_model) / 0.87962566103423978
            nn.init.trunc_normal_(self.router.weight, 0.0, std, -2 * std,
                                  2 * std, generator=gen)
            self.router.bias.zero_()
            self.w_in.normal_(0.0, INIT_STD, generator=gen)
            self.w_out.normal_(0.0, INIT_STD, generator=gen)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, d = x.shape
        params = {"router": {"kernel": self.router.weight.t(),
                             "bias": self.router.bias},
                  "w_in": self.w_in, "w_out": self.w_out}
        y, balance = dense_moe_apply(params, x.reshape(b * t, d),
                                     dtype=self.dtype)
        return y.reshape(b, t, d), balance


# ------------------------------------------------------------ knobs & math
_MOE_WIRES = ("int8", "int4")


def moe_wire(value: Optional[str] = None) -> str:
    """The MoE token exchange's wire (``HOROVOD_MOE_WIRE``; ``value``, the
    step's ``wire=`` argument, overrides it): ``""`` (off: the exact
    all_to_all), ``"int8"`` or ``"int4"``. int4 must pass the convergence
    gate (``ops/adaptive.admit_wire``), else it is int8."""
    v = os.environ.get("HOROVOD_MOE_WIRE", "") if value is None else value
    v = (v or "").strip().lower()
    if v in ("", "0", "off", "none"):
        return ""
    if v not in _MOE_WIRES:
        raise ValueError(f"HOROVOD_MOE_WIRE must be int8|int4|off, got {v!r}")
    return adaptive.admit_wire(v)


def expert_capacity(num_tokens: int, num_experts: int,
                    capacity_factor: float) -> int:
    """Slots an expert for ``num_tokens`` routed tokens: ``ceil(CF · N /
    E)``, at least 1 (the Switch Transformer rule)."""
    if num_tokens <= 0 or num_experts <= 0:
        raise ValueError(
            f"need positive tokens/experts, got {num_tokens}/{num_experts}")
    if capacity_factor <= 0:
        raise ValueError(f"capacity_factor must be positive, "
                         f"got {capacity_factor}")
    return max(1, int(math.ceil(capacity_factor * num_tokens / num_experts)))


def init_moe_params(seed, d: int, num_experts: int, hidden_mult: int = 4,
                    device=None) -> dict:
    """The functional parameter tree of the capacity dispatch: ``router``
    (``kernel [d, E]``, ``x @ kernel`` as in the reference, and a zero
    ``bias``) and the stacked ``w_in`` / ``w_out``, normal(0.02) from
    ``seed`` (an int or a ``torch.Generator``), f32."""
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    h = hidden_mult * d

    def normal(*shape):
        return INIT_STD * torch.randn(*shape, generator=gen)

    tree = {"router": {"kernel": normal(d, num_experts),
                       "bias": torch.zeros(num_experts)},
            "w_in": normal(num_experts, d, h),
            "w_out": normal(num_experts, h, d)}
    if device is None:
        return tree
    return tree_map_with_path(lambda _p, t: t.to(device), tree)


def _router(params, x2):
    """Exact top-1 routing in f32: ``(probs [N, E], onehot, gate [N])``.
    Routing is never quantized: a rounded router desynchronizes dispatch
    across ranks."""
    logits = x2.float() @ params["router"]["kernel"] + params["router"]["bias"]
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(probs.argmax(-1), probs.shape[-1]).to(torch.float32)
    gate = (probs * onehot).sum(-1)
    return probs, onehot, gate


def dense_moe_apply(params, x2, mesh=None,
                    dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense one-hot dispatch of ``x2 [N, d]`` on a functional tree
    (the reference the capacity dispatch is held to): ``(y [N, d],
    balance)``, the router in f32 and the experts' einsums in ``dtype``.

    With a (dp, ep) ``mesh`` (:class:`ExactDispatch`), ``params`` holds
    this rank's experts: the router and the gate run over all E, the
    experts' input goes through ``copy_to_tp`` over ep (its gradient sums
    the ep ranks' partial ones), their outputs sum with ``reduce_from_tp``,
    and the balance loss takes the dp row's means averaged over dp (the
    global batch's)."""
    e_loc = params["w_in"].shape[0]
    probs, onehot, gate = _router(params, x2)
    xin, mine = x2.to(dtype), onehot
    if mesh is not None:
        xin = copy_to_tp(xin, mesh.ep_group)
        mine = onehot[:, mesh.ep_rank * e_loc:(mesh.ep_rank + 1) * e_loc]
    xe = torch.einsum("nd,ne->end", xin, mine.to(dtype))
    he = _gelu(torch.einsum("end,edh->enh", xe, params["w_in"].to(dtype)))
    ye = torch.einsum("enh,ehd->end", he, params["w_out"].to(dtype))
    y = ye.sum(0)
    frac, mean_probs = onehot.mean(0), probs.mean(0)
    if mesh is not None:
        y = reduce_from_tp(y, mesh.ep_group)
        frac = _pmean(frac, mesh.dp_group)
        mean_probs = _pmean(mean_probs, mesh.dp_group)
    y = y * gate[:, None].to(dtype)
    balance = onehot.shape[1] * torch.sum(frac * mean_probs)
    return y.to(x2.dtype), balance.float()


def _positions(onehot):
    """Each token's place among the tokens routed to its expert, from an
    f32 cumulative sum over the tokens (the reference's, exact below
    2^24 tokens)."""
    return ((torch.cumsum(onehot, dim=0) - 1.0) * onehot).sum(-1)


def dispatch_mask(onehot, capacity: int):
    """``(dmask [N, E, C], keep [N])``: ``dmask[n, e, c] = 1`` iff token n
    is the c-th token routed to expert e and ``c < capacity``; overflow
    tokens get an all-zero row (dropped). ``F.one_hot`` refuses an index
    past C, where ``jax.nn.one_hot`` gives zeros, so those are masked."""
    pos = _positions(onehot)
    keep = pos < capacity
    slot = F.one_hot(torch.where(keep, pos, 0.0).long(),
                     capacity).to(torch.float32) * keep[:, None]
    return onehot[:, :, None] * slot[:, None, :], keep


def _pmean(t, group):
    """Mean over ``group`` whose gradient is the mean of the cotangents
    (``psum``'s transpose is ``psum`` in the reference's ``shard_map``)."""
    n = axis(group)[0]
    return reduce_from_tp(copy_to_tp(t, group), group) / n


class SwitchDispatch:
    """Capacity-factor Switch dispatch for one call of the capacity step,
    handed to ``loss_fn(params, batch, moe)``: ``moe(params, x2)`` takes the
    functional tree (this rank's expert shards) and the local ``[n, d]``
    tokens and returns ``(y, aux)`` like :func:`dense_moe_apply`.

    Its first call banks the dispatch statistics (per-expert load and
    dropped tokens over the grid, the capacity) and the new error-feedback
    residual pair; later calls (several MoE layers) exchange with no
    residual.

    The ``[E, C, d]`` buffer is expert-major, so its dim 0 is already
    grouped by destination: peer p owns experts ``[p E/ep, (p+1) E/ep)``.
    A token lands in its slot by an index copy and its expert's output
    comes back by an index select (a dropped token's from a spare zero
    row): each slot holds one token, so these are the bits of the
    reference's one-hot einsums."""

    def __init__(self, mesh, capacity_factor: float, wire: str,
                 block: Optional[int], ef_loc):
        self.mesh = mesh
        self.capacity_factor = capacity_factor
        self.wire = wire
        self.block = block
        self._ef_loc = ef_loc          # [2, E, C, d] this rank's rows
        self.stats = None
        self.new_ef = None

    def _swap(self, z, ef):
        """The exchange over ep: ``(what arrives, the new residual or
        None)``; with no wire, the exact all_to_all and a zero residual
        (``quantized_all_to_all``'s fallback)."""
        out = spmd.quantized_all_to_all(z, self.mesh.ep_group, self.wire,
                                        self.block, ef=ef)
        return out if ef is not None else (out, None)

    def route(self, params, x2):
        """The routing and the dispatch buffer of ``x2``: ``(probs, onehot,
        gate, keep, index, buf)`` with ``index`` each token's row of the
        flat ``[E * C (+ 1), d]`` buffer (dropped tokens: the spare last
        row, cut off) and ``buf`` the ``[E, C, d]`` payload the exchange
        sends. No host synchronization."""
        e = self.mesh.ep * params["w_in"].shape[0]
        n_loc, d = x2.shape
        cap = expert_capacity(n_loc, e, self.capacity_factor)
        probs, onehot, gate = _router(params, x2)
        pos = _positions(onehot)
        keep = pos < cap
        index = torch.where(keep, onehot.argmax(-1) * cap + pos.long(),
                            e * cap)
        buf = x2.new_zeros((e * cap + 1, d), dtype=torch.float32) \
            .index_copy(0, index, x2.float())[:-1].reshape(e, cap, d)
        return probs, onehot, gate, keep, index, buf

    def __call__(self, params, x2) -> Tuple[torch.Tensor, torch.Tensor]:
        ep = self.mesh.ep
        e_loc = params["w_in"].shape[0]
        e = ep * e_loc
        n_loc, d = x2.shape
        probs, onehot, gate, keep, index, buf = self.route(params, x2)
        cap = buf.shape[1]

        first = self.stats is None
        ef = self._ef_loc if (first and self._ef_loc is not None) else None
        if ef is not None and ef.shape[1:] != buf.shape:
            raise ValueError(
                f"EF residual shaped {tuple(ef.shape[1:])} does not match the "
                f"[E, C, d] exchange {tuple(buf.shape)}; rebuild the "
                f"optimizer state with moe_opt_state() for this batch size")

        recv, ef_d = self._swap(buf, ef[0] if ef is not None else None)
        xe = (recv.reshape(ep, e_loc, cap, d).transpose(0, 1)
              .reshape(e_loc, ep * cap, d))
        he = _gelu(torch.einsum("egd,edh->egh", xe, params["w_in"]))
        ye = torch.einsum("egh,ehd->egd", he, params["w_out"])
        back = (ye.reshape(e_loc, ep, cap, d).transpose(0, 1)
                .reshape(e, cap, d))
        out, ef_c = self._swap(back, ef[1] if ef is not None else None)
        y = F.pad(out.reshape(e * cap, d), (0, 0, 0, 1)).index_select(
            0, index) * gate[:, None]

        # the balance loss over the global batch: means over the grid
        frac = _pmean(onehot.mean(0), None)
        balance = e * torch.sum(frac * _pmean(probs.mean(0), None))

        if first:
            with torch.no_grad():
                load = _sum(onehot.sum(0), None)
                dropped = _sum((n_loc - keep.float().sum()).reshape(1),
                               None)[0]
            self.stats = {"load": load, "dropped": dropped,
                          "capacity": torch.tensor(float(cap))}
            if self._ef_loc is not None:
                self.new_ef = torch.stack([ef_d, ef_c])
        return y.to(x2.dtype), balance.float()


def _sum(t, group):
    return _exchange("all_reduce", t, group)


class ExactDispatch:
    """The exact dispatch over a (dp, ep) grid, for the exact step:
    ``moe(params, x2) -> (y, aux)`` is :func:`dense_moe_apply` on this
    rank's experts over ``mesh``, as it is on the whole batch."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __call__(self, params, x2) -> Tuple[torch.Tensor, torch.Tensor]:
        return dense_moe_apply(params, x2, self.mesh)


# ------------------------------------------------------- sharding helpers
@dataclass(frozen=True)
class DpEpMesh:
    """This rank's place on the (dp, ep) grid, rank ``r`` at ``divmod(r,
    ep)``, and the groups of its two axes (None at world size 1)."""
    dp: int
    ep: int
    dp_rank: int
    ep_rank: int
    dp_group: Any
    ep_group: Any

    @property
    def world(self) -> int:
        return self.dp * self.ep

    @property
    def rank(self) -> int:
        """This rank's place in the grid's row-major order (its block of a
        batch sharded over (dp, ep))."""
        return self.dp_rank * self.ep + self.ep_rank


def make_dp_ep_mesh(dp: int, ep: int) -> DpEpMesh:
    """The (dp, ep) grid over every rank, row-major (``sp_training.grid``).
    Raises ``ValueError`` unless ``dp * ep`` is the world size."""
    (dp_rank, ep_rank), (dp_group, ep_group) = grid((dp, ep), [(0,), (1,)])
    return DpEpMesh(dp, ep, dp_rank, ep_rank, dp_group, ep_group)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts and lists (a tuple is
    a leaf: a spec), ``path`` the list of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(path), tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list tree, in key order."""
    return [t for _, t in _paths(tree)]


def ep_param_spec(path_keys, leaf=None) -> tuple:
    """``("ep",)`` (dim 0, the expert dim, over ep) for a stacked expert
    tensor, a leaf named ``w_in`` / ``w_out``; ``()`` (replicated) for the
    router and everything else."""
    names = [str(k) for k in path_keys]
    return ("ep",) if names and names[-1] in ("w_in", "w_out") else ()


def ep_specs(tree):
    """The tree of :func:`ep_param_spec` tuples matching ``tree``."""
    return tree_map_with_path(ep_param_spec, tree)


def shard_params_ep(params, mesh: DpEpMesh):
    """This rank's parameters: each expert tensor's ``E / ep`` experts of
    the rank's place on ep (a copy), every other leaf whole. Raises
    ``ValueError`` naming the leaf when E does not split over ep."""
    def one(path, leaf):
        if ep_param_spec(path, leaf):
            if leaf.shape[0] % mesh.ep:
                raise ValueError(
                    f"{'/'.join(path)}: expert dim {leaf.shape[0]} not "
                    f"divisible by ep={mesh.ep}")
            k = leaf.shape[0] // mesh.ep
            return leaf[mesh.ep_rank * k:(mesh.ep_rank + 1) * k].clone()
        return leaf.clone()

    return tree_map_with_path(one, params)


def moe_opt_state(make_optimizer: Callable, params, mesh: DpEpMesh,
                  num_tokens: int, capacity_factor: float = 1.25):
    """``(optimizer, ef)`` for the capacity step: ``make_optimizer(leaves)``
    over this rank's parameter tensors (``params`` as
    :func:`shard_params_ep` returns them) and this rank's zero ``[2, E, C,
    d]`` f32 error-feedback residual, a direction each. ``num_tokens`` is
    the GLOBAL token count a step; raises ``ValueError`` unless the grid's
    ranks split it evenly."""
    world = mesh.world
    if num_tokens % world:
        raise ValueError(f"global tokens {num_tokens} not divisible by "
                         f"{world} devices")
    e_loc, d, _ = params["w_in"].shape
    e = e_loc * mesh.ep
    cap = expert_capacity(num_tokens // world, e, capacity_factor)
    ef = torch.zeros((2, e, cap, d), dtype=torch.float32,
                     device=params["w_in"].device)
    return make_optimizer(tree_leaves(params)), ef


# ------------------------------------------------------------ the record
_record: dict = {}


def moe_record() -> dict:
    """What the capacity steps of this process recorded (the reference's
    metric instruments): ``expert_load`` (the last step's tokens an expert
    over the grid), ``imbalance`` (its max over its mean),
    ``dropped_tokens`` and the wire's bytes (``wire_bytes``, one rank's,
    ``comp.moe_wire_footprint``; ``wire_bytes_exact``, what the exact wire
    would have moved) summed over the steps, ``capacity_factor``."""
    return {k: (list(v) if isinstance(v, list) else v)
            for k, v in _record.items()}


def reset_moe_record() -> None:
    _record.clear()
    _record.update(expert_load=[], imbalance=0.0, dropped_tokens=0.0,
                   capacity_factor=0.0, wire_bytes=0, wire_bytes_exact=0)


reset_moe_record()


def _record_moe(stats, capacity_factor: float, wire: str, per_peer: int,
                ep: int, block: int) -> None:
    load = [float(v) for v in stats["load"].cpu()]
    mean = sum(load) / len(load) if load else 0.0
    _record["expert_load"] = load
    _record["imbalance"] = max(load) / mean if mean > 0 else 0.0
    _record["dropped_tokens"] += float(stats["dropped"])
    _record["capacity_factor"] = float(capacity_factor)
    if wire and spmd._wire_eligible(per_peer, torch.float32, wire, block):
        _record["wire_bytes"] += comp.moe_wire_footprint(per_peer, wire, ep,
                                                         block)
        _record["wire_bytes_exact"] += comp.moe_wire_footprint(
            per_peer, "none", ep, block)


# ------------------------------------------------------------- train steps
def _local_batch(batch, parts: int, index: int, device):
    """Block ``index`` of ``parts`` along dim 0 of each tensor of the
    GLOBAL ``batch``."""
    out = []
    for t in batch:
        t = torch.as_tensor(t)
        if t.shape[0] % parts:
            raise ValueError(f"global batch dim {t.shape[0]} does not split "
                             f"into {parts} blocks")
        k = t.shape[0] // parts
        out.append(t[index * k:(index + 1) * k].to(device))
    return tuple(out)


def make_ep_train_step(loss_fn: Callable, mesh: DpEpMesh,
                       dispatch: str = "exact",
                       capacity_factor: float = 1.25,
                       wire: Optional[str] = None,
                       block: Optional[int] = None) -> Callable:
    """The expert-parallel train step, ``step(params, opt_state, batch)``
    on the GLOBAL ``batch`` (a tuple of tensors, the same on every rank);
    ``params`` is this rank's tree (:func:`shard_params_ep`), its tensors
    the leaves the optimizer updates in place. ``loss_fn(params, batch,
    moe) -> scalar`` gets this rank's block of the batch and calls ``moe(
    params, tokens)``.

    ``dispatch="exact"``: ``opt_state`` is the optimizer; the batch splits
    over dp, ``moe`` is an :class:`ExactDispatch`; every gradient is
    averaged over dp (``sp_training.mean_gradients``); returns the loss
    averaged over dp.

    ``dispatch="capacity"``: ``opt_state`` is ``(optimizer, ef)`` from
    :func:`moe_opt_state` (``ef`` is updated in place); the batch splits
    over the (dp, ep) grid, ``moe`` is a :class:`SwitchDispatch`.
    Gradients as the reference reduces them: each expert shard's already
    sums its ep row's cotangents (the exchange's backward delivers them),
    so it sums over dp and divides by the world; replicated leaves average
    over the grid. Returns ``(loss averaged over the grid, stats)`` and
    adds the step to :func:`moe_record`. ``wire`` resolves
    ``HOROVOD_MOE_WIRE`` when the step is built (:func:`moe_wire`).

    Every rank runs the same backward, in one order: the exchanges'
    backward is a collective."""
    if dispatch not in ("exact", "capacity"):
        raise ValueError(f"dispatch must be exact|capacity, got {dispatch!r}")
    wire = moe_wire(wire) if dispatch == "capacity" else ""
    block = spmd._wire_block(block)
    world = mesh.world

    def device_of(params):
        return tree_leaves(params)[0].device

    def exact_step(params, optimizer, batch):
        local = _local_batch(batch, mesh.dp, mesh.dp_rank, device_of(params))
        optimizer.zero_grad()
        loss = loss_fn(params, local, ExactDispatch(mesh))
        loss.backward()
        mean_gradients(tree_leaves(params), mesh.dp_group)
        optimizer.step()
        return _exchange("all_reduce", loss.detach(), mesh.dp_group) / mesh.dp

    def capacity_step(params, opt_state, batch):
        optimizer, ef = opt_state
        local = _local_batch(batch, world, mesh.rank, device_of(params))
        optimizer.zero_grad()
        moe = SwitchDispatch(mesh, capacity_factor, wire, block, ef)
        loss = loss_fn(params, local, moe)
        if moe.stats is None:
            raise ValueError("dispatch='capacity' requires loss_fn(params, "
                             "batch, moe) to call moe(moe_params, tokens)")
        loss.backward()
        reduce_capacity_gradients(params, mesh)
        optimizer.step()
        if moe.new_ef is not None:
            ef.copy_(moe.new_ef)
        per_peer = ef[0].numel() // mesh.ep  # E_loc · C · d
        _record_moe(moe.stats, capacity_factor, wire, per_peer, mesh.ep,
                    block)
        return (_exchange("all_reduce", loss.detach(), None) / world,
                moe.stats)

    return exact_step if dispatch == "exact" else capacity_step


def reduce_capacity_gradients(params, mesh: DpEpMesh) -> None:
    """The capacity step's gradient rule (the reference's): an expert
    shard's gradient already sums its ep row's cotangents (the exchange's
    backward delivered them), so it sums over dp and divides by the world;
    a replicated leaf's is averaged over the grid. A leaf this rank left
    unused reduces as zeros."""
    for path, p in _paths(params):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        group = mesh.dp_group if ep_param_spec(path) else None
        p.grad = _exchange("all_reduce", g, group) / mesh.world


def _paths(tree):
    out = []
    tree_map_with_path(lambda p, t: out.append((p, t)), tree)
    return out
