"""The Python controller: readiness, validation, fusion planning and stall
inspection for the engine (a port of ``horovod_tpu/runtime/pycontroller.py``,
itself the fallback of the reference's native core, `_core/controller.cc`).

Left out of the port, with what brings them back: the straggler policy (it
is off whenever ``local_only`` is set, which multiprocess mode always sets;
it needs the coordinator, M9); the elastic ``reset()`` (M12); the
flight-recorder and metrics calls (M13); autotune scoring
(``report_score``, which never tunes in the reference's Python controller
either). Without the native core there is no response cache, so its
counters (``cache_stats``) read zero, as the reference's Python
controller's do.

:func:`validate` is the cross-rank check of one tensor. The controller runs
it over the ranks it sees; in multiprocess mode it sees only its own rank,
and the engine runs it again over every rank's entries after one
``all_gather_object`` a response (``runtime/engine.py``). That gather also
carries the sizes a ragged allgather or alltoall needs, so the port accepts
both in multiprocess mode, where the reference's local-only plane refuses
them for want of a size negotiation.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.env import env_float as _env_float
from ..utils.timeline import Timeline
from .messages import RequestType, Response, ResponseType, TensorTableEntry


class _Meta:
    """What the ranks must agree on for one entry (picklable: the engine
    gathers these across processes)."""

    __slots__ = ("name", "rank", "type", "dtype", "shape", "root_rank",
                 "average", "prescale", "postscale", "handle", "enqueue_t",
                 "nbytes", "splits", "compression", "fusable", "parts")

    def __init__(self, e: TensorTableEntry, handle: int):
        self.name = e.tensor_name
        self.rank = e.rank
        self.type = e.request_type
        self.dtype = str(e.array.dtype)
        self.shape = tuple(e.array.shape)
        self.root_rank = e.root_rank
        self.average = e.average
        self.prescale = e.prescale_factor
        self.postscale = e.postscale_factor
        self.handle = handle
        self.enqueue_t = time.monotonic()
        self.nbytes = e.array.numel() * e.array.element_size()
        self.splits = None if e.splits is None else tuple(int(s)
                                                          for s in e.splits)
        self.compression = e.compression
        self.fusable = e.fusable
        self.parts = e.parts


def _per_rank(metas, field) -> str:
    """``rank r value, ...`` of ``field(meta)`` over ``metas``."""
    return ", ".join(f"rank {m.rank} {field(m)}" for m in metas)


def validate(name: str, ranks: Dict[int, _Meta], world: int,
             joined: bool = False) -> Optional[str]:
    """The reference's error for one tensor the ranks disagree on
    (`pycontroller.py:_validate`), each followed by the ranks' values of
    the field that differs; None when the request is valid."""
    metas = [ranks[r] for r in sorted(ranks)]
    e0 = metas[0]

    def differ(field):
        return any(field(m) != field(e0) for m in metas)

    def fail(message, field):
        return f"{message}: {_per_rank(metas, field)}"

    checks = (
        (lambda m: m.type.name,
         f"Mismatched collective operations for tensor '{name}'"),
        (lambda m: m.dtype, f"Mismatched data types for tensor '{name}'"),
        (lambda m: (m.average, m.prescale, m.postscale),
         f"Mismatched reduction op/scale factors for tensor '{name}'"),
        (lambda m: m.compression,
         f"Mismatched compression for tensor '{name}': set "
         "HOROVOD_COMPRESSION identically on every rank"))
    for field, message in checks:
        if differ(field):
            return fail(message, field)
    a2a_ragged = e0.type == RequestType.ALLTOALL and e0.splits is not None
    if e0.type in (RequestType.ALLREDUCE, RequestType.ADASUM,
                   RequestType.BROADCAST) or (
            e0.type == RequestType.ALLTOALL and not a2a_ragged):
        if differ(lambda m: (m.shape, m.parts)):
            return fail(f"Mismatched tensor shapes for '{name}'",
                        lambda m: m.shape if m.parts is None
                        else (m.shape, m.parts))
    if e0.type == RequestType.ALLGATHER:
        if any(len(m.shape) == 0 for m in metas):
            return f"Allgather of scalar tensor '{name}' is not supported."
        if differ(lambda m: m.shape[1:]):
            return fail("Mismatched allgather tensor shapes beyond first "
                        f"dimension for '{name}'", lambda m: m.shape)
    if e0.type == RequestType.ADASUM and (world & (world - 1)):
        return (f"Adasum requires a power-of-2 number of ranks; got "
                f"{world}.")
    if e0.type == RequestType.ALLTOALL:
        if differ(lambda m: m.splits is None):
            return (f"Mismatched alltoall splits usage for tensor "
                    f"'{name}': some ranks passed splits, others did not.")
        if a2a_ragged:
            for m in metas:
                if not m.shape:
                    return (f"Alltoall of scalar tensor '{name}' is not "
                            "supported.")
                if len(m.splits) != world:
                    return (f"Alltoall splits for tensor '{name}' on rank "
                            f"{m.rank} has {len(m.splits)} entries; "
                            f"expected world size {world}.")
                if any(s < 0 for s in m.splits):
                    return (f"Alltoall splits for tensor '{name}' on rank "
                            f"{m.rank} contains a negative entry.")
                if sum(m.splits) != m.shape[0]:
                    return (f"Alltoall splits for tensor '{name}' on rank "
                            f"{m.rank} sum to {sum(m.splits)} but dim 0 is "
                            f"{m.shape[0]}.")
                if m.shape[1:] != e0.shape[1:]:
                    return fail("Mismatched alltoall tensor shapes beyond "
                                f"first dimension for '{name}'",
                                lambda m: m.shape)
        else:
            d0 = e0.shape[0] if e0.shape else 0
            if not e0.shape or d0 % world != 0:
                return (f"Alltoall tensor '{name}' first dimension ({d0}) "
                        f"must be divisible by world size {world}.")
    if e0.type == RequestType.BROADCAST:
        if differ(lambda m: m.root_rank):
            return fail(f"Mismatched root ranks for broadcast '{name}'",
                        lambda m: m.root_rank)
        if not (0 <= e0.root_rank < world):
            return (f"Invalid root rank {e0.root_rank} for broadcast "
                    f"'{name}' (world size {world}).")
    if joined and e0.type in (RequestType.ALLGATHER, RequestType.BROADCAST,
                              RequestType.ALLTOALL):
        return f"{e0.type.name} is not supported while a rank has joined."
    return None


class PyController:
    SUBMIT_DUPLICATE = -1
    SUBMIT_SHUTDOWN = -2

    def __init__(self, world: int, fusion_threshold: int,
                 stall_warning_s: float, stall_shutdown_s: float,
                 fusion_enabled: bool, timeline_path: Optional[str],
                 cycle_time_ms: float, local_only: bool = False,
                 self_rank: int = 0):
        self._world = world
        self._local_only = local_only
        self._self_rank = self_rank
        self._threshold = fusion_threshold
        self._stall_warning_s = stall_warning_s
        self._stall_shutdown_s = stall_shutdown_s
        # enforced watchdog; 0 keeps the warn-only stall inspector
        self._collective_timeout_s = _env_float(
            "HOROVOD_COLLECTIVE_TIMEOUT", 0.0)
        self._fusion_enabled = fusion_enabled
        self._cycle_ms = cycle_time_ms
        self._timeline = Timeline(timeline_path)
        self._next_handle = 0
        self._order: List[str] = []
        self._table: Dict[str, Dict[int, _Meta]] = {}
        self._joined: set = set()
        self._join_handles: Dict[int, int] = {}
        self._last_joined = -1
        self._shutdown = False
        self._warned: set = set()
        self._lock = threading.Lock()

    def submit(self, entry: TensorTableEntry) -> int:
        with self._lock:
            if self._shutdown:
                return self.SUBMIT_SHUTDOWN
            ranks = self._table.setdefault(entry.tensor_name, {})
            if entry.rank in ranks:
                return self.SUBMIT_DUPLICATE
            h = self._next_handle
            self._next_handle += 1
            if not ranks:
                self._order.append(entry.tensor_name)
            ranks[entry.rank] = _Meta(entry, h)
            self._timeline.negotiate_start(entry.tensor_name, entry.rank)
            return h

    def join(self, rank: int) -> int:
        with self._lock:
            if self._shutdown:
                return self.SUBMIT_SHUTDOWN
            if rank in self._join_handles:  # repeated join: same barrier
                return self._join_handles[rank]
            h = self._next_handle
            self._next_handle += 1
            self._joined.add(rank)
            self._join_handles[rank] = h
            self._last_joined = rank
            return h

    def _validate(self, name: str, ranks: Dict[int, _Meta]) -> Optional[str]:
        return validate(name, ranks, self._world, bool(self._joined))

    @staticmethod
    def _sig(m: _Meta):
        # compression included: quantized and plain buckets run different
        # wire programs
        return (int(m.type), m.dtype, m.average, m.prescale, m.postscale,
                m.root_rank, m.compression)

    def tick(self):
        """``None`` when there is nothing to do, else ``(responses,
        handle_pairs, join_released, last_joined, stall_warnings,
        stall_shutdown)``; ``handle_pairs[i]`` are the ``(rank, handle)``
        pairs of ``responses[i]``."""
        with self._lock:
            if self._shutdown:
                return None
            now = time.monotonic()
            if self._local_only:
                active = {self._self_rank} - self._joined
                all_joined = self._self_rank in self._joined
            else:
                active = set(range(self._world)) - self._joined
                all_joined = len(self._joined) == self._world
            if self._joined and all_joined and not self._table:
                join_released = list(self._join_handles.values())
                last_joined = self._last_joined
                self._join_handles.clear()
                self._joined.clear()
                return ([], [], join_released, last_joined, [], False)

            ready, waiting = [], []
            stall_warnings: List[str] = []
            stall_shutdown = False
            timed_out: List[Tuple[str, Dict[int, _Meta], List[int],
                                  float]] = []
            for name in self._order:
                st = self._table.get(name)
                if st is None:
                    continue
                if active <= set(st.keys()):
                    ready.append(name)
                    # completed: re-arm the stall inspector so a second
                    # stall of the same tensor warns again
                    self._warned.discard(name)
                    continue
                waited = now - min(m.enqueue_t for m in st.values())
                missing = sorted(active - set(st.keys()))
                if (self._collective_timeout_s
                        and waited > self._collective_timeout_s):
                    # enforced watchdog: fail the submitted handles with a
                    # named error instead of warning forever
                    timed_out.append((name, self._table.pop(name), missing,
                                      waited))
                    self._warned.discard(name)
                    continue
                waiting.append(name)
                if waited > self._stall_warning_s and name not in self._warned:
                    self._warned.add(name)
                    stall_warnings.append(
                        f"{name} (waiting on ranks {missing} for "
                        f"{int(waited)}s)")
                if self._stall_shutdown_s and waited > self._stall_shutdown_s:
                    stall_shutdown = True
            self._order = waiting
            if (not ready and not stall_warnings and not stall_shutdown
                    and not timed_out):
                return None

            singles = []
            responses: List[Response] = []
            handle_pairs: List[List[Tuple[int, int]]] = []
            for name, st, missing, waited in timed_out:
                responses.append(Response(
                    ResponseType.ERROR, [name],
                    error_message=(
                        f"collective timeout: tensor '{name}' waited "
                        f"{int(waited)}s on ranks {missing} "
                        f"(HOROVOD_COLLECTIVE_TIMEOUT="
                        f"{self._collective_timeout_s:g}s exceeded)")))
                handle_pairs.append(sorted((r, m.handle)
                                           for r, m in st.items()))
            for name in ready:
                st = self._table.pop(name)
                pairs = sorted((r, m.handle) for r, m in st.items())
                err = self._validate(name, st)
                if err is not None:
                    responses.append(Response(ResponseType.ERROR, [name],
                                              error_message=err))
                    handle_pairs.append(pairs)
                    continue
                singles.append((name, st[min(st)], pairs))

            used = [False] * len(singles)
            for i, (name, e0, pairs) in enumerate(singles):
                if used[i]:
                    continue
                used[i] = True
                bucket = [i]
                total = e0.nbytes
                # client-built buckets (fusable=False) never merge: each
                # stays its own response so its wire can start while later
                # buckets are still enqueueing
                fusable = self._fusion_enabled and e0.fusable and e0.type in (
                    RequestType.ALLREDUCE, RequestType.ADASUM,
                    RequestType.ALLGATHER)
                if fusable:
                    for j in range(i + 1, len(singles)):
                        if used[j]:
                            continue
                        if (singles[j][1].fusable
                                and self._sig(singles[j][1]) == self._sig(e0)
                                and total + singles[j][1].nbytes
                                <= self._threshold):
                            used[j] = True
                            bucket.append(j)
                            total += singles[j][1].nbytes
                resp = Response(ResponseType(int(e0.type)),
                                [singles[k][0] for k in bucket],
                                average=e0.average)
                resp.prescale = e0.prescale
                resp.postscale = e0.postscale
                resp.root_rank = e0.root_rank
                resp.compression = e0.compression
                hp: List[Tuple[int, int]] = []
                for k in bucket:
                    hp.extend(singles[k][2])
                responses.append(resp)
                handle_pairs.append(hp)
            return (responses, handle_pairs, [], -1, stall_warnings,
                    stall_shutdown)

    def shutdown(self) -> List[int]:
        with self._lock:
            if self._shutdown:
                return []
            self._shutdown = True
            orphans = [m.handle for st in self._table.values()
                       for m in st.values()]
            orphans.extend(self._join_handles.values())
            self._table.clear()
            self._order.clear()
            self._join_handles.clear()
            self._joined.clear()
        self._timeline.close()
        return orphans

    # ---- timeline and knobs
    def timeline_op_start(self, tensor: str, op: str) -> None:
        self._timeline.op_start(tensor, op)

    def timeline_op_end(self, tensor: str) -> None:
        self._timeline.op_end(tensor)

    def timeline_cycle(self) -> None:
        self._timeline.cycle_tick()

    def fusion_threshold(self) -> int:
        return self._threshold

    def cycle_time_ms(self) -> float:
        return self._cycle_ms

    def cache_stats(self):
        return (0, 0)
