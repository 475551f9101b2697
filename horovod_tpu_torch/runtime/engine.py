"""Background collective engine: queue, negotiation, fusion, execution
(a port of ``horovod_tpu/runtime/engine.py``; reference parity: the
background-thread engine of `horovod/common/operations.cc`,
``BackgroundThreadLoop`` :328, ``RunLoopOnce`` :531, ``PerformOperation``
:227).

``enqueue`` hands a named tensor to the controller (``pycontroller.py``)
and returns a handle. The engine thread ticks the controller, which returns
the responses that are ready (fused under ``HOROVOD_FUSION_THRESHOLD`` where
fusion is on), and performs each on the executor (``executor.py``). A
completion callback runs before the handle is marked done, so an in-place
copy-back is visible when ``synchronize`` returns.

Multiprocess mode has no coordinator yet (the reference's cross-process
control plane, M9): each process's controller sees only its own rank
(``local_only``), fusion is off, and the ranks agree by program order, as
the reference does without a coordinator. Before a response's data moves,
the engine runs one ``all_gather_object`` of its entries' metadata on the
engine's own process group and checks them with
:func:`pycontroller.validate`: a mismatch, or a local error on any rank,
fails every handle of the response on every rank with the same message,
and nothing is computed. The gather also gives a ragged allgather its
dim-0 sizes and a ragged alltoall its send matrix.

On the card the engine thread runs the executor on a stream of its own.
``enqueue`` records an event on the caller's current stream (the tensor's
producer, e.g. autograd's device thread in a gradient hook); the engine's
stream waits on it before it reads the tensor, and ``synchronize`` makes
the caller's current stream wait on an event recorded after the result and
its callbacks. Tensors that cross streams are marked with
``record_stream`` so the caching allocator does not reuse them early.

Consecutive Adasum responses enqueued in one ``batch()`` are negotiated
and gathered one by one, then combined in one ``Executor.execute_adasum``
call (one kernel launch a tree level on the card); a tensor's bits do not
depend on the grouping. A batch reaches the controller in one tick, and
every rank must enqueue the same batches, so that every rank issues the
same collectives in the same order.

Left out, with what brings them back: the native core and the coordinator
(M9), the straggler policy, the elastic executor and membership resets
(M12), goodput, metrics, the flight recorder, fault injection and
cross-rank tracing (M13), and autotune.

Env knobs: ``HOROVOD_FUSION_THRESHOLD`` (bytes, default 64 MiB),
``HOROVOD_CYCLE_TIME`` (ms, default 5), ``HOROVOD_STALL_CHECK_TIME_SECONDS``
(60), ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` (0 = never),
``HOROVOD_STALL_CHECK_DISABLE``, ``HOROVOD_COLLECTIVE_TIMEOUT`` (0 = warn
only), ``HOROVOD_TIMELINE`` (Chrome-trace path).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..exceptions import (CollectiveTimeoutError, DuplicateNameError,
                          HorovodInternalError, ShutdownError)
from ..utils.env import env_float as _env_float, env_on as _env_on
from .executor import Executor
from .handles import HandleManager
from .messages import (AlltoallvResult, Response, ResponseType,
                       TensorTableEntry)
from .pycontroller import PyController, _Meta, _per_rank, validate

DEFAULT_FUSION_BYTES = 64 * 1024 * 1024
DEFAULT_CYCLE_MS = 5.0

logger = logging.getLogger("horovod_tpu_torch")


def _timeline_path(mode: str, self_rank: int) -> Optional[str]:
    """Rank 0 writes HOROVOD_TIMELINE verbatim; in multiprocess mode every
    other rank writes its own spans to ``<path>.rank<N>``."""
    path = os.environ.get("HOROVOD_TIMELINE")
    if not path:
        return None
    if mode != "multiprocess" or self_rank == 0:
        return path
    return f"{path}.rank{self_rank}"


def _stall_knobs():
    """(warning_s, shutdown_s) with HOROVOD_STALL_CHECK_DISABLE folded in:
    disabling the check (`env_parser.cc:120`) means neither warning nor
    forced shutdown ever fires, regardless of the time knobs."""
    if _env_on("HOROVOD_STALL_CHECK_DISABLE"):
        return float("inf"), 0.0
    return (_env_float("HOROVOD_STALL_CHECK_TIME_SECONDS", 60.0),
            _env_float("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0))


def _make_controller(world: int, mode: str, self_rank: int = 0):
    stall_warning_s, stall_shutdown_s = _stall_knobs()
    return PyController(
        world=world,
        fusion_threshold=int(_env_float("HOROVOD_FUSION_THRESHOLD",
                                        DEFAULT_FUSION_BYTES)),
        stall_warning_s=stall_warning_s,
        stall_shutdown_s=stall_shutdown_s,
        # fusion across processes needs the coordinator: bucket contents
        # must not depend on each process's tick timing
        fusion_enabled=(mode != "multiprocess"),
        timeline_path=_timeline_path(mode, self_rank),
        cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME", DEFAULT_CYCLE_MS),
        # only this process's rank submits to its table; readiness must not
        # wait on the other ranks, which agree by program order
        local_only=(mode == "multiprocess"),
        self_rank=self_rank)


def _tensors(result):
    """The tensors of a handle's result."""
    if isinstance(result, AlltoallvResult):
        return [result.output]
    return [result] if isinstance(result, torch.Tensor) else []


class Engine:
    """One engine per process; owns the negotiation thread and executor.
    ``state`` is the framework's state (``basics._GlobalState``); ``group``
    is the engine's own process group in multiprocess mode.
    ``responses_performed`` counts the responses executed (fused or not,
    errors excluded)."""

    def __init__(self, state, group=None):
        self._world = state.size
        self._mode = state.mode
        self._rank = state.rank
        self._device = state.device
        self._group = group
        self._negotiate_across = state.mode == "multiprocess" and state.size > 1
        self.handles = HandleManager()
        self.controller = _make_controller(state.size, state.mode, state.rank)
        self._executor = Executor(state.size, state.backend, group)
        # reentrant: batch() holds it across several enqueues
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._pending: Dict[int, TensorTableEntry] = {}  # ctrl handle -> entry
        self._inflight: set = set()  # names enqueued and not yet completed
        self._join_waiters: Dict[int, List[int]] = {}  # ctrl h -> user hs
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        self.cycle_time_s = self.controller.cycle_time_ms() / 1e3
        self._stream = None  # the engine thread's CUDA stream
        self._done_events: Dict[int, torch.cuda.Event] = {}
        self._inplace: Dict[int, torch.Tensor] = {}
        self._auto_names: Dict[str, int] = {}
        self._batch: Optional[int] = None  # the open batch()
        self._batches = 0
        self.responses_performed = 0

    # ------------------------------------------------------------------ API
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="hvd_torch_engine", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        """Stop the thread; what is still pending fails with
        ``ShutdownError``."""
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def auto_name(self, prefix: str, name: Optional[str]) -> str:
        """``name``, or ``<prefix>.noname.<n>`` for the n-th unnamed call of
        this kind since the engine started: ranks that issue the same calls
        in the same order name them alike."""
        if name is not None:
            return name
        with self._lock:
            n = self._auto_names.get(prefix, 0)
            self._auto_names[prefix] = n + 1
        return f"{prefix}.noname.{n}"

    @contextlib.contextmanager
    def batch(self):
        """Enqueues made inside reach the controller in one tick (the
        engine thread ticks under the same lock), and a run of Adasum
        requests among them is combined in one executor call. Every rank
        must enqueue the same requests in a batch."""
        with self._lock:
            self._batches += 1
            outer, self._batch = self._batch, self._batches
            try:
                yield
            finally:
                self._batch = outer

    def enqueue(self, entry: TensorTableEntry,
                inplace: Optional[torch.Tensor] = None) -> int:
        """Add a named tensor; returns an async user handle. ``inplace``:
        the tensor that ``synchronize`` returns (the callback wrote the
        result into it).

        Mirrors EnqueueTensorAllreduce/-Allgather/-Broadcast
        (`operations.cc:783-934`); duplicate detection in the controller
        (DUPLICATE_NAME_ERROR `common.h:160`)."""
        if entry.array.device.type == "cuda":
            entry.ready = torch.cuda.Event()
            entry.ready.record(torch.cuda.current_stream(entry.array.device))
        user = self.handles.allocate()
        entry.handle = user
        if inplace is not None:
            self._inplace[user] = inplace
        fail = None
        with self._lock:
            if self._shutdown:
                fail = (ShutdownError, "Horovod has been shut down.")
            else:
                entry.batch = self._batch
                # a name stays taken until its collective completes: the
                # local-only controller lets it go at the next tick
                ch = (self.controller.SUBMIT_DUPLICATE
                      if entry.tensor_name in self._inflight
                      else self.controller.submit(entry))
                if ch == self.controller.SUBMIT_DUPLICATE:
                    fail = (DuplicateNameError,
                            f"Duplicate tensor name {entry.tensor_name!r}: "
                            f"a collective with this name from rank "
                            f"{entry.rank} is already pending.")
                elif ch == self.controller.SUBMIT_SHUTDOWN:
                    fail = (ShutdownError, "Horovod has been shut down.")
                else:
                    self._pending[ch] = entry
                    self._inflight.add(entry.tensor_name)
                    self._wake.notify_all()
        if fail is not None:
            # the completion contract covers submit-time failures too, and
            # callbacks never run under the engine lock
            cls, msg = fail
            self._fire_callback(entry, False, msg)
            self.handles.mark_done(user, False, error=msg, error_cls=cls)
        return user

    def join(self, rank: int) -> int:
        """Rank signals it has no more data (JoinOp, `operations.cc:908-934`)."""
        user = self.handles.allocate()
        with self._lock:
            if self._shutdown:
                self.handles.mark_done(user, False,
                                       error="Horovod has been shut down.",
                                       error_cls=ShutdownError)
                return user
            ch = self.controller.join(rank)
            self._join_waiters.setdefault(ch, []).append(user)
            self._wake.notify_all()
        return user

    def poll(self, handle: int) -> bool:
        return self.handles.poll(handle)

    def synchronize(self, handle: int):
        """Block until ``handle`` completes; returns its result (for an
        in-place handle, the tensor written), raises its error. On the card
        the caller's current stream waits for the result first."""
        try:
            result = self.handles.synchronize(handle)
        finally:
            done = self._done_events.pop(handle, None)
            target = self._inplace.pop(handle, None)
        if target is not None:
            result = target
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in _tensors(result):
                t.record_stream(stream)
        return result

    # ----------------------------------------------------------------- loop
    def _loop(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            # the kernel wrappers launch on the current stream, and the TMA
            # encoder needs the card's context current on this thread
            torch.cuda.set_device(self._device)
            self._stream = torch.cuda.Stream(self._device)
        while True:
            try:
                with self._lock:
                    if (not self._shutdown and not self._pending
                            and not self._join_waiters):
                        self._wake.wait(timeout=self.cycle_time_s)
                    if self._shutdown:
                        drained = self._drain_locked()
                    else:
                        drained = None
                        tick = self.controller.tick()
                if drained is not None:
                    self._finish_drain(*drained)
                    return
                if tick is None:
                    time.sleep(self.cycle_time_s / 5)
                    continue
                (responses, handle_pairs, join_released, last_joined,
                 stall_warnings, stall_shutdown) = tick
                for name in stall_warnings:
                    logger.warning(
                        "One or more tensors were submitted to be reduced/"
                        "gathered/broadcasted by subset of ranks and are "
                        "waiting for remainder of ranks for more than %ss. "
                        "Stalled op: %s",
                        os.environ.get("HOROVOD_STALL_CHECK_TIME_SECONDS",
                                       "60"), name)
                if responses:
                    self.controller.timeline_cycle()
                self._perform_all(responses, handle_pairs)
                if join_released:
                    with self._lock:
                        users = [u for ch in join_released
                                 for u in self._join_waiters.pop(ch, [])]
                    for user in users:
                        self.handles.mark_done(user, True, result=last_joined)
                if stall_shutdown:
                    raise RuntimeError(
                        "Stalled tensors exceeded "
                        "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS; aborting "
                        "(stall_inspector.h:80).")
            except Exception as exc:
                logger.error("engine thread aborting: %s", exc)
                with self._lock:
                    self._shutdown = True
                    drained = self._drain_locked()
                self._finish_drain(*drained)
                return

    def _drain_locked(self):
        """Under the engine lock: stop the controller, snapshot and clear
        everything outstanding. `_finish_drain` runs with the lock
        released: completion callbacks may call back into the engine."""
        self.controller.shutdown()
        entries = list(self._pending.values())
        self._pending.clear()
        users = [u for us in self._join_waiters.values() for u in us]
        self._join_waiters.clear()
        return entries, users

    def _finish_drain(self, entries, users) -> None:
        """Fail everything outstanding with the shutdown error
        (`operations.cc:511-517`)."""
        for entry in entries:
            self._complete(entry, False, "Horovod has been shut down.",
                           ShutdownError)
        for user in users:
            self.handles.mark_done(user, False,
                                   error="Horovod has been shut down.",
                                   error_cls=ShutdownError)

    def _complete(self, entry, ok: bool, payload,
                  error_cls=HorovodInternalError) -> None:
        """Free the entry's name, run its callback, then mark its handle
        done with ``payload`` (the result, or the error's message)."""
        with self._lock:
            self._inflight.discard(entry.tensor_name)
        self._fire_callback(entry, ok, payload)
        if ok:
            self.handles.mark_done(entry.handle, True, result=payload)
        else:
            self.handles.mark_done(entry.handle, False, error=payload,
                                   error_cls=error_cls)

    @staticmethod
    def _fire_callback(entry, ok: bool, payload) -> None:
        if entry.callback:
            try:
                entry.callback(ok, payload)
            except Exception as exc:
                logger.error("completion callback for %r failed: %s",
                             entry.tensor_name, exc)

    # -------------------------------------------------------------- perform
    def _perform_all(self, responses, handle_pairs) -> None:
        """Perform a tick's responses in order; consecutive Adasum
        responses of one batch are one run, combined in one executor
        call."""
        runs: list = []  # [(batch or None, [(response, entries)])]
        # in enqueue order: the controller lists a tick's refused requests
        # first, and the ranks must negotiate in program order
        for resp, pairs in sorted(zip(responses, handle_pairs),
                                  key=lambda rp: min(ch for _, ch in rp[1])):
            with self._lock:
                entries = [self._pending.pop(ch) for _, ch in pairs]
            order = {n: i for i, n in enumerate(resp.tensor_names)}
            entries.sort(key=lambda e: order[e.tensor_name])
            batch = entries[0].batch
            if (resp.response_type == ResponseType.ADASUM
                    and batch is not None and runs and runs[-1][0] == batch
                    and all(e.batch == batch for e in entries)):
                runs[-1][1].append((resp, entries))
                continue
            runs.append((batch if resp.response_type == ResponseType.ADASUM
                         else None, [(resp, entries)]))
        for _, run in runs:
            self._perform_run(run)

    def _perform_run(self, items) -> None:
        """Negotiate each ``(response, entries)``, fail those refused, and
        execute the rest together (several only for an Adasum run). If the
        negotiation itself fails (a lost peer), every entry of the run
        fails with it before the engine stops."""
        ok = []
        try:
            for resp, entries in items:
                err = self._negotiate(resp, entries)
                if err is None:
                    ok.append((resp, entries))
                    continue
                cls = (CollectiveTimeoutError
                       if err.startswith("collective timeout")
                       else HorovodInternalError)
                for e in entries:
                    self._complete(e, False, err, cls)
        except Exception as exc:
            for _, entries in items:
                for e in entries:
                    if not self.handles.poll(e.handle):
                        self._complete(e, False,
                                       f"{type(exc).__name__}: {exc}")
            raise
        if ok:
            self._execute(ok)

    def _negotiate(self, resp: Response, entries) -> Optional[str]:
        """The error that fails ``resp`` on every rank, or None. In
        multiprocess mode one ``all_gather_object`` of every rank's
        metadata (and local error) for this response comes first; it fills
        in the sizes a ragged allgather or alltoall needs."""
        mine = (resp.error_message or "unknown error"
                if resp.response_type == ResponseType.ERROR else None)
        if not self._negotiate_across:
            return mine
        metas = [_Meta(e, e.handle) for e in entries]
        per_rank: list = [None] * self._world
        dist.all_gather_object(per_rank, (mine, metas), group=self._group)
        for err, _ in per_rank:
            if err is not None:
                return err  # the lowest rank's error, on every rank
        counts = [len(ms) for _, ms in per_rank]
        if len(set(counts)) > 1:
            return ("Mismatched number of collectives submitted together: "
                    + ", ".join(f"rank {r} {n}" for r, n in enumerate(counts)))
        rows = [[ms[i] for _, ms in per_rank] for i in range(counts[0])]
        for row in rows:
            if len({m.name for m in row}) > 1:
                return ("Mismatched tensor names: "
                        + _per_rank(row, lambda m: m.name))
            err = validate(row[0].name, {m.rank: m for m in row}, self._world)
            if err is not None:
                return err
        if resp.response_type == ResponseType.ALLGATHER:
            resp.tensor_sizes = [[m.shape[0] for m in row] for row in rows]
        elif (resp.response_type == ResponseType.ALLTOALL
              and rows[0][0].splits is not None):
            resp.tensor_sizes = [[s for m in rows[0] for s in m.splits]]
        return None

    def _execute(self, items) -> None:
        """Run negotiated responses on the executor (on the engine's stream
        on the card), fire each entry's callback, then mark it done."""
        groups = [es for _, es in items]
        names = [n for resp, _ in items for n in resp.tensor_names]
        for resp, _ in items:
            for n in resp.tensor_names:
                self.controller.timeline_op_start(n, resp.response_type.name)
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        try:
            with stream:
                for e in (e for es in groups for e in es):
                    if e.ready is not None:
                        self._stream.wait_event(e.ready)
                        e.array.record_stream(self._stream)
                if items[0][0].response_type == ResponseType.ADASUM:
                    outs = self._executor.execute_adasum(groups)
                else:
                    (resp, es), = items
                    outs = [self._executor.execute(
                        resp, {self._rank: es})[self._rank]]
                results = [(e, out) for es, os_ in zip(groups, outs)
                           for e, out in zip(es, os_)]
                # callbacks BEFORE mark_done: an in-place copy-back must be
                # visible by the time synchronize() returns
                for e, out in results:
                    self._fire_callback(e, True, out)
                done = None
                if self._stream is not None:
                    done = torch.cuda.Event()
                    done.record(self._stream)
        except Exception as exc:  # surface execution errors on every handle
            msg = f"{type(exc).__name__}: {exc}"
            logger.error("collective %s failed: %s", names, msg)
            for es in groups:
                for e in es:
                    self._complete(e, False, msg)
            return
        finally:
            for n in names:
                self.controller.timeline_op_end(n)
        self.responses_performed += len(items)
        for e, out in results:
            if done is not None:
                self._done_events[e.handle] = done
            with self._lock:
                self._inflight.discard(e.tensor_name)
            self.handles.mark_done(e.handle, True, result=out)
