"""Chrome-tracing timeline profiler.

Reference parity: `horovod/common/timeline.{h,cc}` — per-tensor NEGOTIATE spans,
top-level op spans, and named activities written as Chrome tracing JSON by a
dedicated writer thread fed through a queue (`timeline.h:47-75`). Enabled via
``HOROVOD_TIMELINE=/path.json`` (`operations.cc:389-396`);
``HOROVOD_TIMELINE_MARK_CYCLES=1`` adds engine-tick instant events
(`operations.cc:400`). (A copy of ``horovod_tpu/utils/timeline.py``
without its ``jax.profiler`` helper; device-side detail comes from
``torch.profiler``.)

The Timeline is now a thin adapter over the tracing subsystem's primitives:
the queue-fed writer thread lives in
:class:`horovod_tpu_torch.tracing.writer.ChromeTraceWriter`, and all timestamps
come from :func:`horovod_tpu_torch.tracing.clock.trace_us` — one monotonic
(``time.perf_counter_ns``-anchored) clock for every begin/end pair, so a
span's end can never precede its begin even if the system wall clock steps
between the two (the old ``time.time()`` stamps could go backward under NTP
slew). This file keeps the per-rank activity surface.
"""

from __future__ import annotations

import os
from typing import Optional

from ..tracing import clock as _clock
from ..tracing.writer import ChromeTraceWriter


class Timeline:
    """Host-side span recorder; no-op unless a path is configured."""

    def __init__(self, path: Optional[str]):
        self._path = path
        self._enabled = bool(path)
        self._mark_cycles = os.environ.get(
            "HOROVOD_TIMELINE_MARK_CYCLES", "") in ("1", "true", "True")
        self._tid = {}
        self._next_tid = 1
        self._writer: Optional[ChromeTraceWriter] = None
        if self._enabled:
            self._writer = ChromeTraceWriter(path)

    @property
    def enabled(self) -> bool:
        return self._enabled

    def _emit(self, ev: dict) -> None:
        if self._enabled:
            self._writer.emit(ev)

    def _ts(self) -> int:
        # single monotonic clock for every begin/end pair (shared with the
        # distributed-tracing spans so both land on one timeline)
        return _clock.trace_us()

    def _tensor_tid(self, name: str) -> int:
        t = self._tid.get(name)
        if t is None:
            t = self._next_tid
            self._next_tid += 1
            self._tid[name] = t
            self._emit({"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                        "args": {"name": name}})
        return t

    # span API mirroring Timeline::NegotiateStart/Start/ActivityStart/End
    def negotiate_start(self, name: str, rank: int) -> None:
        if not self._enabled:
            return
        self._emit({"name": f"NEGOTIATE_{name}", "ph": "B", "pid": 0,
                    "tid": self._tensor_tid(name), "ts": self._ts(),
                    "args": {"rank": rank}})

    def op_start(self, name: str, op: str) -> None:
        if not self._enabled:
            return
        tid = self._tensor_tid(name)
        self._emit({"name": f"NEGOTIATE_{name}", "ph": "E", "pid": 0,
                    "tid": tid, "ts": self._ts()})
        self._emit({"name": op, "ph": "B", "pid": 0, "tid": tid,
                    "ts": self._ts()})

    def activity(self, name: str, activity: str) -> None:
        if not self._enabled:
            return
        self._emit({"name": activity, "ph": "i", "pid": 0,
                    "tid": self._tensor_tid(name), "ts": self._ts(), "s": "t"})

    def op_end(self, name: str) -> None:
        if not self._enabled:
            return
        self._emit({"name": "op", "ph": "E", "pid": 0,
                    "tid": self._tensor_tid(name), "ts": self._ts()})

    def cycle_tick(self) -> None:
        if self._enabled and self._mark_cycles:
            self._emit({"name": "CYCLE", "ph": "i", "pid": 0, "tid": 0,
                        "ts": self._ts(), "s": "g"})

    def epoch_marker(self, epoch: int) -> None:
        """Global instant event on every elastic membership epoch change, so a
        trace shows exactly which collectives straddled a reset
        (docs/elastic.md)."""
        if self._enabled:
            self._emit({"name": f"EPOCH_{epoch}", "ph": "i", "pid": 0,
                        "tid": 0, "ts": self._ts(), "s": "g"})

    def cache_counter(self, hits: int, misses: int) -> None:
        """Chrome counter track of response-cache hits/misses (the fast
        path that skips negotiation, reference `controller.cc:171-185`)."""
        if self._enabled:
            self._emit({"name": "response_cache", "ph": "C", "pid": 0,
                        "ts": self._ts(),
                        "args": {"hits": hits, "misses": misses}})

    def close(self) -> None:
        if not self._enabled:
            return
        self._writer.close()
        self._enabled = False

