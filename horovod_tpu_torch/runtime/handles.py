"""Async operation handles.

Reference parity: `horovod/torch/handle_manager.{h,cc}` (a copy of
``horovod_tpu/runtime/handles.py``) — integer handles
allocated at enqueue; completion marks status + result; ``synchronize`` blocks,
``poll`` is non-blocking (`torch/mpi_ops.py:460-509`).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from ..exceptions import HorovodInternalError


class _HandleEntry:
    __slots__ = ("event", "ok", "result", "error", "error_cls")

    def __init__(self):
        self.event = threading.Event()
        self.ok = False
        self.result = None
        self.error: Optional[str] = None
        self.error_cls = HorovodInternalError


class HandleManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._entries: Dict[int, _HandleEntry] = {}

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._entries[h] = _HandleEntry()
            return h

    def mark_done(self, handle: int, ok: bool, result: Any = None,
                  error: Optional[str] = None,
                  error_cls=HorovodInternalError) -> None:
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            return
        e.ok = ok
        e.result = result
        e.error = error
        e.error_cls = error_cls
        e.event.set()

    def poll(self, handle: int) -> bool:
        with self._lock:
            e = self._entries.get(handle)
        return e is not None and e.event.is_set()

    def synchronize(self, handle: int, timeout: Optional[float] = None) -> Any:
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            raise HorovodInternalError(f"unknown handle {handle}")
        if not e.event.wait(timeout):
            raise HorovodInternalError(f"timeout waiting for handle {handle}")
        with self._lock:
            self._entries.pop(handle, None)
        if not e.ok:
            raise e.error_cls(e.error or "collective failed")
        return e.result
