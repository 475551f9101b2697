# Copyright 2018 Uber Technologies, Inc. All Rights Reserved.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or
# implied. See the License for the specific language governing
# permissions and limitations under the License.
# ==============================================================================
"""Chrome-trace output: the streaming event writer (the part of
``horovod_tpu/tracing/writer.py`` that the timeline uses).

``ChromeTraceWriter`` is a queue-fed writer thread; the timeline
(:class:`horovod_tpu_torch.utils.timeline.Timeline`) holds one of these.
"""

import json
import queue
import threading


class ChromeTraceWriter:
    """Streaming Chrome-trace array writer fed through a queue.

    Keeps the file one valid JSON array at all times once :meth:`close`
    appends ``]`` (comma before every event after the first); batches the
    flush to queue-empty boundaries to keep the hot path off the disk.
    """

    def __init__(self, path):
        self._q = queue.Queue()
        self._wrote_event = False
        self._f = open(path, "w")
        self._f.write("[\n")
        self._thread = threading.Thread(
            target=self._loop, name="hvd_torch_trace_writer", daemon=True)
        self._thread.start()

    def emit(self, ev: dict) -> None:
        self._q.put(ev)

    def _loop(self) -> None:
        while True:
            ev = self._q.get()
            if ev is None:
                return
            while True:
                if self._wrote_event:
                    self._f.write(",\n")
                self._f.write(json.dumps(ev))
                self._wrote_event = True
                try:
                    ev = self._q.get_nowait()
                except queue.Empty:
                    break
                if ev is None:
                    self._f.flush()
                    return
            self._f.flush()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=2)
        # the writer never leaves a trailing comma, so closing the array
        # yields strictly valid Chrome-trace JSON ("[]" when no events fired)
        self._f.write("\n]\n")
        self._f.close()
