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
"""Monotonic trace clock (the part of ``horovod_tpu/tracing/clock.py``
that the timeline uses).

All trace timestamps are microseconds in a timebase anchored once per
process: wall-clock at import plus a ``time.perf_counter_ns`` delta.
Because the delta is monotonic, timestamps can never go backwards even
if the system wall clock steps (NTP slew, manual adjustment) -- the wall
origin only fixes the epoch so traces from different processes land in
the same ballpark. The reference's rank-0 offset handshake comes with the
cross-rank tracing, which is not ported; ``trace_us`` is ``local_us``.
"""

import time

# Anchored once at import; everything after is pure perf_counter deltas.
_PERF_ORIGIN_NS = time.perf_counter_ns()
_WALL_ORIGIN_US = int(time.time() * 1e6)


def local_us() -> int:
    """Monotonic microseconds in this process's local timebase."""
    return _WALL_ORIGIN_US + (time.perf_counter_ns() - _PERF_ORIGIN_NS) // 1000


def trace_us() -> int:
    """Monotonic microseconds of the trace timeline."""
    return local_us()
