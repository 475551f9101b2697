"""Request/Response value types for the collective engine.

Reference parity: `horovod/common/message.{h,cc}` — Request (what one rank wants
done with one named tensor) and Response (what the coordinator decided a tick
should execute, possibly fused over several names). The reference serializes
these with FlatBuffers (`wire/message.fbs`); here the engine passes them as
objects. (A copy of ``horovod_tpu/runtime/messages.py``: ``TensorTableEntry.
array`` holds a torch tensor; the control-plane frame and the metrics report
wait for the cross-process control plane and the metrics registry.)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple


class RequestType(enum.IntEnum):
    # Parity: message.h:48-49 (ALLREDUCE/ALLGATHER/BROADCAST/JOIN/ADASUM).
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5  # extension (north-star op set)


class ResponseType(enum.IntEnum):
    # Parity: message.h:133-134 (response adds ERROR).
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    ERROR = 6


class AlltoallvResult(NamedTuple):
    """Result of a ragged ``alltoall(tensor, splits)``: the gathered output
    plus the negotiated per-source row counts (later-horovod's
    ``(output, received_splits)`` return shape). Produced by the executor,
    carried through the handle manager; framework surfaces unwrap it."""

    output: Any
    received_splits: Tuple[int, ...]


@dataclass
class Request:
    """One rank's intent for one named tensor (message.h Request)."""

    request_rank: int
    request_type: RequestType
    tensor_name: str
    tensor_dtype: str
    tensor_shape: Tuple[int, ...]
    root_rank: int = -1  # broadcast only
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0


@dataclass
class Response:
    """Coordinator decision for a tick; may cover several fused names
    (controller.cc:626-750 FuseResponses)."""

    response_type: ResponseType
    tensor_names: List[str] = field(default_factory=list)
    error_message: str = ""
    # devices involved; informational (common.h Response devices field)
    devices: List[int] = field(default_factory=list)
    # allgather: per-rank dim0 sizes per tensor (tensor_sizes in reference)
    tensor_sizes: List[List[int]] = field(default_factory=list)
    # allreduce: divide the sum by world size (Average op); the reference does
    # this division in-framework (`tensorflow/__init__.py:117`) — here it fuses
    # into the compiled collective.
    average: bool = False
    prescale: float = 1.0
    postscale: float = 1.0
    root_rank: int = -1
    # Metadata the cross-process plane negotiates so a rank can participate in
    # a collective it has no local entries for (joined ranks contribute zeros,
    # `controller.cc:202-256`) and so ragged allgathers know every rank's dim0
    # (Response::tensor_sizes in the reference):
    tensor_dtype: str = ""
    # per-tensor shape of the rank-0 instance (allgather: dim0 is rank 0's;
    # use tensor_sizes for the negotiated per-rank dim0s)
    tensor_shapes: List[Tuple[int, ...]] = field(default_factory=list)
    # negotiated wire compression for the fused bucket ("" = none, "int8",
    # "int8-dcn"): the coordinator's decision every rank compiles against,
    # so the quantize→collective→dequantize programs match across ranks
    compression: str = ""
    # membership epoch the decision was negotiated under (-1 = non-elastic);
    # executing a response against a different epoch means a rank set change
    # raced this tick, and the executor must fail fast instead of exchanging
    # data with a stale member set (docs/elastic.md)
    epoch: int = -1
    # straggler policy (runtime/straggler.py): ranks whose contribution is
    # ABSENT from this collective — the executor zero-fills their slots, so
    # an averaging engine must divide by world - len(excluded_ranks) instead
    # of world. In-memory only (set by the in-process controllers); the
    # cross-process plane carries exclusion in the ResponseList tail and
    # corrects the average via the data plane's participant count.
    excluded_ranks: Optional[List[int]] = None


@dataclass
class TensorTableEntry:
    """Pending named tensor from one rank (`common.h:129-250` TensorTableEntry).

    ``array`` is a torch tensor on the rank's device; ``callback``
    receives (status_ok, result_or_error). ``ready`` is the CUDA event
    recorded on the enqueuing thread's current stream after the tensor's
    producer (None on the CPU): the engine's stream waits on it before it
    reads the tensor. ``parts`` (Adasum only) are the element counts of a
    client-built bucket's members, each combined with its own
    coefficients. ``batch`` numbers the ``Engine.batch()`` the entry was
    enqueued in (None: none); the engine sets it.
    """

    tensor_name: str
    rank: int
    request_type: RequestType
    array: Any
    root_rank: int = -1
    callback: Optional[Any] = None
    handle: Optional[int] = None
    enqueue_seq: int = 0
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    average: bool = False  # Average op: fused divide-by-size
    # alltoall splits (extension)
    splits: Optional[Any] = None
    # requested wire compression ("" = none; see Response.compression)
    compression: str = ""
    # False = this entry is already a client-built bucket (backward-pass
    # bucket overlap, optim/distributed.py): the controller must not merge
    # it with other tensors — re-fusing hand-made buckets would serialize
    # the wire behind the last bucket and erase the overlap. The flag is
    # rank-local but set deterministically by the same client code on every
    # rank, so enforcement decisions resolve identically everywhere; planes
    # whose wire/ABI cannot carry it (native tick frames, coordinator
    # Requests) are backstopped by the engine's response split.
    fusable: bool = True
    ready: Optional[Any] = None
    parts: Optional[Tuple[int, ...]] = None
    batch: Optional[int] = None
