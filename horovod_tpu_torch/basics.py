"""Process model and global state (counterpart of ``horovod_tpu/basics.py``).

A rank is one process. Two modes:

* **standalone** -- rank 0 of 1, no process group;
* **multiprocess** -- the launcher's env (``HVD_NUM_PROCS`` > 1,
  ``HVD_PROCESS_ID``, ``HVD_COORDINATOR_ADDR``, ``HVD_LOCAL_RANK/SIZE``,
  ``HVD_CROSS_RANK/SIZE``; `horovod_tpu/run/launcher.py`) names this
  process's place, and a ``torch.distributed`` process group joins the ranks.
  ``HVD_COORDINATOR_ADDR`` is ``host:port`` (a TCP rendezvous) or a
  ``file://`` URL.

The backend is NCCL when every local rank has a card of its own, and gloo
otherwise: on the CPU, or when several ranks share one card (NCCL refuses
two ranks on one GPU). :func:`backend` says which.

Entry points run on the card. They run on the CPU only when the caller asks
(``init(device="cpu")``); with no card and no such request ``init`` raises.

``init`` starts the collective engine (``runtime/engine.py``) and
``shutdown`` stops it. In multiprocess mode the engine gets a process group
of its own, made at ``init`` on every rank, so that collectives issued on
the caller's thread (the parallel paths, ``spmd``) never interleave with
the engine thread's on one group.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from .exceptions import HorovodError, NotInitializedError

# Reduce-op constants, as in horovod_tpu.basics.
Average = 0
Sum = 1
Adasum = 2


@dataclass
class _GlobalState:
    initialized: bool = False
    mode: str = "standalone"  # standalone | multiprocess
    size: int = 1
    rank: int = 0
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    device: Optional[torch.device] = None
    backend: Optional[str] = None  # "nccl" | "gloo" | None (standalone)
    executor: Any = None
    engine: Any = None
    groups: dict = field(default_factory=dict)  # ranks -> process group


_state = _GlobalState()
_init_lock = threading.Lock()


def _resolve_device(device, local_rank: int) -> torch.device:
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodError(
                "horovod_tpu_torch.init: no CUDA device is available; pass "
                "init(device='cpu') to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise HorovodError(f"horovod_tpu_torch.init: unsupported device {dev}")
    return dev


def init(device=None) -> None:
    """Initialize the framework. Idempotent.

    ``device``: ``None`` or ``"cuda"`` (this rank's card, ``cuda:<local
    rank mod card count>``), ``"cuda:<i>"``, or ``"cpu"``.
    """
    global _state
    with _init_lock:
        if _state.initialized:
            return
        nproc = int(os.environ.get("HVD_NUM_PROCS", "1"))
        if nproc > 1:
            pid = int(os.environ["HVD_PROCESS_ID"])
            local_rank = int(os.environ.get("HVD_LOCAL_RANK", 0))
            local_size = int(os.environ.get("HVD_LOCAL_SIZE", 1))
            cross_rank = int(os.environ.get("HVD_CROSS_RANK", pid))
            cross_size = int(os.environ.get("HVD_CROSS_SIZE", nproc))
            dev = _resolve_device(device, local_rank)
            own_card = (dev.type == "cuda"
                        and local_size <= torch.cuda.device_count())
            backend = "nccl" if own_card else "gloo"
            coord = os.environ["HVD_COORDINATOR_ADDR"]
            init_method = coord if "://" in coord else f"tcp://{coord}"
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(backend, init_method=init_method,
                                    rank=pid, world_size=nproc)
            st = _GlobalState(
                initialized=True, mode="multiprocess", size=nproc, rank=pid,
                local_rank=local_rank, local_size=local_size,
                cross_rank=cross_rank, cross_size=cross_size, device=dev,
                backend=backend)
        else:
            dev = _resolve_device(device, 0)
            st = _GlobalState(initialized=True, device=dev)
        from .runtime.engine import Engine

        group = (dist.new_group(list(range(st.size)))
                 if st.mode == "multiprocess" else None)
        st.engine = Engine(st, group)
        st.executor = st.engine._executor
        st.engine.start()
        _state = st


def shutdown() -> None:
    """Stop the engine, tear down the process group (if any) and reset
    state."""
    global _state
    with _init_lock:
        if not _state.initialized:
            return
        _state.engine.shutdown()
        if _state.mode == "multiprocess" and dist.is_initialized():
            dist.destroy_process_group()
        _state = _GlobalState()


def process_group(ranks):
    """The process group of the global ``ranks``, made at its first request
    and kept until ``shutdown``. As with ``dist.new_group``, every rank
    requests every group, in the same order."""
    st = _require_init()
    key = tuple(ranks)
    if key not in st.groups:
        st.groups[key] = dist.new_group(list(key))
    return st.groups[key]


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _GlobalState:
    if not _state.initialized:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized; call init() first.")
    return _state


def rank() -> int:
    return _require_init().rank


def size() -> int:
    return _require_init().size


def local_rank() -> int:
    return _require_init().local_rank


def local_size() -> int:
    return _require_init().local_size


def cross_rank() -> int:
    return _require_init().cross_rank


def cross_size() -> int:
    return _require_init().cross_size


def device() -> torch.device:
    """The device this rank's tensors live on."""
    return _require_init().device


def backend() -> Optional[str]:
    """``"nccl"`` or ``"gloo"`` in multiprocess mode, ``None`` standalone."""
    return _require_init().backend


def _executor():
    return _require_init().executor


def _engine():
    return _require_init().engine
