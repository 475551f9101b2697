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
the engine thread's on one group; with a host grouping
(``HVD_UNIFORM_LOCAL_SIZE``, ``runtime/executor.two_level_size``) also
its own host and cross-host groups, for the two-level programs.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from .exceptions import HorovodError, NotInitializedError
from .utils.env import env_on

logger = logging.getLogger("horovod_tpu_torch")

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
_shutdown_hooks = []

# HOROVOD_LOG_LEVEL's names (the reference's logging.h levels; TRACE and
# FATAL map to the nearest stdlib level)
_LOG_LEVELS = {"TRACE": logging.DEBUG, "DEBUG": logging.DEBUG,
               "INFO": logging.INFO, "WARNING": logging.WARNING,
               "ERROR": logging.ERROR, "FATAL": logging.CRITICAL}


def _setup_logging() -> None:
    """Apply ``HOROVOD_LOG_LEVEL`` / ``HOROVOD_LOG_HIDE_TIME`` to the
    ``horovod_tpu_torch`` logger only (never the root), and give it a
    handler only if neither it nor the root has one (the application's
    logging setup wins)."""
    level = os.environ.get("HOROVOD_LOG_LEVEL", "").upper()
    if level in _LOG_LEVELS:
        logger.setLevel(_LOG_LEVELS[level])
    if logger.handlers or logging.getLogger().handlers:
        return
    handler = logging.StreamHandler()
    fmt = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
    if env_on("HOROVOD_LOG_HIDE_TIME"):
        fmt = "%(levelname)s %(name)s: %(message)s"
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)


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


def init(ranks: Optional[Sequence[int]] = None, *, device=None) -> None:
    """Initialize the framework. Idempotent.

    ``device``: ``None`` or ``"cuda"`` (this rank's card, ``cuda:<local
    rank mod card count>``), ``"cuda:<i>"``, or ``"cpu"``. ``ranks`` is
    accepted for parity with the reference's subset init, which accepts and
    ignores it too: every launched process joins.
    """
    global _state
    with _init_lock:
        if _state.initialized:
            return
        _setup_logging()
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
        from .runtime.executor import two_level_size

        group = two_level = None
        if st.mode == "multiprocess":
            group = dist.new_group(list(range(st.size)))
            ls = two_level_size(st.size, True, st.local_size)
            if ls:
                from .parallel.hierarchical import build_two_level_mesh

                two_level = build_two_level_mesh(st.size, st.rank, ls,
                                                 dist.new_group)
        st.engine = Engine(st, group, two_level)
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
    for fn in _shutdown_hooks:
        try:
            fn()
        except Exception:
            logger.exception("shutdown hook %r failed", fn)


def register_shutdown_hook(fn) -> None:
    """Run ``fn()`` after every ``shutdown`` (per-module cleanup). A hook
    with the same module and qualified name replaces the one registered
    before it, so a reimported module does not pile up copies."""
    key = (getattr(fn, "__module__", None), getattr(fn, "__qualname__", None))
    for i, existing in enumerate(_shutdown_hooks):
        if (getattr(existing, "__module__", None),
                getattr(existing, "__qualname__", None)) == key:
            _shutdown_hooks[i] = fn
            return
    _shutdown_hooks.append(fn)


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


def is_homogeneous() -> bool:
    """Whether every host runs the same number of ranks: the launcher's
    global fact ``HVD_UNIFORM_LOCAL_SIZE`` (0 when hosts hold unequal
    counts; empty counts as unset), True without it (one host)."""
    _require_init()
    uniform = os.environ.get("HVD_UNIFORM_LOCAL_SIZE")
    if uniform:
        try:
            return int(uniform) > 0
        except ValueError:
            raise ValueError(
                f"HVD_UNIFORM_LOCAL_SIZE={uniform!r} is not an integer; "
                "the launcher exports the uniform local size (0 when "
                "hosts hold unequal rank counts)")
    return True


# Build and runtime probes, as the reference's top level exports them. They
# tell the truth about this package: no MPI, no DDL / MLSL, no XLA; NCCL
# and gloo are torch.distributed's backends, built when its build has them.
def mpi_threads_supported() -> bool:
    return False


def mpi_enabled() -> bool:
    """MPI is never the control or data plane here."""
    return False


def gloo_enabled() -> bool:
    """Whether this process runs over gloo (the backend on the CPU or when
    ranks share a card)."""
    return is_initialized() and _state.backend == "gloo"


def mpi_built() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_available() and dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_available() and dist.is_nccl_available()


def ddl_built() -> bool:
    return False


def mlsl_built() -> bool:
    return False


def xla_built() -> bool:
    """No XLA here: the collectives are torch.distributed's and the kernels
    CUDA C++."""
    return False
