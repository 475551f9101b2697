"""Error types of the framework (a copy of ``horovod_tpu/exceptions.py``,
so that the port imports nothing of the reference).

Reference parity: the C++ `Status` model (`horovod/common/common.h:150-250`) carries
OK / UNKNOWN_ERROR / PRECONDITION_ERROR / ABORTED / INVALID_ARGUMENT / IN_PROGRESS.
Here those surface as Python exceptions raised from `synchronize()` on a handle,
matching the framework bindings' behavior (`horovod/torch/mpi_ops.py:476-492`).
"""


class HorovodError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodError):
    """An error reported by the collective engine (negotiation or execution).

    Mirrors coordinator-constructed ERROR responses
    (`horovod/common/controller.cc:358-534`).
    """


class DuplicateNameError(HorovodInternalError):
    """A rank enqueued two tensors with the same name before completion.

    Mirrors DUPLICATE_NAME_ERROR (`horovod/common/common.h:160-163`).
    """


class ShutdownError(HorovodInternalError):
    """Collective enqueued after engine shutdown.

    Mirrors SHUT_DOWN_ERROR (`horovod/common/common.h:155-158`,
    `operations.cc:824-826`). Subclasses HorovodInternalError so generic
    ``except HorovodInternalError`` handlers around ``synchronize()`` match.
    """


class RanksChangedError(HorovodInternalError):
    """Cluster membership changed under an in-flight collective.

    Raised from ``synchronize()`` when the coordinator bumped the membership
    epoch (a worker was lost or admitted) while this collective was pending.
    Elastic training loops (``horovod_tpu.elastic.run_fn``) catch this, restore the
    last committed state, ``sync()`` from the lowest surviving rank and
    resume; non-elastic callers see it as a fatal engine error. Mirrors
    later-horovod's ``HorovodInternalError`` recovery contract
    (`horovod/common/elastic.py`).
    """


class WorkerLostError(RanksChangedError):
    """Membership changed because a worker dropped its control-plane
    connection (crash, preemption, kill) — as opposed to a planned
    join/resize. Subclasses RanksChangedError so one handler covers both.
    """


class NotInitializedError(HorovodError):
    """API used before ``init()`` was called.

    Mirrors `horovod/common/operations.cc:660-663` (NOT_INITIALIZED_ERROR).
    """


class NonFiniteError(HorovodInternalError):
    """A gradient (or allreduce input) contained NaN/Inf under
    ``HOROVOD_GRAD_GUARD=abort`` (docs/fault-tolerance.md, data-plane
    integrity). The message names the offending tensors, the ranks that
    produced them and the optimizer step."""


class ParameterDesyncError(HorovodInternalError):
    """Replica parameters diverged across ranks and the consistency
    auditor runs under ``HOROVOD_CONSISTENCY_POLICY=abort``. The message
    lists the divergent tensors and the ranks whose digests differ from
    the root's (docs/fault-tolerance.md)."""


class CollectiveTimeoutError(HorovodInternalError):
    """A collective stalled past ``HOROVOD_COLLECTIVE_TIMEOUT``: some
    ranks submitted the tensor and the remainder never arrived. Raised
    from ``synchronize()`` on the ranks that did submit, naming the
    tensor and the missing ranks — the enforced form of the stall
    inspector's warning (stall_inspector.h:75)."""
