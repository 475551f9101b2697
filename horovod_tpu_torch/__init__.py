"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu for NVIDIA
Hopper GPUs.

Synchronous data-parallel training: ``init`` joins the ranks, gradients are
averaged by an allreduce (optionally on the int8 / int4 quantized wire), and
``DistributedOptimizer`` takes the step -- or, with ``op=Adasum``, combines
the local updates with the Adasum rule. The collectives go through a
background engine (``runtime/engine.py``) with async handles
(``allreduce_async``, ``poll``, ``synchronize``). The kernels are CUDA C++
in ``csrc/``. ``spmd`` holds the in-step primitives. Imports ``torch`` and
never ``jax`` or ``horovod_tpu``.

    import horovod_tpu_torch as hvd
    hvd.init()                       # this rank's card; init(device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8, error_feedback=True)
    # or op=hvd.Adasum (a power-of-2 world), compression none or fp16
"""

from . import spmd
from .basics import (Adasum, Average, Sum, backend, cross_rank, cross_size,
                     device, init, is_initialized, local_rank, local_size,
                     rank, shutdown, size)
from .exceptions import (DuplicateNameError, HorovodError,
                         HorovodInternalError, NotInitializedError)
from .ops.collective_ops import (allgather, allgather_async, allreduce,
                                 allreduce_, allreduce_async,
                                 allreduce_async_, alltoall, broadcast,
                                 broadcast_, broadcast_async,
                                 broadcast_async_, join, poll, synchronize)
from .ops.compression import Compression
from .optim.broadcast import broadcast_optimizer_state, broadcast_parameters
from .optim.distributed import DistributedOptimizer

__all__ = [
    "Adasum", "Average", "Sum", "Compression", "DistributedOptimizer",
    "DuplicateNameError", "HorovodError", "HorovodInternalError",
    "NotInitializedError", "allgather", "allgather_async", "allreduce",
    "allreduce_", "allreduce_async", "allreduce_async_", "alltoall",
    "backend", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "broadcast_optimizer_state", "broadcast_parameters",
    "cross_rank", "cross_size", "device", "init", "is_initialized", "join",
    "local_rank", "local_size", "poll", "rank", "shutdown", "size", "spmd",
    "synchronize",
]
