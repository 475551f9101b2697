"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu for NVIDIA
Hopper GPUs.

Synchronous data-parallel training: ``init`` joins the ranks, gradients are
averaged by an allreduce (optionally on the int8 / int4 quantized wire), and
``DistributedOptimizer`` takes the step -- or, with ``op=Adasum``, combines
the local updates with the Adasum rule. The collectives go through a
background engine (``runtime/engine.py``) with async handles
(``allreduce_async``, ``poll``, ``synchronize``). The kernels are CUDA C++
in ``csrc/``. ``spmd`` holds the compiled data-parallel plane
(``spmd.make_train_step``: one CUDA graph a step at world 1, the quantized
ring / tree / two-level allreduces, ZeRO-1) and the in-step primitives.
Imports ``torch`` and never ``jax`` or ``horovod_tpu``.

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
                     ddl_built, device, gloo_built, gloo_enabled, init,
                     is_homogeneous, is_initialized, local_rank, local_size,
                     mlsl_built, mpi_built, mpi_enabled,
                     mpi_threads_supported, nccl_built, rank,
                     register_shutdown_hook, shutdown, size, xla_built)
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
    "cross_rank", "cross_size", "ddl_built", "device", "gloo_built",
    "gloo_enabled", "init", "is_homogeneous", "is_initialized", "join",
    "local_rank", "local_size", "mlsl_built", "mpi_built", "mpi_enabled",
    "mpi_threads_supported", "nccl_built", "poll", "rank",
    "register_shutdown_hook", "shutdown", "size", "spmd", "synchronize",
    "xla_built",
]
