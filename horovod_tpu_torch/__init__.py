"""horovod_tpu_torch: the PyTorch / CUDA port of horovod_tpu for NVIDIA
Hopper GPUs.

Synchronous data-parallel training: ``init`` joins the ranks, gradients are
averaged by an allreduce (optionally on the int8 / int4 quantized wire, whose
kernels are CUDA C++ in ``csrc/``), and ``DistributedOptimizer`` takes the
step. Imports ``torch`` and never ``jax`` or ``horovod_tpu``.

    import horovod_tpu_torch as hvd
    hvd.init()                       # this rank's card; init(device="cpu")
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8, error_feedback=True)
"""

from .basics import (Average, Sum, backend, cross_rank, cross_size, device,
                     init, is_initialized, local_rank, local_size, rank,
                     shutdown, size)
from .exceptions import HorovodError, HorovodInternalError, NotInitializedError
from .ops.collective_ops import allgather, allreduce, broadcast
from .ops.compression import Compression
from .optim.broadcast import broadcast_optimizer_state, broadcast_parameters
from .optim.distributed import DistributedOptimizer

__all__ = [
    "Average", "Sum", "Compression", "DistributedOptimizer",
    "HorovodError", "HorovodInternalError", "NotInitializedError",
    "allgather", "allreduce", "backend", "broadcast",
    "broadcast_optimizer_state", "broadcast_parameters", "cross_rank",
    "cross_size", "device", "init", "is_initialized", "local_rank",
    "local_size", "rank", "shutdown", "size",
]
