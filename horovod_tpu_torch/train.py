"""Synthetic data-parallel training: the port's main path (the loop of the
reference's ``bench.py``).

Synthetic ImageNet-shaped images from ``RandomState(0)`` and labels from
``RandomState(1)`` form a global batch of ``batch * size()`` samples; rank r
trains on its ``batch``-sized shard. SGD (lr 0.01, momentum 0.9) is wrapped
in :func:`DistributedOptimizer`; the loss is softmax cross-entropy. On the
card the forward runs under bf16 autocast with f32 parameters, in
channels_last.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import basics
from .models import resnet
from .ops import compression as comp
from .ops import cuda_kernels as ck
from .optim.broadcast import broadcast_parameters
from .optim.distributed import DistributedOptimizer


def params_sha256(model: torch.nn.Module) -> str:
    """sha256 over the parameters' bytes in name order (buffers such as BN
    running statistics are rank-local and left out)."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def synthetic_batch(batch: int, image: int, num_classes: int, rank: int,
                    world: int):
    """This rank's shard of the seeded global batch: NHWC f32 images and
    int64 labels, as numpy arrays."""
    total = batch * world
    images = np.random.RandomState(0).randn(total, image, image, 3).astype(
        np.float32)
    labels = np.random.RandomState(1).randint(0, num_classes, (total,))
    sl = slice(rank * batch, (rank + 1) * batch)
    return images[sl], labels[sl].astype(np.int64)


def synthetic_train(model: str = "ResNet50", batch: int = 32,
                    image: int = 224, steps: int = 5, warmup: int = 2,
                    compression="int8", error_feedback: bool = True,
                    device: Optional[str] = None, num_classes: int = 1000,
                    seed: int = 0) -> dict:
    """Train ``model`` for ``warmup + steps`` steps on synthetic data.

    Initializes the framework on ``device`` if it is not initialized yet.
    Returns ``losses`` (every step's), ``images_per_sec`` (this rank, timed
    steps only), ``launches`` (kernel launches of this call, per wrapper),
    ``device``, ``peak_memory_bytes`` (CUDA only, else None) and
    ``params_sha256``.
    """
    basics.init(device=device)
    dev = basics.device()
    rank, world = basics.rank(), basics.size()
    on_cuda = dev.type == "cuda"
    compressor = (comp.by_name(compression) if isinstance(compression, str)
                  else compression)
    net = getattr(resnet, model)(num_classes=num_classes, seed=seed).to(dev)
    if on_cuda:
        net = net.to(memory_format=torch.channels_last)
    broadcast_parameters(net.state_dict(), root_rank=0)
    images, labels = synthetic_batch(batch, image, num_classes, rank, world)
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(labels).to(dev)
    opt = DistributedOptimizer(
        torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9),
        named_parameters=net.named_parameters(), compression=compressor,
        error_feedback=error_feedback)

    def step():
        opt.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=on_cuda):
            logits = net(x)
        loss = F.cross_entropy(logits.float(), y)
        loss.backward()
        opt.step()
        return loss.detach()

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    before = ck.launch_counts()
    net.train()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [step() for _ in range(warmup)]
    sync()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    sync()
    elapsed = time.perf_counter() - t0
    after = ck.launch_counts()
    return {
        "losses": [float(v) for v in losses],
        "images_per_sec": batch * steps / elapsed if steps else None,
        "launches": {k: after[k] - before[k] for k in after},
        "device": str(dev),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_cuda else None),
        "params_sha256": params_sha256(net),
        "gradient_leaves": sum(1 for p in net.parameters()
                               if p.requires_grad),
    }
