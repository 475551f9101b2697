"""The MNIST nets of the end-to-end examples as ``nn.Module``s (counterpart
of ``horovod_tpu/models/mnist.py``).

``MNISTConvNet``: conv(32, 3x3) -> ReLU -> conv(64, 3x3) -> ReLU -> 2x2
max-pool -> dropout 0.25 -> dense(128) -> ReLU -> dropout 0.5 ->
dense(classes). The convs have Flax's default ``'SAME'`` padding and a
bias, so a 28x28 input stays 28x28 until the pool; the flatten runs in
Flax's NHWC order, as VGG's does. ``MNISTMLP``: dense(128) -> ReLU ->
dense(classes) over the NHWC input flattened as it lies. Both take NHWC of
``image_size`` squared with ``in_channels`` channels (MNIST's 28 and 1) and
return f32 logits; weights are LeCun-normal from ``seed``, biases zero.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv, lecun_normal_
from .vgg import Dropout, DropoutRNG


class MNISTConvNet(nn.Module):
    def __init__(self, num_classes: int = 10, dropout: Sequence[float] = (
            0.25, 0.5), seed: int = 0, image_size: int = 28,
                 in_channels: int = 1):
        super().__init__()
        self.convs = nn.ModuleList([Conv(in_channels, 32, 3, bias=True),
                                    Conv(32, 64, 3, bias=True)])
        side = image_size // 2
        self.dense = nn.ModuleList([nn.Linear(side * side * 64, 128),
                                    nn.Linear(128, num_classes)])
        self.rng = DropoutRNG(seed)
        self.drops = nn.ModuleList(Dropout(r, self.rng) for r in dropout)
        lecun_normal_(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last strides
        for conv in self.convs:
            x = F.relu(conv(x))
        x = self.drops[0](F.max_pool2d(x, 2, 2))
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's (h, w, c) order
        x = self.drops[1](F.relu(self.dense[0](x)))
        return self.dense[1](x).float()


class MNISTMLP(nn.Module):
    """Small dense net for fast CPU tests."""

    def __init__(self, num_classes: int = 10, seed: int = 0,
                 image_size: int = 28, in_channels: int = 1):
        super().__init__()
        self.dense = nn.ModuleList([
            nn.Linear(image_size * image_size * in_channels, 128),
            nn.Linear(128, num_classes)])
        lecun_normal_(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.dense[1](F.relu(self.dense[0](x))).float()
