"""Inception V3 as ``nn.Module``s (counterpart of
``horovod_tpu/models/inception.py``, the reference's headline scaling
model).

Layer for layer the Flax model: the stem, 3 x ``InceptionA``,
``ReductionA``, 4 x ``InceptionB``, ``ReductionB``, 2 x ``InceptionC``, the
global mean and a dense head, each conv a ``ConvBN`` (a bias-free conv,
BatchNorm at momentum 0.9 and eps 1e-3, ReLU). Submodules carry Flax's
auto-names (``ConvBN_0``, ``InceptionA_1``, ``Dense_0``, ...) and a
``ConvBN`` holds ``conv`` and ``bn`` (Flax's ``Conv_0`` / ``BatchNorm_0``),
so ``inception_state_dict_from_flax`` is a rename. ``forward`` takes NHWC
and permutes to NCHW strides inside (channels_last on a contiguous NHWC
input). The 3x3 stride-1 ``'SAME'`` average pool counts the zero padding,
as Flax's ``avg_pool`` does by default; max-pools are ``'VALID'`` (torch's
floor mode). f32 logits.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import BatchNorm, Conv, lecun_normal_


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k, stride=1,
                 padding: str = "SAME"):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, padding)
        self.bn = BatchNorm(cout, momentum=0.9, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class _Tower(nn.Module):
    """A block whose convs are ``ConvBN_<i>`` in Flax's creation order;
    ``specs`` are ``(cin, cout, kernel, stride, padding)``."""

    def __init__(self, specs: Sequence[tuple]):
        super().__init__()
        for i, spec in enumerate(specs):
            self.add_module(f"ConvBN_{i}", ConvBN(*spec))

    def c(self, i: int) -> ConvBN:
        return getattr(self, f"ConvBN_{i}")


class InceptionA(_Tower):
    def __init__(self, cin: int, pool_features: int):
        super().__init__([(cin, 64, 1), (cin, 48, 1), (48, 64, 5),
                          (cin, 64, 1), (64, 96, 3), (96, 96, 3),
                          (cin, pool_features, 1)])
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        c = self.c
        b1 = c(0)(x)
        b5 = c(2)(c(1)(x))
        b3 = c(5)(c(4)(c(3)(x)))
        bp = c(6)(_avg_pool_same(x))
        return torch.cat([b1, b5, b3, bp], 1)


class ReductionA(_Tower):
    def __init__(self, cin: int):
        super().__init__([(cin, 384, 3, 2, "VALID"), (cin, 64, 1),
                          (64, 96, 3), (96, 96, 3, 2, "VALID")])
        self.out_channels = 384 + 96 + cin

    def forward(self, x):
        c = self.c
        b3 = c(0)(x)
        bd = c(3)(c(2)(c(1)(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionB(_Tower):
    def __init__(self, cin: int, channels_7x7: int):
        n = channels_7x7
        super().__init__([(cin, 192, 1), (cin, n, 1), (n, n, (1, 7)),
                          (n, 192, (7, 1)), (cin, n, 1), (n, n, (7, 1)),
                          (n, n, (1, 7)), (n, n, (7, 1)), (n, 192, (1, 7)),
                          (cin, 192, 1)])
        self.out_channels = 4 * 192

    def forward(self, x):
        c = self.c
        b1 = c(0)(x)
        b7 = c(3)(c(2)(c(1)(x)))
        b77 = c(8)(c(7)(c(6)(c(5)(c(4)(x)))))
        bp = c(9)(_avg_pool_same(x))
        return torch.cat([b1, b7, b77, bp], 1)


class ReductionB(_Tower):
    def __init__(self, cin: int):
        super().__init__([(cin, 192, 1), (192, 320, 3, 2, "VALID"),
                          (cin, 192, 1), (192, 192, (1, 7)),
                          (192, 192, (7, 1)), (192, 192, 3, 2, "VALID")])
        self.out_channels = 320 + 192 + cin

    def forward(self, x):
        c = self.c
        b3 = c(1)(c(0)(x))
        b7 = c(5)(c(4)(c(3)(c(2)(x))))
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionC(_Tower):
    def __init__(self, cin: int):
        super().__init__([(cin, 320, 1), (cin, 384, 1), (384, 384, (1, 3)),
                          (384, 384, (3, 1)), (cin, 448, 1), (448, 384, 3),
                          (384, 384, (1, 3)), (384, 384, (3, 1)),
                          (cin, 192, 1)])
        self.out_channels = 320 + 4 * 384 + 192

    def forward(self, x):
        c = self.c
        b1 = c(0)(x)
        b3 = c(1)(x)
        bd = c(5)(c(4)(x))
        bp = c(8)(_avg_pool_same(x))
        return torch.cat([b1, c(2)(b3), c(3)(b3), c(6)(bd), c(7)(bd), bp],
                         1)


class InceptionV3(nn.Module):
    """``forward(x)``: ``x`` is NHWC float (299 x 299 for ImageNet; any
    size from 75 up), the result f32 logits. Weights are LeCun-normal from
    ``seed``; BN scales one, biases zero."""

    def __init__(self, num_classes: int = 1000, seed: int = 0,
                 in_channels: int = 3):
        super().__init__()
        stem = [(in_channels, 32, 3, 2, "VALID"), (32, 32, 3, 1, "VALID"),
                (32, 64, 3), (64, 80, 1, 1, "VALID"),
                (80, 192, 3, 1, "VALID")]
        for i, spec in enumerate(stem):
            self.add_module(f"ConvBN_{i}", ConvBN(*spec))
        blocks, cin = [], 192
        for kind, arg in (("A", 32), ("A", 64), ("A", 64), ("RA", None),
                          ("B", 128), ("B", 160), ("B", 160), ("B", 192),
                          ("RB", None), ("C", None), ("C", None)):
            block = {"A": lambda: InceptionA(cin, arg),
                     "RA": lambda: ReductionA(cin),
                     "B": lambda: InceptionB(cin, arg),
                     "RB": lambda: ReductionB(cin),
                     "C": lambda: InceptionC(cin)}[kind]()
            blocks.append(block)
            cin = block.out_channels
        counts: dict = {}
        self.towers = []
        for block in blocks:
            name = type(block).__name__
            idx = counts.get(name, 0)
            counts[name] = idx + 1
            self.add_module(f"{name}_{idx}", block)
            self.towers.append(f"{name}_{idx}")
        self.Dense_0 = nn.Linear(cin, num_classes)
        lecun_normal_(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last strides
        c = [getattr(self, f"ConvBN_{i}") for i in range(5)]
        x = c[2](c[1](c[0](x)))
        x = _max_pool(x)
        x = _max_pool(c[4](c[3](x)))
        for name in self.towers:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x).float()
