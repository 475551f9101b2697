"""ResNet v1.5 family as ``nn.Module``s (counterpart of
``horovod_tpu/models/resnet.py``, the benchmark model).

Matches the Flax model layer for layer, so that its parameters convert
(`models/convert.py`) and its logits agree:

* the public ``forward`` takes NHWC like the Flax model and permutes to
  NCHW strides inside, which on a contiguous NHWC input is channels_last;
* v1.5 stride placement (on the 3x3 conv); Flax ``'SAME'`` padding computed
  per input size -- a stride-2 3x3 conv on an even input pads (0, 1), not
  torch's symmetric (1, 1);
* BatchNorm with momentum 0.9 (torch's ``momentum=0.1``) and eps 1e-5; the
  running variance is updated with the *biased* batch variance, as Flax does
  (``F.batch_norm`` would use the unbiased one), so the update is computed
  here;
* the last BN scale of each block starts at zero.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Bias-free conv with Flax ``'SAME'`` padding (or an explicit one)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.padding = k, stride, padding

    def forward(self, x):
        if self.padding is not None:
            return F.conv2d(x, self.weight, None, self.stride, self.padding)
        top, bottom = _same_pads(x.shape[-2], self.k, self.stride)
        left, right = _same_pads(x.shape[-1], self.k, self.stride)
        if top or bottom or left or right:
            if (top, left) == (bottom, right):
                return F.conv2d(x, self.weight, None, self.stride,
                                (top, left))
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, None, self.stride, 0)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW channels:
    batch statistics in training (biased variance, at least f32), running
    statistics in eval."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c) if zero_scale
                                   else torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.momentum, self.eps = momentum, eps

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            xs = x if x.dtype in (torch.float32, torch.float64) else x.float()
            var, mean = torch.var_mean(xs, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
        return y


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        out = filters * 4
        self.conv0, self.bn0 = Conv(cin, filters, 1), BatchNorm(filters)
        self.conv1 = Conv(filters, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2, self.bn2 = Conv(filters, out, 1), BatchNorm(out, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != out:
            self.conv_proj = Conv(cin, out, 1, stride)
            self.norm_proj = BatchNorm(out)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        r = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(r + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int):
        super().__init__()
        self.conv0 = Conv(cin, filters, 3, stride)
        self.bn0 = BatchNorm(filters)
        self.conv1 = Conv(filters, filters, 3)
        self.bn1 = BatchNorm(filters, zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if stride != 1 or cin != filters:
            self.conv_proj = Conv(cin, filters, 1, stride)
            self.norm_proj = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        r = x if self.conv_proj is None else self.norm_proj(self.conv_proj(x))
        return F.relu(r + y)


class ResNet(nn.Module):
    """``forward(x)``: ``x`` is NHWC float, the result is f32 logits."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 seed: int = 0):
        super().__init__()
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3)
        self.bn_init = BatchNorm(num_filters)
        blocks = []
        cin = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2 ** i, stride))
                cin = num_filters * 2 ** i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.fc = nn.Linear(cin, num_classes)
        self.init_weights(torch.Generator().manual_seed(seed))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """LeCun-normal conv and dense kernels (Flax's default), zero biases;
        BN scales keep their construction values."""
        for m in self.modules():
            if isinstance(m, (Conv, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(1.0 / fan_in))
                if isinstance(m, nn.Linear):
                    m.bias.zero_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last strides
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return self.fc(x).float()


def ResNet18(**kw):
    return ResNet([2, 2, 2, 2], BasicBlock, **kw)


def ResNet34(**kw):
    return ResNet([3, 4, 6, 3], BasicBlock, **kw)


def ResNet50(**kw):
    return ResNet([3, 4, 6, 3], BottleneckBlock, **kw)


def ResNet101(**kw):
    return ResNet([3, 4, 23, 3], BottleneckBlock, **kw)


def ResNet152(**kw):
    return ResNet([3, 8, 36, 3], BottleneckBlock, **kw)
