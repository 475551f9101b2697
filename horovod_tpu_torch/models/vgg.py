"""VGG-16 / 19 as ``nn.Module``s (counterpart of
``horovod_tpu/models/vgg.py``, the hard-scaling model of the reference's
table: 138M parameters, a 102.76M-element first dense kernel).

Layer for layer the Flax model, so that its parameters convert
(``models/convert.py``, ``vgg_state_dict_from_flax``):

* ``forward`` takes NHWC and permutes to NCHW strides inside (channels_last
  on a contiguous NHWC input);
* 3x3 convs with a bias (Flax ``'SAME'``), ReLU, 2x2 max-pool with stride 2
  (``'VALID'``);
* the flatten runs in Flax's NHWC order, ``(h, w, c)``: the first dense
  layer's inputs are ``x.permute(0, 2, 3, 1).flatten(1)`` (a free view on a
  channels_last tensor), so its weight is the Flax kernel transposed and
  nothing else;
* two 4096-wide dense layers, each followed by ReLU and dropout, then the
  classifier; f32 logits.

The flatten's width depends on the input size, so the model is built for
one ``image_size`` (224 by default: 7 x 7 x 512 = 25,088 inputs).
"""

from __future__ import annotations

from typing import Dict, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv, lecun_normal_

_CFG = {
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"],
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
         512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


class DropoutRNG:
    """The dropout masks' generators of one model: one ``torch.Generator``
    a device, made at first use and seeded from ``seed``, so a seed gives
    the same masks run after run (their bits are the device's: a CPU and a
    CUDA generator draw different streams)."""

    def __init__(self, seed: int):
        self.seed = int(seed)
        self._gens: Dict[torch.device, torch.Generator] = {}

    def get(self, device: torch.device) -> torch.Generator:
        gen = self._gens.get(device)
        if gen is None:
            gen = torch.Generator(device).manual_seed(self.seed)
            self._gens[device] = gen
        return gen


class Dropout(nn.Module):
    """Flax ``nn.Dropout(rate)``: in training each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask
    drawn from ``rng``; the identity in eval or at rate 0. A CUDA-graph
    capture cannot replay the masks of a generator it does not own, so a
    capture through an active dropout raises."""

    def __init__(self, rate: float, rng: DropoutRNG):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate {rate} outside [0, 1)")
        self.rate, self.rng = float(rate), rng

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("dropout draws its masks from the model's "
                               "own generator, which a CUDA graph cannot "
                               "replay: build the model with dropout 0 for "
                               "a graphed step")
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, device=x.device,
                          generator=self.rng.get(x.device)) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class VGG(nn.Module):
    """``forward(x)``: ``x`` is NHWC float of ``image_size`` squared, the
    result f32 logits. ``cfg``: conv widths and ``"M"`` (a max-pool).
    Weights are LeCun-normal from ``seed`` (biases zero); dropout masks
    come from the model's :class:`DropoutRNG`, also seeded by ``seed``."""

    def __init__(self, cfg: Sequence[Union[int, str]],
                 num_classes: int = 1000, dropout: float = 0.5,
                 seed: int = 0, image_size: int = 224,
                 in_channels: int = 3):
        super().__init__()
        self.cfg = list(cfg)
        convs, cin, side = [], in_channels, image_size
        for v in self.cfg:
            if v == "M":
                side //= 2
            else:
                convs.append(Conv(cin, int(v), 3, bias=True))
                cin = int(v)
        if side < 1:
            raise ValueError(f"image_size {image_size} is too small for "
                             f"{self.cfg.count('M')} pools")
        self.convs = nn.ModuleList(convs)
        self.rng = DropoutRNG(seed)
        widths = [side * side * cin, 4096, 4096, num_classes]
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(widths, widths[1:]))
        self.drops = nn.ModuleList(Dropout(dropout, self.rng)
                                   for _ in range(2))
        lecun_normal_(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view, channels_last strides
        convs = iter(self.convs)
        for v in self.cfg:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(next(convs)(x))
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax's (h, w, c) order
        for dense, drop in zip(self.dense, self.drops):
            x = drop(F.relu(dense(x)))
        return self.dense[-1](x).float()


def VGG16(**kw):
    return VGG(_CFG[16], **kw)


def VGG19(**kw):
    return VGG(_CFG[19], **kw)
