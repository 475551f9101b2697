"""Parameters of the Flax ResNet (``horovod_tpu/models/resnet.py``) as a
``state_dict`` of :mod:`.resnet`.

Takes nested dicts of numpy arrays, so it needs no JAX: the caller turns its
Flax variables into numpy first (``jax.tree_util.tree_map(np.asarray, ...)``).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_BLOCK = re.compile(r"^(?:BottleneckBlock|BasicBlock)_(\d+)$")
_LAYER = {"Conv": "conv", "BatchNorm": "bn"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}


def _module_name(flax_name: str) -> str:
    """Flax auto-name of a block's layer -> the torch attribute."""
    if flax_name in ("conv_proj", "norm_proj"):
        return flax_name
    kind, _, idx = flax_name.rpartition("_")
    if kind not in _LAYER or not idx.isdigit():
        raise KeyError(f"unknown Flax layer {flax_name!r}")
    return f"{_LAYER[kind]}{idx}"


def _tensor(leaf: str, arr) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if leaf == "kernel" and a.ndim == 4:      # HWIO -> OIHW
        a = a.transpose(3, 2, 0, 1)
    elif leaf == "kernel" and a.ndim == 2:    # Dense [in, out] -> [out, in]
        a = a.T
    return torch.tensor(np.ascontiguousarray(a))


def _leaf_name(leaf: str) -> str:
    return "weight" if leaf == "kernel" else _BN[leaf]


def resnet_state_dict_from_flax(params: Dict, batch_stats: Dict) -> Dict:
    """``params`` / ``batch_stats``: the Flax ResNet's collections as nested
    dicts of numpy arrays. Returns a ``state_dict`` for the torch ResNet of
    the same depth and width."""
    out = {}

    def put(prefix: str, leaves: Dict) -> None:
        for leaf, arr in leaves.items():
            out[f"{prefix}.{_leaf_name(leaf)}"] = _tensor(leaf, arr)

    for tree in (params, batch_stats):
        for top, sub in tree.items():
            m = _BLOCK.match(top)
            if m:
                for layer, leaves in sub.items():
                    put(f"blocks.{m.group(1)}.{_module_name(layer)}", leaves)
            elif top in ("conv_init", "bn_init"):
                put(top, sub)
            elif top == "Dense_0":
                for leaf, arr in sub.items():
                    key = "fc.weight" if leaf == "kernel" else "fc.bias"
                    out[key] = _tensor(leaf, arr)
            else:
                raise KeyError(f"unknown Flax module {top!r}")
    return out
