"""Parameters of the Flax ResNet (``horovod_tpu/models/resnet.py``), VGG,
Inception V3, MNIST nets and transformer LM (``horovod_tpu/models/``) as a
``state_dict`` of the port's model of the same name; the MoE layer's
(``horovod_tpu/parallel/expert.py``) as the port's functional tree or
``MoEMLP``'s ``state_dict``; stacked pipeline stages as tensors.

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


_LM_BLOCK = re.compile(r"^block_(\d+)$")
_LN = {"scale": "weight", "bias": "bias"}


def transformer_state_dict_from_flax(params: Dict) -> Dict:
    """``params``: the Flax ``TransformerLM``'s params collection as nested
    dicts of numpy arrays (either LayerNorm class: both name their leaves
    ``scale`` / ``bias``). Returns a ``state_dict`` for the torch
    ``TransformerLM`` of the same shape: a Dense kernel ``[in, out]``
    becomes ``weight [out, in]`` with the qkv column order kept; the token
    and position tables pass through."""
    out = {}

    def put(prefix: str, layer: str, leaves: Dict) -> None:
        for leaf, arr in leaves.items():
            name = _LN[leaf] if layer.startswith("ln_") else _leaf_name(leaf)
            out[f"{prefix}.{name}"] = _tensor(leaf, arr)

    for top, sub in params.items():
        m = _LM_BLOCK.match(top)
        if m:
            for layer, leaves in sub.items():
                put(f"blocks.{m.group(1)}.{layer}", layer, leaves)
        elif top == "tok_emb":
            out["tok_emb.weight"] = _tensor("embedding", sub["embedding"])
        elif top == "pos_emb":
            out["pos_emb"] = _tensor("pos_emb", sub)
        elif top == "ln_f":
            put("ln_f", top, sub)
        else:
            raise KeyError(f"unknown Flax module {top!r}")
    return out



def moe_params_from_jax(tree):
    """A nested dict (or list) of numpy arrays as the same tree of f32
    torch tensors, layouts kept: the functional MoE tree of
    ``init_moe_params`` (``x @ kernel``'s ``[d, E]`` router kernel), a
    stacked ``[S, ...]`` pipeline tree, or one stage's."""
    if isinstance(tree, dict):
        return {k: moe_params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(moe_params_from_jax(v) for v in tree)
    return torch.tensor(np.ascontiguousarray(np.asarray(tree,
                                                        dtype=np.float32)))


def moe_state_dict_from_flax(params: Dict) -> Dict:
    """``MoEMLP``'s Flax params (numpy) as the torch ``MoEMLP``'s
    ``state_dict``: the router is an ``nn.Linear``, so its kernel ``[d,
    E]`` becomes ``weight [E, d]``; ``w_in`` / ``w_out`` pass through."""
    return {"router.weight": _tensor("kernel", params["router"]["kernel"]),
            "router.bias": _tensor("bias", params["router"]["bias"]),
            "w_in": _tensor("w_in", params["w_in"]),
            "w_out": _tensor("w_out", params["w_out"])}


_SEQ = re.compile(r"^(Conv|Dense)_(\d+)$")
_SEQ_LIST = {"Conv": "convs", "Dense": "dense"}


def vgg_state_dict_from_flax(params: Dict) -> Dict:
    """``params``: the Flax ``VGG``'s params collection as nested dicts of
    numpy arrays. Returns a ``state_dict`` for the torch ``VGG`` of the same
    cfg and input size: ``Conv_<i>`` / ``Dense_<i>`` become ``convs.<i>`` /
    ``dense.<i>``, each ``kernel`` transposed to ``weight``. The first
    dense kernel is only transposed: both models flatten in (h, w, c)
    order."""
    out = {}
    for top, leaves in params.items():
        m = _SEQ.match(top)
        if not m:
            raise KeyError(f"unknown Flax module {top!r}")
        for leaf, arr in leaves.items():
            if leaf not in ("kernel", "bias"):
                raise KeyError(f"unknown Flax leaf {top}/{leaf}")
            out[f"{_SEQ_LIST[m.group(1)]}.{m.group(2)}.{_leaf_name(leaf)}"] \
                = _tensor(leaf, arr)
    return out


def mnist_state_dict_from_flax(params: Dict) -> Dict:
    """``params`` of the Flax ``MNISTConvNet`` or ``MNISTMLP`` (numpy) as
    the torch model's ``state_dict``: the names map as VGG's do."""
    return vgg_state_dict_from_flax(params)


_INCEPTION_TOP = re.compile(
    r"^(?:ConvBN|InceptionA|ReductionA|InceptionB|ReductionB|InceptionC)"
    r"_\d+$")
_CONVBN = {"Conv_0": "conv", "BatchNorm_0": "bn"}


def inception_state_dict_from_flax(params: Dict, batch_stats: Dict) -> Dict:
    """``params`` / ``batch_stats`` of the Flax ``InceptionV3`` (numpy) as
    the torch ``InceptionV3``'s ``state_dict``: the port keeps Flax's
    module names, so a path maps token by token (``Conv_0`` -> ``conv``,
    ``BatchNorm_0`` -> ``bn``, ``kernel`` -> ``weight``, ...)."""
    out = {}

    def walk(path, tree):
        for key, sub in tree.items():
            if isinstance(sub, dict):
                if key in _CONVBN:
                    name = _CONVBN[key]
                elif (not path and (_INCEPTION_TOP.match(key)
                                    or key == "Dense_0")) or (
                        path and key.startswith("ConvBN_")):
                    name = key
                else:
                    raise KeyError(f"unknown Flax module "
                                   f"{'/'.join(path + [key])!r}")
                walk(path + [name], sub)
            else:
                if key not in ("kernel", "bias", "scale", "mean", "var"):
                    raise KeyError(f"unknown Flax leaf "
                                   f"{'/'.join(path + [key])!r}")
                out[".".join(path + [_leaf_name(key)])] = _tensor(key, sub)

    walk([], params)
    walk([], batch_stats)
    return out
