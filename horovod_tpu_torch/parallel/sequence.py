"""Ulysses sequence parallelism: attention between two all-to-alls
(counterpart of ``horovod_tpu/parallel/sequence.py``, the DeepSpeed-Ulysses
construction).

Attention needs the whole sequence of a head, so an all-to-all over the
ranks of ``group`` turns sequence blocks ``[B, T/sp, H, D]`` into head
groups ``[B, T, H/sp, D]``, flash attention (K5 forward, K7 backward) runs
on those, and a second all-to-all turns the output back. Chunk order
follows group-rank order on both sides. Needs ``H % sp == 0``; beyond the
head count, use :mod:`ring_attention`.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..ops.attention import flash_attention
from ._comm import all_to_all, axis, gather_seq, shard_seq


def _check_heads(h: int, group) -> int:
    n, _ = axis(group)
    if h % n:
        raise ValueError(f"Ulysses attention needs the head count ({h}) to "
                         f"be a multiple of the sequence-parallel size ({n})")
    return n


def seq_to_heads(x, group=None):
    """[B, T/sp, H, D] -> [B, T, H/sp, D]: head group j goes to rank j, and
    the blocks that arrive are laid along the sequence in rank order."""
    b, t, h, d = x.shape
    n = _check_heads(h, group)
    y = all_to_all(x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4),
                   group)                       # [src rank, B, T/sp, H/sp, D]
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)


def heads_to_seq(x, group=None):
    """[B, T, H/sp, D] -> [B, T/sp, H, D]: the inverse of
    :func:`seq_to_heads`."""
    b, t, hl, d = x.shape
    n, _ = axis(group)
    y = all_to_all(x.reshape(b, n, t // n, hl, d).transpose(0, 1),
                   group)                       # [src rank, B, T/sp, H/sp, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hl, d)


def ulysses_attention(q, k, v, group=None, causal: bool = False,
                      attn_fn: Optional[Callable] = None):
    """Attention over this rank's sequence blocks ``[B, T/sp, H, D]`` of q,
    k, v; returns this rank's block of the output. ``attn_fn(q, k, v,
    causal=...)`` computes full attention on ``[B, T, H/sp, D]`` (default:
    ``ops.attention.flash_attention``). Differentiable."""
    _check_heads(q.shape[2], group)
    attn_fn = attn_fn or flash_attention
    out = attn_fn(seq_to_heads(q, group), seq_to_heads(k, group),
                  seq_to_heads(v, group), causal=causal)
    return heads_to_seq(out, group)


def make_ulysses_attention(group=None, causal: bool = False):
    """Ulysses attention on global ``[B, T, H, D]`` tensors, the same on
    every rank of ``group``, as :func:`ring_attention.make_ring_attention`
    does it. Raises ``ValueError`` unless ``H % sp == 0``."""
    def fn(q, k, v):
        q, k, v = (shard_seq(x, group) for x in (q, k, v))
        return gather_seq(ulysses_attention(q, k, v, group, causal), group)

    return fn
