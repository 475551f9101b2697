"""Ring attention: exact attention over a sequence sharded across the ranks
of a process group (counterpart of ``horovod_tpu/parallel/ring_attention.py``,
after Liu et al., "Ring Attention with Blockwise Transformers").

Each rank holds ``[B, T/n, H, D]`` blocks of q, k and v. The forward runs
n hops: at hop i the k/v block of rank ``(my - i) mod n`` is here, kernel K6
(``cuda_kernels.flash_attention_step``) folds it into the carried
``(m, l, o)`` at the hop's global offsets, and the block moves one rank on
(one stacked ``[2, ...]`` buffer; the last block is used after the loop, so
no rotation trails it). Causal hops above the diagonal see no key and leave
the carry as it is. The output is normalized once at the end.

The backward is a second ring (``_RingFlash.backward``): ``D = rowsum(dO O)``
once, then at each hop kernel K7 (``flash_attention_bwd`` with f32 outputs
at the hop's offsets) against the visiting block; dq accumulates here in
f32, and the f32 (dk, dv) accumulator travels with its block, n rotations,
so that it lands on the block's owner; one cast to the input dtype at the
end. Residuals are ``(q, k, v, out, lse)``: O(T/n) a rank.

The ring's hops go through ``runtime.executor._collective`` and are not
overlapped with the kernels yet. On CPU tensors the kernels' plain twins
run. ``_block_attn`` is the plain per-hop step, differentiable, which the
tests run through ``_ring_fwd_stats`` against the reference's jnp ring.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ..ops import cuda_kernels as ck
from ._comm import axis, gather_seq, ppermute, shard_seq


def _block_attn(q, k, v, m, l, o, q_off, k_off, causal, scale):
    """One flash step of q against the (k, v) block, in plain torch and
    natural log units; differentiable. q [B, Tq, H, D], k and v [B, Tk, H,
    D], m and l [B, H, Tq], o [B, Tq, H, D] f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        qpos = q_off + torch.arange(q.shape[1], device=q.device)
        kpos = k_off + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    # fully masked rows: no exp(-inf - -inf)
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    alpha = torch.where(torch.isneginf(m), torch.zeros_like(m),
                        torch.exp(m - m_safe))
    l_new = l * alpha + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o * alpha.transpose(1, 2)[..., None] + pv


def _ring_fwd_stats(q, k, v, group, step):
    """The forward ring: the raw ``(m, l, o)`` after every hop."""
    n, my = axis(group)
    b, t, h, d = q.shape
    m = torch.full((b, h, t), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for i in range(n):
        if i:
            kv = ppermute(kv, group)
        src = (my - i) % n  # whose block is here at hop i
        m, l, o = step(q, kv[0], kv[1], m, l, o, my * t, src * t)
    return m, l, o


def _kernel_step(q, k, v, m, l, o, q_off, k_off, causal, scale):
    return ck.flash_attention_step(q, k, v, m, l, o, causal=causal,
                                   scale=scale, q_off=q_off, k_off=k_off)


class _RingFlash(torch.autograd.Function):
    """K6 forward ring, K7 backward ring (see the module's docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        m, l, o = _ring_fwd_stats(q, k, v, group, partial(
            _kernel_step, causal=causal, scale=scale))
        out, lse = ck.finalize_attention_stats(m, l, o, q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        n, my = axis(group)
        t = q.shape[1]
        dout = dout.contiguous()
        dd = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                          device=k.device)
        kv = torch.stack([k, v])
        for i in range(n):
            src = (my - i) % n
            dq_i, dk_i, dv_i = ck.flash_attention_bwd(
                q, kv[0], kv[1], dout, lse, dd, causal=ctx.causal,
                scale=ctx.scale, out_dtype=torch.float32, q_off=my * t,
                k_off=src * t)
            dq += dq_i
            dkv[0] += dk_i
            dkv[1] += dv_i
            if i < n - 1:
                kv = ppermute(kv, group)
            dkv = ppermute(dkv, group)  # n rotations: home again
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None)


def ring_attention(q, k, v, group=None, causal: bool = False,
                   scale: Optional[float] = None):
    """Exact attention over q, k, v ``[B, T/n, H, D]``, this rank's blocks
    of a sequence sharded over the n ranks of ``group`` (a process group;
    None: every rank), in group-rank order. Returns this rank's block of
    the output, in q's dtype. Differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingFlash.apply(q, k, v, group, bool(causal), float(scale))


def make_ring_attention(group=None, causal: bool = False):
    """Ring attention on global ``[B, T, H, D]`` tensors, the same on every
    rank of ``group``: each rank takes its block of the sequence and gets
    the whole output back; gradients reach the global inputs whole."""
    def fn(q, k, v):
        q, k, v = (shard_seq(x, group) for x in (q, k, v))
        return gather_seq(ring_attention(q, k, v, group, causal), group)

    return fn


def reference_attention(q, k, v, causal: bool = False,
                        scale: Optional[float] = None):
    """Plain full attention (for tests): an f32 softmax, output in q's
    dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
