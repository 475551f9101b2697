"""Flash attention as an autograd function (counterpart of
``pallas_kernels.flash_attention`` and its ``_flash_fullattn_vjp``).

The forward runs K5 (``cuda_kernels.flash_attention_fwd``) and saves
``(q, k, v, out, lse)``: O(T) residuals. The backward computes
``D = rowsum(dO * O)`` and runs K7 (``cuda_kernels.flash_attention_bwd``),
which recomputes the probabilities tile by tile from the saved LSE, so no
``[T, T]`` tensor is ever held. On CPU tensors both go through the plain
twins.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import cuda_kernels as ck


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = ck.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dd = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = ck.flash_attention_bwd(q, k, v, dout, lse, dd,
                                            causal=ctx.causal,
                                            scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None):
    """Attention over ``[B, T, H, D]`` q, k, v (f32 or bf16), output in q's
    dtype; ``scale`` defaults to ``D ** -0.5``. Differentiable: the
    gradients come from the flash backward kernel."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None):
    """The plain twin of :func:`flash_attention` (the reference's
    ``reference_attention`` with the fully-masked-row convention: such a
    row gives 0), differentiable through autograd."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return ck.flash_attention_fwd_plain(q, k, v, causal=causal,
                                        scale=float(scale))[0]
