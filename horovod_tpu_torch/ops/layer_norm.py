"""LayerNorm over the last axis with the K8 forward (counterpart of
``pallas_kernels.fused_layer_norm``).

The forward runs ``cuda_kernels.layer_norm_rows`` (K8) and saves the f32
mean and rstd, one [2, N] tensor; the backward is the plain formula of the
reference's ``_ln_fused_vjp_bwd`` in PyTorch, on purpose, as in the
reference. On CPU tensors the forward is the plain twin.
"""

from __future__ import annotations

import torch

from . import cuda_kernels as ck


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps: float):
        y, stats = ck.layer_norm_rows(x2, gamma, beta, eps)
        ctx.save_for_backward(x2, stats, gamma)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, stats, gamma = ctx.saved_tensors
        d = x2.shape[1]
        mu, rs = stats[:, :, None]
        xhat = (x2.float() - mu) * rs
        dyf = dy.float()
        g = dyf * gamma.float()
        c1 = (g * xhat).sum(1, keepdim=True) / d
        c2 = g.sum(1, keepdim=True) / d
        dx = (rs * (g - xhat * c1 - c2)).to(x2.dtype)
        dg = (dyf * xhat).sum(0).to(gamma.dtype)
        db = dyf.sum(0).to(gamma.dtype)
        return dx, dg, db, None


def fused_layer_norm(x, gamma, beta, *, eps: float = 1e-6):
    """LayerNorm of ``x [..., D]`` with ``gamma``/``beta [D]``: statistics
    in f32, output in x's dtype, parameter gradients in the parameters'
    dtype."""
    d = x.shape[-1]
    y = _FusedLayerNorm.apply(x.reshape(-1, d).contiguous(), gamma, beta,
                              float(eps))
    return y.reshape(x.shape)
