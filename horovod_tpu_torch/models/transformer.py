"""Decoder-only transformer LM (counterpart of
``horovod_tpu/models/transformer.py``, its training path).

Pre-LN blocks, a GELU MLP (4x), learned positions and a weight-tied head,
with the reference's numerics made explicit:

* ``dtype`` is the compute dtype (bf16 on the card): f32 parameters are cast
  to it where they are used, as Flax's ``dtype=`` does; LayerNorm takes its
  statistics in f32 and returns ``dtype``. No autocast (it would run the
  norm in f32 and return f32, which changes every cast after it).
* The fused qkv projection's columns are head-major ``[h][3][hd]``.
* GELU is the tanh approximation (Flax's ``nn.gelu``); LayerNorm's epsilon
  is Flax's 1e-6. The plain LayerNorm is Flax's ``nn.LayerNorm`` with its
  fast variance ``E[x^2] - E[x]^2``; ``fused_ln=True`` takes the K8 kernel
  (two-pass statistics), as the reference's ``HVD_FUSED_LN=1`` does.
* The tied head promotes both operands to ``dtype`` (Flax's
  ``Embed.attend``), so a bf16 model's logits are a bf16 product, then f32.
* Attention is pluggable; the default is causal flash attention (K5/K7).
* ``remat``: ``"full"`` recomputes each block in the backward;
  ``"dots"`` is the reference's ``dots_with_no_batch_dims_saveable``: the
  outputs of the products without a batch dimension (``aten.mm`` /
  ``aten.addmm``: the qkv, proj, mlp_in and mlp_out projections) are
  kept, everything else of the block is recomputed (both LayerNorms, the
  attention forward, GELU, the weights' casts). Torch's selective
  checkpoint (non-reentrant) does it; a kernel whose launch dispatch does
  not see (K5, K8) simply runs again with the recomputed inputs.

Not ported yet: ``cached_attention`` and the KV-cache path (serving), which
raise ``NotImplementedError``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import flash_attention
from ..ops.layer_norm import fused_layer_norm

INIT_STD = 0.02
LN_EPS = 1e-6
REMAT = ("none", "full", "dots")
#: the ops whose outputs ``remat="dots"`` keeps: the products without a
#: batch dimension (``aten.bmm`` has one and is recomputed)
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def default_attention(q, k, v):
    """Causal flash attention over ``[B, T, H, D]``."""
    return flash_attention(q, k, v, causal=True)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon=1e-6, dtype=dtype, param_dtype=f32)``
    (fast variance), or with ``fused=True`` the reference's
    ``FusedLayerNorm`` on the K8 kernel. Parameters ``weight`` / ``bias``
    (Flax's ``scale`` / ``bias``)."""

    def __init__(self, d: int, dtype=torch.float32, fused: bool = False,
                 eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.dtype, self.fused, self.eps = dtype, fused, eps

    def forward(self, x):
        if self.fused:
            return fused_layer_norm(x, self.weight, self.bias,
                                    eps=self.eps).to(self.dtype)
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mean * mean,
                              0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class Dense(nn.Module):
    """Flax ``nn.Dense(dtype=dtype, param_dtype=f32)``: weight ``[out, in]``
    (the transpose of Flax's kernel) and bias, cast to ``dtype`` at use."""

    def __init__(self, d_in: int, d_out: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dtype, attn_fn,
                 fused_ln: bool = False):
        super().__init__()
        self.num_heads, self.dtype, self.attn_fn = num_heads, dtype, attn_fn
        # fixed here: under tensor parallelism a rank's qkv holds only its
        # heads (``parallel/tensor.py``), so neither the head count nor the
        # attention output's width can be read off d_model in forward
        self.head_dim = d_model // num_heads
        ln = partial(LayerNorm, d_model, dtype=dtype, fused=fused_ln)
        self.ln_attn = ln()
        self.qkv = Dense(d_model, 3 * d_model, dtype)
        self.proj = Dense(d_model, d_model, dtype)
        self.ln_mlp = ln()
        self.mlp_in = Dense(d_model, 4 * d_model, dtype)
        self.mlp_out = Dense(4 * d_model, d_model, dtype)

    def forward(self, x):
        b, t, _ = x.shape
        qkv = self.qkv(self.ln_attn(x)).view(b, t, -1, 3, self.head_dim)
        out = self.attn_fn(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :])
        x = x + self.proj(out.to(self.dtype).reshape(b, t, -1))
        h = F.gelu(self.mlp_in(self.ln_mlp(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """``tokens [B, T]`` -> logits ``[B, T, vocab]`` f32 (or, with
    ``return_hidden=True``, the final-LN hidden states in ``dtype``).

    Parameters are drawn from ``normal(0.02)`` (dense weights, token and
    position tables) with a CPU generator seeded by ``seed``, so a seed
    gives the same weights on every device; biases are zero and LayerNorm
    scales one. ``remat``: ``"none"``, ``"full"`` (each block recomputed
    in the backward) or ``"dots"`` (the block's products kept, the rest
    recomputed; see the module's docstring)."""

    def __init__(self, vocab_size: int, num_layers: int = 12,
                 num_heads: int = 12, d_model: int = 768,
                 max_seq_len: int = 2048, dtype=torch.bfloat16,
                 attn_fn: Optional[Callable] = None, remat: str = "none",
                 fused_ln: bool = False, seed: int = 0):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat={remat!r}; expected one of "
                             f"{sorted(REMAT)}")
        self.vocab_size, self.max_seq_len = vocab_size, max_seq_len
        self.dtype, self.remat = dtype, remat
        attn = attn_fn if attn_fn is not None else default_attention
        self.tok_emb = nn.Embedding(vocab_size, d_model)
        self.pos_emb = nn.Parameter(torch.empty(max_seq_len, d_model))
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, dtype, attn, fused_ln)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(d_model, dtype=dtype, fused=fused_ln)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("weight") and p.dim() == 2 or name == \
                        "pos_emb":
                    p.normal_(0.0, INIT_STD, generator=gen)

    def forward(self, tokens, pos_offset: int = 0, return_hidden: bool = False,
                kv_cache=None):
        if kv_cache is not None:
            raise NotImplementedError(
                "kv_cache (cached_attention, the serving KV-cache path) is "
                "not ported yet")
        t = tokens.shape[1]
        pos_offset = int(pos_offset)
        if pos_offset + t > self.max_seq_len:
            raise ValueError(f"sequence [{pos_offset}, {pos_offset + t}) "
                             f"exceeds max_seq_len={self.max_seq_len}")
        x = (F.embedding(tokens, self.tok_emb.weight).to(self.dtype)
             + self.pos_emb[pos_offset:pos_offset + t].to(self.dtype))
        remat = self.remat if torch.is_grad_enabled() else "none"
        for block in self.blocks:
            if remat == "full":
                x = checkpoint(block, x, use_reentrant=False)
            elif remat == "dots":
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=_dots_context)
            else:
                x = block(x)
        x = self.ln_f(x)
        if return_hidden:
            return x
        # weight-tied head: both operands in the compute dtype
        return F.linear(x.to(self.dtype),
                        self.tok_emb.weight.to(self.dtype)).float()


def lm_loss(logits, targets):
    """Mean next-token cross entropy of f32 logits ``[B, T, V]``."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           targets.reshape(-1))


def _chunk_ll(h, emb_t, y, w):
    # bf16 operands with f32 sums: the product of two bf16 values is exact
    # in f32, so an f32 product of the rounded operands is that contraction
    logits = h.float() @ emb_t.float()
    ll = torch.log_softmax(logits, -1).gather(1, y[:, None])[:, 0]
    return (ll * w).sum()


def lm_loss_chunked(hidden, emb_table, targets, chunk_tokens: int = 2048):
    """Weight-tied cross entropy without the ``[B, T, vocab]`` logits:
    ``chunk_tokens`` tokens at a time, each chunk recomputed in the
    backward (``torch.utils.checkpoint``). The head product takes bf16
    operands with f32 sums; the token stream is padded to whole chunks
    with weight-0 rows, as in the reference."""
    b, t, d = hidden.shape
    total = b * t
    chunk = min(chunk_tokens, total)
    pad = (-total) % chunk
    emb_t = emb_table.to(torch.bfloat16).t()
    h = hidden.to(torch.bfloat16).reshape(total, d)
    y = targets.reshape(total)
    w = torch.ones(total, dtype=torch.float32, device=hidden.device)
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad))
        w = F.pad(w, (0, pad))
    acc = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, total + pad, chunk):
        sl = slice(i, i + chunk)
        acc = acc + checkpoint(_chunk_ll, h[sl], emb_t, y[sl], w[sl],
                               use_reentrant=False)
    return -acc / total


TransformerLMTiny = partial(TransformerLM, num_layers=2, num_heads=2,
                            d_model=128, max_seq_len=512)
TransformerLM124M = partial(TransformerLM, num_layers=12, num_heads=12,
                            d_model=768, max_seq_len=2048)
