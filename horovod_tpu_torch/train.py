"""Synthetic data-parallel training: the port's main path (the loop of the
reference's ``bench.py``).

The image model is any ``BENCH_MODEL`` family, by name (``IMAGE_MODELS``:
the ResNets, Inception V3, VGG-16 / 19 and the MNIST nets). Synthetic
ImageNet-shaped images from ``RandomState(0)`` and labels from
``RandomState(1)`` form a global batch of ``batch * size()`` samples; rank r
trains on its ``batch``-sized shard. SGD (lr 0.01, momentum 0.9) is wrapped
in :func:`DistributedOptimizer`, which averages the gradients
(``op="average"``) or Adasum-combines the local updates (``op="adasum"``);
the loss is softmax cross-entropy. On the card the forward runs under bf16
autocast with f32 parameters, in channels_last.

``synthetic_lm_train`` is the dense transformer-LM step of the reference's
``benchmarks/lm_bench.py``: tokens/s and MFU of AdamW training on seeded
random tokens.

``synthetic_moe_train`` is the Switch-MoE step of ``lm_bench --moe``: one
weight-tied MoE block over a (dp, ep) grid, exact or capacity dispatch,
the latter on the int8 / int4 wire.

``plane="compiled"`` (ResNet) / ``compiled=True`` (LM) trains through the
compiled data-parallel plane instead, ``spmd.make_train_step``: one CUDA
graph a step at world 1 on the card (``graph``), the quantized ring with its
error-feedback residual on a wire, no engine and no hooks.
"""

from __future__ import annotations

import hashlib
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import basics, models, spmd
from .basics import Adasum, Average
from .models import mnist
from .models.vgg import Dropout
from .models.transformer import TransformerLM, lm_loss, lm_loss_chunked
from .ops import compression as comp
from .ops import cuda_kernels as ck
from .optim.broadcast import broadcast_parameters
from .optim.distributed import DistributedOptimizer
from .optim.fused import FusedAdamW
from .parallel import expert as epar

# lm_bench's presets (benchmarks/lm_bench.py:50-58): widths and the
# per-replica batch and sequence
LM_PRESETS = {
    "medium": dict(num_layers=24, d_model=1024, num_heads=16, batch=8,
                   seq=1024),
    "small": dict(num_layers=12, d_model=768, num_heads=12, batch=8,
                  seq=1024),
    "tiny": dict(num_layers=2, d_model=64, num_heads=2, batch=2, seq=64),
}
# Dense bf16 tensor-core peak by card name (NVIDIA data sheets), FLOP/s:
# the MFU denominator.
PEAK_BF16_FLOPS = (("H100 NVL", 835e12), ("H100 PCIe", 756e12),
                   ("H100", 989.4e12), ("H200", 989.4e12))


def peak_bf16_flops(name: str):
    """The dense bf16 peak of the card named ``name``, or None."""
    for key, flops in PEAK_BF16_FLOPS:
        if key in name:
            return flops
    return None


def params_sha256(model: torch.nn.Module) -> str:
    """sha256 over the parameters' bytes in name order (buffers such as BN
    running statistics are rank-local and left out)."""
    h = hashlib.sha256()
    for name, p in sorted(model.named_parameters()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# The image models a trainer builds by name (bench.py's BENCH_MODEL
# families, and the MNIST nets of the examples): the class, the channels of
# the synthetic images it takes, and the size keywords its constructor
# takes beside num_classes and seed.
IMAGE_MODELS = {name: (getattr(models, name), 3, ("num_filters",))
                for name in ("ResNet18", "ResNet34", "ResNet50", "ResNet101",
                             "ResNet152")}
IMAGE_MODELS.update(InceptionV3=(models.InceptionV3, 3, ()),
                    VGG16=(models.VGG16, 3, ("image_size",)),
                    VGG19=(models.VGG19, 3, ("image_size",)),
                    MNISTConvNet=(mnist.MNISTConvNet, 1, ("image_size",)),
                    MNISTMLP=(mnist.MNISTMLP, 1, ("image_size",)))


def image_model(model: str, num_classes: int = 1000, seed: int = 0,
                image: int = 224, num_filters: Optional[int] = None
                ) -> torch.nn.Module:
    """The image model ``model`` (a key of ``IMAGE_MODELS``) on the CPU,
    weights from ``seed``, for ``image`` x ``image`` inputs.
    ``num_filters``: the ResNets' width (64, the published one, if None);
    any other family raises."""
    if model not in IMAGE_MODELS:
        raise ValueError(f"model {model!r}: expected one of "
                         f"{sorted(IMAGE_MODELS)}")
    cls, _, knobs = IMAGE_MODELS[model]
    kw = dict(num_classes=num_classes, seed=seed)
    if num_filters is not None:
        if "num_filters" not in knobs:
            raise ValueError(f"num_filters sets a ResNet's width; {model} "
                             "has no such knob")
        kw["num_filters"] = num_filters
    if "image_size" in knobs:
        kw["image_size"] = image
    return cls(**kw)


def has_dropout(net: torch.nn.Module) -> bool:
    """Whether ``net`` drops anything in training."""
    return any(isinstance(m, Dropout) and m.rate > 0 for m in net.modules())


def synthetic_batch(batch: int, image: int, num_classes: int, rank: int,
                    world: int, channels: int = 3):
    """This rank's shard of the seeded global batch: NHWC f32 images and
    int64 labels, as numpy arrays."""
    total = batch * world
    images = np.random.RandomState(0).randn(total, image, image,
                                            channels).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, num_classes, (total,))
    sl = slice(rank * batch, (rank + 1) * batch)
    return images[sl], labels[sl].astype(np.int64)


class ImageTrainer:
    """The model, data and optimizer of :func:`synthetic_train`, built on
    this rank's device (the framework is initialized on ``device`` if it is
    not yet); :meth:`step` takes one training step and returns the loss (a
    device tensor). Arguments as in :func:`synthetic_train`; ``opt`` is the
    plain SGD and ``train_step`` the compiled plane's step (None on the
    engine's plane)."""

    def __init__(self, model: str = "ResNet50", batch: int = 32,
                 image: int = 224, compression=None,
                 error_feedback: bool = True, device: Optional[str] = None,
                 num_classes: int = 1000, seed: int = 0, op: str = "average",
                 num_filters: Optional[int] = None, plane: str = "engine",
                 graph: Optional[bool] = None, zero1: bool = False):
        if op not in ("average", "adasum"):
            raise ValueError(f"op {op!r}: expected 'average' or 'adasum'")
        if plane not in ("engine", "compiled"):
            raise ValueError(f"plane {plane!r}: expected 'engine' or "
                             "'compiled'")
        if plane == "compiled" and op != "average":
            raise ValueError("the compiled plane averages (op='average')")
        if compression is None:
            compression = "int8" if op == "average" else "none"
        compressor = (comp.by_name(compression)
                      if isinstance(compression, str) else compression)
        if op == "adasum":
            if compressor not in (comp.NoneCompressor, comp.FP16Compressor):
                raise ValueError(f"op='adasum' takes compression 'none' or "
                                 f"'fp16', not {compression!r}")
            error_feedback = False
        if plane == "compiled" and compressor not in (
                comp.NoneCompressor, comp.Int8Compressor,
                comp.Int4Compressor):
            raise ValueError(f"the compiled plane's wire is 'none', 'int8' "
                             f"or 'int4', not {compression!r}")
        net = image_model(model, num_classes=num_classes, seed=seed,
                          image=image, num_filters=num_filters)
        if plane == "compiled" and has_dropout(net):
            if graph:
                raise ValueError(f"{model}'s dropout draws from the model's "
                                 "own generator, which a CUDA graph cannot "
                                 "replay: pass graph=False")
            graph = False
        basics.init(device=device)
        self.device = dev = basics.device()
        self.batch, self.plane, self.op = batch, plane, op
        self.on_cuda = on_cuda = dev.type == "cuda"
        self.net = net = net.to(dev)
        if on_cuda:
            net = net.to(memory_format=torch.channels_last)
        broadcast_parameters(net.state_dict(), root_rank=0)
        images, labels = synthetic_batch(batch, image, num_classes,
                                         basics.rank(), basics.size(),
                                         IMAGE_MODELS[model][1])
        self.x = torch.from_numpy(images).to(dev)
        self.y = torch.from_numpy(labels).to(dev)
        self.opt = torch.optim.SGD(net.parameters(), lr=0.01, momentum=0.9)
        self.train_step = None
        if plane == "compiled":
            self.train_step = spmd.make_train_step(
                self._compiled_loss, self.opt, net, zero1=zero1, graph=graph,
                compression=getattr(compressor, "wire", None) or "off")
        else:
            self.dist_opt = DistributedOptimizer(
                self.opt, named_parameters=net.named_parameters(),
                compression=compressor,
                op=Adasum if op == "adasum" else Average,
                error_feedback=error_feedback)

    def _compiled_loss(self, xb, yb):
        # no autocast cache: a CUDA graph replays the casts each step
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=self.on_cuda, cache_enabled=False):
            logits = self.net(xb)
        return F.cross_entropy(logits.float(), yb)

    def step(self):
        if self.train_step is not None:
            return self.train_step(self.x, self.y)
        self.dist_opt.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            enabled=self.on_cuda):
            logits = self.net(self.x)
        loss = F.cross_entropy(logits.float(), self.y)
        loss.backward()
        self.dist_opt.step()
        return loss.detach()

    def sync(self) -> None:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)


def synthetic_train(model: str = "ResNet50", batch: int = 32,
                    image: int = 224, steps: int = 5, warmup: int = 2,
                    compression=None, error_feedback: bool = True,
                    device: Optional[str] = None, num_classes: int = 1000,
                    seed: int = 0, op: str = "average",
                    num_filters: Optional[int] = None, plane: str = "engine",
                    graph: Optional[bool] = None, zero1: bool = False
                    ) -> dict:
    """Train ``model`` (a key of ``IMAGE_MODELS``) for ``warmup + steps``
    steps on synthetic data.

    ``num_filters``: a ResNet's width (64, the published one, if None;
    other families raise). On the compiled plane a model with dropout (VGG,
    MNISTConvNet) runs eagerly: a CUDA graph cannot replay the model's own
    generator.
    ``op``: ``"average"`` (gradients averaged; ``compression`` defaults to
    ``"int8"``) or ``"adasum"`` (the delta flow; ``compression`` is
    ``"none"``, its default, or ``"fp16"``, and error feedback is off).
    ``plane``: ``"engine"`` (``DistributedOptimizer`` through the eager
    engine) or ``"compiled"`` (``spmd.make_train_step`` with ``graph`` and
    ``zero1``; ``op="average"`` only, and on a wire the error-feedback
    residual is always carried, as in the reference).
    Initializes the framework on ``device`` if it is not initialized yet.
    Returns ``losses`` (every step's), ``images_per_sec`` (this rank, timed
    steps only), ``launches`` (kernel launches of this call, per wrapper),
    ``device``, ``peak_memory_bytes`` (CUDA only, else None) and
    ``params_sha256``; on the compiled plane also ``graphed`` and
    ``launches_per_replay``.
    """
    before = ck.launch_counts()
    tr = ImageTrainer(model, batch=batch, image=image,
                      compression=compression,
                      error_feedback=error_feedback, device=device,
                      num_classes=num_classes, seed=seed, op=op,
                      num_filters=num_filters, plane=plane, graph=graph,
                      zero1=zero1)
    net, dev = tr.net, tr.device
    net.train()
    if tr.on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [tr.step() for _ in range(warmup)]
    tr.sync()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(steps)]
    tr.sync()
    elapsed = time.perf_counter() - t0
    after = ck.launch_counts()
    ts = tr.train_step
    return {
        "losses": [float(v) for v in losses],
        "images_per_sec": batch * steps / elapsed if steps else None,
        "launches": {k: after[k] - before[k] for k in after},
        "device": str(dev),
        "op": op,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if tr.on_cuda else None),
        "params_sha256": params_sha256(net),
        "gradient_leaves": sum(1 for p in net.parameters()
                               if p.requires_grad),
        "plane": plane,
        **(dict(graphed=ts.graphed,
                launches_per_replay=ts.launches_per_replay, zero1=zero1,
                zero1_state_numel=(ts.zero1_state_numel() if zero1
                                   else None))
           if ts is not None else {}),
    }


def synthetic_lm_tokens(batch: int, seq: int, vocab: int, rank: int,
                        world: int):
    """This rank's rows of the seeded global token batch ``[batch * world,
    seq + 1]`` (``RandomState(0)``), as lm_bench draws and shards it."""
    toks = np.random.RandomState(0).randint(0, vocab, (batch * world,
                                                       seq + 1))
    return toks[rank * batch:(rank + 1) * batch].astype(np.int64)


class LMTrainer:
    """The model, data and optimizer of :func:`synthetic_lm_train`, built
    on this rank's device (the framework is initialized on ``device`` if it
    is not yet); :meth:`step` takes one training step. Arguments as in
    :func:`synthetic_lm_train`."""

    def __init__(self, preset: str = "medium", batch: Optional[int] = None,
                 seq: Optional[int] = None, vocab: int = 32768,
                 fused_ln: bool = False, fused_opt: bool = False,
                 mu_dtype: str = "bf16", chunked="auto", remat: str = "none",
                 device: Optional[str] = None, seed: int = 0,
                 num_layers: Optional[int] = None, compiled: bool = False,
                 graph: Optional[bool] = None):
        if preset not in LM_PRESETS:
            raise ValueError(f"preset {preset!r}: expected one of "
                             f"{sorted(LM_PRESETS)}")
        cfg = LM_PRESETS[preset]
        self.batch = cfg["batch"] if batch is None else batch
        self.seq = cfg["seq"] if seq is None else seq
        self.num_layers = (cfg["num_layers"] if num_layers is None
                           else num_layers)
        basics.init(device=device)
        self.device = dev = basics.device()
        self.world = basics.size()
        self.on_cuda = dev.type == "cuda"
        if chunked == "auto":
            chunked = self.batch * self.seq * vocab * 4 > 2 * 2 ** 30
        self.chunked = chunked
        self.net = net = TransformerLM(
            vocab, num_layers=self.num_layers, num_heads=cfg["num_heads"],
            d_model=cfg["d_model"], max_seq_len=self.seq,
            dtype=torch.bfloat16 if self.on_cuda else torch.float32,
            remat=remat, fused_ln=fused_ln, seed=seed).to(dev)
        broadcast_parameters(net.state_dict(), root_rank=0)
        self.n_params = sum(p.numel() for p in net.parameters())
        self.n_nonemb = (self.n_params - net.tok_emb.weight.numel()
                         - net.pos_emb.numel())
        toks = torch.from_numpy(synthetic_lm_tokens(
            self.batch, self.seq, vocab, basics.rank(), self.world)).to(dev)
        self.x, self.y = toks[:, :-1], toks[:, 1:]
        capturable = compiled and self.on_cuda
        if fused_opt:
            inner = FusedAdamW(net.parameters(), lr=3e-4, weight_decay=0.01,
                               mu_dtype=mu_dtype, capturable=capturable)
        else:
            inner = torch.optim.AdamW(net.parameters(), lr=3e-4,
                                      weight_decay=0.01, fused=self.on_cuda,
                                      capturable=capturable)
        self.train_step = None
        if compiled:
            self.opt = inner
            self.train_step = spmd.make_train_step(self._loss, inner, net,
                                                   graph=graph)
        else:
            self.opt = DistributedOptimizer(
                inner, named_parameters=net.named_parameters())
        self.config = dict(preset=preset, num_layers=self.num_layers,
                           batch=self.batch, seq=self.seq, vocab=vocab,
                           world=self.world, fused_ln=fused_ln,
                           fused_opt=fused_opt,
                           mu_dtype=mu_dtype if fused_opt else None,
                           chunked=chunked, remat=remat, compiled=compiled,
                           graphed=(self.train_step.graphed
                                    if compiled else False))

    def _loss(self, x, y):
        if self.chunked:
            return lm_loss_chunked(self.net(x, return_hidden=True),
                                   self.net.tok_emb.weight, y)
        return lm_loss(self.net(x), y)

    def step(self):
        """One training step; returns the loss (a device tensor)."""
        if self.train_step is not None:
            return self.train_step(self.x, self.y)
        self.opt.zero_grad()
        loss = self._loss(self.x, self.y)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def sync(self) -> None:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)


def synthetic_lm_train(preset: str = "medium", batch: Optional[int] = None,
                       seq: Optional[int] = None, vocab: int = 32768,
                       steps: int = 5, warmup: int = 2,
                       fused_ln: bool = False, fused_opt: bool = False,
                       mu_dtype: str = "bf16", chunked="auto",
                       remat: str = "none", device: Optional[str] = None,
                       seed: int = 0, num_layers: Optional[int] = None,
                       compiled: bool = False, graph: Optional[bool] = None
                       ) -> dict:
    """Train the transformer LM of ``preset`` for ``warmup + steps`` steps
    (the dense path of ``benchmarks/lm_bench.py``).

    bf16 compute on the card (f32 on the CPU) with f32 parameters; causal
    flash attention (K5/K7) in every layer; ``fused_ln`` takes the K8
    LayerNorm, ``fused_opt`` the fused AdamW (K9) with ``mu_dtype``. The
    default optimizer is ``torch.optim.AdamW`` (``fused=True`` on the card),
    the counterpart of the reference's ``optax.adamw``; it keeps its first
    moment in the parameters' f32, not in ``mu_dtype``. Both take lr 3e-4
    and weight decay 0.01, wrapped in ``DistributedOptimizer`` (Average,
    exact wire). ``num_layers`` cuts the preset's depth (its widths stay).
    ``chunked``: ``"auto"`` takes the chunked loss when this rank's f32
    logits would pass 2 GiB, as lm_bench does; or True / False. Weights
    come from ``seed``; tokens from ``RandomState(0)``, a global batch of
    ``batch * size()`` rows of which this rank takes its own.
    ``compiled`` / ``graph``: the compiled plane (:class:`LMTrainer`).

    Returns ``losses``, ``tokens_per_sec`` (all ranks, timed steps),
    ``mfu_pct`` (6 * non-embedding parameters * tokens/s over the card's
    dense bf16 peak times the world size; None on the CPU or an unknown
    card), ``peak_memory_bytes``, ``launches`` (per wrapper, this call),
    ``params_sha256`` and the configuration.
    """
    tr = LMTrainer(preset, batch=batch, seq=seq, vocab=vocab,
                   fused_ln=fused_ln, fused_opt=fused_opt, mu_dtype=mu_dtype,
                   chunked=chunked, remat=remat, device=device, seed=seed,
                   num_layers=num_layers, compiled=compiled, graph=graph)
    before = ck.launch_counts()
    if tr.on_cuda:
        torch.cuda.reset_peak_memory_stats(tr.device)
    losses = [tr.step() for _ in range(warmup)]
    tr.sync()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(steps)]
    tr.sync()
    elapsed = time.perf_counter() - t0
    after = ck.launch_counts()
    tok_s = tr.batch * tr.world * tr.seq * steps / elapsed if steps else None
    peak = (peak_bf16_flops(torch.cuda.get_device_name(tr.device))
            if tr.on_cuda else None)
    return {
        "losses": [float(v) for v in losses],
        "tokens_per_sec": tok_s,
        "mfu_pct": (100 * 6 * tr.n_nonemb * tok_s / (tr.world * peak)
                    if tok_s and peak else None),
        "peak_flops": peak,
        "step_ms": 1e3 * elapsed / steps if steps else None,
        "launches": {k: after[k] - before[k] for k in after},
        "device": str(tr.device),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(tr.device)
                              if tr.on_cuda else None),
        "params_sha256": params_sha256(tr.net),
        "n_params": tr.n_params, "n_nonemb_params": tr.n_nonemb,
        "gradient_leaves": sum(1 for p in tr.net.parameters()
                               if p.requires_grad),
        "launches_per_replay": (tr.train_step.launches_per_replay
                                if tr.train_step is not None else None),
        **tr.config,
    }


# lm_bench --moe's defaults on the TPU (benchmarks/lm_bench.py:119-127)
MOE_WIDTHS = dict(d_model=1024, hidden_mult=4, vocab=32768, experts=8,
                  tokens=65536, capacity_factor=1.25)
# lm_bench's dispatch configurations: (dispatch, wire)
MOE_DISPATCH = {"exact": ("exact", ""), "capacity": ("capacity", "off"),
                "capacity-int8": ("capacity", "int8"),
                "capacity-int4": ("capacity", "int4")}


def moe_lm_params(seed: int, d_model: int, experts: int, hidden_mult: int,
                  vocab: int) -> dict:
    """The MoE block's full parameters: :func:`epar.init_moe_params` from
    ``seed`` and the tied embedding ``emb [vocab, d]``, normal(0.02) from
    ``seed + 1``, f32 on the CPU."""
    params = epar.init_moe_params(seed, d_model, experts, hidden_mult)
    gen = torch.Generator().manual_seed(seed + 1)
    params["emb"] = 0.02 * torch.randn(vocab, d_model, generator=gen)
    return params


def moe_lm_loss(params, batch, moe):
    """lm_bench's MoE loss: embed, the routed expert MLP as a residual,
    the tied head; ``CE + 0.01 * aux``."""
    tok, tgt = batch
    h = params["emb"][tok]
    y, aux = moe(params, h)
    logits = (h + y) @ params["emb"].t()
    return F.cross_entropy(logits, tgt) + 0.01 * aux


class MoETrainer:
    """The model, data and optimizer of :func:`synthetic_moe_train` on this
    rank (the framework is initialized on ``device`` if it is not yet);
    :meth:`step` takes one step. ``params`` (a full tree as
    :func:`moe_lm_params` returns, e.g. carried from the reference) replaces
    the seeded weights."""

    def __init__(self, dispatch: str = "capacity-int8",
                 d_model: int = MOE_WIDTHS["d_model"],
                 hidden_mult: int = MOE_WIDTHS["hidden_mult"],
                 vocab: int = MOE_WIDTHS["vocab"],
                 experts: int = MOE_WIDTHS["experts"],
                 tokens: int = MOE_WIDTHS["tokens"],
                 capacity_factor: float = MOE_WIDTHS["capacity_factor"],
                 ep: Optional[int] = None, device: Optional[str] = None,
                 seed: int = 0, params: Optional[dict] = None):
        if dispatch not in MOE_DISPATCH:
            raise ValueError(f"dispatch {dispatch!r}: expected one of "
                             f"{sorted(MOE_DISPATCH)}")
        basics.init(device=device)
        self.device = dev = basics.device()
        self.on_cuda = dev.type == "cuda"
        world = basics.size()
        ep = ep or math.gcd(world, experts)
        if world % ep or experts % ep:
            raise ValueError(f"ep={ep} must divide both the world size "
                             f"({world}) and the experts ({experts})")
        self.mesh = mesh = epar.make_dp_ep_mesh(world // ep, ep)
        self.n_tokens = n = max(world, tokens // world * world)
        if params is None:
            params = moe_lm_params(seed, d_model, experts, hidden_mult, vocab)
        self.params = epar.tree_map_with_path(
            lambda _p, t: t.to(dev).requires_grad_(),
            epar.shard_params_ep(params, mesh))
        toks = np.random.RandomState(0).randint(0, vocab, (n + 1,))
        self.batch = (torch.from_numpy(toks[:-1]).to(dev),
                      torch.from_numpy(toks[1:]).to(dev))
        kind, wire = MOE_DISPATCH[dispatch]
        self.capacity = kind == "capacity"

        def make_opt(leaves):
            return torch.optim.Adam(leaves, lr=1e-2)  # lm_bench's

        self.opt_state = (epar.moe_opt_state(make_opt, self.params, mesh, n,
                                             capacity_factor)
                          if self.capacity
                          else make_opt(epar.tree_leaves(self.params)))
        self.train_step = epar.make_ep_train_step(
            moe_lm_loss, mesh, dispatch=kind,
            capacity_factor=capacity_factor, wire=wire)
        self.stats = None
        self.config = dict(dispatch=dispatch, d_model=d_model,
                           hidden_mult=hidden_mult, vocab=vocab,
                           experts=experts, tokens=n,
                           capacity_factor=capacity_factor, world=world,
                           dp=mesh.dp, ep=ep,
                           wire=(epar.moe_wire(wire) if self.capacity
                                 else ""))

    def step(self):
        """One training step; returns the loss (a device tensor)."""
        out = self.train_step(self.params, self.opt_state, self.batch)
        if self.capacity:
            out, self.stats = out
        return out

    def sync(self) -> None:
        if self.on_cuda:
            torch.cuda.synchronize(self.device)


def synthetic_moe_train(dispatch: str = "capacity-int8", steps: int = 3,
                        warmup: int = 2, device: Optional[str] = None,
                        **kwargs) -> dict:
    """Train ``lm_bench --moe``'s model for ``warmup + steps`` steps: one
    weight-tied MoE block (embed -> top-1 routed expert MLP -> tied head),
    loss ``CE + 0.01 * aux``, Adam at 1e-2, f32, over a (dp, ep) grid of
    every rank (``ep = gcd(world, experts)`` unless given), with
    ``dispatch`` ``exact``, ``capacity`` (the exact exchange),
    ``capacity-int8`` or ``capacity-int4``; tokens from ``RandomState(0)``,
    weights from ``seed``. Widths default to lm_bench's on the TPU
    (``MOE_WIDTHS``); the other keywords are :class:`MoETrainer`'s.

    Returns ``losses``, ``tokens_per_sec`` (the global tokens of the timed
    steps over their wall time), ``step_ms``, ``drop_rate`` and
    ``imbalance`` (the last capacity step's; None under exact),
    ``peak_memory_bytes`` (None on the CPU), ``launches`` (per wrapper,
    this call) and the configuration."""
    tr = MoETrainer(dispatch, device=device, **kwargs)
    before = ck.launch_counts()
    if tr.on_cuda:
        torch.cuda.reset_peak_memory_stats(tr.device)
    losses = [tr.step() for _ in range(warmup)]
    tr.sync()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(steps)]
    tr.sync()
    elapsed = time.perf_counter() - t0
    after = ck.launch_counts()
    stats = tr.stats
    load = stats["load"].float().cpu() if stats is not None else None
    return {
        "losses": [float(v) for v in losses],
        "tokens_per_sec": tr.n_tokens * steps / elapsed if steps else None,
        "step_ms": 1e3 * elapsed / steps if steps else None,
        "drop_rate": (float(stats["dropped"]) / tr.n_tokens
                      if stats is not None else None),
        "imbalance": (float(load.max() / load.mean())
                      if load is not None else None),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(tr.device)
                              if tr.on_cuda else None),
        "launches": {k: after[k] - before[k] for k in after},
        "device": str(tr.device),
        **tr.config,
    }
