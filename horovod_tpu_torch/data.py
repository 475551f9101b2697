"""Rank-sharded input pipeline for data-parallel training (counterpart of
``horovod_tpu/data.py``, copied: it is numpy only).

The reference's real-data flow (``examples/keras_imagenet_resnet50.py``,
``examples/pytorch_imagenet_resnet50.py``: per-rank iterators over an
on-disk image folder with ``DistributedSampler`` semantics):

* :func:`list_image_folder` -- deterministic (path, label) scan of a
  ``root/<class>/<image>`` tree (the Keras ``flow_from_directory`` layout).
* :class:`ShardedImageFolder` -- one GLOBAL permutation per epoch (seeded
  ``seed + epoch`` identically on every rank, reseeded by ``set_epoch``),
  strided rank sharding ``indices[rank::size]``, truncation to whole global
  batches so every rank runs the same number of steps.

Decoding uses PIL when the files are images and plain ``np.load`` for
``.npy`` arrays. Batches are host numpy, NHWC f32 images and int32 labels;
the caller moves them to its device.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif")


def list_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """Scan a ``root/<class>/<file>`` tree into (paths, labels, classes).

    Classes are the sorted subdirectory names, labels their indices; files
    are sorted within each class — the listing is deterministic, so every
    rank/host derives the identical order (a prerequisite for the shared
    global permutation, like the reference sampler's ``len(dataset)``
    contract)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"no class subdirectories under {root!r} "
                         "(expected root/<class>/<image> layout)")
    paths: List[str] = []
    labels: List[int] = []
    for li, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(_IMG_EXTS + (".npy",)):
                paths.append(os.path.join(cdir, fname))
                labels.append(li)
    if not paths:
        raise ValueError(f"no images found under {root!r}")
    return paths, labels, classes


def _load_image(path: str, image_size: Optional[int]) -> np.ndarray:
    """One file -> float32 HWC in [0, 1]."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        # scale by DTYPE, not by value: a per-file value heuristic would mix
        # 0-1 and 0-255 scales within one dataset (a dark uint8-saved-as-float
        # image must not come out 255x brighter than its neighbours)
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = arr.astype(np.float32)
            # float fixtures are taken at face value as [0, 1]; a float
            # array of 0-255 pixel values would silently train 255x out of
            # range, so fail loudly (1.5 leaves headroom for slightly
            # out-of-gamut normalized data while catching 0-255 scales)
            amax = float(arr.max()) if arr.size else 0.0
            if amax > 1.5:
                raise ValueError(
                    f"{path}: float .npy fixture has max value {amax:.3g} "
                    "but float fixtures are NOT rescaled — expected [0, 1] "
                    "data (store uint8 for 0-255 pixel data, or divide by "
                    "255 before saving)")
    else:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("RGB")
            if image_size is not None:
                im = im.resize((image_size, image_size))
            arr = np.asarray(im, dtype=np.float32) / 255.0
    if image_size is not None and arr.shape[:2] != (image_size, image_size):
        raise ValueError(
            f"{path}: got shape {arr.shape}, expected "
            f"({image_size}, {image_size}, 3) — resize only applies to "
            "image files; .npy fixtures must be stored at size")
    return arr


class ShardedImageFolder:
    """Per-rank iterator over an image folder with DistributedSampler
    semantics.

    Every rank holds the SAME global permutation (seeded by
    ``seed + epoch``); rank ``r`` reads ``perm[r::size]``. The global
    length is truncated to a multiple of ``batch_size * size`` so each
    rank runs the identical number of steps per epoch — a rank with one
    extra batch would hang the others' collectives (the reference solves
    the same problem with DistributedSampler's padding; truncation keeps
    epochs exact-data at the cost of dropping a partial tail batch).

    Usage (the reference's `pytorch_imagenet_resnet50.py` loop shape)::

        ds = ShardedImageFolder(root, batch_size=32, image_size=224,
                                rank=hvd.rank(), size=hvd.size())
        for epoch in range(epochs):
            ds.set_epoch(epoch)          # reshuffle, identically on all ranks
            for x, y in ds:              # numpy [B,H,W,3] f32, [B] i32
                step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    """

    def __init__(self, root: str, batch_size: int,
                 image_size: Optional[int] = None,
                 rank: Optional[int] = None, size: Optional[int] = None,
                 shuffle: bool = True, seed: int = 0):
        if rank is None or size is None:
            from . import basics

            rank = basics.rank() if rank is None else rank
            size = basics.size() if size is None else size
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} not in [0, {size})")
        self.paths, self.labels, self.classes = list_image_folder(root)
        self.batch_size = int(batch_size)
        self.image_size = image_size
        self.rank, self.size = int(rank), int(size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self._epoch = 0
        per_step = self.batch_size * self.size
        self._global_len = (len(self.paths) // per_step) * per_step
        if self._global_len == 0:
            raise ValueError(
                f"{len(self.paths)} images < one global batch "
                f"({self.batch_size} x {self.size} ranks)")

    @property
    def steps_per_epoch(self) -> int:
        return self._global_len // (self.batch_size * self.size)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shared permutation (DistributedSampler.set_epoch
        parity) — call before iterating each epoch, with the same epoch
        number on every rank."""
        self._epoch = int(epoch)

    def _indices(self) -> np.ndarray:
        if self.shuffle:
            perm = np.random.RandomState(self.seed + self._epoch).permutation(
                len(self.paths))
        else:
            perm = np.arange(len(self.paths))
        return perm[:self._global_len][self.rank::self.size]

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._indices()
        for s in range(self.steps_per_epoch):
            batch = idx[s * self.batch_size:(s + 1) * self.batch_size]
            imgs = [_load_image(self.paths[i], self.image_size)
                    for i in batch]
            shapes = {im.shape for im in imgs}
            if len(shapes) > 1:
                raise ValueError(
                    f"batch mixes image shapes {sorted(shapes)} — pass "
                    "image_size= to ShardedImageFolder to resize on load "
                    "(required for datasets with non-uniform dimensions)")
            x = np.stack(imgs)
            y = np.asarray([self.labels[i] for i in batch], np.int32)
            yield x, y


def shard_sizes(n_examples: int, batch_size: int, size: int) -> dict:
    """How one epoch of ``n_examples`` divides over ``size`` ranks at
    ``batch_size`` a rank."""
    per_step = batch_size * size
    steps = n_examples // per_step
    return {
        "global_batch": per_step,
        "steps_per_epoch": steps,
        "examples_used": steps * per_step,
        "examples_dropped": n_examples - steps * per_step,
        "examples_per_rank_per_epoch": steps * batch_size,
    }
