"""The port's rank-sharded input pipeline (``horovod_tpu_torch/data.py``)
against the reference's (``horovod_tpu/data.py``): byte-equal batches on
the same folder, seed and epoch for every rank of 4 across two epochs, and
the cases of ``tests/test_data_pipeline.py``; then two gloo ranks of the
port train on their shards through ``DistributedOptimizer``."""

import numpy as np
import pytest

import horovod_tpu.data as ref_data
import horovod_tpu_torch as hvd
from horovod_tpu_torch import testing
from horovod_tpu_torch.data import (ShardedImageFolder, _load_image,
                                    list_image_folder, shard_sizes)
from torch_data_workers import data_worker

Image = pytest.importorskip("PIL.Image", reason="Pillow is not installed")


@pytest.fixture()
def image_folder(tmp_path):
    """21 tiny PNGs over 3 classes (ragged: no batch grid divides it)."""
    rng = np.random.RandomState(0)
    for i in range(21):
        cdir = tmp_path / f"class_{i % 3}"
        cdir.mkdir(exist_ok=True)
        arr = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(cdir / f"img_{i:03d}.png")
    return str(tmp_path)


@pytest.fixture(scope="module")
def mixed_folder(tmp_path_factory):
    """4 classes of 8x8 images: uint8 and [0, 1] float ``.npy`` arrays, a
    2-D (grey) array, and PNGs, 45 files in all."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.RandomState(1)
    for i in range(45):
        cdir = root / f"c{i % 4}"
        cdir.mkdir(exist_ok=True)
        if i % 5 == 0:
            arr = (rng.rand(8, 8, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(cdir / f"p{i:02d}.png")
        elif i % 5 == 1:
            np.save(cdir / f"f{i:02d}.npy",
                    rng.rand(8, 8, 3).astype(np.float32))
        elif i % 5 == 2:
            np.save(cdir / f"g{i:02d}.npy",
                    (rng.rand(8, 8) * 255).astype(np.uint8))
        else:
            np.save(cdir / f"u{i:02d}.npy",
                    (rng.rand(8, 8, 3) * 255).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("rank", range(4))
def test_batches_byte_equal_to_the_reference(mixed_folder, rank):
    """Ranks 0-3 of 4, batch 2 (5 steps of the 45 files, 5 dropped), two
    epochs: the port's batches are the reference's, byte for byte."""
    kw = dict(batch_size=2, image_size=8, rank=rank, size=4, seed=11)
    port = ShardedImageFolder(mixed_folder, **kw)
    ref = ref_data.ShardedImageFolder(mixed_folder, **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch == 5
    assert port.paths == ref.paths and port.classes == ref.classes
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(port._indices(), ref._indices())
        got, want = list(port), list(ref)
        assert len(got) == len(want) == 5
        for (x, y), (rx, ry) in zip(got, want):
            assert x.dtype == rx.dtype == np.float32
            assert y.dtype == ry.dtype == np.int32
            assert x.tobytes() == rx.tobytes()
            assert y.tobytes() == ry.tobytes()


def test_unshuffled_and_shard_sizes_match_the_reference(mixed_folder):
    kw = dict(batch_size=3, image_size=8, rank=1, size=2, shuffle=False)
    got = list(ShardedImageFolder(mixed_folder, **kw))
    want = list(ref_data.ShardedImageFolder(mixed_folder, **kw))
    assert [(x.tobytes(), y.tobytes()) for x, y in got] == [
        (x.tobytes(), y.tobytes()) for x, y in want]
    for args in ((45, 2, 4), (21, 4, 2), (1000, 32, 8), (7, 8, 1)):
        assert shard_sizes(*args) == ref_data.shard_sizes(*args)


def test_list_image_folder_deterministic(image_folder):
    p1, l1, c1 = list_image_folder(image_folder)
    p2, l2, c2 = list_image_folder(image_folder)
    assert p1 == p2 and l1 == l2
    assert c1 == ["class_0", "class_1", "class_2"]
    assert len(p1) == 21
    assert all(f"class_{li}" in p for p, li in zip(p1, l1))


def test_shards_disjoint_and_cover(image_folder):
    world, bs = 2, 4
    loaders = [ShardedImageFolder(image_folder, batch_size=bs, image_size=8,
                                  rank=r, size=world, seed=3)
               for r in range(world)]
    # 21 images, global batch 8: 2 steps, 16 used, 5 dropped
    assert all(ld.steps_per_epoch == 2 for ld in loaders)
    assert shard_sizes(21, bs, world)["examples_dropped"] == 5
    seen = [set(ld._indices().tolist()) for ld in loaders]
    assert all(len(ld._indices()) == 8 for ld in loaders)
    assert seen[0].isdisjoint(seen[1])
    assert len(seen[0] | seen[1]) == 16


def test_set_epoch_reshuffles_identically(image_folder):
    loaders = [ShardedImageFolder(image_folder, batch_size=2, image_size=8,
                                  rank=r, size=2) for r in range(2)]
    e0 = [ld._indices().tolist() for ld in loaders]
    for ld in loaders:
        ld.set_epoch(1)
    e1 = [ld._indices().tolist() for ld in loaders]
    assert e0[0] != e1[0], "set_epoch did not reshuffle"
    for ep in (e0, e1):
        assert set(ep[0]).isdisjoint(set(ep[1]))
        assert len(set(ep[0]) | set(ep[1])) == 20


def test_batches_shapes_and_values(image_folder):
    ld = ShardedImageFolder(image_folder, batch_size=4, image_size=8,
                            rank=0, size=1, shuffle=False)
    batches = list(ld)
    assert len(batches) == ld.steps_per_epoch == 5
    for x, y in batches:
        assert x.shape == (4, 8, 8, 3) and x.dtype == np.float32
        assert y.shape == (4,) and y.dtype == np.int32
        assert 0.0 <= x.min() and x.max() <= 1.0
        assert set(y.tolist()) <= {0, 1, 2}


def test_npy_fixture_fallback(tmp_path):
    for i in range(4):
        cdir = tmp_path / f"c{i % 2}"
        cdir.mkdir(exist_ok=True)
        np.save(cdir / f"a_{i}.npy",
                np.full((8, 8, 3), float(i) / 4.0, np.float32))
    ld = ShardedImageFolder(str(tmp_path), batch_size=2, image_size=8,
                            rank=0, size=1, shuffle=False)
    (x, y), (x2, y2) = list(ld)
    assert x.shape == (2, 8, 8, 3)
    assert y.tolist() == [0, 0] and y2.tolist() == [1, 1]


def test_validation_errors(tmp_path, image_folder):
    (tmp_path / "empty_missing").mkdir()
    with pytest.raises(ValueError, match="no class subdirectories"):
        list_image_folder(str(tmp_path / "empty_missing"))
    with pytest.raises(ValueError, match="rank"):
        ShardedImageFolder(image_folder, batch_size=2, rank=2, size=2)
    with pytest.raises(ValueError, match="global batch"):
        ShardedImageFolder(image_folder, batch_size=64, rank=0, size=2)
    (tmp_path / "no_images" / "c0").mkdir(parents=True)
    with pytest.raises(ValueError, match="no images"):
        list_image_folder(str(tmp_path / "no_images"))


def test_mixed_shapes_and_npy_at_the_wrong_size_fail(tmp_path):
    cdir = tmp_path / "c0"
    cdir.mkdir()
    np.save(cdir / "a.npy", np.zeros((8, 8, 3), np.uint8))
    np.save(cdir / "b.npy", np.zeros((6, 6, 3), np.uint8))
    with pytest.raises(ValueError, match="mixes image shapes"):
        list(ShardedImageFolder(str(tmp_path), batch_size=2, rank=0, size=1,
                                shuffle=False))
    with pytest.raises(ValueError, match="must be stored at size"):
        list(ShardedImageFolder(str(tmp_path), batch_size=2, image_size=8,
                                rank=0, size=1, shuffle=False))


def test_npy_float_out_of_range_fails_loudly(tmp_path):
    cdir = tmp_path / "c0"
    cdir.mkdir()
    bad = cdir / "scaled_0_255.npy"
    np.save(bad, np.full((8, 8, 3), 200.0, np.float32))
    with pytest.raises(ValueError, match=r"NOT rescaled.*divide by.*255"):
        _load_image(str(bad), 8)
    np.save(cdir / "also_bad.npy", np.full((8, 8, 3), 99.0, np.float32))
    ld = ShardedImageFolder(str(tmp_path), batch_size=2, image_size=8,
                            rank=0, size=1, shuffle=False)
    with pytest.raises(ValueError, match="NOT rescaled"):
        list(ld)
    ok_f = cdir / "ok_float.npy"
    np.save(ok_f, np.full((8, 8, 3), 0.25, np.float32))
    assert _load_image(str(ok_f), 8).max() == pytest.approx(0.25)
    ok_u8 = cdir / "ok_uint8.npy"
    np.save(ok_u8, np.full((8, 8, 3), 51, np.uint8))
    assert _load_image(str(ok_u8), 8).max() == pytest.approx(0.2)


def test_rank_and_size_default_to_the_ports_basics(image_folder):
    hvd.init(device="cpu")
    try:
        ld = ShardedImageFolder(image_folder, batch_size=3, image_size=8)
        assert (ld.rank, ld.size) == (0, 1)
    finally:
        hvd.shutdown()


def test_two_ranks_train_on_disjoint_shards(image_folder):
    """Two gloo ranks of the port stream disjoint shards of the folder
    (rank and size from ``basics``) and train a linear model through
    ``DistributedOptimizer``: the weights end bit-identical."""
    ranks = testing.run_cluster(data_worker, np=2, device="cpu",
                                args=(image_folder, 2, 2), timeout=300)
    assert [r["size"] for r in ranks] == [2, 2]
    for epoch in range(2):
        a, b = (set(r["shards"][epoch]) for r in ranks)
        assert a.isdisjoint(b) and len(a | b) == 20
    assert ranks[0]["shards"][0] != ranks[0]["shards"][1]
    np.testing.assert_array_equal(ranks[0]["weight"], ranks[1]["weight"])
    assert np.abs(ranks[0]["weight"]).max() > 0
