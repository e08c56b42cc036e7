"""The port's packed records (``sota_imagenet_tpu_torch.data.packed``) against
the JAX package's ``data/packed.py`` on a tiny JPEG tree.

``create_packed_records`` of both packages, with the same decoder, writes
byte-identical shards and indexes, with one crop per image and with two;
``PackedLoader``'s batches (images, labels, the val mask of the padded tail)
are the JAX loader's over two epochs. Both decoders are held: PIL (the
native library made unavailable to both packages, one writer process) and
the native core with the port's pool of spawned writers (its processes do not
see a monkeypatch, so they use what the host has; the native core's failures
fall back to PIL for the same files in both packages)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from sota_imagenet_tpu.data import native as jnative
from sota_imagenet_tpu.data import packed as JPK
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.data import decode as D
from sota_imagenet_tpu_torch.data import native
from sota_imagenet_tpu_torch.data import packed as PK
from sota_imagenet_tpu_torch.data import pipeline as P
from sota_imagenet_tpu_torch.data import records as R

TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_synthetic.yaml")
N_TRAIN, N_VAL, CLASSES, SIZE = 18, 7, 3, 24


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/{train,val}/class_<c>/*.jpg: 40-90 px JPEGs of low-frequency content and one PNG."""
    root = tmp_path_factory.mktemp("packed_tree")
    rng = np.random.default_rng(3)
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        for i in range(n):
            d = root / split / f"class_{i % CLASSES}"
            os.makedirs(d, exist_ok=True)
            w, h = (int(v) for v in rng.integers(40, 91, 2))
            img = Image.fromarray(rng.integers(0, 256, (4, 5, 3), np.uint8)).resize((w, h), Image.BILINEAR)
            img.save(d / (f"{i:03d}.png" if i == 3 else f"{i:03d}.jpg"), **({} if i == 3 else {"quality": 90}))
    return str(root)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if "_packed" in d:
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _pack_both(tree, tmp_path, decoder, monkeypatch, **kw):
    if decoder == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
        port_workers = 1
    else:
        if not native.available():
            pytest.skip("native/libimgpipe.so cannot be built here")
        port_workers = 2  # the spawned pool
    kw = dict(image_size=SIZE, train_shards=4, val_shards=2, **kw)
    PK.create_packed_records(tree, str(tmp_path / "port"), workers=port_workers, **kw)
    JPK.create_packed_records(tree, str(tmp_path / "jax"), workers=1, **kw)
    return str(tmp_path / "port"), str(tmp_path / "jax")


@pytest.mark.parametrize("crops", [1, 2])
@pytest.mark.parametrize("decoder", ["pil", "native"])
def test_shards_and_indexes_are_byte_identical_to_jax(tree, tmp_path, monkeypatch, decoder, crops):
    port, jax_out = _pack_both(tree, tmp_path, decoder, monkeypatch, crops_per_image=crops)
    got, want = _files(port), _files(jax_out)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("train_packed" + os.sep)]) == 4
    for name in want:
        assert got[name] == want[name], name
    n = sum(len(R.read_index(os.path.join(port, k))) for k in got if k.startswith("train_packed_indexes"))
    assert n == N_TRAIN * crops


def test_train_records_hold_the_online_decode(tree, tmp_path, monkeypatch):
    """A packed train sample is decode_train of its file with the writer's
    generator ((seed, replica, index) over the seed-42 shuffle)."""
    port, _ = _pack_both(tree, tmp_path, "pil", monkeypatch)
    files, labels, _ = P.scan_image_folder(os.path.join(tree, "train"))
    got = {}
    rec_dir, _ = PK.packed_dirs(port, "train")
    for name in sorted(os.listdir(rec_dir)):
        for payload in R.read_tfrecord(os.path.join(rec_dir, name)):
            ex = R.decode_example(payload)
            got[ex["image/filename"].decode()] = (np.frombuffer(ex["image/raw"], np.uint8).reshape(SIZE, SIZE, 3),
                                                   ex["image/class/label"])
    assert len(got) == N_TRAIN
    for i, (path, label) in enumerate(zip(files, labels)):
        want = D.decode_train(path, np.random.default_rng((R.SHUFFLE_SEED, 0, i)), SIZE)
        img, lab = got[os.path.basename(path)]
        np.testing.assert_array_equal(img, want)
        assert lab == label


@pytest.fixture(scope="module")
def packed_tree(tree, tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        out = str(tmp_path_factory.mktemp("packed_out"))
        PK.create_packed_records(tree, out, image_size=SIZE, train_shards=4, val_shards=2, workers=1)
    return out


def _epochs(loader, epochs=2):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("workers", [1, 3])
def test_train_loader_batches_match_jax_over_two_epochs(packed_tree, workers):
    kw = dict(is_train=True, batch_size=4, image_size=SIZE, workers=workers)
    port, ref = PK.PackedLoader(packed_tree, **kw), JPK.PackedLoader(packed_tree, **kw)
    assert len(port) == len(ref) == N_TRAIN // 4
    got, want = _epochs(port), _epochs(ref)
    for g_ep, w_ep in zip(got, want):
        assert len(g_ep) == len(w_ep)
        for g, w in zip(g_ep, w_ep):
            assert len(g) == len(w) == 2
            assert g[0].dtype == np.uint8 and g[0].shape == (4, SIZE, SIZE, 3) and g[1].dtype == np.int32
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
    labels = [np.concatenate([b[1] for b in ep]) for ep in got]
    assert not np.array_equal(labels[0], labels[1]), "the shuffle changes with the epoch"
    again = PK.PackedLoader(packed_tree, **kw)
    for (a, la), (b, lb) in zip(got[0], again):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_val_loader_pads_and_masks_its_tail_as_jax(packed_tree):
    kw = dict(is_train=False, batch_size=3, image_size=SIZE, drop_last=False, workers=2)
    got, want = _epochs(PK.PackedLoader(packed_tree, **kw)), _epochs(JPK.PackedLoader(packed_tree, **kw))
    for g_ep, w_ep in zip(got, want):
        assert len(g_ep) == len(w_ep) == 3  # 7 val images at batch 3: 3 + 3 + a padded 1
        for g, w in zip(g_ep, w_ep):
            assert len(g) == len(w) == 3, "every val batch carries a mask"
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    imgs, labels, mask = got[0][-1]
    assert mask.tolist() == [1.0, 0.0, 0.0] and labels[1:].tolist() == [-1, -1]
    assert (imgs[1:] == imgs[0]).all(), "the last image repeats"
    assert sum(float(b[2].sum()) for b in got[0]) == N_VAL


def test_size_mismatch_raises(packed_tree):
    with pytest.raises(ValueError, match="rebuild with create_packed_records"):
        PK.PackedLoader(packed_tree, is_train=True, batch_size=4, image_size=2 * SIZE)


def test_process_shards_take_every_nth_entry(packed_tree, monkeypatch):
    whole = PK.PackedLoader(packed_tree, is_train=True, batch_size=4, image_size=SIZE)
    monkeypatch.setattr(PK, "process_index", lambda: 1)
    monkeypatch.setattr(PK, "process_count", lambda: 2)
    second = PK.PackedLoader(packed_tree, is_train=True, batch_size=4, image_size=SIZE)
    assert second.entries == whole.entries[1::2]


def test_build_loader_packed_backend_feeds_the_augment(packed_tree):
    """use_packed reaches PackedLoader (root = the packed tree, as the JAX
    branch), and DeviceFeed hands the train augment its batches."""
    cfg = TC.load(TINY, overrides=[f"loader.root_data_dir={packed_tree}", "loader.backend=auto", "loader.use_packed=true",
                                   f"loader.image_size={SIZE}", "loader.batch_size=4", "loader.workers=2"],
                  strict_env=False)
    host = P._build_host_loader(cfg.loader, True)
    assert isinstance(host, PK.PackedLoader) and host.drop_last and host.workers == 2
    feed = P.build_loader(cfg.loader, True, device="cpu", out_dtype=torch.float32)
    batches = list(feed)
    assert len(batches) == N_TRAIN // 4
    assert tuple(batches[0]["image"].shape) == (4, SIZE, SIZE, 3) and batches[0]["image"].dtype == torch.float32
    val = P._build_host_loader(cfg.loader, False)
    assert isinstance(val, PK.PackedLoader) and not val.drop_last and not val.is_train


def test_records_cli_packs_a_tree(tree, tmp_path, monkeypatch):
    from sota_imagenet_tpu_torch import cli

    monkeypatch.setattr(native, "available", lambda: False)
    cli.records_main(["packed", tree, "--out", str(tmp_path), "--size", str(SIZE), "--workers", "1",
                      "--crops-per-image", "2"])
    loader = PK.PackedLoader(str(tmp_path), is_train=True, batch_size=4, image_size=SIZE)
    assert len(loader.entries) == 2 * N_TRAIN
    assert len(os.listdir(PK.packed_dirs(str(tmp_path), "val")[0])) == R.VAL_SHARDS
    # tfrecord is ported (tests/test_torch_tfrecord_loader.py): it writes the shards beside their indexes
    cli.records_main(["tfrecord", tree, "--out", str(tmp_path / "tf"), "--workers", "1"])
    assert len(os.listdir(tmp_path / "tf" / "val_records")) == R.VAL_SHARDS
    # resize is ported (tests/test_torch_resize_tool.py): it writes the mirror tree
    cli.records_main(["resize", tree, "--size", str(SIZE), "--workers", "1"])
    assert os.path.isdir(tree.rstrip("/") + f"_{SIZE}")
