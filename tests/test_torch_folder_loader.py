"""The port's ImageFolder loader (``FolderLoader``, ``scan_image_folder``),
its ``DeviceFeed`` of 3-tuples and the folder branch of ``build_loader``
against the JAX package's, on a small JPEG tree written from a seed.

``FolderLoader``'s batches, labels, masks and resample meta are exactly the
JAX loader's over two epochs, in all four modes: the native batch executor
or the PIL thread pool, each with the resize on the host or, with
``device_resample``, DCT-scaled canvases for the device (compared on each
canvas's valid extent: the native core leaves the rest of its buffer
unwritten, and the device resample gives it zero weight). The val loader's
padded tail (the last image repeated, label -1, mask 0) and its mask on
every batch are exact too, and so is the whole val feed, the JAX one on the
8-device CPU mesh. The native modes skip only when ``native/libimgpipe.so``
cannot be built here."""

import copy
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.data import native as jnative
from sota_imagenet_tpu.data import pipeline as JP
from sota_imagenet_tpu.ops.augment import build_val_augment as jax_val_augment
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.data import decode as D
from sota_imagenet_tpu_torch.data import native
from sota_imagenet_tpu_torch.data import pipeline as P
from sota_imagenet_tpu_torch.ops.augment import build_train_augment, build_val_augment

TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_synthetic.yaml")
N_TRAIN, N_VAL, CLASSES = 30, 13, 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/{train,val}/class_<c>/*: 32-96 px JPEGs of low-frequency content,
    one PNG and one grayscale JPEG in each split."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        for i in range(n):
            d = root / split / f"class_{i % CLASSES}"
            os.makedirs(d, exist_ok=True)
            w, h = (int(v) for v in rng.integers(32, 97, 2))
            img = Image.fromarray(rng.integers(0, 256, (4, 5, 3), np.uint8)).resize((w, h), Image.BILINEAR)
            if i == 3:
                img.save(d / f"{i:03d}.png")
            elif i == 4:
                img.convert("L").save(d / f"{i:03d}.jpg", quality=90)
            else:
                img.save(d / f"{i:03d}.jpg", quality=90)
    (root / "train" / "class_0" / "notes.txt").write_text("not an image")
    return str(root)


@pytest.fixture(params=["pil", "native"])
def decoder(request, monkeypatch):
    """Which decoder both packages use: PIL (the native library made
    unavailable to both) or the native core."""
    if request.param == "native":
        if not native.available():
            pytest.skip("native/libimgpipe.so cannot be built here")
        assert jnative.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


def _epochs(loader, epochs=2):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


def _assert_batches_equal(got, want, meta_kind):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g[1], w[1])  # labels
        if meta_kind == "resample":
            np.testing.assert_array_equal(g[2], w[2])  # (sh, sw, filt)
            for img, jimg, (sh, sw, _) in zip(g[0], w[0], g[2]):
                np.testing.assert_array_equal(img[:sh, :sw], jimg[:sh, :sw])
        else:
            np.testing.assert_array_equal(g[0], w[0])
            if len(g) > 2:
                np.testing.assert_array_equal(g[2], w[2])  # val mask


def test_scan_image_folder_matches_jax(tree):
    got = P.scan_image_folder(os.path.join(tree, "train"))
    assert got == JP.scan_image_folder(os.path.join(tree, "train"))
    assert len(got[0]) == N_TRAIN and got[2] == ["class_0", "class_1", "class_2"]


@pytest.mark.parametrize("device_resample", [False, True], ids=["host_resize", "device_resample"])
def test_train_batches_match_jax_over_two_epochs(tree, decoder, device_resample):
    kw = dict(is_train=True, batch_size=8, image_size=16, workers=2, random_interpolation=True,
              device_resample=device_resample)
    port = P.FolderLoader(os.path.join(tree, "train"), **kw)
    ref = JP.FolderLoader(os.path.join(tree, "train"), **kw)
    assert port.meta_kind == ref.meta_kind == ("resample" if device_resample else None)
    assert len(port) == len(ref) == N_TRAIN // 8
    got, want = _epochs(port), _epochs(ref)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w, port.meta_kind)
    labels = [np.concatenate([b[1] for b in ep]) for ep in got]
    assert not np.array_equal(labels[0], labels[1]), "the shuffle changes with the epoch"
    if device_resample:
        assert got[0][0][0].shape == (8, D.resample_canvas(16), D.resample_canvas(16), 3)


def test_train_decoder_counts(tree, decoder):
    before = dict(D.decoded)
    loader = P.FolderLoader(os.path.join(tree, "train"), is_train=True, batch_size=8, image_size=16, workers=2)
    n = sum(b[0].shape[0] for b in loader)
    pil = D.decoded["pil"] - before["pil"]
    nat = D.decoded["native"] - before["native"]
    assert pil + nat == n
    if decoder == "pil":
        assert nat == 0
    else:  # PIL takes the PNG and whatever the C core gives back (the JAX loader does the same)
        assert nat > n // 2


@pytest.mark.parametrize("full_crop", [False, True])
def test_val_batches_padding_and_masks_match_jax(tree, decoder, full_crop):
    kw = dict(is_train=False, batch_size=8, image_size=24, workers=2, drop_last=False, full_crop=full_crop)
    port = P.FolderLoader(os.path.join(tree, "val"), **kw)
    got, want = _epochs(port), _epochs(JP.FolderLoader(os.path.join(tree, "val"), **kw))
    for g, w in zip(got, want):
        _assert_batches_equal(g, w, None)
    images, labels, mask = got[0][-1]
    n_tail = N_VAL - 8
    assert [len(b) for b in got[0]] == [3, 3], "every val batch carries a mask"
    assert mask.tolist() == [1.0] * n_tail + [0.0] * (8 - n_tail)
    assert (labels[n_tail:] == -1).all()
    assert all((images[i] == images[n_tail - 1]).all() for i in range(n_tail, 8)), "the last image repeats"


def test_val_feed_matches_jax_feed(tree, mesh8, decoder):
    """The port's DeviceFeed of the padded val loader (on the CPU) against the
    JAX DeviceFeed on the 8-device CPU mesh: images, one-hot labels (zero rows
    for the pads) and the mask exact."""
    kw = dict(is_train=False, batch_size=8, image_size=24, workers=2, drop_last=False)
    port = P.DeviceFeed(P.FolderLoader(os.path.join(tree, "val"), **kw),
                        build_val_augment(num_classes=CLASSES, out_dtype=torch.float32), device="cpu")
    ref = JP.DeviceFeed(JP.FolderLoader(os.path.join(tree, "val"), **kw), mesh8,
                        jax_val_augment(num_classes=CLASSES, out_dtype=jnp.float32))
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "label", "mask"}
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    assert got[-1]["label"][N_VAL - 8:].abs().sum() == 0


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, generator, *tensors):
        self.calls.append(tensors)
        return {"image": tensors[0], "label": tensors[1]}


def test_device_feed_hands_meta_to_the_augment_and_masks_to_the_batch():
    class Host:
        batch_size = 2

        def __init__(self, third, meta_kind):
            self.third, self.meta_kind = third, meta_kind

        def __len__(self):
            return 1

        def __iter__(self):
            yield np.zeros((2, 4, 4, 3), np.uint8), np.array([1, -1], np.int32), self.third

    meta = np.array([[3, 4, 0], [4, 4, 1]], np.int32)
    aug = _Recorder()
    (batch,) = list(P.DeviceFeed(Host(meta, "resample"), aug, device="cpu"))
    assert len(aug.calls[0]) == 3 and torch.equal(aug.calls[0][2], torch.from_numpy(meta))
    assert "mask" not in batch
    aug = _Recorder()
    mask = np.array([1.0, 0.0], np.float32)
    (batch,) = list(P.DeviceFeed(Host(mask, None), aug, device="cpu", label_divisor=2))
    assert len(aug.calls[0]) == 2 and torch.equal(batch["mask"], torch.from_numpy(mask))
    assert batch["label"].tolist() == [0, -1], "pad labels stay -1 under the divisor"


def test_device_resample_feed_matches_the_host_resize_feed(tree):
    """The port's feed with device_resample against its host-resize feed
    (the same crops, the same augment draws): the resampled pixels within the
    resampler's rounding, 2 uint8 steps after the colour twist
    (tests/test_device_resample.py:121 holds the JAX feeds so)."""
    if not native.available():
        pytest.skip("native/libimgpipe.so cannot be built here")
    kw = dict(is_train=True, batch_size=8, image_size=32, workers=2, random_interpolation=True)
    aug_kw = dict(num_classes=CLASSES, out_dtype=torch.float32, color_twist_prob=0.5, re_prob=0.5)
    host = P.DeviceFeed(P.FolderLoader(os.path.join(tree, "train"), **kw), build_train_augment(**aug_kw),
                        device="cpu", seed=7)
    dev = P.DeviceFeed(P.FolderLoader(os.path.join(tree, "train"), device_resample=True, **kw),
                       build_train_augment(resample_to=32, **aug_kw), device="cpu", seed=7)
    for bh, bd in zip(host, dev):
        assert torch.equal(bh["label"], bd["label"])
        assert (bh["image"] - bd["image"]).abs().max() <= 2.0 / 51.0 + 1e-5


# --------------------------------------------------------------------------- #
# build_loader / _build_host_loader / DataManager
# --------------------------------------------------------------------------- #


def _cfg(tree, *overrides, config=TINY):
    base = [f"loader.root_data_dir={tree}", f"val_loader.root_data_dir={tree}", "loader.backend=auto",
            "val_loader.backend=auto", "loader.workers=2", "val_loader.workers=2"]
    return TC.load(config, overrides=[*base, *overrides], strict_env=False)


def test_auto_backend_finds_the_folder_tree(tree):
    cfg = _cfg(tree)
    assert isinstance(P._build_host_loader(cfg.loader, True), P.FolderLoader)
    val = P._build_host_loader(cfg.val_loader, False)
    assert isinstance(val, P.FolderLoader) and not val.drop_last and not val.is_train
    cfg = _cfg(tree, "val_loader.rectangular=true")
    assert isinstance(P._build_host_loader(cfg.val_loader, False), P.RectValLoader)
    missing = _cfg(os.path.join(tree, "nowhere"))
    assert isinstance(P._build_host_loader(missing.loader, True), P.SyntheticLoader)


def test_folder_loader_takes_the_jax_arguments(tree):
    cfg = _cfg(tree, "loader.min_area=0.3", "loader.random_interpolation=true", "loader.interpolation=cubic",
               "val_loader.full_crop=true", "loader.device_resample=true")
    train = P._build_host_loader(cfg.loader, True)
    ref = JP._build_host_loader(JC.load(TINY, overrides=[f"loader.root_data_dir={tree}", "loader.backend=folder",
                                                          "loader.min_area=0.3", "loader.random_interpolation=true",
                                                          "loader.interpolation=cubic", "loader.device_resample=true",
                                                          "loader.workers=2"], strict_env=False).loader, True)
    for attr in ("batch_size", "image_size", "min_area", "random_interpolation", "interpolation", "workers",
                 "drop_last", "device_resample", "meta_kind", "seed", "files"):
        assert getattr(train, attr) == getattr(ref, attr), attr
    assert P._build_host_loader(cfg.val_loader, False).full_crop


def test_build_loader_composes_the_resample(tree):
    feed = P.build_loader(_cfg(tree, "loader.device_resample=true", "loader.batch_size=8").loader, True, device="cpu")
    assert feed.host.meta_kind == "resample"
    batches = list(feed)
    assert len(batches) == N_TRAIN // 8
    assert tuple(batches[0]["image"].shape) == (8, 32, 32, 3) and tuple(batches[0]["label"].shape) == (8, 1000)


def test_device_cache_with_rectangular_val_is_rejected_first(tree):
    cfg = _cfg(tree, "val_loader.device_cache=true", "val_loader.rectangular=true")
    with pytest.raises(ValueError, match="incompatible with val_loader.rectangular"):
        P.build_loader(cfg.val_loader, False, device="cpu")


def test_accumulation_multiplies_the_loader_batch_as_in_jax(mesh8):
    """accumulate_steps 2 at batch_size 16: the loader's batch is 32, split
    by the train step into two microbatches of 16 (the JAX DataManager's
    rule, pipeline.py:682-687)."""
    overrides = ["loader.batch_size=16", "val_loader.batch_size=16", "run.accumulate_steps=2", "loader.image_size=8"]
    dm = P.DataManager(TC.load(TINY, overrides=overrides, strict_env=False), device="cpu")
    dm.set_stage(0)
    jdm = JP.DataManager(JC.load(TINY, overrides=overrides, strict_env=False), mesh8)
    jdm.set_stage(0)
    assert dm.loader.batch_size == jdm.loader.batch_size == 32
    assert dm.val_loader.batch_size == jdm.val_loader.batch_size == 16


def test_loader_config_is_not_mutated_by_the_stage(tree):
    cfg = _cfg(tree, "run.accumulate_steps=2")
    before = copy.deepcopy(dict(cfg.loader))
    dm = P.DataManager(cfg, device="cpu")
    dm.set_stage(0)
    assert dict(cfg.loader) == before and dm.loader.batch_size == 2 * before["batch_size"]
