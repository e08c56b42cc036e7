"""The port's device resample (``sota_imagenet_tpu_torch/ops/resample.py``)
against the JAX package's (``sota_imagenet_tpu/ops/resample.py``), its
composition ahead of the train augment, and the one-hot of the pad label.

Tolerances: the weights within 1e-6 of JAX's (both float32, other orders of
operations); the resampled pixels at most 1 uint8 step apart on at most 0.1%
of the values (two float32 sums in other orders can land on the two sides of
a .5 before the half-up rounding), and the CPU resample of a scaled decode
within 1 step of the host resize, as tests/test_device_resample.py holds
JAX."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sota_imagenet_tpu.ops import resample as JR
from sota_imagenet_tpu_torch.data import decode as D
from sota_imagenet_tpu_torch.data import native
from sota_imagenet_tpu_torch.ops import augment as A
from sota_imagenet_tpu_torch.ops import resample as R


def _meta(rng, n, canvas, out_size):
    """(n, 3) [sh, sw, filt]: extents from below to above the target, both filters."""
    sizes = rng.integers(out_size // 2, canvas + 1, (n, 2))
    return np.concatenate([sizes, rng.integers(0, 2, (n, 1))], axis=1).astype(np.int32)


@pytest.mark.parametrize("out_size, canvas", [(16, 40), (32, 80), (24, 24)])
def test_weights_match_jax(out_size, canvas):
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, canvas + 1, 12).astype(np.int32)
    cubic = rng.integers(0, 2, 12).astype(bool)
    got = R.resample_weights(torch.from_numpy(sizes), out_size, canvas, torch.from_numpy(cubic)).numpy()
    want = np.asarray(JR.resample_weights(jnp.asarray(sizes), out_size, canvas, jnp.asarray(cubic)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for b, s in enumerate(sizes):
        assert np.abs(got[b, :, s:]).max(initial=0.0) == 0.0, "weights beyond the valid extent must be exact zero"
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_weights_are_the_identity_when_size_equals_out():
    w = R.resample_weights(torch.tensor([32]), 32, 64, torch.tensor([False]))
    np.testing.assert_allclose(w[0, :, :32].numpy(), np.eye(32), atol=1e-6)
    assert w[0, :, 32:].abs().max() == 0.0


@pytest.mark.parametrize("out_size, canvas, batch", [(16, 40, 12), (32, 80, 6)])
def test_device_resample_matches_jax(out_size, canvas, batch):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (batch, canvas, canvas, 3), np.uint8)
    meta = _meta(rng, batch, canvas, out_size)
    got = R.device_resample(torch.from_numpy(images), torch.from_numpy(meta), out_size=out_size).numpy()
    want = np.asarray(JR.device_resample(jnp.asarray(images), jnp.asarray(meta), out_size=out_size))
    assert got.shape == (batch, out_size, out_size, 3) and got.dtype == np.float32
    assert np.array_equal(got, np.floor(got)) and got.min() >= 0 and got.max() <= 255
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_rounding_is_half_up_not_half_to_even():
    """[0, 1] resampled to one pixel by the triangle filter is exactly 0.5:
    floor(x + 0.5) gives 1 where torch.round would give 0."""
    img = torch.zeros((1, 2, 2, 3), dtype=torch.uint8)
    img[0, :, 1] = 1
    out = R.device_resample(img, torch.tensor([[2, 2, R.FILT_TRIANGULAR]]), out_size=1)
    assert out.flatten().tolist() == [1.0, 1.0, 1.0]


def test_resample_is_full_float32_even_with_tf32_allowed(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    real = torch.einsum

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "einsum", spy)
    R.device_resample(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), torch.tensor([[8, 8, 0]]), out_size=4)
    assert seen == [False, False] and torch.backends.cuda.matmul.allow_tf32


def _jpeg(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def test_scaled_decode_and_resample_match_the_host_decode():
    """decode_train (host resample) against decode_train_scaled + the port's
    resample with the same generator: the same crop and filter draws, pixels
    within one step (tests/test_device_resample.py:90-105 holds JAX so)."""
    if not native.available():
        pytest.skip("native/libimgpipe.so cannot be built here")
    rng_img = np.random.default_rng(0)
    for h, w in [(500, 400), (120, 100), (90, 140)]:
        small = rng_img.integers(0, 256, (6, 5, 3), np.uint8)
        data = _jpeg(np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR)))
        for seed in range(3):
            host = D.decode_train(data, np.random.default_rng(seed), 56, random_interpolation=True)
            img, sh, sw, filt = D.decode_train_scaled(data, np.random.default_rng(seed), 56, random_interpolation=True)
            dev = R.device_resample(torch.from_numpy(img[None]), torch.tensor([[sh, sw, filt]]), out_size=56)[0]
            assert np.abs(dev.numpy().astype(int) - host.astype(int)).max() <= 1


def test_train_augment_resamples_first():
    """build_train_augment(resample_to=...) is the device resample, cast to
    uint8, then the augment: the same as calling the two in turn."""
    rng = np.random.default_rng(2)
    canvases = torch.from_numpy(rng.integers(0, 256, (4, 40, 40, 3), np.uint8))
    meta = torch.from_numpy(_meta(rng, 4, 40, 16))
    labels = torch.tensor([0, 1, 2, -1])
    kw = dict(num_classes=3, out_dtype=torch.float32, color_twist_prob=0.5, gray_prob=0.3, re_prob=0.5)
    got = A.build_train_augment(resample_to=16, **kw)(torch.Generator().manual_seed(5), canvases, labels, meta)
    resampled = R.device_resample(canvases, meta, out_size=16).to(torch.uint8)
    want = A.build_train_augment(**kw)(torch.Generator().manual_seed(5), resampled.contiguous(), labels)
    assert torch.equal(got["image"], want["image"]) and torch.equal(got["label"], want["label"])
    assert tuple(got["image"].shape) == (4, 16, 16, 3)


@pytest.mark.parametrize("which", ["train", "val"])
def test_pad_label_gives_a_zero_one_hot_row_as_in_jax(which):
    labels = np.array([2, -1, 0, -1], np.int32)
    images = torch.zeros((4, 8, 8, 3), dtype=torch.uint8)
    build = A.build_train_augment if which == "train" else A.build_val_augment
    got = build(num_classes=3, out_dtype=torch.float32)(torch.Generator(), images, torch.from_numpy(labels))["label"]
    want = np.asarray(jax.nn.one_hot(jnp.asarray(labels), 3, dtype=jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1].abs().sum() == 0
