"""The port's train augment (sota_imagenet_tpu_torch.ops.augment / fused_aug)
against the JAX package's Pallas augment, run interpreted on the CPU as the
JAX package's own tests run it (tests/test_pallas_aug.py).

Both sides get the same inputs: images from numpy, and the uniforms JAX
draws are handed to the port's scalar mapping. Tolerances:
  * scalars: rtol/atol 1e-6 (f32 cos/sin and 3x3 matrix products in a
    different summation order);
  * augment output: exact, except where a colour/luma sum lands on an exact
    .5 rounding tie: XLA:CPU contracts a*b+c into FMAs there, the port (and
    its CUDA kernel) rounds every operation, so such a pixel may move by one
    uint8 step — at most 1/51 after normalize, on at most 0.1% of values.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_fused_aug_cuda.py, marked ``cuda``; chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.ops.augment import _batch_gaussian_blur as jax_blur
from sota_imagenet_tpu.ops.augment import build_val_augment as jax_build_val_augment
from sota_imagenet_tpu.ops.pallas_aug import draw_augment_scalars as jax_draw_scalars
from sota_imagenet_tpu.ops.pallas_aug import pallas_augment
from sota_imagenet_tpu_torch.constants import DATA_MEAN, DATA_STD
from sota_imagenet_tpu_torch.ops.augment import _batch_gaussian_blur, build_train_augment, build_val_augment
from sota_imagenet_tpu_torch.ops.fused_aug import (
    draw_augment_scalars,
    fused_augment,
    fused_augment_reference,
    scalars_from_uniform,
)

STAGES = {
    "off": dict(color_twist_prob=0.0, gray_prob=0.0, re_prob=0.0, re_count=3),
    "on_re1": dict(color_twist_prob=0.4, gray_prob=0.2, re_prob=0.3, re_count=1),
    "on_re3": dict(color_twist_prob=0.4, gray_prob=0.2, re_prob=0.3, re_count=3),
}
SHAPES = {"8x32x32": (8, 32, 32), "ragged_3x37x53": (3, 37, 53)}


def _imgs(b, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), np.uint8)


def _jax_scalars(kw, b, seed=1):
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, (b, 7 + 4 * kw["re_count"])))
    return u, np.asarray(jax_draw_scalars(key, b, **kw))


@pytest.mark.parametrize("stages", ["on_re1", "on_re3"])
def test_scalars_from_uniform_matches_jax(stages):
    kw = STAGES[stages]
    u, want = _jax_scalars(kw, 64)
    got = scalars_from_uniform(torch.from_numpy(u), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _assert_close_up_to_ties(got, want):
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert diff.max() <= 1.0 / DATA_STD + 1e-3, diff.max()
    assert np.mean(diff > 0) <= 1e-3, np.mean(diff > 0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("stages", sorted(STAGES))
def test_reference_matches_pallas_interpreted(shape, stages):
    b, h, w = SHAPES[shape]
    kw = STAGES[stages]
    imgs = _imgs(b, h, w)
    _, scalars = _jax_scalars(kw, b)
    if stages != "off":  # every other image grayed, every image erased
        scalars = scalars.copy()
        scalars[:, 10] = np.arange(b) % 2
        scalars[:, 11] = 1.0
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(pallas_augment(jnp.asarray(imgs), jnp.asarray(scalars), out_dtype=jdt, interpret=True, **kw))
        got = fused_augment_reference(torch.from_numpy(imgs), torch.from_numpy(scalars), out_dtype=tdt, **kw)
        assert got.dtype == tdt and tuple(got.shape) == (b, h, w, 3)
        _assert_close_up_to_ties(got.float().numpy(), want.astype(np.float32))


def test_wrapper_takes_plain_version_on_cpu_and_checks_inputs():
    imgs = torch.from_numpy(_imgs(2, 8, 8))
    scalars = draw_augment_scalars(torch.Generator().manual_seed(0), 2, **STAGES["on_re3"])
    before = fused_augment.launches
    out = fused_augment(imgs, scalars, out_dtype=torch.float32, **STAGES["on_re3"])
    ref = fused_augment_reference(imgs, scalars, out_dtype=torch.float32, **STAGES["on_re3"])
    assert torch.equal(out, ref)
    assert fused_augment.launches == before  # only kernel launches count
    with pytest.raises(ValueError):
        fused_augment(imgs.float(), scalars)
    with pytest.raises(ValueError):
        fused_augment(imgs, scalars[:, :-1], re_count=3)
    with pytest.raises(ValueError):
        fused_augment(imgs, scalars, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):  # the kernel's contract holds on the CPU too
        fused_augment(imgs.transpose(1, 2), scalars, **STAGES["on_re3"])


def test_blur_matches_jax():
    imgs = _imgs(3, 20, 24).astype(np.float32)
    sigmas = np.asarray([0.5, 0.8, 1.1], np.float32)
    want = np.asarray(jax_blur(jnp.asarray(imgs), jnp.asarray(sigmas)))
    got = _batch_gaussian_blur(torch.from_numpy(imgs), torch.from_numpy(sigmas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_val_augment_matches_jax(out_dtype):
    imgs, labels = _imgs(4, 16, 16), np.asarray([0, 3, 9, 1])
    want = jax_build_val_augment(num_classes=10, out_dtype=getattr(jnp, out_dtype))(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(labels)
    )
    got = build_val_augment(num_classes=10, out_dtype=getattr(torch, out_dtype))(
        None, torch.from_numpy(imgs), torch.from_numpy(labels)
    )
    np.testing.assert_array_equal(got["image"].float().numpy(), np.asarray(want["image"]).astype(np.float32))
    np.testing.assert_array_equal(got["label"].numpy(), np.asarray(want["label"]))


def test_train_augment_normalizes_and_mirrors():
    """Stages off (r50_baseline): every image is the normalized input or its
    mirror; labels are one-hot."""
    imgs = _imgs(16, 8, 12)
    aug = build_train_augment(num_classes=10, out_dtype=torch.float32)
    out = aug(torch.Generator().manual_seed(0), torch.from_numpy(imgs), torch.arange(16) % 10)
    norm = (imgs.astype(np.float32) - np.float32(DATA_MEAN)) * np.float32(1.0 / DATA_STD)
    image = out["image"].numpy()
    mirrored = [np.array_equal(image[i], norm[i, :, ::-1]) for i in range(16)]
    assert all(np.array_equal(image[i], norm[i]) or mirrored[i] for i in range(16))
    assert 0 < sum(mirrored) < 16
    np.testing.assert_array_equal(out["label"].numpy(), np.eye(10, dtype=np.float32)[np.arange(16) % 10])


def test_mirror_applied_after_erase():
    """Erase precedes mirror (dali_dataloader.py:113-122): pre-mirror, boxes
    anchored in U[0,1] only clip at the right edge; the trailing mirror makes
    left-edge-clipped boxes appear too. Mirror-first would give none."""
    b, s = 64, 16
    imgs = np.full((b, s, s, 3), 255, np.uint8)
    aug = build_train_augment(num_classes=10, re_prob=1.0, re_count=3, out_dtype=torch.float32)
    out = aug(torch.Generator().manual_seed(3), torch.from_numpy(imgs), torch.zeros(b, dtype=torch.int64))
    denorm = out["image"].numpy() * DATA_STD + DATA_MEAN
    erased = np.abs(denorm[..., 0] - 128.0) < 0.6
    left = int(np.sum(erased[:, :, 0].any(axis=1)))
    right = int(np.sum(erased[:, :, -1].any(axis=1)))
    assert left >= 3, f"no left-edge erases: mirror ran before erase (left={left}, right={right})"
    assert right >= 3


def test_train_augment_with_every_stage_runs_on_cpu():
    imgs = _imgs(6, 24, 20)
    aug = build_train_augment(
        num_classes=5, blur_prob=0.5, color_twist_prob=0.5, gray_prob=0.5, re_prob=0.5, out_dtype=torch.bfloat16
    )
    out = aug(torch.Generator().manual_seed(1), torch.from_numpy(imgs), torch.arange(6) % 5)
    assert out["image"].dtype == torch.bfloat16 and tuple(out["image"].shape) == (6, 24, 20, 3)
    assert torch.isfinite(out["image"].float()).all()


def test_train_augment_builds_no_tensor_from_host_data_per_step(monkeypatch):
    """The colour matrices are made once per device: a tensor built from host
    data on every step would be a copy to the card and a wait for its stream
    (two a step on the H100 before this was repaired), which holds the host
    to the card."""
    aug = build_train_augment(num_classes=10, color_twist_prob=0.5, out_dtype=torch.float32)
    imgs, labels = torch.from_numpy(_imgs(4, 8, 8)), torch.arange(4)
    aug(torch.Generator().manual_seed(0), imgs, labels)  # the first step may build them

    def from_host(*a, **kw):
        raise AssertionError("torch.tensor called in a train step")

    monkeypatch.setattr(torch, "tensor", from_host)
    out = aug(torch.Generator().manual_seed(1), imgs, labels)
    assert out["image"].shape == (4, 8, 8, 3)
