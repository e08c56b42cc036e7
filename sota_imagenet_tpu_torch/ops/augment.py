"""On-device augmentation (port of ``sota_imagenet_tpu/ops/augment.py``:46-78,
119-145,172-243,283-314; the DALI GPU-augment replacement).

The host ships raw uint8 NHWC crops (or, under loader.device_resample,
canvases that ops/resample.py resizes first); on the device the train augment runs
blur (a per-sample-sigma depthwise conv), then the fused colour twist /
grayscale / erase / normalize kernel (ops/fused_aug.py, CUDA), then the
mirror, then one-hot labels — the reference pipeline's order
(dali_dataloader.py:81-123): erase precedes mirror.

On CUDA tensors the train augment always goes through the kernel, as the JAX
package always takes its Pallas kernel on a TPU (augment.py:198-243); on CPU
tensors it takes the kernel's plain PyTorch version. Randomness comes from an
explicit ``torch.Generator`` on the batch's device.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch.constants import DATA_MEAN, DATA_STD

# DALI colour math — linearized YIQ, not true HSV (sota_imagenet_tpu/ops/augment.py:23-43):
# fn.color_twist / fn.hsv are one linear transform in YIQ space with one
# saturating round-to-uint8 at the end of each DALI op.
RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.321), (0.211, -0.523, 0.311))
YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.107, 1.705))


@functools.lru_cache(maxsize=None)
def _yiq_matrices(device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(YIQ2RGB, RGB2YIQ) on ``device``, built once per device and dtype: a
    tensor made from host data copies it to the card and waits for the
    stream, which on every train step would hold the host to the card."""
    return torch.tensor(YIQ2RGB, dtype=dtype, device=device), torch.tensor(RGB2YIQ, dtype=dtype, device=device)


def dali_color_matrix(hue_deg, saturation, contrast, brightness):
    """Per-image 3x3 matrix + offset reproducing DALI fn.color_twist (a linear
    transform in YIQ space; sota_imagenet_tpu/ops/augment.py:46-71).

    out = A @ rgb + off with A = brightness*contrast * YIQ2RGB @ R(h)S(s) @ RGB2YIQ
    and off = brightness*128*(1-contrast). Takes (B,) f32 tensors; returns
    (B, 3, 3) and (B,)."""
    h = hue_deg * (torch.pi / 180.0)
    c, s = torch.cos(h), torch.sin(h)
    one, zero = torch.ones_like(h), torch.zeros_like(h)
    sat = saturation
    chroma = torch.stack(
        [
            torch.stack([one, zero, zero], -1),
            torch.stack([zero, sat * c, sat * s], -1),
            torch.stack([zero, -sat * s, sat * c], -1),
        ],
        -2,
    )
    yiq2rgb, rgb2yiq = _yiq_matrices(h.device, h.dtype)
    m = yiq2rgb @ chroma @ rgb2yiq
    a = (brightness * contrast)[..., None, None] * m
    off = brightness * 128.0 * (1.0 - contrast)
    return a, off


def _u8_round(x: torch.Tensor) -> torch.Tensor:
    """DALI materializes uint8 between pipeline ops: saturating cast with
    round-half-to-even (torch.round and CUDA rintf both round half to even)."""
    return torch.clamp(torch.round(x), 0.0, 255.0)


def _batch_gaussian_blur(images: torch.Tensor, sigmas: torch.Tensor, window: int = 11) -> torch.Tensor:
    """Per-sample-sigma separable gaussian blur (window 11, dali_dataloader.py:82)
    of (B, H, W, C) float images in two depthwise convs: samples are packed
    into the channel dim and each channel gets its own kernel (augment.py:119-145)."""
    b, h, w, c = images.shape
    r = window // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=images.device)
    kern = torch.exp(-0.5 * (xs[None, :] / torch.clamp(sigmas[:, None], min=1e-3)) ** 2)  # (B, win)
    kern = kern / kern.sum(dim=1, keepdim=True)
    kern_bc = kern.repeat_interleave(c, dim=0)  # (B*C, win), per packed channel
    x = images.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    x = F.conv2d(x, kern_bc.view(b * c, 1, window, 1), padding=(r, 0), groups=b * c)  # vertical
    x = F.conv2d(x, kern_bc.view(b * c, 1, 1, window), padding=(0, r), groups=b * c)  # horizontal
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1).contiguous()


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot rows; a label outside [0, num_classes), such as the -1
    of a padded val sample, gives a zero row (as ``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[:, None] == classes).to(torch.float32)


def build_train_augment(
    *,
    num_classes: int = 1000,
    blur_prob: float = 0.0,
    gray_prob: float = 0.0,
    color_twist_prob: float = 0.0,
    contrast_range: Tuple[float, float] = (0.7, 1.3),
    brightness_range: Tuple[float, float] = (0.7, 1.3),
    re_prob: float = 0.0,
    re_count: int = 3,
    out_dtype: torch.dtype = torch.bfloat16,
    resample_to: int = None,
) -> Callable:
    """Returns fn(generator, images_u8, labels) -> {'image', 'label'}:
    images (B, H, W, 3) ``out_dtype`` NHWC, labels one-hot float32. With
    ``resample_to`` it is fn(generator, canvases_u8, labels, meta): the device
    resample (ops/resample.py) to ``resample_to`` px comes first, and its
    uint8 batch enters the augment (augment.py:283-303 of the JAX package)."""
    from sota_imagenet_tpu_torch.ops.fused_aug import draw_augment_scalars, fused_augment

    kernel_kw = dict(color_twist_prob=color_twist_prob, gray_prob=gray_prob, re_prob=re_prob, re_count=re_count)

    def augment(generator: torch.Generator, images_u8: torch.Tensor, labels: torch.Tensor):
        bsz, dev = images_u8.shape[0], images_u8.device
        if blur_prob > 0:
            imgf = images_u8.to(torch.float32)
            sigmas = 0.5 + 0.6 * torch.rand(bsz, generator=generator, device=dev)
            blurred = _batch_gaussian_blur(imgf, sigmas)
            pick = (torch.rand(bsz, generator=generator, device=dev) < blur_prob).view(bsz, 1, 1, 1)
            images_u8 = _u8_round(torch.where(pick, blurred, imgf)).to(torch.uint8)
        scalars = draw_augment_scalars(
            generator,
            bsz,
            device=dev,
            contrast_range=tuple(contrast_range),
            brightness_range=tuple(brightness_range),
            **kernel_kw,
        )
        images = fused_augment(images_u8, scalars, out_dtype=out_dtype, **kernel_kw)
        # mirror LAST, like the reference (crop_mirror_normalize comes after
        # erase, dali_dataloader.py:113-122): erase boxes only clip at the
        # right/bottom edge pre-mirror, and the mirror symmetrizes them.
        # Mirror commutes with the pointwise normalize inside the kernel.
        mirror = (torch.rand(bsz, generator=generator, device=dev) < 0.5).view(bsz, 1, 1, 1)
        images = torch.where(mirror, images.flip(2), images)
        return {"image": images, "label": one_hot(labels, num_classes)}

    if resample_to is None:
        return augment
    from sota_imagenet_tpu_torch.ops.resample import device_resample

    def with_resample(generator: torch.Generator, images_u8: torch.Tensor, labels: torch.Tensor, meta: torch.Tensor):
        # dense NHWC, as the kernel reads it (the einsum may hand back a permuted view)
        resampled = device_resample(images_u8, meta, out_size=resample_to)
        resampled = resampled.to(torch.uint8, memory_format=torch.contiguous_format)
        return augment(generator, resampled, labels)

    return with_resample


def build_val_augment(*, num_classes: int = 1000, out_dtype: torch.dtype = torch.bfloat16) -> Callable:
    def augment(generator, images_u8: torch.Tensor, labels: torch.Tensor):
        del generator  # uniform signature with the train augment
        # XLA evaluates the JAX package's (x - mean) / std as a multiply by
        # f32(1/std) (bit for bit), which is also the train kernel's normalize
        images = ((images_u8.to(torch.float32) - DATA_MEAN) * (1.0 / DATA_STD)).to(out_dtype)
        return {"image": images, "label": one_hot(labels, num_classes)}

    return augment
