"""Fused train augment: colour twist, grayscale, random erase and normalise in
one pass over the batch (the reference's DALI GPU augment ops,
dali_dataloader.py:81-122).

Three pieces, the port of ``sota_imagenet_tpu/ops/pallas_aug.py``:

* ``draw_augment_scalars`` / ``scalars_from_uniform`` — the per-image
  (B, 12 + 4*re_count) f32 parameters (colour matrix, offset, gray/erase
  flags, erase boxes), drawn outside the kernel. The draw is split from the
  mapping so a test can feed the mapping the uniforms JAX drew.
* ``fused_augment`` — the wrapper of the hand-written CUDA kernel
  (``csrc/fused_aug.cu``). A CUDA tensor launches the kernel or raises; a
  CPU tensor takes the plain version. It counts its launches in
  ``fused_augment.launches``.
* ``fused_augment_reference`` — the plain PyTorch version, with the kernel's
  (and the Pallas body's) f32 arithmetic order: the CPU path, and what the
  kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sota_imagenet_tpu_torch.constants import DATA_MEAN, DATA_STD
from sota_imagenet_tpu_torch.ops import cuda_build
from sota_imagenet_tpu_torch.ops.augment import _u8_round, dali_color_matrix

# m00..m22 (row-major), offset, apply_gray, apply_re
N_BASE_SCALARS = 12
MAX_RE_COUNT = 16  # csrc/fused_aug.cu kMaxBoxes

_SOURCES = ("fused_aug.cu",)


def scalars_from_uniform(
    u: torch.Tensor,
    *,
    color_twist_prob: float = 0.0,
    contrast_range: Tuple[float, float] = (0.7, 1.3),
    brightness_range: Tuple[float, float] = (0.7, 1.3),
    gray_prob: float = 0.0,
    re_prob: float = 0.0,
    re_count: int = 3,
) -> torch.Tensor:
    """Map u ~ U[0,1)^(B, 7 + 4*re_count) to the (B, 12 + 4*re_count) f32
    kernel scalars: colour matrix (identity when the colour coin said no),
    offset, gray/erase flags, erase boxes — the reference distributions
    (dali_dataloader.py:85-110; sota_imagenet_tpu/ops/pallas_aug.py:131-154)."""
    batch = u.shape[0]
    if u.shape[1] != 7 + 4 * re_count:
        raise ValueError(f"u must be (B, {7 + 4 * re_count}) for re_count={re_count}, got {tuple(u.shape)}")
    apply_ct = u[:, 0] < color_twist_prob
    brightness = brightness_range[0] + u[:, 1] * (brightness_range[1] - brightness_range[0])
    contrast = contrast_range[0] + u[:, 2] * (contrast_range[1] - contrast_range[0])
    hue_deg = -20.0 + u[:, 3] * 40.0
    saturation = 0.7 + u[:, 4] * 0.6
    a, off = dali_color_matrix(hue_deg, saturation, contrast, brightness)  # (B,3,3), (B,)
    eye = torch.eye(3, dtype=a.dtype, device=a.device).expand_as(a)
    a = torch.where(apply_ct[:, None, None], a, eye)
    off = torch.where(apply_ct, off, torch.zeros_like(off))
    cols = [
        a.reshape(batch, 9),
        off[:, None],
        (u[:, 5] < gray_prob).to(torch.float32)[:, None],
        (u[:, 6] < re_prob).to(torch.float32)[:, None],
    ]
    for k in range(re_count):
        base = 7 + 4 * k
        cols.append(u[:, base + 0 : base + 1])  # anchor y ~ U[0,1]
        cols.append(u[:, base + 1 : base + 2])  # anchor x
        cols.append(0.05 + u[:, base + 2 : base + 3] * 0.20)  # shape y ~ U[0.05,0.25]
        cols.append(0.05 + u[:, base + 3 : base + 4] * 0.20)  # shape x
    return torch.cat(cols, dim=1).to(torch.float32)


def draw_augment_scalars(
    generator: torch.Generator,
    batch: int,
    *,
    device=None,
    color_twist_prob: float = 0.0,
    contrast_range: Tuple[float, float] = (0.7, 1.3),
    brightness_range: Tuple[float, float] = (0.7, 1.3),
    gray_prob: float = 0.0,
    re_prob: float = 0.0,
    re_count: int = 3,
) -> torch.Tensor:
    """(B, 12 + 4*re_count) f32 per-image parameters, drawn on ``device``
    from ``generator`` (which must live on that device)."""
    u = torch.rand((batch, 7 + 4 * re_count), generator=generator, device=device, dtype=torch.float32)
    return scalars_from_uniform(
        u,
        color_twist_prob=color_twist_prob,
        contrast_range=contrast_range,
        brightness_range=brightness_range,
        gray_prob=gray_prob,
        re_prob=re_prob,
        re_count=re_count,
    )


def fused_augment_reference(
    images_u8: torch.Tensor,
    scalars: torch.Tensor,
    *,
    color_twist_prob: float = 0.0,
    gray_prob: float = 0.0,
    re_prob: float = 0.0,
    re_count: int = 3,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B,H,W,3) uint8 -> (B,H,W,3)
    ``out_dtype``, with the Pallas body's f32 operation order
    (sota_imagenet_tpu/ops/pallas_aug.py:58-114)."""
    b, h, w, _ = images_u8.shape
    x = images_u8.to(torch.float32)
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    s = scalars.to(torch.float32)

    def col(k):
        return s[:, k].view(b, 1, 1)

    if color_twist_prob > 0:
        off = col(9)
        rt = col(0) * r + col(1) * g + col(2) * bl + off
        gt = col(3) * r + col(4) * g + col(5) * bl + off
        bt = col(6) * r + col(7) * g + col(8) * bl + off
        r, g, bl = _u8_round(rt), _u8_round(gt), _u8_round(bt)
    if gray_prob > 0:
        luma = _u8_round(0.299 * r + 0.587 * g + 0.114 * bl)
        apply_gray = col(10) != 0.0
        r = torch.where(apply_gray, luma, r)
        g = torch.where(apply_gray, luma, g)
        bl = torch.where(apply_gray, luma, bl)
    if re_prob > 0:
        lin = torch.arange(h * w, device=x.device).view(h, w)
        px = (lin % w).to(torch.float32) * (1.0 / w)
        py = (lin // w).to(torch.float32) * (1.0 / h)
        mask = torch.zeros((b, h, w), dtype=torch.bool, device=x.device)
        for k in range(re_count):
            base = N_BASE_SCALARS + 4 * k
            ay, ax, sy, sx = col(base), col(base + 1), col(base + 2), col(base + 3)
            mask = mask | ((py >= ay) & (py < ay + sy) & (px >= ax) & (px < ax + sx))
        mask = mask & (col(11) != 0.0)
        r = torch.where(mask, 128.0, r)
        g = torch.where(mask, 128.0, g)
        bl = torch.where(mask, 128.0, bl)
    inv = 1.0 / DATA_STD
    return torch.stack([(r - DATA_MEAN) * inv, (g - DATA_MEAN) * inv, (bl - DATA_MEAN) * inv], dim=-1).to(out_dtype)


def _check(images_u8: torch.Tensor, scalars: torch.Tensor, re_count: int, out_dtype: torch.dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"images must be (B, H, W, 3) uint8, got {tuple(images_u8.shape)} {images_u8.dtype}")
    if not 0 <= re_count <= MAX_RE_COUNT:
        raise ValueError(f"re_count must be in [0, {MAX_RE_COUNT}], got {re_count}")
    n = N_BASE_SCALARS + 4 * re_count
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (images_u8.shape[0], n):
        raise ValueError(f"scalars must be ({images_u8.shape[0]}, {n}) float32, got {tuple(scalars.shape)} {scalars.dtype}")
    if scalars.device != images_u8.device:
        raise ValueError(f"images on {images_u8.device} but scalars on {scalars.device}")
    # checked on every device, so the CPU path holds callers to the kernel's contract
    if not (images_u8.is_contiguous() and scalars.is_contiguous()):
        raise ValueError("fused_augment needs contiguous images and scalars")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = cuda_build.load("fused_aug", _SOURCES)
    fn = lib.fused_aug_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # images u8
            ctypes.c_void_p,  # scalars f32
            ctypes.c_void_p,  # out
            ctypes.c_int,  # out is bf16
            ctypes.c_int,  # batch
            ctypes.c_int,  # h
            ctypes.c_int,  # w
            ctypes.c_int,  # n_scalars
            ctypes.c_int,  # color stage on
            ctypes.c_int,  # gray stage on
            ctypes.c_int,  # erase stage on
            ctypes.c_int,  # re_count
            ctypes.c_float,  # f32(1/w)
            ctypes.c_float,  # f32(1/h)
            ctypes.c_float,  # f32(1/DATA_STD)
            ctypes.c_void_p,  # cudaStream_t
        ]
    return lib


def fused_augment(
    images_u8: torch.Tensor,
    scalars: torch.Tensor,
    *,
    color_twist_prob: float = 0.0,
    gray_prob: float = 0.0,
    re_prob: float = 0.0,
    re_count: int = 3,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Normalized (B, H, W, 3) images in ``out_dtype``; mirror comes after.

    A stage runs iff its probability is > 0 (the per-image coins are in
    ``scalars``). On a CUDA tensor this launches ``csrc/fused_aug.cu`` on the
    current stream; on a CPU tensor it runs ``fused_augment_reference``."""
    _check(images_u8, scalars, re_count, out_dtype)
    kw = dict(color_twist_prob=color_twist_prob, gray_prob=gray_prob, re_prob=re_prob, re_count=re_count)
    if images_u8.device.type == "cpu":
        return fused_augment_reference(images_u8, scalars, out_dtype=out_dtype, **kw)
    if images_u8.device.type != "cuda":
        raise ValueError(f"fused_augment runs on cuda or cpu tensors, got {images_u8.device}")
    lib = library()
    b, h, w, _ = images_u8.shape
    out = torch.empty((b, h, w, 3), dtype=out_dtype, device=images_u8.device)
    with torch.cuda.device(images_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_aug_launch(
            images_u8.data_ptr(),
            scalars.data_ptr(),
            out.data_ptr(),
            int(out_dtype == torch.bfloat16),
            b,
            h,
            w,
            scalars.shape[1],
            int(color_twist_prob > 0),
            int(gray_prob > 0),
            int(re_prob > 0),
            re_count,
            1.0 / w,
            1.0 / h,
            1.0 / DATA_STD,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_aug kernel launch failed with CUDA error {err}")
    fused_augment.launches += 1
    return out


fused_augment.launches = 0
