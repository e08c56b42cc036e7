"""Host-side JPEG decode + geometric augmentation (port of
``sota_imagenet_tpu/data/decode.py``:36-279; replaces DALI's decode stage,
reference dali_dataloader.py:65-79,145-148).

Decode stays on the host CPUs, as in the JAX package; the tricks that keep
it cheap:

  * JPEG *draft mode*: libjpeg decodes directly at 1/2, 1/4, 1/8 scale from
    the DCT coefficients, at the smallest scale that still covers the
    requested crop (DALI's fused decode+random_crop idea).
  * the random crop happens before the full-resolution resize, so the
    expensive filter runs on crop-sized data only.

Distributions match DALI's ``decoders.image_random_crop``
(dali_dataloader.py:65-72): aspect ~ U[0.75, 1.25] (uniform, not
log-uniform like torchvision), area ~ U[min_area, 1.0], 100 attempts then a
centre fallback. Interpolation: triangular == PIL BILINEAR (antialiased
triangle filter), cubic == PIL BICUBIC; random_interpolation picks the other
filter per image with p=0.5 (dali_dataloader.py:74-79). Every function draws
from its ``np.random.Generator`` in the JAX package's order, so the same
generator gives the same crop and filter in both packages.
"""

from __future__ import annotations

import io
import math
import threading
from typing import Tuple, Union

import numpy as np
from PIL import Image

from sota_imagenet_tpu_torch.data import native

TRIANGULAR = Image.BILINEAR
CUBIC = Image.BICUBIC

# images decoded in this process, by decoder: the native libjpeg core or PIL
# (non-JPEG files, or no native library). Read by tools that report which
# decoder ran; the decode pools' threads add to it under the lock.
decoded = {"native": 0, "pil": 0}
_DECODED_LOCK = threading.Lock()


def count_decoded(decoder: str, n: int = 1) -> None:
    with _DECODED_LOCK:
        decoded[decoder] += n


def _open(src: Union[str, bytes]) -> Image.Image:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return Image.open(io.BytesIO(src))
    return Image.open(src)


def sample_random_crop(
    rng: np.random.Generator,
    width: int,
    height: int,
    min_area: float = 0.08,
    max_area: float = 1.0,
    aspect_range: Tuple[float, float] = (0.75, 1.25),
    num_attempts: int = 100,
) -> Tuple[int, int, int, int]:
    """(x, y, w, h) with DALI's distribution (dali_dataloader.py:65-72)."""
    area = width * height
    for _ in range(num_attempts):
        target_area = rng.uniform(min_area, max_area) * area
        aspect = rng.uniform(*aspect_range)
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            x = int(rng.integers(0, width - w + 1))
            y = int(rng.integers(0, height - h + 1))
            return x, y, w, h
    # fallback: biggest valid center crop at aspect 1
    s = min(width, height)
    return (width - s) // 2, (height - s) // 2, s, s


def _read_bytes(src: Union[str, bytes]) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def pick_filter(rng: np.random.Generator, random_interpolation: bool, interpolation: str) -> int:
    """0 (triangular) or 1 (cubic): the base filter, or with
    ``random_interpolation`` the other one with p=0.5 (one draw)."""
    base = 1 if interpolation == "cubic" else 0
    return (1 - base) if (random_interpolation and rng.random() < 0.5) else base


def decode_train(
    src: Union[str, bytes],
    rng: np.random.Generator,
    image_size: int,
    min_area: float = 0.08,
    random_interpolation: bool = False,
    interpolation: str = "triangular",
    use_native: bool = True,
) -> np.ndarray:
    """Decode + random-resized-crop to (image_size, image_size, 3) uint8.

    ``interpolation`` sets the base resize filter (legacy flat-schema
    ``resize_method: cubic``); ``random_interpolation`` flips to the OTHER
    filter with p=0.5 per image.

    Fast path: the native libjpeg core (data/native.py) fuses scaled decode,
    crop and antialiased resize in C with the GIL released; PIL otherwise
    (identical distributions)."""
    if use_native and native.available():
        data = _read_bytes(src)
        dims = native.jpeg_dims(data)
        if dims is not None:
            x, y, w, h = sample_random_crop(rng, *dims, min_area=min_area)
            filt = pick_filter(rng, random_interpolation, interpolation)
            out = native.decode_crop_resize(data, (x, y, w, h), (image_size, image_size), filt)
            if out is not None:
                count_decoded("native")
                return out
    img = _open(src)
    w0, h0 = img.size
    x, y, w, h = sample_random_crop(rng, w0, h0, min_area=min_area)
    # draft-mode decode: smallest DCT scale whose crop still >= image_size
    if img.format == "JPEG":
        img.draft("RGB", (max(w0 * image_size // max(w, 1), 1), max(h0 * image_size // max(h, 1), 1)))
        sw, sh = img.size
        if (sw, sh) != (w0, h0):
            sx, sy = sw / w0, sh / h0
            x, y = int(x * sx), int(y * sy)
            w, h = max(int(w * sx), 1), max(int(h * sy), 1)
    if img.mode != "RGB":
        img = img.convert("RGB")
    crop = img.crop((x, y, x + w, y + h))
    interp = CUBIC if pick_filter(rng, random_interpolation, interpolation) else TRIANGULAR
    out = crop.resize((image_size, image_size), interp)
    count_decoded("pil")
    return np.asarray(out, dtype=np.uint8)


def resample_canvas(image_size: int) -> int:
    """Fixed device-resample canvas: 2.5x the target, rounded up to a multiple
    of 8. The DCT-scale rule (smallest n/8 with scaled crop >= target in both
    dims) bounds the scaled min dim below 2*target, and the DALI aspect
    distribution bounds max/min <= 1.25, so the scaled max dim stays under
    2.5*target: no legal crop overflows the canvas."""
    return (5 * image_size // 2 + 7) // 8 * 8


def decode_train_scaled(
    src: Union[str, bytes],
    rng: np.random.Generator,
    image_size: int,
    min_area: float = 0.08,
    random_interpolation: bool = False,
    interpolation: str = "triangular",
    use_native: bool = True,
) -> Tuple[np.ndarray, int, int, int]:
    """Host half of the device-resample split: sample the DALI crop, decode it
    at the best DCT scale without host resampling. Returns (canvas uint8
    (C, C, 3) top-left-anchored, sh, sw, filt) for ops/resample.py on the
    device. The crop and filter draws are decode_train's, in its order, so
    switching loader.device_resample changes only where the resample runs."""
    canvas = resample_canvas(image_size)
    if use_native and native.available():
        data = _read_bytes(src)
        dims = native.jpeg_dims(data)
        if dims is not None:
            x, y, w, h = sample_random_crop(rng, *dims, min_area=min_area)
            filt = pick_filter(rng, random_interpolation, interpolation)
            out = native.decode_crop_scaled(data, (x, y, w, h), image_size, canvas)
            if out is not None:
                img, sh, sw = out
                count_decoded("native")
                return img, sh, sw, filt
    # PIL (non-JPEG / no library): decode the crop at full resolution; if it
    # fits the canvas the device resamples it (the C path at DCT scale 8/8);
    # else resize to the target here (the device resample is then the identity).
    count_decoded("pil")
    img = _open(src)
    w0, h0 = img.size
    x, y, w, h = sample_random_crop(rng, w0, h0, min_area=min_area)
    filt = pick_filter(rng, random_interpolation, interpolation)
    if img.mode != "RGB":
        img = img.convert("RGB")
    crop = img.crop((x, y, x + w, y + h))
    cw, ch = crop.size
    canvas_img = np.zeros((canvas, canvas, 3), np.uint8)
    if cw <= canvas and ch <= canvas:
        canvas_img[:ch, :cw] = np.asarray(crop, dtype=np.uint8)
        return canvas_img, ch, cw, filt
    resized = crop.resize((image_size, image_size), CUBIC if filt else TRIANGULAR)
    canvas_img[:image_size, :image_size] = np.asarray(resized, dtype=np.uint8)
    return canvas_img, image_size, image_size, filt


def val_resize_size(image_size: int, full_crop: bool = False) -> int:
    """Shorter-side resize target (reference formula, dali_dataloader.py:147)."""
    if full_crop:
        return image_size
    return int(math.ceil((image_size * 1.14 + 8) // 16 * 16))


def _resize_shorter(img: Image.Image, resize_shorter: int, min_w: int, min_h: int) -> Image.Image:
    """Draft-decode a JPEG near ``resize_shorter``, convert to RGB, and resize
    its shorter side to ``resize_shorter`` (triangular), at least
    (min_w, min_h)."""
    w0, h0 = img.size
    if img.format == "JPEG":
        scale = resize_shorter / min(w0, h0)
        img.draft("RGB", (max(int(w0 * scale), 1), max(int(h0 * scale), 1)))
        w0, h0 = img.size
    if img.mode != "RGB":
        img = img.convert("RGB")
    scale = resize_shorter / min(w0, h0)
    nw, nh = max(int(round(w0 * scale)), min_w), max(int(round(h0 * scale)), min_h)
    return img.resize((nw, nh), TRIANGULAR)


def _center_crop(img: Image.Image, ch: int, cw: int) -> np.ndarray:
    nw, nh = img.size
    x, y = (nw - cw) // 2, (nh - ch) // 2
    return np.asarray(img.crop((x, y, x + cw, y + ch)), dtype=np.uint8)


def decode_val(src: Union[str, bytes], image_size: int, full_crop: bool = False, use_native: bool = True) -> np.ndarray:
    """Decode → resize shorter side → center crop (dali_dataloader.py:145-158)."""
    if use_native and native.available():
        data = _read_bytes(src)
        out = native.decode_val(data, val_resize_size(image_size, full_crop), image_size)
        if out is not None:
            count_decoded("native")
            return out
    count_decoded("pil")
    resize_shorter = val_resize_size(image_size, full_crop)
    img = _resize_shorter(_open(src), resize_shorter, resize_shorter, resize_shorter)
    return _center_crop(img, image_size, image_size)


# --------------------------------------------------------------------------- #
# Rectangular validation (closes the reference's TODO, dali_dataloader.py:5)
# --------------------------------------------------------------------------- #


def rect_buckets(image_size: int):
    """Three static aspect buckets (h, w): tall / square / wide. The long side
    is 4:3-ish rounded down to a multiple of 8; the aspect threshold is chosen
    so the shorter-side resize always leaves enough pixels to crop the long
    side (resize target ≈ 1.14*size ≥ long/thresh)."""
    long = max(int(image_size * 4 / 3) // 8 * 8, (image_size + 8) // 8 * 8)
    thresh = max(1.2, long / val_resize_size(image_size) + 0.02)
    return {
        "tall": (long, image_size),
        "square": (image_size, image_size),
        "wide": (image_size, long),
    }, thresh


def bucket_of(width: int, height: int, thresh: float) -> str:
    if width >= height * thresh:
        return "wide"
    if height >= width * thresh:
        return "tall"
    return "square"


def decode_val_rect(src: Union[str, bytes], image_size: int, crop_hw) -> np.ndarray:
    """Aspect-preserving validation decode: resize the shorter side to the
    reference target (dali_dataloader.py:147), center-crop to the bucket's
    rectangular (h, w). Always PIL, as in the JAX package."""
    count_decoded("pil")
    ch, cw = crop_hw
    img = _resize_shorter(_open(src), val_resize_size(image_size), cw, ch)
    return _center_crop(img, ch, cw)
