"""Device-side image resampling as batched dense products (port of
``sota_imagenet_tpu/ops/resample.py``:41-85).

The device half of the device-resample split (reference analog: DALI's GPU
resize after fused decode+crop, dali_dataloader.py:73-80). The host ships
the DCT-scaled crop on a fixed (canvas, canvas) uint8 buffer plus its valid
(h, w) extent; here each image is resampled to (out_size, out_size) by two
batched products with per-sample weight matrices built on the device from
the extents:

    tmp[b,o,w,c] = sum_i Wv[b,o,i] * img[b,i,w,c]        (vertical pass)
    out[b,o,p,c] = sum_j Wh[b,p,j] * tmp[b,o,j,c]        (horizontal pass)

The JAX package computes this outside any Pallas kernel (two einsums that
XLA lowers), so the port's are two ``torch.einsum`` in float32, forced to
full float32 whatever ``torch.backends.cuda.matmul.allow_tf32`` says: TF32
moves pixels by more than one uint8 step.

The weight math is the host resampler's (native/imgpipe.cpp build_taps,
itself matched to PIL/DALI): triangle or Catmull-Rom (a=-0.5) kernel,
antialias widening by fscale=max(in/out, 1) on downscale, pixel-centre
mapping centre(o) = (o+0.5)*in/out - 0.5, exact-zero weights beyond the
valid extent and rows renormalised. The final cast rounds half up
(floor(x + 0.5)) and clamps, like the C path's +0.5f cast; it is not the
augment's half-to-even rounding. When in == out the triangle weights are
the identity, so host-side fallback resizes pass through unchanged.
"""

from __future__ import annotations

import contextlib

import torch

FILT_TRIANGULAR = 0
FILT_CUBIC = 1


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _catmull_rom(x: torch.Tensor) -> torch.Tensor:
    # Keys cubic, a = -0.5 (PIL BICUBIC / DALI INTERP_CUBIC; imgpipe.cpp:54-60)
    a = -0.5
    ax = x.abs()
    near = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    far = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * a
    return torch.where(ax < 1.0, near, torch.where(ax < 2.0, far, torch.zeros_like(ax)))


def resample_weights(sizes: torch.Tensor, out_size: int, canvas: int, is_cubic: torch.Tensor) -> torch.Tensor:
    """Per-sample resampling matrices (B, out_size, canvas) float32.

    sizes: (B,) int valid input extents (<= canvas); is_cubic: (B,) bool.
    Rows sum to 1 over the valid extent; columns >= size get exact 0."""
    dev = sizes.device
    sizes_f = sizes.to(torch.float32)
    scale = sizes_f / float(out_size)
    fscale = torch.clamp(scale, min=1.0)  # antialias widening on downscale
    o = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = torch.arange(canvas, dtype=torch.float32, device=dev)
    center = (o[None, :] + 0.5) * scale[:, None] - 0.5  # (B, O)
    x = (i[None, None, :] - center[:, :, None]) / fscale[:, None, None]  # (B, O, I)
    w = torch.where(is_cubic[:, None, None], _catmull_rom(x), _triangle(x))
    w = w * (i[None, None, :] < sizes_f[:, None, None])  # mask beyond extent
    return w / w.sum(dim=-1, keepdim=True)


@contextlib.contextmanager
def _full_float32():
    """float32 products in full float32 on the card for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def device_resample(images: torch.Tensor, meta: torch.Tensor, *, out_size: int) -> torch.Tensor:
    """(B, canvas, canvas, 3) uint8 + meta (B, 3) int [sh, sw, filt] ->
    (B, out_size, out_size, 3) float32 carrying exact uint8 values."""
    canvas = images.shape[1]
    is_cubic = meta[:, 2] == FILT_CUBIC
    wv = resample_weights(meta[:, 0], out_size, canvas, is_cubic)  # (B, O, I)
    wh = resample_weights(meta[:, 1], out_size, canvas, is_cubic)
    imgf = images.to(torch.float32)
    with _full_float32():
        tmp = torch.einsum("boi,biwc->bowc", wv, imgf)  # vertical
        out = torch.einsum("bpj,bojc->bopc", wh, tmp)  # horizontal
    # round half up + clamp, as the host resampler's +0.5f cast (imgpipe.cpp)
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)
