"""Fused 1x1 conv (matmul) + BatchNorm statistics: y = x @ w^T in bf16 with
f32 accumulation, plus the per-column sum and sum of squares of the
bf16-ROUNDED y in f32 (port of ``sota_imagenet_tpu/ops/pallas_conv_stats.py``).

* ``conv1x1_stats_reference`` — the plain PyTorch version: the CPU path, and
  what the kernel is held against on the card.
* ``conv1x1_stats`` — a ``torch.autograd.Function``. Its forward launches the
  hand-written CUDA kernel (``csrc/conv_stats.cu``) for a CUDA tensor and
  takes the plain version for a CPU tensor; it counts its launches in
  ``conv1x1_stats.launches``. Its backward follows the JAX custom VJP
  (``_bwd``, pallas_conv_stats.py:123-132): the cotangents of the sums fold
  into the output's, ``gy + gs1 + 2 y gs2``, and dx, dw are two bf16 products
  with f32 accumulation. In the JAX package that backward is no Pallas kernel
  but an elementwise fold and two ``jnp.dot``s left to XLA, so here it is
  plain torch ops.
* ``conv1x1_stats_nhwc`` — a strided 1x1 conv of the port's NCHW view of
  channels_last memory: a spatial subsample, then the product.

Unlike the JAX function, ``w`` is (N, K) — the OIHW weight squeezed — so both
operands are K-contiguous and no transpose is copied per step.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sota_imagenet_tpu_torch.ops import cuda_build

TILE_M = 128  # rows of y per kernel block: one row of partial sums each (csrc/conv_stats.cu kBM)
_SOURCES = ("conv_stats.cu",)
_DTYPES = (torch.bfloat16, torch.float32)


def conv1x1_stats_reference(x2d: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: x2d (M, K), w (N, K), any float types, used as
    bf16. Products of bf16 values are exact in f32, so the f32 product of the
    bf16-rounded operands is an f32-accumulated bf16 product; TF32 must be off
    on the card. Returns (y (M, N) bf16, sum (N,) f32, sum of squares (N,) f32)."""
    if x2d.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("conv1x1_stats_reference needs TF32 off (torch.backends.cuda.matmul.allow_tf32 = False)")
    y = (x2d.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()).to(torch.bfloat16)
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def _check(x2d: torch.Tensor, w: torch.Tensor) -> None:
    if x2d.dim() != 2 or w.dim() != 2 or x2d.shape[1] != w.shape[1]:
        raise ValueError(f"conv1x1_stats needs x (M, K) and w (N, K), got {tuple(x2d.shape)} and {tuple(w.shape)}")
    if x2d.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(f"conv1x1_stats takes bfloat16 or float32 operands, got {x2d.dtype} and {w.dtype}")
    if x2d.device != w.device:
        raise ValueError(f"x on {x2d.device} but w on {w.device}")
    # checked on every device, so the CPU path holds callers to the kernel's contract
    if not (x2d.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv1x1_stats needs contiguous (M, K) and (N, K) operands")


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = cuda_build.load("conv_stats", _SOURCES)
    fn = lib.conv1x1_stats_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x (M, K) bf16
            ctypes.c_void_p,  # w (N, K) bf16
            ctypes.c_void_p,  # y (M, N) bf16
            ctypes.c_void_p,  # partial sums (tiles, N) f32
            ctypes.c_void_p,  # partial sums of squares (tiles, N) f32
            ctypes.c_int,  # M
            ctypes.c_int,  # N
            ctypes.c_int,  # K
            ctypes.c_void_p,  # cudaStream_t
        ]
    return lib


def _forward_cuda(xb: torch.Tensor, wb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lib = library()
    m, k = xb.shape
    n = wb.shape[0]
    tiles = -(-m // TILE_M)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=xb.device)
    parts = torch.empty((2, tiles, n), dtype=torch.float32, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv1x1_stats_launch(
            xb.data_ptr(), wb.data_ptr(), y.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(), m, n, k, stream
        )
    if err != 0:
        raise RuntimeError(f"conv1x1_stats kernel launch failed with CUDA error {err}")
    conv1x1_stats.launches += 1
    sums = parts.sum(1)
    return y, sums[0], sums[1]


def _matmul_f32_acc(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a @ b for bf16 a and b, accumulated in f32 and returned in
    ``out_dtype`` (jnp.dot with preferred_element_type=f32, then astype)."""
    if not a.is_cuda:
        return (a.float() @ b.float()).to(out_dtype)  # exact bf16 products, f32 sums
    if out_dtype == torch.bfloat16:
        return torch.mm(a, b)  # cuBLAS accumulates in f32 and rounds once
    return torch.mm(a, b, out_dtype=torch.float32).to(out_dtype)  # f32 out, no bf16 rounding


class _Conv1x1Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d: torch.Tensor, w: torch.Tensor):
        ctx.set_materialize_grads(False)  # a sum nobody uses gets None, not a zero tensor
        xb, wb = x2d.to(torch.bfloat16), w.to(torch.bfloat16)
        if x2d.device.type == "cpu":
            y, s1, s2 = conv1x1_stats_reference(xb, wb)
        elif x2d.device.type == "cuda":
            y, s1, s2 = _forward_cuda(xb, wb)
        else:
            raise ValueError(f"conv1x1_stats runs on cuda or cpu tensors, got {x2d.device}")
        ctx.save_for_backward(x2d, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy: Optional[torch.Tensor], gs1: Optional[torch.Tensor], gs2: Optional[torch.Tensor]):
        x2d, w, y = ctx.saved_tensors
        # gy + gs1 + 2 y gs2 in f32, in the JAX expression's order, then bf16
        if gy is not None:
            gy_tot = gy.to(torch.float32, copy=True)
        else:
            gy_tot = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
        if gs1 is not None:
            gy_tot = gy_tot.add_(gs1)
        if gs2 is not None:
            gy_tot = gy_tot.add_(y.float().mul_(2.0).mul_(gs2))
        gy_b = gy_tot.to(torch.bfloat16)
        del gy_tot
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _matmul_f32_acc(gy_b, w.to(torch.bfloat16), x2d.dtype)  # (M, N) @ (N, K)
        if ctx.needs_input_grad[1]:
            dw = _matmul_f32_acc(gy_b.t(), x2d.to(torch.bfloat16), w.dtype)  # (N, M) @ (M, K)
        return dx, dw


def conv1x1_stats(x2d: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y = x2d @ w^T (bf16) plus the f32 column sum and sum of squares of y.

    x2d: (M, K) activations, bf16 or f32 (used as bf16); w: (N, K) weights
    (f32 master, used as bf16); both contiguous. Returns (y (M, N) bf16,
    sum (N,) f32, sum of squares (N,) f32), differentiable in x2d and w."""
    _check(x2d, w)
    return _Conv1x1Stats.apply(x2d, w)


conv1x1_stats.launches = 0


def conv1x1_stats_nhwc(
    x: torch.Tensor, w: torch.Tensor, stride: int = 1
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """1x1 conv of stride ``stride`` + statistics, on the port's layout.

    x: (B, C, H, W), the NCHW view of channels_last memory; w: (N, C, 1, 1)
    or (N, C). A 1x1 stride-s conv is a spatial subsample followed by the
    product (pallas_conv_stats.py:138-150). Returns (y (B, N, H', W') bf16 in
    channels_last memory, sum (N,), sum of squares (N,))."""
    if stride != 1:
        x = x[:, :, ::stride, ::stride]
    b, c, h, wd = x.shape
    # (M, K) rows of channels: a view of dense channels_last memory, and the
    # one copy of the strided subsample otherwise
    x2d = x.permute(0, 2, 3, 1).contiguous().view(b * h * wd, c)
    y2d, s1, s2 = conv1x1_stats(x2d, w.reshape(w.shape[0], -1))
    # (M, N) row-major is NHWC: the NCHW view is channels_last, no copy
    return y2d.view(b, h, wd, -1).permute(0, 3, 1, 2), s1, s2
