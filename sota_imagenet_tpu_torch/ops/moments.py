"""Per-channel moments: mean and biased variance over all leading axes of a
(..., C) tensor, from f32 sums of x and x^2 (port of
``sota_imagenet_tpu/ops/pallas_norm.py``).

* ``moments_reference`` — the plain PyTorch version: the CPU path, and what
  the kernel is held against on the card.
* ``moments`` — a ``torch.autograd.Function``. Its forward launches the
  hand-written CUDA kernel (``csrc/moments.cu``) for a CUDA tensor and takes
  the plain version for a CPU tensor; it counts its launches in
  ``moments.launches``. Its backward is the JAX VJP's elementwise expression
  (``_moments_bwd``, pallas_norm.py:84-90) in torch ops:
  dx = (dmean + 2 dvar (x - mean)) / N.

As in the JAX package, no model calls it; it is its own op.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from sota_imagenet_tpu_torch.ops import cuda_build

_SOURCES = ("moments.cu",)
_DTYPES = (torch.bfloat16, torch.float32)
TARGET_BLOCKS = 1056  # 8 blocks for each of the H100's 132 SMs
MIN_CHUNK_ROWS = 64


def _finish(s1: torch.Tensor, s2: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """mean and var = max(E[x^2] - mean^2, 0) from the sums (pallas_norm.py:74-75)."""
    mean = s1 / n
    return mean, torch.clamp(s2 / n - mean * mean, min=0.0)


def moments_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: f32 sums of x and x^2 over all leading axes of
    a (..., C) tensor -> (mean (C,), var (C,)) f32."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return _finish(flat.sum(0), (flat * flat).sum(0), flat.shape[0])


def _check(x: torch.Tensor) -> None:
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"moments needs a (..., C) tensor with C > 0, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"moments takes bfloat16 or float32, got {x.dtype}")
    # checked on every device, so the CPU path holds callers to the kernel's contract
    if not x.is_contiguous():
        raise ValueError("moments needs a contiguous (..., C) tensor")


def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = cuda_build.load("moments", _SOURCES)
    fn = lib.moments_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x (rows, C)
            ctypes.c_int,  # x is bf16 (else f32)
            ctypes.c_void_p,  # partial sums (chunks, C) f32
            ctypes.c_void_p,  # partial sums of squares (chunks, C) f32
            ctypes.c_longlong,  # rows
            ctypes.c_int,  # C
            ctypes.c_int,  # chunks
            ctypes.c_longlong,  # rows per chunk
            ctypes.c_void_p,  # cudaStream_t
        ]
    return lib


def _chunking(rows: int, c: int) -> Tuple[int, int]:
    """(chunks, rows per chunk): about TARGET_BLOCKS blocks of 32 channels,
    each walking at least MIN_CHUNK_ROWS rows."""
    col_blocks = -(-c // 32)
    chunks = max(1, min(65535, TARGET_BLOCKS // col_blocks, -(-rows // MIN_CHUNK_ROWS)))
    chunk_rows = max(1, -(-rows // chunks))
    return -(-max(rows, 1) // chunk_rows), chunk_rows


def _forward_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = library()
    c = x.shape[-1]
    rows = x.numel() // c
    chunks, chunk_rows = _chunking(rows, c)
    parts = torch.empty((2, chunks, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moments_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), parts[0].data_ptr(), parts[1].data_ptr(),
            rows, c, chunks, chunk_rows, stream,
        )
    if err != 0:
        raise RuntimeError(f"moments kernel launch failed with CUDA error {err}")
    moments.launches += 1
    sums = parts.sum(1)
    return _finish(sums[0], sums[1], rows)


class _Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            mean, var = moments_reference(x)
        elif x.device.type == "cuda":
            mean, var = _forward_cuda(x)
        else:
            raise ValueError(f"moments runs on cuda or cpu tensors, got {x.device}")
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, dmean: Optional[torch.Tensor], dvar: Optional[torch.Tensor]):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if dmean is not None:
            dx = dx.add_(dmean)
        if dvar is not None:
            dx = dx.add_(dvar * 2.0 * (x.float() - mean))
        return (dx / n).to(x.dtype)


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, var) f32 over all leading axes of a contiguous
    (..., C) bf16 or f32 tensor; var is the biased variance."""
    _check(x)
    return _Moments.apply(x)


moments.launches = 0
