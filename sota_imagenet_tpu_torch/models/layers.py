"""Primitive layers (port of ``sota_imagenet_tpu/models/layers.py``).

Modules take NCHW tensors (the port keeps them in channels_last memory, so
they are NHWC in memory as on the TPU) and keep float32 parameters. The
compute dtype follows the activations unless a module's ``dtype`` pins it
(the JAX package's policy, layers.py:331-345): a bf16 activation runs the
conv in bf16 against a bf16 copy of the f32 weight.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _hard_silu(x):
    return F.hardswish(x)


_ACTIVATIONS: dict = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
    "identity": lambda x: x,
    "none": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "swish": F.silu,
    "silu": F.silu,
    "swish_hard": _hard_silu,
    "hard_swish": _hard_silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "selu": F.selu,
    "softplus": F.softplus,
}


def activation_from_name(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    key = name.strip().strip("'\"").lower()
    if key not in _ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[key]


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, padding: int = 1) -> torch.Tensor:
    """torch-style MaxPool2d(window, stride, padding) (layers.py:178)."""
    return F.max_pool2d(x, window, stride, padding)


class Conv(nn.Module):
    """Plain conv2d with torch-style integer padding (layers.py:317). The
    weight is OIHW f32, initialized kaiming-normal with fan-out
    (flax variance_scaling(2.0, "fan_out", "normal"))."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 1,
        groups: int = 1,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype
        self.weight = nn.Parameter(torch.empty(out_chs, in_chs // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_chs)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        out_chs, _, kh, kw = self.weight.shape
        nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / (out_chs * kh * kw)), generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, 1, self.groups)


class Linear(nn.Module):
    """flax nn.Dense(param_dtype=f32): weight stored torch-style (out, in),
    normal(std) init, zero bias. With ``dtype`` None the compute dtype is the
    promotion of input and weight — so a bf16 input meets the f32 weight in
    f32, as flax's promote_dtype does (the JAX ResNet's f32 logits island)."""

    def __init__(self, in_features: int, out_features: int, std: float = 0.01, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.std, self.dtype = std, dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.normal_(self.weight, 0.0, self.std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
