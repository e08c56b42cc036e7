"""Channel attention modules (port of ``sota_imagenet_tpu/models/attention.py``:
SE :27, SEVar3 :44, ECA :77, get_attn :247).

Each pools the activations to one float32 vector per sample, computes a
sigmoid gate from it in float32, and multiplies the activations by the gate
cast to their dtype. XCA, UFO, FCA and SEVar3Mod are not ported yet: their
names raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.layers import Conv, Linear, ScaledStdConv
from sota_imagenet_tpu_torch.registry import NotPortedError


class SE(nn.Module):
    """Squeeze-and-Excitation with reduction (two lecun-normal Dense layers)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(channels // reduction, 8)
        self.fc1 = Linear(channels, mid, std=None)
        self.fc2 = Linear(mid, channels, std=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3))
        gate = torch.sigmoid(self.fc2(F.relu(self.fc1(s)))).to(x.dtype)
        return x * gate[:, :, None, None]


class SEVar3(nn.Module):
    """SE without dimensionality reduction (ECA paper SE-Var3): one 1x1 conv
    on the pooled vector, weight-standardized if ``scaled``."""

    def __init__(self, channels: int, scaled: bool = False):
        super().__init__()
        if scaled:
            self.conv = ScaledStdConv(channels, channels, kernel_size=1, padding=0)
        else:
            self.conv = Conv(channels, channels, 1, 1, 0, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv(s)).to(x.dtype)


class ECA(nn.Module):
    """Efficient Channel Attention: a 1-D conv of ``kernel_size`` taps (padding
    ``k // 2``, no bias) over the pooled channel vector. ``weight`` is
    (1, 1, k), lecun-normal (fan-in 1 in the JAX (k, 1, 1) layout)."""

    def __init__(self, channels: int = 0, kernel_size: int = 3):
        super().__init__()
        del channels  # the gate's width follows the input
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(1, 1, kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        std = math.sqrt(1.0 / self.kernel_size) / 0.87962566103423978  # lecun_normal, fan_in = k * 1
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3))  # (B, C)
        s = F.conv1d(s[:, None, :], self.weight.to(s.dtype), padding=self.kernel_size // 2)[:, 0, :]
        return x * torch.sigmoid(s).to(x.dtype)[:, :, None, None]


def _not_ported(name: str) -> Callable:
    def make(chs, **kw):
        raise NotPortedError(f"attention {name!r}", "Queue 1 item 10c")

    return make


_ATTN = {
    "se": lambda chs, **kw: SE(chs, **kw),
    "eca": lambda chs, **kw: ECA(chs, **kw),
    "eca9": lambda chs, **kw: ECA(chs, kernel_size=9, **kw),
    "sevar3": lambda chs, **kw: SEVar3(chs, **kw),
    "se-var3": lambda chs, **kw: SEVar3(chs, **kw),
    "xca": _not_ported("xca"),
    "ufo": _not_ported("ufo"),
    "fca": _not_ported("fca"),
    "fca-eca": _not_ported("fca-eca"),
}


def get_attn(name: Optional[str]) -> Callable[..., Optional[nn.Module]]:
    """pytorch_tools get_attn equivalent: name -> constructor taking the channels."""
    if name is None:
        return lambda chs, **kw: None
    key = name.strip().strip("'\"").lower()
    if key not in _ATTN:
        raise KeyError(f"unknown attention {name!r}; known: {sorted(_ATTN)}")
    return _ATTN[key]
