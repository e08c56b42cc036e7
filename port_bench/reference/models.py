"""Plain PyTorch forward passes of the two benchmarked networks, written from
their published descriptions; they import nothing of the code under test.

* ResNet-50 (He et al., arXiv:1512.03385; the torchvision v1.5 layout, with
  the stride on the 3x3 conv): 7x7/2 stem, 3x3/2 max-pool, bottlenecks
  [3, 4, 6, 3] of widths 64-512 and expansion 4, BatchNorm (eps 1e-5,
  momentum 0.1, biased running variance), average pool, 1000-way linear.
* ECA-NFNet-L0 (Brock et al., arXiv:2102.06171, with the ECA gate of
  arXiv:1910.03151, as timm's ``eca_nfnet_l0``): scaled weight-standardised
  convs (eps 1e-6, gain, bias), a 16-32-64-128 stem (strides 2, 1, 1, 2),
  pre-activation bottlenecks of depths [1, 2, 6, 3] and widths [256, 512,
  1536, 1536], group size 64, bottleneck ratio 0.25, alpha 0.2 and beta
  from the expected variance, SiLU times its gamma 1.7881293, an ECA gate of
  3 taps with gain 2, stochastic depth, a skip-init gain, a 2304-wide final
  1x1 conv, dropout and a 1000-way linear.

Inputs are NHWC images; the trunk runs on NCHW tensors. Parameter and buffer
names are the torchvision-style names the benchmark's weight maker uses, so
one state dict loads into both sides.

Every conv's and linear's operands and result, every norm's result and
every block's output pass through ``quant`` (identity by default; the
correctness control rounds them, and their gradients, to a lower
precision), at the points where the program holds them in bfloat16. Drop
masks come from ``masks``, a callable ``(keep_prob, shape) -> bool tensor``
or None for no dropping.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _BN(nn.Module):
    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.quant = _identity

    def forward(self, x):
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean[:, None, None]) * (inv * self.weight)[:, None, None] + self.bias[:, None, None]
        mean = x.mean(dim=(0, 2, 3))
        var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))  # biased
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.detach(), alpha=m)
        y = (x - mean[:, None, None]) * torch.rsqrt(var + self.eps)[:, None, None]
        return self.quant(y * self.weight[:, None, None] + self.bias[:, None, None])


class _Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, groups=1):
        super().__init__()
        self.stride, self.pad, self.groups = stride, pad, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.quant = _identity

    def forward(self, x):
        return self.quant(F.conv2d(self.quant(x), self.quant(self.weight), None, self.stride, self.pad, 1, self.groups))


class _Bottleneck(nn.Module):
    def __init__(self, cin, width, stride, down):
        super().__init__()
        self.conv1, self.bn1 = _Conv(cin, width, 1), _BN(width)
        self.conv2, self.bn2 = _Conv(width, width, 3, stride, 1), _BN(width)
        self.conv3, self.bn3 = _Conv(width, width * 4, 1), _BN(width * 4)
        self.downsample = nn.Sequential(_Conv(cin, width * 4, 1, stride), _BN(width * 4)) if down else None
        self.quant = _identity

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.quant(F.relu(out + (x if self.downsample is None else self.downsample(x))))


class ResNet50(nn.Module):
    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.conv1, self.bn1 = _Conv(3, 64, 7, 2, 3), _BN(64)
        cin = 64
        for i, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for b in range(n):
                stride = 2 if (b == 0 and i > 0) else 1
                blocks.append(_Bottleneck(cin, width, stride, b == 0))
                cin = width * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes)
        self.quant = _identity

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
        x = x.mean(dim=(2, 3))
        return self.quant(F.linear(self.quant(x), self.quant(self.fc.weight), self.fc.bias))


SILU_GAMMA = 1.7881293296813965


class _WSConv(nn.Module):
    """Scaled weight standardisation: per output channel, zero mean and unit
    (biased) variance over the fan-in, times gain / sqrt(fan_in)."""

    def __init__(self, cin, cout, k, stride=1, pad=0, groups=1, eps=1e-6):
        super().__init__()
        self.stride, self.pad, self.groups, self.eps = stride, pad, groups, eps
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.gain = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.fan_in = k * k * (cin // groups)
        self.quant = _identity

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = (w - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        w = (w - mean) * torch.rsqrt(var + self.eps) * (self.gain * self.fan_in ** -0.5)[:, None, None, None]
        return self.quant(F.conv2d(self.quant(x), self.quant(w), self.bias, self.stride, self.pad, 1, self.groups))


class _ECA(nn.Module):
    def __init__(self, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, k))

    def forward(self, x):
        s = x.mean(dim=(2, 3))
        g = F.conv1d(s[:, None, :], self.weight, padding=self.weight.shape[-1] // 2)[:, 0, :]
        return x * torch.sigmoid(g)[:, :, None, None]


def _act(x):
    return F.silu(x) * SILU_GAMMA


class _NFBlock(nn.Module):
    def __init__(self, cin, cout, stride, beta, keep_prob, alpha=0.2, group_size=64, ratio=0.25):
        super().__init__()
        self.stride, self.beta, self.alpha, self.keep_prob = stride, beta, alpha, keep_prob
        groups = max(int(cout * ratio) // group_size, 1)
        mid = groups * group_size
        self.downsample = _WSConv(cin, cout, 1) if (stride > 1 or cin != cout) else None
        self.conv1 = _WSConv(cin, mid, 1)
        self.conv2 = _WSConv(mid, mid, 3, stride, 1, groups)
        self.conv2b = _WSConv(mid, mid, 3, 1, 1, groups)
        self.conv3 = _WSConv(mid, cout, 1)
        self.attn = _ECA()
        self.skipinit_gain = nn.Parameter(torch.zeros(()))
        self.masks: Optional[Callable] = None
        self.quant = _identity

    def forward(self, x):
        out = _act(x) * self.beta
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample(F.avg_pool2d(out, 2, 2) if self.stride > 1 else out)
        out = _act(self.conv1(out))
        out = _act(self.conv2(out))
        out = _act(self.conv2b(out))
        out = 2.0 * self.attn(self.conv3(out))
        if self.keep_prob < 1.0 and self.masks is not None:
            keep = self.masks(self.keep_prob, (out.shape[0], 1, 1, 1))
            out = torch.where(keep, out / self.keep_prob, torch.zeros_like(out))
        return self.quant(out * self.skipinit_gain * self.alpha + shortcut)


class ECANFNetL0(nn.Module):
    def __init__(self, num_classes: int = 1000, drop_rate: float = 0.2, drop_path_rate: float = 0.15, alpha: float = 0.2):
        super().__init__()
        self.drop_rate = drop_rate
        cin = 3
        for i, (c, s) in enumerate(zip((16, 32, 64, 128), (2, 1, 1, 2))):
            self.add_module(f"stem_conv{i}", _WSConv(cin, c, 3, s, 1))
            cin = c
        depths, widths = (1, 2, 6, 3), (256, 512, 1536, 1536)
        total, idx, expected = sum(depths), 0, 1.0
        self.blocks = []
        for st, (d, c) in enumerate(zip(depths, widths)):
            for b in range(d):
                keep = 1.0 - drop_path_rate * idx / (total - 1)
                blk = _NFBlock(cin, c, 2 if (b == 0 and st > 0) else 1, 1.0 / expected, keep, alpha)
                self.add_module(f"stage{st}_block{b}", blk)
                self.blocks.append(blk)
                cin = c
                if b == 0:
                    expected = 1.0
                expected = math.sqrt(expected ** 2 + alpha ** 2)
                idx += 1
        self.final_conv = _WSConv(cin, int(widths[-1] * 1.5), 1)
        self.fc = nn.Linear(int(widths[-1] * 1.5), num_classes)
        self.quant = _identity
        self.masks: Optional[Callable] = None

    def set_masks(self, masks: Optional[Callable]) -> None:
        self.masks = masks
        for b in self.blocks:
            b.masks = masks

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.permute(0, 3, 1, 2)
        for i in range(4):
            x = getattr(self, f"stem_conv{i}")(x)
            if i < 3:
                x = _act(x)
        for b in self.blocks:
            x = b(x)
        x = _act(self.final_conv(x)).mean(dim=(2, 3))
        if self.drop_rate > 0 and self.masks is not None:
            keep = 1.0 - self.drop_rate
            x = torch.where(self.masks(keep, tuple(x.shape)), x / keep, torch.zeros_like(x))
        return self.quant(F.linear(self.quant(x), self.quant(self.fc.weight), self.fc.bias))


def build(arch: str, **kw) -> nn.Module:
    return {"resnet50": ResNet50, "eca_nfnet_l0": ECANFNetL0}[arch](**kw)


def set_quant(model: nn.Module, quant: Callable) -> None:
    """Route every conv's and linear's operands through ``quant``."""
    for m in model.modules():
        if hasattr(m, "quant"):
            m.quant = quant
