"""Primitive layers (port of ``sota_imagenet_tpu/models/layers.py``).

Modules take NCHW tensors (the port keeps them in channels_last memory, so
they are NHWC in memory as on the TPU) and keep float32 parameters. The
compute dtype follows the activations unless a module's ``dtype`` pins it
(the JAX package's policy, layers.py:331-345): a bf16 activation runs the
conv in bf16 against a bf16 copy of the f32 weight.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
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


# Signal-propagation gains: E[f(x)^2]^-0.5 for x~N(0,1) (layers.py:50). The
# NFNet recipe folds them into the activation (``gamma * act(x)``).
ACTIVATION_GAMMA: dict = {
    "relu": math.sqrt(2.0 / (1.0 - 1.0 / math.pi)),  # ≈1.7139
    "silu": 1.7881293296813965,  # timm _nonlin_gamma value, for exact import parity
    "swish": 1.7881293296813965,
    "swish_hard": 1.8138,
    "gelu": 1.7015,
    "identity": 1.0,
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
    zero bias. ``std`` is the normal init's (the model heads' normal(0.01));
    None gives flax's lecun_normal (the CModel ``Linear``, layers.py:478).

    With ``dtype`` None the compute dtype is the promotion of input and
    weight — a bf16 input meets the f32 weight in f32, as flax's
    promote_dtype does (the JAX ResNet's f32 logits island) — unless
    ``follow_input``: then it is the input's dtype (the JAX NFNet head and
    the CModel ``Linear``, which pass ``dtype=x.dtype``)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        std: Optional[float] = 0.01,
        dtype: Optional[torch.dtype] = None,
        use_bias: bool = True,
        follow_input: bool = False,
    ):
        super().__init__()
        self.std, self.dtype, self.follow_input = std, dtype, follow_input
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.std is None:
            # variance_scaling(1.0, "fan_in", "truncated_normal"): +-2 sigma, rescaled to unit variance
            std = math.sqrt(1.0 / self.weight.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        else:
            nn.init.normal_(self.weight, 0.0, self.std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or (x.dtype if self.follow_input else torch.promote_types(x.dtype, self.weight.dtype))
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


def linear(in_features: int, out_features: int, bias: bool = True, **kw) -> Linear:
    """The CModel ``Linear`` head (layers.py:498)."""
    return Linear(in_features, out_features, std=None, use_bias=bias, follow_input=True, **kw)


def conv3x3(in_chs: int, out_chs: int, stride: int = 1, groups: int = 1, bias: bool = False, **kw) -> Conv:
    return Conv(in_chs, out_chs, 3, stride, 1, groups=groups, use_bias=bias, **kw)


def conv1x1(in_chs: int, out_chs: int, stride: int = 1, bias: bool = False, **kw) -> Conv:
    return Conv(in_chs, out_chs, 1, stride, 0, use_bias=bias, **kw)


class ScaledStdConv(nn.Module):
    """Conv2d with Scaled Weight Standardization (layers.py:358-461; NFNet
    paper arXiv:2101.08692).

    At every forward the weight is standardized per output channel over its
    fan-in (zero mean, unit biased variance, ``rsqrt(var + eps)``) and
    multiplied by ``gain * gamma * fan_in**-0.5 * n_heads**0.5``; the
    statistics are float32 (float64 for a float64 weight), the result is cast
    to the activation dtype for the conv. ``norm`` switches to weight
    normalization (zero mean, unit L2 norm); ``n_heads`` averages head
    groups, the bias added before the mean; ``partial_conv`` compensates the
    zero padding at the edges (3x3, padding 1 only); ``coord_conv`` appends
    x and y coordinate channels. Names: ``weight`` (OIHW), ``gain``, ``bias``."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Union[int, str] = 1,
        groups: int = 1,
        dilation: int = 1,
        use_bias: bool = True,
        gamma: float = 1.0,
        gain_init: Optional[float] = 1.0,
        eps: float = 1e-6,
        n_heads: int = 1,
        norm: bool = False,
        single_gain: bool = False,
        partial_conv: bool = False,
        coord_conv: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if coord_conv:
            in_chs += 2
        self.out_chs, self.stride, self.groups, self.dilation = out_chs, stride, groups, dilation
        self.padding = padding.lower() if isinstance(padding, str) else padding
        self.eps, self.n_heads, self.norm, self.coord_conv, self.dtype = eps, n_heads, norm, coord_conv, dtype
        self.gain_init = gain_init
        self.partial = partial_conv and padding == 1 and kernel_size == 3
        fan_in = kernel_size * kernel_size * (in_chs // groups)
        # gamma / sqrt(fan_in), * sqrt(n_heads) to compensate the head mean
        self.scale = gamma * fan_in**-0.5 * n_heads**0.5
        total = out_chs * n_heads
        self.weight = nn.Parameter(torch.empty(total, in_chs // groups, kernel_size, kernel_size))
        self.gain = nn.Parameter(torch.empty(1 if single_gain else total)) if gain_init is not None else None
        self.bias = nn.Parameter(torch.zeros(total)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        total, _, kh, kw = self.weight.shape
        nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / (total * kh * kw)), generator=generator)
        if self.gain is not None:
            nn.init.constant_(self.gain, self.gain_init)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def standardized_weight(self) -> torch.Tensor:
        w = self.weight.to(torch.promote_types(self.weight.dtype, torch.float32))
        gain = self.scale if self.gain is None else (self.gain.to(w.dtype) * self.scale).view(-1, 1, 1, 1)
        if self.norm:
            w = w - w.mean(dim=(1, 2, 3), keepdim=True)
            l2 = w.square().sum(dim=(1, 2, 3), keepdim=True).sqrt()
            return w / (l2 + self.eps) * gain
        var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
        return (w - mean) * torch.rsqrt(var + self.eps) * gain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        if self.coord_conv:
            b, _, h, w = x.shape
            xx = torch.linspace(-1.0, 1.0, w, device=x.device).to(x.dtype).view(1, 1, 1, w).expand(b, 1, h, w)
            yy = torch.linspace(-1.0, 1.0, h, device=x.device).to(x.dtype).view(1, 1, h, 1).expand(b, 1, h, w)
            x = torch.cat([x, xx, yy], dim=1)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        # with heads or the edge compensation the bias is added by hand, in the JAX order
        fused_bias = bias if self.n_heads == 1 and not self.partial else None
        weight = self.standardized_weight().to(x.dtype)
        out = F.conv2d(x, weight, fused_bias, self.stride, self.padding, self.dilation, self.groups)
        if self.n_heads != 1:
            if bias is not None:
                out = out + bias.view(1, -1, 1, 1)
                bias = None
            b, _, h, w = out.shape
            out = out.reshape(b, self.n_heads, self.out_chs, h, w).mean(dim=1)
        if self.partial:
            # edge compensation: 9 / (number of valid taps) per output position
            h, w = out.shape[2:]
            ones = torch.ones((1, 1, h, w), dtype=torch.float32, device=out.device)
            cnt = F.conv2d(ones, torch.ones((1, 1, 3, 3), dtype=torch.float32, device=out.device), padding=1)
            out = out * (9.0 / cnt).to(out.dtype)
            if bias is not None:
                out = out + bias.view(1, -1, 1, 1)
        return out


def scaled_conv3x3(in_chs: int, out_chs: int, padding: int = 1, **kw) -> ScaledStdConv:
    """Reference scaled_conv3x3 (layers.py:464)."""
    kw.setdefault("use_bias", kw.pop("bias", True))
    return ScaledStdConv(in_chs, out_chs, kernel_size=3, padding=padding, **kw)


def scaled_conv1x1(in_chs: int, out_chs: int, **kw) -> ScaledStdConv:
    """Reference scaled_conv1x1 (layers.py:471)."""
    kw.setdefault("use_bias", kw.pop("bias", True))
    return ScaledStdConv(in_chs, out_chs, kernel_size=1, padding=0, **kw)


class Activation(nn.Module):
    """Activation as a module, so it can appear in CModel layer configs."""

    def __init__(self, act: str = "relu"):
        super().__init__()
        self.act = act
        self.fn = activation_from_name(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def extra_repr(self) -> str:
        return self.act


# --------------------------------------------------------------------------- #
# Shape utilities. Tensors are NCHW here and NHWC in the JAX package: each
# module orders its output channels as the JAX one does.
# --------------------------------------------------------------------------- #


class SpaceToDepth(nn.Module):
    """(B, C, H, W) -> (B, C*s*s, H/s, W/s), output channel (sy*s + sx)*C + c (layers.py:83)."""

    def __init__(self, block_size: int = 2):
        super().__init__()
        self.block_size = block_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.block_size
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)


class ChannelShuffle(nn.Module):
    """Mix channels after a grouped conv (layers.py:98): (groups, C/groups) -> transpose -> flatten."""

    def __init__(self, groups: int = 1):
        super().__init__()
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.groups == 1:
            return x
        b, c, h, w = x.shape
        return x.reshape(b, self.groups, c // self.groups, h, w).transpose(1, 2).reshape(b, c, h, w)


_NHWC_TO_NCHW_AXIS = {0: 0, 1: 2, 2: 3, 3: 1, -1: 1, -2: 3, -3: 2, -4: 0}


class Concat(nn.Module):
    """Concatenate several inputs; ``axis`` counts NHWC axes as in the configs
    (the default -1 is the channels), mapped to the NCHW tensor here."""

    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        return torch.cat(xs, dim=_NHWC_TO_NCHW_AXIS[self.axis] if xs[0].dim() == 4 else self.axis)


class Flatten(nn.Module):
    """(B, C, H, W) -> (B, H*W*C) in the JAX package's NHWC order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.reshape(x.shape[0], -1)


class FastGlobalAvgPool(nn.Module):
    """Global average pool (layers.py:135): (B, C) if ``flatten`` else (B, C, 1, 1)."""

    def __init__(self, flatten: bool = True):
        super().__init__()
        self.flatten = flatten

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(2, 3), keepdim=not self.flatten)


class GEMPool(nn.Module):
    """Generalized-mean pooling (reference GEM_pool, model.py:756-771;
    layers.py:150): mean(clip(x, eps)^p)^(1/p) over H and W with a learnable
    0-d ``p``. x is clipped in float32, as in the JAX module, and the power
    runs in the promotion of float32 and p's dtype; the output takes x's
    dtype. (B, C) if ``flatten`` else (B, C, 1, 1)."""

    def __init__(self, p: float = 3.0, eps: float = 1e-6, flatten: bool = True, channels: Optional[int] = None):
        super().__init__()
        self.init_p, self.eps, self.flatten = float(p), eps, flatten
        self.p = nn.Parameter(torch.full(() if channels is None else (channels,), self.init_p))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.constant_(self.p, self.init_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p.view(1, -1, 1, 1) if self.p.dim() else self.p
        xf = x.to(torch.float32).clamp(min=self.eps).to(torch.promote_types(torch.float32, p.dtype))
        out = xf.pow(p).mean(dim=(2, 3), keepdim=True) ** (1.0 / p)
        return (out.flatten(1) if self.flatten else out).to(x.dtype)


class GEMPoolChannel(GEMPool):
    """GEM pool with a per-channel ``p`` of shape (C,), init 1 (reference
    GEM_pool_channel, model.py:764-771; layers.py:165)."""

    def __init__(self, num_channels: int = 0, eps: float = 1e-6, flatten: bool = True):
        if num_channels <= 0:
            raise ValueError("GEMPoolChannel needs its channel count (the JAX module reads it from its input)")
        super().__init__(1.0, eps, flatten, channels=num_channels)


class MaxPool(nn.Module):
    def __init__(self, window: int = 3, stride: int = 2, padding: int = 1):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(x, self.window, self.stride, self.padding)


class AvgPool(nn.Module):
    """torch-style AvgPool2d; padded zeros count in the mean, as in flax's avg_pool."""

    def __init__(self, window: int = 2, stride: int = 2, padding: int = 0):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.window, self.stride, self.padding, count_include_pad=True)


class BlurPool(nn.Module):
    """Anti-aliased downsampling (Zhang 2019; layers.py:225): a depthwise conv
    with a fixed binomial kernel, stride 2. ``channels`` is accepted for
    config parity; the kernel is expanded to the input's channels."""

    def __init__(self, channels: Optional[int] = None, filt_size: int = 3, stride: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        del channels
        self.filt_size, self.stride, self.dtype = filt_size, stride, dtype
        filt1d = np.asarray((np.poly1d([0.5, 0.5]) ** (filt_size - 1)).coeffs, dtype=np.float32)  # binomial row
        filt = np.outer(filt1d, filt1d)
        # not in the state_dict: a constant, as in the JAX module
        self.register_buffer("filt", torch.from_numpy(filt / filt.sum()), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, k = x.shape[1], self.filt_size
        pad = (k - 1) // 2
        pad_hi = k - 1 - pad
        kernel = self.filt.to(x.dtype).expand(c, 1, k, k)
        return F.conv2d(F.pad(x, (pad, pad_hi, pad, pad_hi)), kernel, None, self.stride, 0, 1, c)


# --------------------------------------------------------------------------- #
# Regularization. Each takes its random mask from ``draw_keep_mask`` and
# applies it with ``apply_keep_mask``, so a test can feed a mask drawn
# elsewhere. ``generator`` is bound by the train step (train/steps.py) to the
# run's generator on the device; None draws from torch's default generator.
# --------------------------------------------------------------------------- #


def draw_keep_mask(generator: Optional[torch.Generator], keep_prob: float, shape, device) -> torch.Tensor:
    """Boolean Bernoulli(keep_prob) mask of ``shape`` on ``device``."""
    return torch.rand(tuple(shape), generator=generator, device=device) < keep_prob


def apply_keep_mask(x: torch.Tensor, mask: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """where(mask, x / keep_prob, 0), as the JAX DropPath and Dropout."""
    return torch.where(mask, x / keep_prob, torch.zeros_like(x))


class DropPath(nn.Module):
    """Stochastic depth (layers.py:264): in train mode drops a sample's whole
    branch with probability ``1 - keep_prob`` and rescales the kept ones."""

    generator: Optional[torch.Generator] = None

    def __init__(self, keep_prob: float = 1.0):
        super().__init__()
        self.keep_prob = keep_prob

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.keep_prob >= 1.0:
            return x
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return apply_keep_mask(x, draw_keep_mask(self.generator, self.keep_prob, shape, x.device), self.keep_prob)


class Dropout(nn.Module):
    """torch-style Dropout(p) on the shared draw/apply pair (layers.py:280)."""

    generator: Optional[torch.Generator] = None

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        return apply_keep_mask(x, draw_keep_mask(self.generator, keep, x.shape, x.device), keep)


def bind_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every DropPath and Dropout of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.generator = generator
