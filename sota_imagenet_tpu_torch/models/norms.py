"""The norm zoo (port of ``sota_imagenet_tpu/models/norms.py``): BatchNorm
(the default branch of norms.py:143-192), GroupNorm :282, ScaleNorm :294,
Affine :312, Gain :327, FRNv1 :345, FRNv2 :374, VarEMA :407, MeanEMA :441,
Identity :453 and ``norm_from_name`` :459-484. The activated-BN family (ABN,
AGN, EstimatedABN, norms.py:195-279) is not ported: its names raise naming
the ROADMAP item.

Modules take NCHW tensors (channel = dim 1). Each takes its channel count as
its first argument, where the JAX module reads it from its input; the ones
that keep no per-channel state accept and ignore it. Statistics run in
float32 (float64 for float64 inputs) and the output takes the input's dtype.
Running statistics are buffers, updated in place by train-mode forwards, as
the JAX modules update ``batch_stats``.

BatchNorm's convention kept from the JAX package (flax ``nn.BatchNorm``): the running
variance EMAs the BIASED batch variance, where ``nn.BatchNorm2d`` EMAs the
unbiased one (factor n/(n-1), n = batch*H*W). Momentum is torch's
(new = (1-m)*old + m*batch, m = cfg.bn_momentum = 0.1). Statistics and the
normalize run in float32 whatever the activation dtype; the output takes the
activation dtype.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.registry import NotPortedError


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class BatchNorm(nn.Module):
    """BatchNorm2d over NCHW with flax's biased running variance.

    Train mode normalizes with the batch statistics (one ``native_batch_norm``
    pass, which also returns the batch mean and inverse std) and updates the
    running buffers in place from those; eval mode normalizes with the
    running buffers. Parameter and buffer names follow ``nn.BatchNorm2d``
    (weight, bias, running_mean, running_var), without num_batches_tracked."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator  # deterministic init (ones / zeros)
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps).to(dt)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = (invstd.float().pow(-2) - self.eps).clamp_(min=0.0)  # biased batch variance
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(dt)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW (params ``weight``/``bias`` for flax's
    scale/bias); ``num_groups`` contiguous blocks of channels."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(_at_least_f32(x), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class ScaleNorm(nn.Module):
    """x * scale / ||x|| over the channels (reference model.py:212-224)."""

    def __init__(self, num_channels: int = 0, eps: float = 1e-5, trainable: bool = True):
        super().__init__()
        del num_channels
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(1)) if trainable else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.scale is not None:
            nn.init.ones_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _at_least_f32(x)
        norm = torch.linalg.vector_norm(xf, dim=1, keepdim=True)
        scale = 1.0 if self.scale is None else self.scale.to(xf.dtype).view(1, 1, 1, 1)
        return (xf * (scale / norm.clamp(min=self.eps))).to(x.dtype)


class Affine(nn.Module):
    """x * value, the value a parameter ``value`` if trainable (reference model.py:227-240)."""

    def __init__(self, value: float = 1.0, trainable: bool = False):
        super().__init__()
        self.init_value = float(value)
        self.value = nn.Parameter(torch.tensor(self.init_value)) if trainable else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.value is not None:
            nn.init.constant_(self.value, self.init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.init_value if self.value is None else self.value.to(x.dtype)
        return x * v


class Gain(nn.Module):
    """Per-channel learnable gain ``gain``, init 1 (reference model.py:243-253);
    ``filter_from_wd: [gain]`` keeps it out of the weight decay."""

    def __init__(self, size: int):
        super().__init__()
        self.gain = nn.Parameter(torch.ones(size))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.gain)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gain.to(x.dtype).view(1, -1, 1, 1)


def _clamped_ratio(num: torch.Tensor, den: torch.Tensor, lo: float = 0.2, hi: float = 5.0) -> torch.Tensor:
    """Batch-ReNorm style correction factor, detached (reference clamps 1/5..5,
    model.py:262,298,307,378)."""
    return (num / den).clamp(lo, hi).detach()


def _ema_(buf: torch.Tensor, decay: float, value: torch.Tensor) -> None:
    """buf = decay * buf + (1 - decay) * value, in place (the JAX modules' EMA of their statistics)."""
    with torch.no_grad():
        buf.copy_(decay * buf + (1.0 - decay) * value.detach().to(buf.dtype))


class FRNv1(nn.Module):
    """Filter Response Norm v1 (reference model.py:256-289): per-channel batch
    RMS, re-normalized against the running RMS ``running_var`` (EMA decay
    ``momentum``) so that train and eval see the same scale; affine
    ``weight``/``bias``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.95, use_bias: bool = True):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features)) if use_bias else None
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _at_least_f32(x)
        if self.training:
            x2 = xf.square().mean(dim=(0, 2, 3))  # per-channel batch RMS^2
            y = xf * torch.rsqrt(x2 + self.eps).view(1, -1, 1, 1)
            _ema_(self.running_var, self.momentum, x2)
            y = y * _clamped_ratio(torch.sqrt(x2 + self.eps), torch.sqrt(self.running_var)).view(1, -1, 1, 1)
        else:
            y = xf * torch.rsqrt(self.running_var + self.eps).view(1, -1, 1, 1)
        y = y * self.weight.view(1, -1, 1, 1)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


class FRNv2(nn.Module):
    """FRN v2 (reference model.py:292-345): per-sample RMS over (C, H, W), then
    per-sample, per-channel RMS over (H, W), each re-normalized by a running
    batch average (``single_running_var``, a scalar; ``running_var``, per
    channel). No batch dependence at inference."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.95):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("single_running_var", torch.ones(()))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.single_running_var.fill_(1.0)
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _at_least_f32(x)
        if self.training:
            x2_ln = xf.square().mean(dim=(1, 2, 3), keepdim=True)  # per sample
            y = xf * torch.rsqrt(x2_ln + self.eps)
            _ema_(self.single_running_var, self.momentum, x2_ln.mean())
            y = y * _clamped_ratio(torch.sqrt(x2_ln + self.eps), torch.sqrt(self.single_running_var))
            x2_in = y.square().mean(dim=(2, 3), keepdim=True)  # per sample, per channel
            y = y * torch.rsqrt(x2_in + self.eps)
            _ema_(self.running_var, self.momentum, x2_in.mean(dim=0).flatten())
            y = y * _clamped_ratio(torch.sqrt(x2_in + self.eps), torch.sqrt(self.running_var).view(1, -1, 1, 1))
        else:
            y = xf * torch.rsqrt(self.single_running_var + self.eps)
            y = y * torch.rsqrt(self.running_var + self.eps).view(1, -1, 1, 1)
        return (y * self.weight.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)).to(x.dtype)


class VarEMA(nn.Module):
    """Normalize by an EMA of the std of the whole tensor, Batch-ReNorm style
    (reference model.py:348-383). The statistics ``std_ema`` and ``mean_ema``
    are scalars, as in the JAX module: the std and the mean are over every
    element (the population std, ``correction=0``, as ``jnp.std``), and each
    buffer moves as ``decay * old + (1 - decay) * batch``. Train mode returns
    ``x / (std + eps) * r`` with ``r = clamp(std / std_ema, 0.2, 5)`` detached
    and the gradient flowing through ``std``; eval mode divides by
    ``std_ema`` (no eps). ``use=False`` keeps the statistics moving and
    returns ``x`` unchanged (a monitor)."""

    def __init__(self, n_channels: int = 0, use: bool = True, decay: float = 0.95, eps: float = 1e-4):
        super().__init__()
        del n_channels  # accepted for config parity: the statistics are scalars
        self.use, self.decay, self.eps = use, decay, eps
        self.register_buffer("std_ema", torch.ones(()))
        self.register_buffer("mean_ema", torch.zeros(()))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.std_ema.fill_(1.0)
        self.mean_ema.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (_at_least_f32(x) / self.std_ema).to(x.dtype) if self.use else x
        # a monitor's statistics need no graph
        with torch.set_grad_enabled(self.use and torch.is_grad_enabled()):
            xf = _at_least_f32(x)
            std, mean = torch.std_mean(xf, correction=0)
        _ema_(self.std_ema, self.decay, std)
        _ema_(self.mean_ema, self.decay, mean)
        if not self.use:
            return x
        return (xf / (std + self.eps) * _clamped_ratio(std, self.std_ema)).to(x.dtype)


class MeanEMA(nn.Module):
    """Per-sample centering (reference model.py:403-419: its EMA path is
    commented out, so the forward is x - mean(x) over (C, H, W))."""

    def __init__(self, num_channels: int = 0, decay: float = 0.99):
        super().__init__()
        del num_channels, decay

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _at_least_f32(x)
        return (xf - xf.mean(dim=(1, 2, 3), keepdim=True)).to(x.dtype)


class Identity(nn.Module):
    def __init__(self, num_channels: int = 0, **_):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _not_ported(name: str) -> Callable[..., nn.Module]:
    def make(*args, **kwargs):
        raise NotPortedError(f"norm {name!r} (the activated-BN family)", "Queue 1 item 10d")

    return make


# name -> constructor taking the channel count first (the JAX table, norms.py:459-477)
_NORMS: dict = {
    "bn": BatchNorm,
    "batchnorm": BatchNorm,
    "abn": _not_ported("abn"),
    "inplaceabn": _not_ported("inplaceabn"),
    "frozenabn": _not_ported("frozenabn"),
    "agn": _not_ported("agn"),
    "estimated_abn": _not_ported("estimated_abn"),
    "gn": GroupNorm,
    "groupnorm": GroupNorm,
    "frn": FRNv1,
    "frnv1": FRNv1,
    "frnv2": FRNv2,
    "varema": VarEMA,
    "scalenorm": ScaleNorm,
    "meanema": MeanEMA,
    "none": Identity,
    "identity": Identity,
}


def norm_from_name(name: str) -> Callable[..., nn.Module]:
    """The norm class for ``name`` (case-insensitive, quotes stripped); called with the channel count."""
    key = name.strip().strip("'\"").lower()
    if key not in _NORMS:
        raise KeyError(f"unknown norm {name!r}; known: {sorted(_NORMS)}")
    return _NORMS[key]
