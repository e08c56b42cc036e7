"""The norm zoo (port of ``sota_imagenet_tpu/models/norms.py``): BatchNorm
(the default branch of norms.py:143-192), GroupNorm :282, ScaleNorm :294,
Affine :312, Gain :327, FRNv1 :345, FRNv2 :374, VarEMA :407, MeanEMA :441,
Identity :453, the activated-BN family (ABN :195, AGN :229, EstimatedABN
:247) and ``norm_from_name`` :459-484.

Modules take NCHW tensors (channel = dim 1). Each takes its channel count as
its first argument, where the JAX module reads it from its input; the ones
that keep no per-channel state accept and ignore it. Statistics run in
float32 (float64 for float64 inputs) and the output takes the input's dtype.
Running statistics are buffers, updated in place by train-mode forwards, as
the JAX modules update ``batch_stats``.

Statistics over the batch axis are over the GLOBAL batch, as in the JAX
package, whose step runs on a global array sharded over the mesh's
``data`` axis (norms.py:1-24 there): with N > 1 data ranks of a
``torch.distributed`` group, each holds rows [r*B/N, (r+1)*B/N) and the
statistics are summed over them (``parallel/mesh.py``); one rank computes
them as one process does. Under spatial partitioning a rank holds a band of
H rows of its images (``parallel/spatial.py``), and the statistics of a band
are summed over the data x spatial ranks, over the global count. ``run.bn_stats`` chooses BatchNorm's and
ABN's view (``resolve_bn_stats``, ``set_bn_stats_groups``): ``global``
(one group, sync-BN), ``local`` (one group per rank) or an int g (g groups,
each a contiguous run of B/g rows of the global batch, which may straddle
ranks).

BatchNorm's convention kept from the JAX package (flax ``nn.BatchNorm``): the running
variance EMAs the BIASED batch variance, where ``nn.BatchNorm2d`` EMAs the
unbiased one (factor n/(n-1), n = batch*H*W). Momentum is torch's
(new = (1-m)*old + m*batch, m = cfg.bn_momentum = 0.1). Statistics and the
normalize run in float32 whatever the activation dtype; the output takes the
activation dtype.
"""

from __future__ import annotations

from typing import Callable, Optional

import math

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.layers import activation_from_name
from sota_imagenet_tpu_torch.parallel.mesh import all_reduce_sum, band_of, data_count, data_index, global_mean
from sota_imagenet_tpu_torch.utils.misc import at_least_f32, sqrt

# Process-wide default of BatchNorm's and ABN's statistics groups, set once
# from cfg.run.bn_stats before the model is built (norms.py:46-56 of the JAX
# package; the same global-patch idiom as the reference's bn momentum).
_BN_STATS_GROUPS: int = 1


def set_bn_stats_groups(groups: int) -> None:
    global _BN_STATS_GROUPS
    _BN_STATS_GROUPS = max(int(groups), 1)


def bn_stats_groups() -> int:
    return _BN_STATS_GROUPS


def resolve_bn_stats(spec, data_devices: int) -> int:
    """Map config ``run.bn_stats`` (global | local | int) to a group count
    (norms.py:58-67 of the JAX package): ``local`` is one group per rank."""
    if spec in (None, "global", 1):
        return 1
    if spec == "local":
        return max(int(data_devices), 1)
    g = int(spec)
    if g < 1:
        raise ValueError(f"run.bn_stats must be 'global', 'local' or a positive int, got {spec!r}")
    return g


def group_moments(x: torch.Tensor, groups: int = 1):
    """Mean and biased variance over (batch, H, W) of each of ``groups``
    contiguous runs of rows of the global batch (the JAX ``_BNCore``'s
    reshape to (g, B/g, ...), norms.py:70-130), from this rank's rows of an
    NCHW ``x``: each row's sums go to its group's row of a (2, g, C) buffer,
    one differentiable all-reduce sums the buffers of the ranks, and
    var = max(E[x^2] - mean^2, 0) as in the JAX one-pass form. Returns the
    (g, C) mean and var in at least float32, and each local row's group.
    The groups count rows of the data axis (the JAX ``resolve_bn_stats``
    over ``mesh.shape['data']``); a band of H rows sums its share over the
    data x spatial ranks."""
    b, world, band = x.shape[0], data_count(), band_of(x)
    if (b * world) % groups:
        raise ValueError(f"bn_stats groups={groups} must divide the global batch ({b * world})")
    per = b * world // groups
    with torch._C.DisableTorchFunction():  # this rank's rows (its band of them), whatever mode is active
        rows = (torch.arange(b, device=x.device) + data_index() * b) // per
        # each row's and channel's sums of x and x^2 over (H, W), accumulated in at least float32 without a
        # float32 copy of x (a bf16 reduction to float32 reads x as it is); autograd keeps x and the norms only
        acc = torch.promote_types(x.dtype, torch.float32)
        sums = torch.stack([x.sum(dim=(2, 3), dtype=acc),
                            torch.linalg.vector_norm(x, dim=(2, 3), dtype=acc).square()])
        # each row's sums into its group's row, as a product with the one-hot (b, g) membership: deterministic on
        # the card, where index_add's atomics sum in a varying order
        part = torch.einsum("bg,sbc->sgc", F.one_hot(rows, groups).to(sums.dtype), sums)
    height = x.shape[2] if band is None else band[1][-1][1]
    tot = all_reduce_sum(part, "bn", "data" if band is None else "data_spatial") / (per * height * x.shape[3])
    return tot[0], (tot[1] - tot[0].square()).clamp(min=0.0), rows


class BatchNorm(nn.Module):
    """BatchNorm2d over NCHW with flax's biased running variance.

    Train mode normalizes with the batch statistics (one ``native_batch_norm``
    pass, which also returns the batch mean and inverse std) and updates the
    running buffers in place from those; eval mode normalizes with the
    running buffers. Parameter and buffer names follow ``nn.BatchNorm2d``
    (weight, bias, running_mean, running_var), without num_batches_tracked.

    ``subsample`` s > 1 takes the batch statistics over x[:, :, ::s, ::s]
    (the JAX ``_BNCore``, norms.py:70-140): mean and E[x^2] in float32 in
    one pass, var = max(E[x^2] - mean^2, 0), and the normalize in the
    activation dtype, each factor cast to it first; the gradient reaches
    the statistics through the subsampled positions only.

    ``stats_groups`` (None: the process default, ``set_bn_stats_groups``)
    g > 1, or more than one rank, takes the statistics of each of g
    runs of the global batch (``group_moments``; g = 1 over the ranks is
    sync-BN), normalizes each row by its group's as x * scale + shift
    (scale = rsqrt(var + eps) * weight, shift = bias - mean * scale, cast
    to the activation dtype), and moves the running buffers by the groups'
    average, the same on every rank (the JAX note, norms.py:113-117)."""

    def __init__(
        self, num_features: int, momentum: float = 0.1, eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
        subsample: int = 1, stats_groups: Optional[int] = None, use_scale: bool = True,
    ):
        super().__init__()
        self.momentum, self.eps, self.dtype, self.subsample = momentum, eps, dtype, max(int(subsample), 1)
        self.stats_groups = stats_groups
        # use_scale=False (the JAX BatchNorm's option): no ``weight``, the normalized x is only shifted
        self.weight = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator  # deterministic init (ones / zeros)
        if self.weight is not None:
            nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.to(self.running_mean.dtype), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.to(self.running_var.dtype), alpha=m)

    def _normalize(self, x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """(x - mean) * rsqrt(var + eps) * weight + bias, every factor in ``dt`` (the _BNCore order)."""
        view = (1, -1, 1, 1)
        y = (x.to(dt) - mean.to(dt).view(view)) * torch.rsqrt(var + self.eps).to(dt).view(view)
        if self.weight is not None:
            y = y * self.weight.to(dt).view(view)
        return y + self.bias.to(dt).view(view)

    def forward(self, x: torch.Tensor, use_running_average: Optional[bool] = None) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if use_running_average is None:
            use_running_average = not self.training
        if use_running_average:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps).to(dt)
        groups = self.stats_groups if self.stats_groups is not None else bn_stats_groups()
        # one group over one rank is the one process's BatchNorm, whether or not a process group is up
        if groups > 1 or data_count() > 1 or band_of(x) is not None:
            s = self.subsample
            mean, var, rows = group_moments(x if s == 1 else x[:, :, ::s, ::s], groups)
            self._update(mean.detach().mean(0), var.detach().mean(0))
            scale = torch.rsqrt(var + self.eps)
            if self.weight is not None:
                scale = scale * self.weight
            shift = self.bias - mean * scale
            view = (x.shape[0], -1, 1, 1)
            return x.to(dt) * scale[rows].to(dt).view(view) + shift[rows].to(dt).view(view)
        if self.subsample > 1:
            s = self.subsample
            xf = at_least_f32(x[:, :, ::s, ::s])
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf.square().mean(dim=(0, 2, 3)) - mean.square()).clamp(min=0.0)
            self._update(mean.detach(), var.detach())
            return self._normalize(x, mean, var, dt)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        self._update(mean, (invstd.detach().pow(-2) - self.eps).clamp_(min=0.0))  # biased batch variance
        return y.to(dt)


class ABN(BatchNorm):
    """Activated BatchNorm (norms.py:195): BatchNorm, then the activation
    (leaky_relu by default, as inplace-abn). ``frozen`` (``frozenabn``)
    normalizes with the running statistics in training too, and leaves them
    as they are. The state is BatchNorm's; the JAX module's flax BatchNorm
    sits one level down, under ``BatchNorm_0``, as in the JAX BatchNorm."""

    def __init__(
        self, num_features: int, activation: str = "leaky_relu", momentum: float = 0.1, eps: float = 1e-5,
        frozen: bool = False, dtype: Optional[torch.dtype] = None, stats_groups: Optional[int] = None,
    ):
        super().__init__(num_features, momentum, eps, dtype, stats_groups=stats_groups)
        self.frozen = frozen
        self.act = activation_from_name(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(super().forward(x, use_running_average=self.frozen or not self.training))


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
        y = F.group_norm(at_least_f32(x), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class AGN(GroupNorm):
    """Activated GroupNorm (norms.py:229; ``norm_layer: agn``): GroupNorm with
    gcd(num_groups, C) groups, then the activation."""

    def __init__(self, num_channels: int, activation: str = "leaky_relu", num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_channels, math.gcd(num_groups, num_channels), eps)
        self.act = activation_from_name(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(super().forward(x))


class EstimatedABN(nn.Module):
    """Activated BN that normalizes with the running ("estimated") statistics
    in train and eval mode alike (norms.py:247; ``estimated_abn``). A train
    forward normalizes with the statistics as they were before it, then
    moves them towards the batch's: mean and E[x^2] - mean^2 (clamped at 0)
    in float32, torch momentum, no gradient through the update. The
    normalize runs in the activation dtype: x * (rsqrt(var + eps) * scale)
    + (bias - mean * scale * rsqrt(var + eps)), each factor cast first. Names
    as BatchNorm's; the JAX module's own leaves are scale, bias / mean, var."""

    def __init__(
        self, num_features: int, activation: str = "leaky_relu", momentum: float = 0.1, eps: float = 1e-5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.act = activation_from_name(activation)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    reset_parameters = BatchNorm.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        mean, var = self.running_mean.clone(), self.running_var.clone()
        if self.training:
            with torch.no_grad():
                xf = at_least_f32(x)
                bmean = global_mean(xf, (0, 2, 3))
                bvar = global_mean(xf.square(), (0, 2, 3)) - bmean.square()
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(bmean.float(), alpha=m)
                self.running_var.mul_(1.0 - m).add_(bvar.float().clamp(min=0.0), alpha=m)
        rs = torch.rsqrt(var + self.eps)
        inv = (rs * self.weight).to(dt).view(1, -1, 1, 1)
        shift = (self.bias - mean * self.weight * rs).to(dt).view(1, -1, 1, 1)
        return self.act(x.to(dt) * inv + shift)


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
        xf = at_least_f32(x)
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
        xf = at_least_f32(x)
        if self.training:
            x2 = global_mean(xf.square(), (0, 2, 3))  # per-channel batch RMS^2
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
        xf = at_least_f32(x)
        if self.training:
            x2_ln = xf.square().mean(dim=(1, 2, 3), keepdim=True)  # per sample
            y = xf * torch.rsqrt(x2_ln + self.eps)
            _ema_(self.single_running_var, self.momentum, global_mean(x2_ln.detach()))
            y = y * _clamped_ratio(torch.sqrt(x2_ln + self.eps), torch.sqrt(self.single_running_var))
            x2_in = y.square().mean(dim=(2, 3), keepdim=True)  # per sample, per channel
            y = y * torch.rsqrt(x2_in + self.eps)
            _ema_(self.running_var, self.momentum, global_mean(x2_in.detach(), 0).flatten())
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
            return (at_least_f32(x) / self.std_ema).to(x.dtype) if self.use else x
        # a monitor's statistics need no graph
        with torch.set_grad_enabled(self.use and torch.is_grad_enabled()):
            xf = at_least_f32(x)
            if data_count() > 1 or band_of(xf) is not None:  # over the global batch: two passes, as jnp.std
                mean = global_mean(xf)
                std = sqrt(global_mean((xf - mean).square()))
            else:  # one fused pass
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
        xf = at_least_f32(x)
        return (xf - xf.mean(dim=(1, 2, 3), keepdim=True)).to(x.dtype)


class Identity(nn.Module):
    def __init__(self, num_channels: int = 0, **_):
        super().__init__()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


# name -> constructor taking the channel count first (the JAX table, norms.py:459-477)
_NORMS: dict = {
    "bn": BatchNorm,
    "batchnorm": BatchNorm,
    "abn": ABN,
    "inplaceabn": ABN,
    "frozenabn": lambda *a, **kw: ABN(*a, frozen=True, **kw),
    "agn": AGN,
    "estimated_abn": EstimatedABN,
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
