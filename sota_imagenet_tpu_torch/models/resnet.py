"""ResNet family, torchvision layout (port of ``sota_imagenet_tpu/models/resnet.py``
:51-343, default options and ``fused_stats``).

The public interface keeps the JAX model's layout: ``forward`` takes NHWC
images (B, H, W, 3) and returns float32 logits. Inside, the NHWC tensor is
viewed as NCHW (``permute``), which is exactly PyTorch's channels_last
memory format, so convolutions run channels_last without a copy. Module and
parameter names follow torchvision (conv1/bn1/layerL.B.convN/bnN/downsample/
fc), the layout ``sota_imagenet_tpu/utils/torch_import.py`` reads and
``utils/weights.flax_to_torch`` writes.

Dtype policy (as the JAX package): parameters stay float32; convs and
BatchNorm outputs run in the activation dtype (bf16 under ``run.bf16``);
global average pooling keeps it; the classifier promotes to float32 (flax
Dense with dtype unset); logits are float32.

``fused_stats=True`` (Bottleneck only, as in the JAX package) replaces each
1x1 conv + BatchNorm of the bottlenecks by ``Conv1x1BNStats`` (``fconv1``,
``fconv3``, ``fdown``), whose train mode takes the batch statistics from the
conv's own epilogue (``ops/conv_stats.py``, a CUDA kernel on the card).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.layers import Conv, Linear, activation_from_name, max_pool
from sota_imagenet_tpu_torch.models.norms import BatchNorm
from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats_nhwc

_BN_FAMILY = ("abn", "bn", "inplaceabn", "batchnorm")


class Conv1x1BNStats(nn.Module):
    """1x1 conv + BatchNorm with the batch statistics taken from the conv's
    epilogue (port of the JAX ``Conv1x1BNStats``, resnet.py:51-107), with an
    optional activation.

    Train mode follows the JAX arithmetic, not ``BatchNorm``'s: y is the bf16
    product of ``conv1x1_stats_nhwc`` (bf16 even in an f32 model), mean = S1/n
    and var = max(S2/n - mean^2, 0) from its f32 sums, the running buffers EMA
    the biased var with torch momentum, and the normalize runs in the
    activation dtype: y * (rsqrt(var + eps) * scale) + (bias - mean * scale *
    rsqrt(var + eps)), each factor cast to that dtype first. Eval mode is a
    plain conv in the activation dtype, normalised with the running buffers.

    Names: ``weight`` (OIHW, fan-out kaiming init as ``Conv``), ``scale``,
    ``bias``; buffers ``running_mean``, ``running_var``."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        stride: int = 1,
        momentum: float = 0.1,
        eps: float = 1e-5,
        activation: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.stride, self.momentum, self.eps, self.dtype = stride, momentum, eps, dtype
        self.act = activation_from_name(activation) if activation else None
        self.weight = nn.Parameter(torch.empty(out_chs, in_chs, 1, 1))
        self.scale = nn.Parameter(torch.ones(out_chs))
        self.bias = nn.Parameter(torch.zeros(out_chs))
        self.register_buffer("running_mean", torch.zeros(out_chs))
        self.register_buffer("running_var", torch.ones(out_chs))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / self.weight.shape[0]), generator=generator)
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if not self.training:
            y = F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride)
            mean, var = self.running_mean, self.running_var
        else:
            y, s1, s2 = conv1x1_stats_nhwc(x, self.weight, self.stride)
            n = y.shape[0] * y.shape[2] * y.shape[3]
            mean = s1 / n
            var = torch.clamp(s2 / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        rs = torch.rsqrt(var + self.eps)
        inv = (rs * self.scale).to(dt).view(1, -1, 1, 1)
        shift = (self.bias - mean * self.scale * rs).to(dt).view(1, -1, 1, 1)
        out = y.to(dt) * inv + shift
        return self.act(out) if self.act is not None else out


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False, bn_momentum=0.1, norm_act="relu", dtype=None):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, 1, use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(planes, bn_momentum, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(planes, bn_momentum, dtype=dtype)
        self.downsample = (
            nn.Sequential(
                Conv(inplanes, planes, 1, stride, 0, use_bias=False, dtype=dtype),
                BatchNorm(planes, bn_momentum, dtype=dtype),
            )
            if downsample
            else None
        )
        self.act = activation_from_name(norm_act)

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return self.act(out + res)


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: the stride sits on the 3x3 conv. With
    ``fused_stats`` the 1x1 convs and their norms are ``Conv1x1BNStats``:
    ``fconv1`` (with the activation; only when ``groups == 1``), ``fconv3``
    and ``fdown`` (none), as in the JAX Bottleneck (resnet.py:184-227)."""

    expansion = 4

    def __init__(
        self, inplanes, planes, stride=1, downsample=False, bn_momentum=0.1, norm_act="relu", groups=1, base_width=64,
        fused_stats=False, dtype=None,
    ):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_chs = planes * self.expansion
        self.fused1 = fused_stats and groups == 1
        self.fused = fused_stats
        if self.fused1:
            self.fconv1 = Conv1x1BNStats(inplanes, width, 1, bn_momentum, activation=norm_act, dtype=dtype)
        else:
            self.conv1 = Conv(inplanes, width, 1, 1, 0, use_bias=False, dtype=dtype)
            self.bn1 = BatchNorm(width, bn_momentum, dtype=dtype)
        self.conv2 = Conv(width, width, 3, stride, 1, groups=groups, use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(width, bn_momentum, dtype=dtype)
        if fused_stats:
            self.fconv3 = Conv1x1BNStats(width, out_chs, 1, bn_momentum, dtype=dtype)
            self.fdown = Conv1x1BNStats(inplanes, out_chs, stride, bn_momentum, dtype=dtype) if downsample else None
        else:
            self.conv3 = Conv(width, out_chs, 1, 1, 0, use_bias=False, dtype=dtype)
            self.bn3 = BatchNorm(out_chs, bn_momentum, dtype=dtype)
            self.downsample = (
                nn.Sequential(
                    Conv(inplanes, out_chs, 1, stride, 0, use_bias=False, dtype=dtype),
                    BatchNorm(out_chs, bn_momentum, dtype=dtype),
                )
                if downsample
                else None
            )
        self.act = activation_from_name(norm_act)

    def forward(self, x):
        out = self.fconv1(x) if self.fused1 else self.act(self.bn1(self.conv1(x)))
        out = self.act(self.bn2(self.conv2(out)))
        out = self.fconv3(out) if self.fused else self.bn3(self.conv3(out))
        down = self.fdown if self.fused else self.downsample
        res = x if down is None else down(x)
        return self.act(out + res)


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"ResNet option {option} is not ported to sota_imagenet_tpu_torch yet (ROADMAP.md {item})")


class ResNet(nn.Module):
    """Configurable ResNet (torchvision layout), default-option subset of the
    JAX ResNet. Options that change the architecture and are not ported
    raise NotImplementedError naming the ROADMAP item that ports them."""

    def __init__(
        self,
        block=Bottleneck,
        layers: Sequence[int] = (3, 4, 6, 3),
        num_classes: int = 1000,
        groups: int = 1,
        base_width: int = 64,
        stem_type: str = "",
        bn_momentum: float = 0.1,
        bn_subsample: int = 1,
        norm_act: str = "relu",
        norm_layer: str = "abn",
        antialias: bool = False,
        attn_type: Optional[str] = None,
        drop_rate: float = 0.0,
        drop_connect_rate: float = 0.0,
        fused_stats: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if stem_type:
            raise _not_ported(f"stem_type={stem_type!r}", "Queue 1 item 10 (BResNet)")
        if str(norm_layer).lower() not in _BN_FAMILY:
            raise _not_ported(f"norm_layer={norm_layer!r}", "Queue 1 item 10 (norm zoo)")
        if antialias:
            raise _not_ported("antialias", "Queue 1 item 10 (BResNet: BlurPool)")
        if attn_type:
            raise _not_ported(f"attn_type={attn_type!r}", "Queue 1 item 10 (BResNet: ECA)")
        if drop_rate > 0 or drop_connect_rate > 0:
            raise _not_ported("drop_rate/drop_connect_rate > 0", "Queue 1 item 10 (BResNet: dropout, drop-path)")
        if fused_stats and bn_subsample > 1 and block is Bottleneck:
            # as the JAX Bottleneck (resnet.py:189-193): the fused stats are full-resolution
            raise ValueError("fused_stats is incompatible with bn_subsample > 1")
        if bn_subsample > 1:
            raise _not_ported("bn_subsample > 1", "Queue 1 item 10 (norm zoo)")
        if groups != 1 and block is not Bottleneck:
            raise ValueError("groups > 1 needs the Bottleneck block")
        self.dtype = dtype
        self.act = activation_from_name(norm_act)
        self.conv1 = Conv(3, 64, 7, 2, 3, use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64, bn_momentum, dtype=dtype)
        in_chs = 64
        for stage, n_blocks in enumerate(layers):
            planes = 64 * (2**stage)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                downsample = stride != 1 or in_chs != planes * block.expansion
                extra = (
                    {"groups": groups, "base_width": base_width, "fused_stats": fused_stats}
                    if block is Bottleneck
                    else {}
                )
                blocks.append(block(in_chs, planes, stride, downsample, bn_momentum, norm_act, dtype=dtype, **extra))
                in_chs = planes * block.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)
        self.fc = Linear(in_chs, num_classes, std=0.01, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-initialize every parameter from ``generator`` (module order)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC images -> (B, num_classes) float32 logits."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
        x = max_pool(self.act(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = x.mean(dim=(2, 3))
        return self.fc(x).float()


def _resnet(block, layers, **kwargs):
    kwargs.pop("pretrained", None)
    if kwargs.pop("deep_stem", False):  # legacy flat-schema alias (resnet34_1phase.yaml)
        kwargs.setdefault("stem_type", "deep")
    return ResNet(block=block, layers=tuple(layers), **kwargs)


def resnet18(**kwargs):
    """torchvision-arch ResNet-18 (reference default model, arg_parser.py:126)."""
    return _resnet(BasicBlock, (2, 2, 2, 2), **kwargs)


def resnet34(**kwargs):
    return _resnet(BasicBlock, (3, 4, 6, 3), **kwargs)


def resnet50(**kwargs):
    """torchvision-arch ResNet-50 — the 77.1% baseline (reference README.md:42)."""
    return _resnet(Bottleneck, (3, 4, 6, 3), **kwargs)


def resnet101(**kwargs):
    return _resnet(Bottleneck, (3, 4, 23, 3), **kwargs)
