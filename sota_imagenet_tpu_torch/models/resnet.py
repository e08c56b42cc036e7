"""ResNet family, torchvision layout (port of ``sota_imagenet_tpu/models/resnet.py``
:42-359: every option of the JAX ResNet, ``fused_stats`` and ``bresnet50``).

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

from sota_imagenet_tpu_torch.models.attention import get_attn
from sota_imagenet_tpu_torch.models.layers import (
    BlurPool, Conv, DropPath, Dropout, Linear, SpaceToDepth, activation_from_name, max_pool,
)
from sota_imagenet_tpu_torch.models.norms import BatchNorm, GroupNorm
from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats_nhwc
from sota_imagenet_tpu_torch.parallel.mesh import all_reduce_sum, band_of, data_count, with_band


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
    Over ranks the sums are the global batch's, as the JAX step's over its
    global array: summed over the data ranks, and over the data x spatial
    ranks for a band of H rows (``parallel/spatial.py``), where the kernel
    runs on this rank's band and a stride takes the band's rows of the
    global subsample.

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
            stride, band = self.stride, band_of(x)
            if band is not None and stride != 1:
                x, stride = x[:, :, ::stride, ::stride], 1  # the band's rows of the global subsample
            with torch._C.DisableTorchFunction():  # the kernel on this rank's rows
                y, s1, s2 = conv1x1_stats_nhwc(x, self.weight, stride)
            y = with_band(y, band_of(x))
            height = y.shape[2] if band is None else band_of(x)[1][-1][1]
            n = y.shape[0] * height * y.shape[3] * data_count()
            if data_count() > 1 or band is not None:
                s1, s2 = all_reduce_sum(torch.stack([s1, s2]), "bn", "data" if band is None else "data_spatial")
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


_GN_FAMILY = ("agn", "gn", "groupnorm")


def _norm(norm_layer: str, chs: int, momentum: float, subsample: int, dtype) -> nn.Module:
    """The JAX ``_bare_norm`` (resnet.py:42): GroupNorm with gcd(32, C) groups
    for the GroupNorm family (``agn``, ``gn``), BatchNorm for any other name.
    The activation, where there is one, is the block's (the JAX ``_NormAct``)."""
    if norm_layer in _GN_FAMILY:
        return GroupNorm(chs, num_groups=math.gcd(32, chs))
    return BatchNorm(chs, momentum, dtype=dtype, subsample=subsample)


class _Block(nn.Module):
    """What BasicBlock and Bottleneck share (resnet.py:110-241 of the JAX
    package): with ``antialias`` the strided 3x3 runs at stride 1 and a
    BlurPool (``blur``) downsamples its output, and the residual path of a
    stride-2 block is blurred (``down_blur``) before its stride-1 1x1 conv;
    ``attn_type`` adds an attention gate (``attn``) after the last norm;
    ``keep_prob`` < 1 drops the branch per sample (``drop_path``) before the
    residual add."""

    def _tail(self, out_chs, stride, antialias, attn_type, keep_prob):
        self.blur = BlurPool() if antialias and stride == 2 else None
        self.attn = get_attn(attn_type)(out_chs)
        self.drop_path = DropPath(keep_prob)

    def _downsample(self, inplanes, out_chs, stride, antialias, norm, dtype):
        """The plain residual path: [BlurPool ->] 1x1 conv -> norm (``downsample``)."""
        blurred = antialias and stride == 2
        self.down_blur = BlurPool() if blurred else None
        return nn.Sequential(Conv(inplanes, out_chs, 1, 1 if blurred else stride, 0, use_bias=False, dtype=dtype),
                             norm(out_chs))

    def _residual(self, x, down):
        if down is None:
            return x
        return down(x if self.down_blur is None else self.down_blur(x))

    def _gate(self, out):
        if self.attn is not None:
            out = self.attn(out)
        return self.drop_path(out)


class BasicBlock(_Block):
    expansion = 1

    def __init__(
        self, inplanes, planes, stride=1, downsample=False, bn_momentum=0.1, norm_act="relu", dtype=None,
        norm_layer="abn", bn_subsample=1, antialias=False, attn_type=None, keep_prob=1.0,
    ):
        super().__init__()
        norm = lambda c: _norm(norm_layer, c, bn_momentum, bn_subsample, dtype)  # noqa: E731
        self.conv1 = Conv(inplanes, planes, 3, 1 if antialias else stride, 1, use_bias=False, dtype=dtype)
        self.bn1 = norm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, use_bias=False, dtype=dtype)
        self.bn2 = norm(planes)
        self._tail(planes, stride, antialias, attn_type, keep_prob)
        self.down_blur = None
        self.downsample = self._downsample(inplanes, planes, stride, antialias, norm, dtype) if downsample else None
        self.act = activation_from_name(norm_act)

    def forward(self, x):
        out = self.conv1(x)
        if self.blur is not None:
            out = self.blur(out)
        out = self.act(self.bn1(out))
        out = self._gate(self.bn2(self.conv2(out)))
        return self.act(out + self._residual(x, self.downsample))


class Bottleneck(_Block):
    """torchvision v1.5 bottleneck: the stride sits on the 3x3 conv. With
    ``fused_stats`` the 1x1 convs and their norms are ``Conv1x1BNStats``:
    ``fconv1`` (with the activation; only when ``groups == 1``), ``fconv3``
    and ``fdown`` (none; a blurred residual keeps its plain conv and norm),
    as in the JAX Bottleneck (resnet.py:184-241)."""

    expansion = 4

    def __init__(
        self, inplanes, planes, stride=1, downsample=False, bn_momentum=0.1, norm_act="relu", groups=1, base_width=64,
        fused_stats=False, dtype=None, norm_layer="abn", bn_subsample=1, antialias=False, attn_type=None,
        keep_prob=1.0,
    ):
        super().__init__()
        if fused_stats and bn_subsample > 1:
            # as the JAX Bottleneck (resnet.py:189-193): the fused stats are full-resolution
            raise ValueError("fused_stats is incompatible with bn_subsample > 1")
        norm = lambda c: _norm(norm_layer, c, bn_momentum, bn_subsample, dtype)  # noqa: E731
        width = int(planes * (base_width / 64.0)) * groups
        out_chs = planes * self.expansion
        self.fused1 = fused_stats and groups == 1
        self.fused = fused_stats
        if self.fused1:
            self.fconv1 = Conv1x1BNStats(inplanes, width, 1, bn_momentum, activation=norm_act, dtype=dtype)
        else:
            self.conv1 = Conv(inplanes, width, 1, 1, 0, use_bias=False, dtype=dtype)
            self.bn1 = norm(width)
        self.conv2 = Conv(width, width, 3, 1 if antialias else stride, 1, groups=groups, use_bias=False, dtype=dtype)
        self.bn2 = norm(width)
        if fused_stats:
            self.fconv3 = Conv1x1BNStats(width, out_chs, 1, bn_momentum, dtype=dtype)
        else:
            self.conv3 = Conv(width, out_chs, 1, 1, 0, use_bias=False, dtype=dtype)
            self.bn3 = norm(out_chs)
        self._tail(out_chs, stride, antialias, attn_type, keep_prob)
        self.down_blur, self.fdown, self.downsample = None, None, None
        if downsample and fused_stats and not (antialias and stride == 2):
            self.fdown = Conv1x1BNStats(inplanes, out_chs, stride, bn_momentum, dtype=dtype)
        elif downsample:
            self.downsample = self._downsample(inplanes, out_chs, stride, antialias, norm, dtype)
        self.act = activation_from_name(norm_act)

    def forward(self, x):
        out = self.fconv1(x) if self.fused1 else self.act(self.bn1(self.conv1(x)))
        out = self.conv2(out)
        if self.blur is not None:
            out = self.blur(out)
        out = self.act(self.bn2(out))
        out = self._gate(self.fconv3(out) if self.fused else self.bn3(self.conv3(out)))
        return self.act(out + self._residual(x, self.downsample if self.fdown is None else self.fdown))


class ResNet(nn.Module):
    """Configurable ResNet (torchvision layout) with the JAX ResNet's options
    (resnet.py:244-316): ``stem_type`` "" (7x7 stride 2 + max-pool),
    "space2depth" (SpaceToDepth(4), a 3x3 48 -> 64 conv and its norm, no
    max-pool) or "deep" (three 3x3 convs of 32, 32 and 64 channels, the first
    strided, each with its norm, then the max-pool; ``conv1`` and ``bn1`` are
    then ModuleLists); ``norm_layer`` (the GroupNorm family, or BatchNorm
    with ``bn_subsample``); the blocks' ``antialias`` and ``attn_type``;
    drop-path rising linearly over the blocks to ``drop_connect_rate``; and
    ``Dropout(drop_rate)`` before ``fc``."""

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
        if stem_type not in ("", "space2depth", "deep"):
            raise ValueError(f"unknown stem_type {stem_type!r}")
        if groups != 1 and block is not Bottleneck:
            raise ValueError("groups > 1 needs the Bottleneck block")
        norm_layer = str(norm_layer).lower()
        norm = lambda c: _norm(norm_layer, c, bn_momentum, bn_subsample, dtype)  # noqa: E731
        self.dtype, self.stem_type = dtype, stem_type
        self.act = activation_from_name(norm_act)
        if stem_type == "space2depth":
            self.s2d = SpaceToDepth(4)  # 3 -> 48 channels, /4 spatially
            self.conv1 = Conv(48, 64, 3, 1, 1, use_bias=False, dtype=dtype)
            self.bn1 = norm(64)
        elif stem_type == "deep":
            chs = (3, 32, 32, 64)
            self.conv1 = nn.ModuleList(
                Conv(chs[i], chs[i + 1], 3, 2 if i == 0 else 1, 1, use_bias=False, dtype=dtype) for i in range(3)
            )
            self.bn1 = nn.ModuleList(norm(c) for c in chs[1:])
        else:
            self.conv1 = Conv(3, 64, 7, 2, 3, use_bias=False, dtype=dtype)
            self.bn1 = norm(64)
        in_chs, total, block_idx = 64, sum(layers), 0
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
                # linearly increasing drop-path (timm convention, resnet.py:281-283)
                keep_prob = 1.0 - drop_connect_rate * block_idx / max(total - 1, 1) if drop_connect_rate > 0 else 1.0
                blocks.append(block(
                    in_chs, planes, stride, downsample, bn_momentum, norm_act, dtype=dtype, norm_layer=norm_layer,
                    bn_subsample=bn_subsample, antialias=antialias, attn_type=attn_type, keep_prob=keep_prob, **extra,
                ))
                in_chs = planes * block.expansion
                block_idx += 1
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)
        self.dropout = Dropout(drop_rate)
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
        if self.stem_type == "space2depth":
            x = self.act(self.bn1(self.conv1(self.s2d(x))))
        elif self.stem_type == "deep":
            for conv, bn in zip(self.conv1, self.bn1):
                x = self.act(bn(conv(x)))
            x = max_pool(x, 3, 2, 1)
        else:
            x = max_pool(self.act(self.bn1(self.conv1(x))), 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = self.dropout(x.mean(dim=(2, 3)))
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


def bresnet50(**kwargs):
    """BResNet-50, the architecture of the 81.4% "ultimate encoder" recipe
    (resnet.py:346-359; BResNet50_encoder.yaml:42-52): space2depth stem,
    BlurPool, ECA, leaky_relu, drop-path and dropout 0.2."""
    defaults = dict(
        stem_type="space2depth", antialias=True, attn_type="eca", norm_act="leaky_relu", drop_rate=0.2,
        drop_connect_rate=0.2,
    )
    defaults.update(kwargs)
    return _resnet(Bottleneck, defaults.pop("layers", (3, 4, 6, 3)), **defaults)
