"""The legacy one-off architectures (port of ``sota_imagenet_tpu/models/extras.py``:
``_CBA`` :31, ``_DarkResidual`` :56, ``Darknet53`` :70, ``DenseNet121`` :121,
``_MBConv`` :162, ``EfficientNetB0`` :197, ``TResNetM`` :237 and the factories
:278-303), which the legacy first-attempt configs name (densenet121,
efficientnet_b0, tresnetm, darknet53, timm_cspdarknet53).

As the JAX modules, they take NHWC images (viewed as NCHW channels_last
inside) and return float32 logits; the classifier (``fc``, flax's default
lecun-normal init) computes in the dtype of its input. Submodules carry the
JAX module's names; the unnamed ones (``_CBA``'s conv and norm,
``_DarkResidual``'s two ``_CBA``) are mapped onto flax's class-and-order
names by ``utils/weights.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.attention import SE
from sota_imagenet_tpu_torch.models.layers import (
    Conv, DropPath, Dropout, Linear, SpaceToDepth, activation_from_name, max_pool,
)
from sota_imagenet_tpu_torch.models.norms import BatchNorm
from sota_imagenet_tpu_torch.models.resnet import BasicBlock, Bottleneck


def _reset(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-initialize every parameter of ``model`` from ``generator`` (module order)."""
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def _classify(fc: Linear, dropout: Dropout, x: torch.Tensor) -> torch.Tensor:
    """Global average pool, dropout and the classifier; float32 logits."""
    return fc(dropout(x.mean(dim=(2, 3)))).float()


class _CBA(nn.Module):
    """conv (padding k // 2, no bias) + BatchNorm + activation."""

    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 activation: str = "leaky_relu", dtype=None):
        super().__init__()
        self.conv = Conv(in_chs, out_chs, kernel_size, stride, kernel_size // 2, groups=groups, use_bias=False,
                         dtype=dtype)
        self.bn = BatchNorm(out_chs, dtype=dtype)
        self.act = activation_from_name(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class _DarkResidual(nn.Module):
    """x + drop_path(3x3 CBA(1x1 CBA to chs // 2))."""

    def __init__(self, chs: int, activation: str = "leaky_relu", keep_prob: float = 1.0, dtype=None):
        super().__init__()
        self.cba1 = _CBA(chs, chs // 2, 1, activation=activation, dtype=dtype)
        self.cba2 = _CBA(chs // 2, chs, 3, activation=activation, dtype=dtype)
        self.drop_path = DropPath(keep_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop_path(self.cba2(self.cba1(x)))


class Darknet53(nn.Module):
    """Darknet-53 (arXiv:1804.02767): a 3x3 stem of 32, then per stage a
    stride-2 3x3 to ``channels[s]`` and ``layers[s]`` residual blocks;
    leaky_relu. ``csp`` wraps each stage of more than one block CSP-style
    (CSPDarknet-53, arXiv:1911.11929): two 1x1 halves, the blocks on one,
    a 1x1 transition, concat [blocks, bypass], a 1x1 out. Drop-path keep
    probability falls linearly over the blocks to 1 - ``drop_connect_rate``."""

    def __init__(
        self,
        layers: Sequence[int] = (1, 2, 8, 8, 4),
        channels: Sequence[int] = (64, 128, 256, 512, 1024),
        csp: bool = False,
        num_classes: int = 1000,
        drop_rate: float = 0.0,
        drop_connect_rate: float = 0.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype, self.layers = dtype, tuple(int(n) for n in layers)
        total = max(sum(self.layers) - 1, 1)
        idx, chs = 0, 32
        self.stem = _CBA(3, 32, 3, dtype=dtype)
        self.csp = [csp and n > 1 for n in self.layers]
        for s, (n, c) in enumerate(zip(self.layers, channels)):
            self.add_module(f"down{s}", _CBA(chs, c, 3, stride=2, dtype=dtype))
            width = c // 2 if self.csp[s] else c
            if self.csp[s]:
                self.add_module(f"csp_in{s}", _CBA(c, width, 1, dtype=dtype))
                self.add_module(f"csp_by{s}", _CBA(c, width, 1, dtype=dtype))
            for i in range(n):
                kp = 1.0 - drop_connect_rate * idx / total if drop_connect_rate else 1.0
                self.add_module(f"stage{s}_block{i}", _DarkResidual(width, keep_prob=kp, dtype=dtype))
                idx += 1
            if self.csp[s]:
                self.add_module(f"csp_t{s}", _CBA(width, width, 1, dtype=dtype))
                self.add_module(f"csp_out{s}", _CBA(2 * width, c, 1, dtype=dtype))
            chs = c
        self.dropout = Dropout(drop_rate)
        self.fc = Linear(chs, num_classes, std=None, dtype=dtype, follow_input=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem(x.permute(0, 3, 1, 2))
        for s, n in enumerate(self.layers):
            x = getattr(self, f"down{s}")(x)
            if self.csp[s]:
                blk, bypass = getattr(self, f"csp_in{s}")(x), getattr(self, f"csp_by{s}")(x)
                for i in range(n):
                    blk = getattr(self, f"stage{s}_block{i}")(blk)
                x = getattr(self, f"csp_out{s}")(torch.cat([getattr(self, f"csp_t{s}")(blk), bypass], dim=1))
            else:
                for i in range(n):
                    x = getattr(self, f"stage{s}_block{i}")(x)
        return _classify(self.fc, self.dropout, x)


class DenseNet121(nn.Module):
    """DenseNet-121 (arXiv:1608.06993): growth 32, blocks (6, 12, 24, 16),
    BN-ReLU-1x1(4k) -> BN-ReLU-3x3(k) concatenated onto the input; between
    blocks BN-ReLU-1x1 to half the width and a 2x2 average pool."""

    def __init__(self, growth: int = 32, blocks: Sequence[int] = (6, 12, 24, 16), num_classes: int = 1000,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype, self.blocks = dtype, tuple(int(n) for n in blocks)
        k = growth
        self.stem_conv = Conv(3, 2 * k, 7, 2, 3, use_bias=False, dtype=dtype)
        self.stem_bn = BatchNorm(2 * k, dtype=dtype)
        chs = 2 * k
        for b, n in enumerate(self.blocks):
            for i in range(n):
                self.add_module(f"b{b}_{i}_bn1", BatchNorm(chs, dtype=dtype))
                self.add_module(f"b{b}_{i}_conv1", Conv(chs, 4 * k, 1, 1, 0, use_bias=False, dtype=dtype))
                self.add_module(f"b{b}_{i}_bn2", BatchNorm(4 * k, dtype=dtype))
                self.add_module(f"b{b}_{i}_conv2", Conv(4 * k, k, 3, 1, 1, use_bias=False, dtype=dtype))
                chs += k
            if b < len(self.blocks) - 1:
                self.add_module(f"t{b}_bn", BatchNorm(chs, dtype=dtype))
                self.add_module(f"t{b}_conv", Conv(chs, chs // 2, 1, 1, 0, use_bias=False, dtype=dtype))
                chs //= 2
        self.final_bn = BatchNorm(chs, dtype=dtype)
        self.act = F.relu
        self.dropout = Dropout(0.0)
        self.fc = Linear(chs, num_classes, std=None, dtype=dtype, follow_input=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        act = self.act
        x = max_pool(act(self.stem_bn(self.stem_conv(x.permute(0, 3, 1, 2)))), 3, 2, 1)
        for b, n in enumerate(self.blocks):
            for i in range(n):
                y = getattr(self, f"b{b}_{i}_conv1")(act(getattr(self, f"b{b}_{i}_bn1")(x)))
                y = getattr(self, f"b{b}_{i}_conv2")(act(getattr(self, f"b{b}_{i}_bn2")(y)))
                x = torch.cat([x, y], dim=1)
            if b < len(self.blocks) - 1:
                x = getattr(self, f"t{b}_conv")(act(getattr(self, f"t{b}_bn")(x)))
                x = F.avg_pool2d(x, 2, 2)
        return _classify(self.fc, self.dropout, act(self.final_bn(x)))


class _MBConv(nn.Module):
    """MBConv: [1x1 expand CBA ->] depthwise k x k + BN + act -> SE (reduced
    from the block's input width) -> 1x1 project + BN [-> drop-path + x at
    stride 1 when the width holds]."""

    def __init__(self, in_chs: int, out_chs: int = 16, expand: int = 6, kernel_size: int = 3, stride: int = 1,
                 se_ratio: float = 0.25, keep_prob: float = 1.0, activation: str = "swish", dtype=None):
        super().__init__()
        mid = in_chs * expand
        self.residual = stride == 1 and in_chs == out_chs
        self.expand = _CBA(in_chs, mid, 1, activation=activation, dtype=dtype) if expand != 1 else None
        self.dw = Conv(mid, mid, kernel_size, stride, kernel_size // 2, groups=mid, use_bias=False, dtype=dtype)
        self.dw_bn = BatchNorm(mid, dtype=dtype)
        self.act = activation_from_name(activation)
        self.se = SE(mid, reduction=int(1 / (se_ratio / expand))) if se_ratio else None
        self.project = Conv(mid, out_chs, 1, 1, 0, use_bias=False, dtype=dtype)
        self.project_bn = BatchNorm(out_chs, dtype=dtype)
        self.drop_path = DropPath(keep_prob) if self.residual else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.expand(x) if self.expand is not None else x
        out = self.act(self.dw_bn(self.dw(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.project_bn(self.project(out))
        return self.drop_path(out) + x if self.residual else out


class EfficientNetB0(nn.Module):
    """EfficientNet-B0 (arXiv:1905.11946): MBConv stages (e, c, n, s, k) as
    ``STAGES``, swish, SE 0.25, head 1280; drop-path keep probability
    falling linearly over the 16 blocks to 1 - ``drop_connect_rate``."""

    STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
              (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))

    def __init__(self, num_classes: int = 1000, drop_rate: float = 0.2, drop_connect_rate: float = 0.2,
                 norm_act: str = "swish", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stem = _CBA(3, 32, 3, stride=2, activation=norm_act, dtype=dtype)
        total = sum(n for _, _, n, _, _ in self.STAGES)
        self.block_names, idx, chs = [], 0, 32
        for s, (e, c, n, stride, k) in enumerate(self.STAGES):
            for i in range(n):
                kp = 1.0 - drop_connect_rate * idx / max(total - 1, 1)
                self.add_module(f"s{s}_b{i}", _MBConv(
                    chs, c, e, k, stride if i == 0 else 1, keep_prob=kp if drop_connect_rate else 1.0,
                    activation=norm_act, dtype=dtype,
                ))
                self.block_names.append(f"s{s}_b{i}")
                idx, chs = idx + 1, c
        self.head = _CBA(chs, 1280, 1, activation=norm_act, dtype=dtype)
        self.dropout = Dropout(drop_rate)
        self.fc = Linear(1280, num_classes, std=None, dtype=dtype, follow_input=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.stem(x.permute(0, 3, 1, 2))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return _classify(self.fc, self.dropout, self.head(x))


class TResNetM(nn.Module):
    """TResNet-M (arXiv:2003.13630): SpaceToDepth(4) -> 1x1 conv to 64 + BN
    + leaky_relu; BasicBlock(64) x3 and BasicBlock(128) x4 with SE,
    Bottleneck(256) x11 with SE, Bottleneck(512) x3; leaky_relu and
    anti-aliased stride 2 throughout. Blocks ``layer{s}_{i}``, the JAX names."""

    PLAN = ((BasicBlock, 64, 3, 1, "se"), (BasicBlock, 128, 4, 2, "se"), (Bottleneck, 256, 11, 2, "se"),
            (Bottleneck, 512, 3, 2, None))

    def __init__(self, num_classes: int = 1000, drop_rate: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.s2d = SpaceToDepth(4)
        self.stem_conv = Conv(48, 64, 1, 1, 0, use_bias=False, dtype=dtype)
        self.stem_bn = BatchNorm(64, dtype=dtype)
        self.act = activation_from_name("leaky_relu")
        self.block_names, in_chs = [], 64
        for s, (block, planes, n, stride, attn) in enumerate(self.PLAN):
            for i in range(n):
                st = stride if i == 0 else 1
                down = st != 1 or in_chs != planes * block.expansion
                self.add_module(f"layer{s + 1}_{i}", block(
                    in_chs, planes, st, down, norm_act="leaky_relu", antialias=True, attn_type=attn, dtype=dtype,
                ))
                self.block_names.append(f"layer{s + 1}_{i}")
                in_chs = planes * block.expansion
        self.dropout = Dropout(drop_rate)
        self.fc = Linear(in_chs, num_classes, std=None, dtype=dtype, follow_input=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.act(self.stem_bn(self.stem_conv(self.s2d(x.permute(0, 3, 1, 2)))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return _classify(self.fc, self.dropout, x)


def _strip(kwargs):
    kwargs.pop("pretrained", None)
    return kwargs


def darknet53(**kwargs) -> Darknet53:
    return Darknet53(**_strip(kwargs))


def cspdarknet53(**kwargs) -> Darknet53:
    return Darknet53(csp=True, **_strip(kwargs))


def densenet121(**kwargs) -> DenseNet121:
    kwargs.pop("memory_efficient", None)  # torch's gradient-checkpointing flag, which the JAX factory drops too
    return DenseNet121(**_strip(kwargs))


def efficientnet_b0(**kwargs) -> EfficientNetB0:
    return EfficientNetB0(**_strip(kwargs))


def tresnetm(**kwargs) -> TResNetM:
    return TResNetM(**_strip(kwargs))
