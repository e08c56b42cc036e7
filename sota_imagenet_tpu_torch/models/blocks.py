"""Blocks for config-built models (port of ``sota_imagenet_tpu/models/blocks.py``:
partial_residual :31, _make_pre_norm :45, ConvActBlock :57, VGGBlock :93,
ConvMixBlock :117, NormFreeBlock :152, NormFreeBlockTimm :193, NonDeepBlock
:258, EMABlock :309, PreInvertedResidual :342, PreBasicBlock :367, Yolo5_C3
:392, FusedRepVGGBlock :426, ConvBnAct :450, ConvResidual :466, Residual
:488, ConvMixerBlock :499): the whole block zoo.

Submodules that hold parameters carry the JAX module's names where it names
them (``conv1``, ``conv2``...); ``utils/weights.py`` maps the others onto
flax's class-and-order names."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.attention import SEVar3, UFO, XCA, get_attn
from sota_imagenet_tpu_torch.models.layers import BlurPool, ChannelShuffle, Conv, DropPath, ScaledStdConv, activation_from_name
from sota_imagenet_tpu_torch.models.norms import Affine, BatchNorm, GroupNorm, VarEMA, norm_from_name


def partial_residual(out: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """out[:, :res_chs] += res (supports res_chs <= out_chs), NCHW."""
    rc, oc = res.shape[1], out.shape[1]
    if rc == oc:
        return out + res
    if rc > oc:
        raise ValueError(f"partial residual needs res chs ({rc}) <= out chs ({oc})")
    return out + F.pad(res.to(out.dtype), (0, 0, 0, 0, 0, oc - rc))


def _groups(in_chs: int, groups: int, groups_width: Optional[int]) -> int:
    return max(in_chs // groups_width, 1) if groups_width else groups


def _make_pre_norm(pre_norm, channels: int) -> Optional[nn.Module]:
    """A pre-norm from its config name. Reference configs write "VarEMA(128)"
    (eval'd in the reference, model.py:1199-1204): the name before the
    parenthesis picks the norm, built for ``channels``."""
    if pre_norm is None or pre_norm is False:
        return None
    if isinstance(pre_norm, str):
        return norm_from_name(pre_norm.split("(")[0])(channels)
    raise ValueError(f"bad pre_norm {pre_norm!r}")


class ConvActBlock(nn.Module):
    """[pre_norm ->] scaled 3x3 conv + (partial) residual -> act [-> XCA]
    (reference model.py:822-870). The residual, the block's input before the
    pre-norm, is BlurPool-downscaled when stride is 2. ``attn_kwargs`` adds
    an XCA (residual by default) after the activation; the JAX block calls
    it without ``train``, so its dropout never runs, and here it is built
    with its dropout rates at 0. ``sse`` adds an SEVar3 gate when the width
    does not change. ``input_chs`` is the width the block receives where it
    differs from ``in_chs``: a CModel repeat of a widening block feeds the
    later copies the first one's output, and the JAX block reads its conv's
    and pre-norm's width off that input while ``in_chs`` still sets the
    groups and the SE condition."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        stride: int = 1,
        groups: int = 1,
        groups_width: Optional[int] = None,
        activation: str = "relu",
        conv_kwargs: Optional[Dict] = None,
        attn_kwargs: Optional[Dict] = None,
        pre_norm: Optional[str] = None,
        sse: bool = False,
        input_chs: Optional[int] = None,
    ):
        super().__init__()
        self.in_chs, self.out_chs = in_chs, out_chs
        self.pre_norm = _make_pre_norm(pre_norm, input_chs or in_chs)
        groups = _groups(in_chs, groups, groups_width)
        ck = dict(conv_kwargs or {})
        ck["groups"] = groups
        self.conv = ScaledStdConv(input_chs or in_chs, out_chs, kernel_size=3, stride=stride, padding=1, **ck)
        self.shuffle = ChannelShuffle(groups)
        self.blur = BlurPool() if stride == 2 else None
        self.act = activation_from_name(activation)
        self.attn = None if attn_kwargs is None else XCA(out_chs, **{**attn_kwargs, "attn_drop": 0.0, "proj_drop": 0.0})
        self.sse = SEVar3(out_chs) if sse and in_chs == out_chs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.shuffle(self.conv(x if self.pre_norm is None else self.pre_norm(x)))
        out = self.act(partial_residual(out, x if self.blur is None else self.blur(x)))
        if self.attn is not None:
            out = self.attn(out)
        return out if self.sse is None else self.sse(out)


def _attention(attention_type: Optional[str], channels: int, kwargs: Optional[Dict]) -> Optional[nn.Module]:
    return get_attn(attention_type)(channels, **(kwargs or {})) if attention_type else None


class NormFreeBlock(nn.Module):
    """Pre-act 2-conv basic block with alpha/beta gain inits (reference
    model.py:874-930; NFNet arXiv:2102.06171): [GroupNorm ->] act -> conv3x3
    (gain beta) -> shuffle -> act -> conv3x3 (gain alpha) -> shuffle [->
    attention * attention_gain] -> drop-path -> + x (partial residual)."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        mid_chs: Optional[int] = None,
        groups: int = 1,
        groups_width: Optional[int] = None,
        activation: str = "relu",
        attention_type: Optional[str] = None,
        attention_kwargs: Optional[Dict] = None,
        attention_gain: float = 2.0,
        keep_prob: float = 1.0,
        beta: float = 1.0,
        alpha: float = 0.2,
        conv_kwargs: Optional[Dict] = None,
        pre_norm_group_width: Optional[int] = None,
    ):
        super().__init__()
        mid = mid_chs or out_chs
        groups = _groups(in_chs, groups, groups_width)
        ck = dict(conv_kwargs or {})
        self.pre_norm = GroupNorm(in_chs, num_groups=in_chs // pre_norm_group_width) if pre_norm_group_width else None
        self.act = activation_from_name(activation)
        self.conv1 = ScaledStdConv(in_chs, mid, kernel_size=3, padding=1, gain_init=beta, groups=groups, **ck)
        self.conv2 = ScaledStdConv(mid, out_chs, kernel_size=3, padding=1, gain_init=alpha, groups=groups, **ck)
        self.shuffle = ChannelShuffle(groups)
        self.attn = _attention(attention_type, out_chs, attention_kwargs)
        self.attn_gain = Affine(attention_gain)
        self.drop_path = DropPath(keep_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x if self.pre_norm is None else self.pre_norm(x)
        out = self.shuffle(self.conv1(self.act(out)))
        out = self.shuffle(self.conv2(self.act(out)))
        if self.attn is not None:
            out = self.attn_gain(self.attn(out))
        return partial_residual(self.drop_path(out), x)


class NormFreeBlockTimm(nn.Module):
    """1-3-3-1 pre-act bottleneck, timm-NFNet style (reference model.py:933-1001):
    [GroupNorm ->] act -> conv1 1x1 (gain beta) -> act -> conv2 3x3 -> act ->
    conv2b 3x3 [-> attention] -> act -> conv3 1x1 (gain alpha) [-> attention]
    -> drop-path -> + x. The 3x3s are grouped by ``groups_width`` of the
    bottleneck width ``mid``; the 1x1s are not, and nothing shuffles.
    ``regnet_attention`` puts the attention before the last activation, and
    its output is scaled by ``attention_gain``; ``full_conv`` pads the 3x3s'
    inputs by reflection instead of zeros."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        mid_chs: Optional[int] = None,
        groups: int = 1,
        groups_width: Optional[int] = None,
        activation: str = "relu",
        attention_type: Optional[str] = None,
        attention_kwargs: Optional[Dict] = None,
        attention_gain: float = 2.0,
        keep_prob: float = 1.0,
        conv_kwargs: Optional[Dict] = None,
        beta: float = 1.0,
        alpha: float = 0.2,
        regnet_attention: bool = False,
        pre_norm_group_width: Optional[int] = None,
        full_conv: bool = False,
    ):
        super().__init__()
        mid = mid_chs or out_chs
        groups = _groups(mid, groups, groups_width)
        ck = dict(conv_kwargs or {})
        ck.pop("padding_mode", None)  # reflect padding is full_conv's
        self.full_conv, self.regnet_attention = full_conv, regnet_attention
        self.pre_norm = GroupNorm(in_chs, num_groups=in_chs // pre_norm_group_width) if pre_norm_group_width else None
        self.act = activation_from_name(activation)
        pad = 0 if full_conv else 1
        self.conv1 = ScaledStdConv(in_chs, mid, kernel_size=1, padding=0, gain_init=beta, **ck)
        self.conv2 = ScaledStdConv(mid, mid, kernel_size=3, padding=pad, groups=groups, **ck)
        self.conv2b = ScaledStdConv(mid, mid, kernel_size=3, padding=pad, groups=groups, **ck)
        self.conv3 = ScaledStdConv(mid, out_chs, kernel_size=1, padding=0, gain_init=alpha, **ck)
        self.attn = _attention(attention_type, mid if regnet_attention else out_chs, attention_kwargs)
        self.attn_gain = Affine(attention_gain)
        self.drop_path = DropPath(keep_prob)

    def _conv3x3(self, conv: ScaledStdConv, x: torch.Tensor) -> torch.Tensor:
        return conv(F.pad(x, (1, 1, 1, 1), mode="reflect") if self.full_conv else x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x if self.pre_norm is None else self.pre_norm(x)
        out = self.act(self.conv1(self.act(out)))
        out = self._conv3x3(self.conv2b, self.act(self._conv3x3(self.conv2, out)))
        if self.attn is not None and self.regnet_attention:
            out = self.attn_gain(self.attn(out))
        out = self.conv3(self.act(out))
        if self.attn is not None and not self.regnet_attention:
            out = self.attn_gain(self.attn(out))
        return partial_residual(self.drop_path(out), x)


class NonDeepBlock(nn.Module):
    """ParNet-style block (reference model.py:658-726; "Non-deep Networks",
    arXiv:2110.07641): x_norm = norm(x); c1 1x1 + c3 3x3 of x_norm (both
    ScaledStdConv when ``scaled``, else Conv with bias; grouped by
    ``groups_width``; c3 only with ``use_conv3``) + one of: XCA of x_norm
    (``xca_kwargs``; in == out), UFO of x_norm (``ufo_kwargs``; from in to
    out, with its projection forced on when they differ), SEVar3 of x_norm
    (``use_se`` and in == out) [-> + x, partial, with ``residual``] [->
    ChannelShuffle with ``shuffle``] -> hard_silu. XCA's and UFO's own
    ``residual`` defaults to False here; set True, it adds x_norm.
    ``se_kwargs`` is accepted and unused, as in the JAX block."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        groups_width: Optional[int] = None,
        conv_kwargs: Optional[Dict] = None,
        scaled: bool = False,
        norm: str = "bn",
        shuffle: bool = True,
        residual: bool = False,
        use_conv3: bool = True,
        xca_kwargs: Optional[Dict] = None,
        ufo_kwargs: Optional[Dict] = None,
        se_kwargs: Optional[Dict] = None,
        use_se: bool = True,
    ):
        super().__init__()
        if residual and in_chs > out_chs:
            raise ValueError("dimension reduction unsupported with residual=True")
        if xca_kwargs is not None and in_chs != out_chs:
            raise ValueError("XCA requires in_chs == out_chs")
        del se_kwargs
        groups = _groups(in_chs, 1, groups_width)
        ck = dict(conv_kwargs or {})
        ck["groups"] = groups
        self.residual = residual
        self.norm = norm_from_name(norm)(in_chs)
        conv = ScaledStdConv if scaled else Conv
        self.c1 = conv(in_chs, out_chs, kernel_size=1, padding=0, **ck)
        self.c3 = conv(in_chs, out_chs, kernel_size=3, padding=1, **ck) if use_conv3 else None
        if xca_kwargs is not None:
            self.attn = XCA(out_chs, **{"residual": False, **xca_kwargs})
        elif ufo_kwargs is not None:
            uk = {"residual": False, **ufo_kwargs}
            if in_chs != out_chs:
                uk["last_proj"] = True  # the projection is what reaches out_chs
            self.attn = UFO(in_chs, out_dim=out_chs, **uk)
        elif use_se and in_chs == out_chs:
            self.attn = SEVar3(out_chs, scaled=scaled)
        else:
            self.attn = None
        self.shuffle = ChannelShuffle(groups) if shuffle else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_norm = self.norm(x)
        out = self.c1(x_norm)
        if self.c3 is not None:
            out = out + self.c3(x_norm)
        if self.attn is not None:
            out = out + self.attn(x_norm)
        if self.residual:
            out = partial_residual(out, x)
        if self.shuffle is not None:
            out = self.shuffle(out)
        return F.hardswish(out)


class EMABlock(nn.Module):
    """VarEMA-normalized residual conv block (reference model.py:422-468):
    res = VarEMA(x) (x with ``remove_ema``); act -> scaled conv3x3 -> shuffle
    (conv -> shuffle -> act with ``conv_act``) -> drop-path -> + res."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        groups: int = 1,
        groups_width: Optional[int] = None,
        activation: str = "relu",
        conv_kwargs: Optional[Dict] = None,
        keep_prob: float = 1.0,
        remove_ema: bool = False,
        conv_act: bool = False,
    ):
        super().__init__()
        groups = _groups(in_chs, groups, groups_width)
        ck = dict(conv_kwargs or {})
        ck["groups"] = groups
        self.conv_act = conv_act
        self.ema = None if remove_ema else VarEMA()
        self.act = activation_from_name(activation)
        self.conv = ScaledStdConv(in_chs, out_chs, kernel_size=3, padding=1, **ck)
        self.shuffle = ChannelShuffle(groups)
        self.drop_path = DropPath(keep_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.ema is None else self.ema(x)
        if self.conv_act:
            out = self.act(self.shuffle(self.conv(res)))
        else:
            out = self.shuffle(self.conv(self.act(res)))
        return partial_residual(self.drop_path(out), res)


class PreInvertedResidual(nn.Module):
    """Pre-norm inverted residual (reference model.py:1004-1035): norm-act ->
    1x1 to ``mid`` -> norm-act -> depthwise 3x3 -> norm-act -> 1x1 to
    ``out_chs`` -> drop-path -> + x (partial). The norms are activated ones
    (``norm_layer``: abn by default) with ``norm_act``."""

    def __init__(
        self, in_chs: int, out_chs: int, mid_chs: Optional[int] = None, keep_prob: float = 1.0,
        norm_layer: str = "abn", norm_act: str = "relu",
    ):
        super().__init__()
        mid = mid_chs or out_chs
        norm = norm_from_name(norm_layer)
        self.norm1 = norm(in_chs, activation=norm_act)
        self.conv1 = Conv(in_chs, mid, 1, 1, 0, use_bias=False)
        self.norm2 = norm(mid, activation=norm_act)
        self.conv2 = Conv(mid, mid, 3, 1, 1, groups=mid, use_bias=False)
        self.norm3 = norm(mid, activation=norm_act)
        self.conv3 = Conv(mid, out_chs, 1, 1, 0, use_bias=False)
        self.drop_path = DropPath(keep_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(self.norm1(x))
        out = self.conv2(self.norm2(out))
        out = self.conv3(self.norm3(out))
        return partial_residual(self.drop_path(out), x)


class PreBasicBlock(nn.Module):
    """Pre-activation basic block (pytorch_tools PreBasicBlock, the BNet
    configs 6-10): norm-act -> 3x3 to ``mid`` -> norm-act -> 3x3 to
    ``out_chs`` -> drop-path -> + x (partial); activated norms as in
    PreInvertedResidual."""

    def __init__(
        self, in_chs: int, out_chs: int, mid_chs: Optional[int] = None, keep_prob: float = 1.0,
        norm_layer: str = "abn", norm_act: str = "relu",
    ):
        super().__init__()
        mid = mid_chs or out_chs
        norm = norm_from_name(norm_layer)
        self.norm1 = norm(in_chs, activation=norm_act)
        self.conv1 = Conv(in_chs, mid, 3, 1, 1, use_bias=False)
        self.norm2 = norm(mid, activation=norm_act)
        self.conv2 = Conv(mid, out_chs, 3, 1, 1, use_bias=False)
        self.drop_path = DropPath(keep_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return partial_residual(self.drop_path(out), x)


class ConvBnAct(nn.Module):
    """conv3x3 + BN + activation, a convenience for VGG-style CModel configs."""

    def __init__(self, in_chs: int, out_chs: int, activation: str = "swish_hard", stride: int = 1):
        super().__init__()
        self.conv = Conv(in_chs, out_chs, 3, stride, 1, use_bias=False)
        self.bn = BatchNorm(out_chs)
        self.act = activation_from_name(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class VGGBlock(nn.Module):
    """[pre_norm ->] act -> scaled conv3x3 -> shuffle, no residual (reference
    model.py:591-621). ``groups_width`` sets the conv's groups and the
    shuffle's."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        groups_width: Optional[int] = None,
        activation: str = "relu",
        conv_kwargs: Optional[Dict] = None,
        pre_norm: Optional[str] = None,
    ):
        super().__init__()
        groups = _groups(in_chs, 1, groups_width)
        ck = dict(conv_kwargs or {})
        ck["groups"] = groups
        self.pre_norm = _make_pre_norm(pre_norm, in_chs)
        self.act = activation_from_name(activation)
        self.conv = ScaledStdConv(in_chs, out_chs, kernel_size=3, padding=1, **ck)
        self.shuffle = ChannelShuffle(groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_norm is not None:
            x = self.pre_norm(x)
        return self.shuffle(self.conv(self.act(x)))


class ConvMixBlock(nn.Module):
    """act -> [pre_norm ->] scaled conv3x3 -> shuffle -> + x on the first
    ``partial_factor`` of the channels both sides share (factor 0, 0.5 or 1;
    reference model.py:773-819, whose 0.5 branch the JAX block repairs)."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        groups_width: Optional[int] = None,
        activation: str = "relu",
        partial_factor: float = 1.0,
        conv_kwargs: Optional[Dict] = None,
        pre_norm: Optional[str] = None,
    ):
        super().__init__()
        if partial_factor not in (0, 0.5, 1, 1.0):
            raise ValueError("partial_factor must be one of {0, 0.5, 1}")
        groups = _groups(in_chs, 1, groups_width)
        ck = dict(conv_kwargs or {})
        ck["groups"] = groups
        self.act = activation_from_name(activation)
        self.pre_norm = _make_pre_norm(pre_norm, in_chs)
        self.conv = ScaledStdConv(in_chs, out_chs, kernel_size=3, padding=1, **ck)
        self.shuffle = ChannelShuffle(groups)
        n_common = min(in_chs, out_chs)
        self.n_res = {0: 0, 0.5: int(n_common * 0.5)}.get(partial_factor, n_common)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.act(x)
        if self.pre_norm is not None:
            out = self.pre_norm(out)
        out = self.shuffle(self.conv(out))
        return partial_residual(out, x[:, : self.n_res]) if self.n_res else out


class Yolo5_C3(nn.Module):
    """CSP bottleneck with NonDeepBlocks (reference model.py:728-754): cv1_2
    (scaled 1x1 -> BatchNorm, or BatchNorm -> scaled 1x1 with ``pre_norm``,
    -> hard_silu) at the input width c; its first half through
    ``num_blocks`` NonDeepBlocks of width c/2, concatenated before the
    second half; cv3 as cv1_2. ``block_kwargs`` go to the NonDeepBlocks
    (SE off by default); its ``se_kwargs`` spelling turns SE off when None."""

    def __init__(self, in_chs: int, num_blocks: int = 1, pre_norm: bool = False, block_kwargs: Optional[Dict] = None):
        super().__init__()
        c = in_chs
        bk = dict(block_kwargs or dict(use_se=False))
        if "se_kwargs" in bk:
            bk["use_se"] = bk.pop("se_kwargs") is not None
        self.pre_norm = pre_norm
        self.cv1_2_bn = BatchNorm(c)
        self.cv1_2_conv = ScaledStdConv(c, c, kernel_size=1, padding=0)
        self.m = nn.ModuleList(NonDeepBlock(c // 2, c // 2, **bk) for _ in range(num_blocks))
        self.cv3_bn = BatchNorm(c)
        self.cv3_conv = ScaledStdConv(c, c, kernel_size=1, padding=0)

    def _cv(self, bn: BatchNorm, conv: ScaledStdConv, t: torch.Tensor) -> torch.Tensor:
        return F.hardswish(conv(bn(t)) if self.pre_norm else bn(conv(t)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        block_inp, res = self._cv(self.cv1_2_bn, self.cv1_2_conv, x).chunk(2, dim=1)
        for block in self.m:
            block_inp = block(block_inp)
        return self._cv(self.cv3_bn, self.cv3_conv, torch.cat([block_inp, res], dim=1))


class FusedRepVGGBlock(nn.Module):
    """RepVGG block (arXiv:2101.03697; pytorch_tools FusedRepVGGBlock):
    3x3 conv -> BN, plus 1x1 conv -> BN, plus BN of the input where the
    shape is kept, summed, then the activation. The three branches stay
    apart in inference too, as in the JAX block (no re-parameterisation)."""

    def __init__(self, in_chs: int, out_chs: int, stride: int = 1, activation: str = "relu"):
        super().__init__()
        self.conv3 = Conv(in_chs, out_chs, 3, stride, 1, use_bias=False)
        self.bn3 = BatchNorm(out_chs)
        self.conv1 = Conv(in_chs, out_chs, 1, stride, 0, use_bias=False)
        self.bn1 = BatchNorm(out_chs)
        self.bn_id = BatchNorm(in_chs) if in_chs == out_chs and stride == 1 else None
        self.act = activation_from_name(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv3(x)) + self.bn1(self.conv1(x))
        if self.bn_id is not None:
            out = out + self.bn_id(x)
        return self.act(out)


class ConvResidual(nn.Module):
    """One conv with a (partial) residual around it (reference model.py:1038-1053):
    a ScaledStdConv, or with ``scaled`` False a plain Conv with bias (the JAX
    Conv's default); padding k // 2."""

    def __init__(
        self, in_chs: int, out_chs: int, kernel_size: int = 3, stride: int = 1, scaled: bool = True,
        conv_kwargs: Optional[Dict] = None,
    ):
        super().__init__()
        if in_chs > out_chs:
            raise ValueError("in_chs > out_chs unsupported (reference model.py:1052)")
        ck = dict(conv_kwargs or {})
        pad = kernel_size // 2
        if scaled:
            self.conv = ScaledStdConv(in_chs, out_chs, kernel_size=kernel_size, stride=stride, padding=pad, **ck)
        else:
            self.conv = Conv(in_chs, out_chs, kernel_size, stride, pad, **ck)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return partial_residual(self.conv(x), x)


class Residual(nn.Module):
    """fn(x) + x (reference model.py:1066-1072)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x) + x


class ConvMixerBlock(nn.Module):
    """ConvMixer block (reference model.py:1075-1089; "Patches Are All You
    Need?"): depthwise k x k conv with bias -> gelu -> BatchNorm -> + x ->
    1x1 conv with bias -> gelu -> BatchNorm. gelu is the tanh approximation
    (``jax.nn.gelu``). The depthwise conv pads 3 whatever k, as the
    reference: with k = 9 the map shrinks by 2 and the residual is cropped
    to the centre."""

    def __init__(self, dim: int, kernel_size: int = 9):
        super().__init__()
        self.conv1 = Conv(dim, dim, kernel_size, 1, 3, groups=dim, use_bias=True)
        self.bn1 = BatchNorm(dim)
        self.conv2 = Conv(dim, dim, 1, 1, 0, use_bias=True)
        self.bn2 = BatchNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(F.gelu(self.conv1(x), approximate="tanh"))
        dh, dw = x.shape[2] - out.shape[2], x.shape[3] - out.shape[3]
        res = x[:, :, dh // 2: x.shape[2] - (dh - dh // 2), dw // 2: x.shape[3] - (dw - dw // 2)] if dh or dw else x
        return self.bn2(F.gelu(self.conv2(out + res), approximate="tanh"))
