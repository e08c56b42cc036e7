"""Blocks for config-built models (port of ``sota_imagenet_tpu/models/blocks.py``:
partial_residual :31, ConvActBlock :57, ConvBnAct :450). The rest of the
block zoo is not ported yet (ROADMAP.md Queue 1 item 10)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.attention import SEVar3
from sota_imagenet_tpu_torch.models.layers import BlurPool, ChannelShuffle, Conv, ScaledStdConv, activation_from_name
from sota_imagenet_tpu_torch.models.norms import BatchNorm
from sota_imagenet_tpu_torch.registry import NotPortedError


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


class ConvActBlock(nn.Module):
    """scaled 3x3 conv + (partial) residual -> act (reference model.py:822-870).
    The residual is BlurPool-downscaled when stride is 2. ``sse`` adds an
    SEVar3 gate when the width does not change."""

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
    ):
        super().__init__()
        if attn_kwargs is not None:
            raise NotPortedError("ConvActBlock attn_kwargs (XCA)", "Queue 1 item 10")
        if pre_norm:
            raise NotPortedError(f"ConvActBlock pre_norm={pre_norm!r} (the norm zoo)", "Queue 1 item 10")
        groups = _groups(in_chs, groups, groups_width)
        ck = dict(conv_kwargs or {})
        ck["groups"] = groups
        self.conv = ScaledStdConv(in_chs, out_chs, kernel_size=3, stride=stride, padding=1, **ck)
        self.shuffle = ChannelShuffle(groups)
        self.blur = BlurPool() if stride == 2 else None
        self.act = activation_from_name(activation)
        self.sse = SEVar3(out_chs) if sse and in_chs == out_chs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.shuffle(self.conv(x))
        out = self.act(partial_residual(out, x if self.blur is None else self.blur(x)))
        return out if self.sse is None else self.sse(out)


class ConvBnAct(nn.Module):
    """conv3x3 + BN + activation, a convenience for VGG-style CModel configs."""

    def __init__(self, in_chs: int, out_chs: int, activation: str = "swish_hard", stride: int = 1):
        super().__init__()
        self.conv = Conv(in_chs, out_chs, 3, stride, 1, use_bias=False)
        self.bn = BatchNorm(out_chs)
        self.act = activation_from_name(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))
