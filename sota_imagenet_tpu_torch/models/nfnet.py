"""Normalizer-free networks, NFNet-L / ECA-NFNet family (port of
``sota_imagenet_tpu/models/nfnet.py``:38-190; Brock et al., arXiv:2101.08692
and arXiv:2102.06171).

Scaled-WS convs, pre-activation bottlenecks with alpha/beta signal-propagation
scaling, ECA attention with gain 2.0, skip-init gains, stochastic depth. Each
block's input is downscaled by beta = 1/expected_std; expected_std resets at
a stage's first block and grows by sqrt(1 + alpha^2) per block. The
activation's gamma is folded into the activation (``gamma * act(x)``), so
every WS conv has gamma 1.0 (the timm convention).

As the port's ResNet, ``forward`` takes NHWC images and returns float32
logits; inside, tensors are NCHW views in channels_last memory. Module names
follow the JAX tree (``stem_conv{i}``, ``stage{s}_block{b}`` with ``conv1``,
``conv2``, ``conv2b``, ``conv3``, ``downsample``, ``attn``,
``skipinit_gain``; ``final_conv``; ``fc``), which ``utils/weights.py`` maps.
Parameters stay float32; the convs and the head run in the activation dtype.

On the card (``kernel_path``: a bf16 CUDA tensor, SiLU, ECA with 3 taps or
no attention, plain convs, channels a multiple of 8, outside spatial
partitioning) the elementwise chains run as hand-written kernels
(``ops/nf_fused.py``): the weight standardisation of a block's convs (and of
the stem's and the final conv's) as one ``nf_ws``,
every SiLU site as ``nf_act``, the conv's bias folded in, and each block's
tail after ``conv3`` (bias, ECA, drop-path, skip-init gain, alpha, residual)
as ``nf_tail``. The drop mask is drawn where and when
``DropPath`` draws it, through ``layers.draw_keep_mask``. Everywhere else,
the CPU (and so ``cli export``) included, the op by op chain runs.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models import layers
from sota_imagenet_tpu_torch.models.attention import ECA, get_attn
from sota_imagenet_tpu_torch.models.layers import (
    ACTIVATION_GAMMA,
    DropPath,
    Dropout,
    Linear,
    ScaledStdConv,
    activation_from_name,
)
from sota_imagenet_tpu_torch.ops import nf_fused
from sota_imagenet_tpu_torch.parallel import spatial
from sota_imagenet_tpu_torch.parallel.mesh import band_of


def kernel_path(
    x: torch.Tensor, act, convs: Sequence[ScaledStdConv], attn: Optional[nn.Module] = None, channels: Sequence[int] = ()
) -> Optional[str]:
    """None where ``nf_fused``'s kernels compute the chains around ``convs``
    (and, with ``attn``, a block's tail), else the reason the op by op chain
    runs: ``activation`` (not SiLU), ``attention`` (neither ECA with 3 taps
    nor none), ``conv`` (heads, edge compensation, coordinates, a pinned
    dtype, weight normalisation, a single gain or a weight not float32),
    ``channels`` (a SiLU site's ``channels`` or a conv's outputs not
    a multiple of 8, or a tail too wide), ``dtype`` (not bf16), ``spatial``
    (spatial partitioning, whose ops on bands of H rows a kernel would
    bypass), ``device`` (not a CUDA tensor)."""
    if act is not F.silu:
        return "activation"
    if attn is not None and not (isinstance(attn, ECA) and attn.kernel_size == 3):
        return "attention"
    if any(c.n_heads != 1 or c.partial or c.coord_conv or c.dtype is not None or c.norm for c in convs):
        return "conv"
    if any(c.weight.dtype != torch.float32 or (c.gain is not None and c.gain.shape != (c.out_chs,)) for c in convs):
        return "conv"
    widths = [*channels, *(c.out_chs for c in convs)]
    if any(w % nf_fused.VEC for w in widths) or (attn is not None and convs[-1].out_chs > nf_fused.MAX_TAIL_CHANNELS):
        return "channels"
    if x.dtype != torch.bfloat16:
        return "dtype"
    if spatial.is_active() or band_of(x) is not None:
        return "spatial"
    if x.device.type != "cuda":
        return "device"
    return None


def _standardized(convs: Sequence[Optional[ScaledStdConv]], dtype: torch.dtype) -> list:
    """Each conv's standardised weight in ``dtype`` (None for a None conv), by one ``nf_ws`` call."""
    present = [c for c in convs if c is not None]
    weights = iter(nf_fused.nf_ws([(c.weight, c.gain, c.scale, c.eps) for c in present], dtype))
    return [None if c is None else next(weights) for c in convs]


def _conv(conv: ScaledStdConv, weight: torch.Tensor, x: torch.Tensor, bias: bool = False) -> torch.Tensor:
    """``conv(x)`` with ``weight``, its standardised weight; without its bias,
    which the kernel after it adds, unless ``bias``."""
    b = conv.bias.to(x.dtype) if bias and conv.bias is not None else None
    return F.conv2d(x, weight, b, conv.stride, conv.padding, conv.dilation, conv.groups)


def _conv_act(conv: ScaledStdConv, weight: torch.Tensor, x: torch.Tensor, gamma: float) -> torch.Tensor:
    """``gamma * silu(conv(x))`` with the conv's bias and the activation in one kernel."""
    return nf_fused.nf_act(_conv(conv, weight, x), conv.bias, gamma)


class NFBlock(nn.Module):
    """Pre-act normalizer-free bottleneck (1-3-3-1) with alpha/beta scaling."""

    def __init__(
        self,
        in_chs: int,
        out_chs: int,
        stride: int = 1,
        beta: float = 1.0,
        alpha: float = 0.2,
        bottle_ratio: float = 0.25,
        group_size: int = 64,
        attn_type: Optional[str] = "eca",
        attn_gain: float = 2.0,
        keep_prob: float = 1.0,
        gamma: float = ACTIVATION_GAMMA["silu"],
        activation: str = "silu",
        skipinit: bool = True,
    ):
        super().__init__()
        self.stride, self.beta, self.alpha, self.attn_gain, self.gamma = stride, beta, alpha, attn_gain, gamma
        self.base_act = activation_from_name(activation)
        groups = max(int(out_chs * bottle_ratio) // group_size, 1)
        mid = groups * group_size
        ws = dict(gamma=1.0)
        self.downsample = (
            ScaledStdConv(in_chs, out_chs, kernel_size=1, padding=0, **ws) if stride > 1 or in_chs != out_chs else None
        )
        self.conv1 = ScaledStdConv(in_chs, mid, kernel_size=1, padding=0, **ws)
        self.conv2 = ScaledStdConv(mid, mid, kernel_size=3, stride=stride, padding=1, groups=groups, **ws)
        self.conv2b = ScaledStdConv(mid, mid, kernel_size=3, padding=1, groups=groups, **ws)
        self.conv3 = ScaledStdConv(mid, out_chs, kernel_size=1, padding=0, **ws)
        self.attn = get_attn(attn_type)(out_chs) if attn_type else None
        self.drop_path = DropPath(keep_prob)
        # zero: at init every block is its shortcut
        self.skipinit_gain = nn.Parameter(torch.zeros(())) if skipinit else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator
        if self.skipinit_gain is not None:
            nn.init.zeros_(self.skipinit_gain)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.base_act(x) * self.gamma

    def kernel_path(self, x: torch.Tensor) -> Optional[str]:
        """``kernel_path`` for this block's input: None where its chains run as kernels."""
        convs = [c for c in (self.downsample, self.conv1, self.conv2, self.conv2b, self.conv3) if c is not None]
        return kernel_path(x, self.base_act, convs, self.attn, channels=(x.shape[1],))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        reason = self.kernel_path(x)
        if x.device.type == "cuda" and self.training:
            if reason:
                nf_fused.fallbacks[reason] += 1
            else:
                nf_fused.fused["NFBlock"] += 1
        return self.chain(x) if reason else self.fused(x)

    def fused(self, x: torch.Tensor) -> torch.Tensor:
        """The block with its chains as ``nf_fused``'s kernels (the plain versions on the CPU)."""
        w_down, w1, w2, w2b, w3 = _standardized(
            (self.downsample, self.conv1, self.conv2, self.conv2b, self.conv3), x.dtype)
        out = nf_fused.nf_act(x, None, self.gamma * self.beta)
        shortcut = x
        if self.downsample is not None:
            shortcut = _conv(self.downsample, w_down, F.avg_pool2d(out, 2, 2) if self.stride > 1 else out, bias=True)
        for conv, weight in ((self.conv1, w1), (self.conv2, w2), (self.conv2b, w2b)):
            out = _conv_act(conv, weight, out, self.gamma)
        out = _conv(self.conv3, w3, out)
        drop, k = self.drop_path, self.alpha
        mask = None
        if drop.training and drop.keep_prob < 1.0:
            # drawn here as DropPath draws it, so the generator's stream and a test's patch see the same draws
            mask = layers.draw_keep_mask(drop.generator, drop.keep_prob, (out.shape[0], 1, 1, 1), out.device)
            k = k / drop.keep_prob
        eca = None
        if self.attn is not None:
            eca, k = self.attn.weight, k * self.attn_gain
        return nf_fused.nf_tail(out, self.conv3.bias, shortcut, eca, self.skipinit_gain, mask, k)

    def chain(self, x: torch.Tensor) -> torch.Tensor:
        """The block op by op."""
        out = self.act(x) * self.beta
        shortcut = x
        if self.downsample is not None:
            # the stride-2 shortcut pools the pre-activated input 2x2, then the 1x1 conv
            shortcut = self.downsample(F.avg_pool2d(out, 2, 2) if self.stride > 1 else out)
        out = self.act(self.conv1(out))
        out = self.act(self.conv2(out))
        out = self.act(self.conv2b(out))
        out = self.conv3(out)
        if self.attn is not None:
            # gain 2.0 compensates the sigmoid gate's mean of ~0.5 (NFNet recipe)
            out = self.attn_gain * self.attn(out)
        out = self.drop_path(out)
        if self.skipinit_gain is not None:
            out = out * self.skipinit_gain.to(out.dtype)
        return out * self.alpha + shortcut


class NFNet(nn.Module):
    """Normalizer-free network with deep-quad stem (NFNet-L layout)."""

    def __init__(
        self,
        depths: Sequence[int] = (1, 2, 6, 3),
        channels: Sequence[int] = (256, 512, 1536, 1536),
        stem_chs: Sequence[int] = (16, 32, 64, 128),
        group_size: int = 64,
        bottle_ratio: float = 0.25,
        alpha: float = 0.2,
        num_classes: int = 1000,
        final_mult: float = 1.5,  # final 1x1 conv: channels[-1] * mult (l0: 2304)
        attn_type: Optional[str] = "eca",
        activation: str = "silu",
        drop_rate: float = 0.0,
        drop_path_rate: float = 0.0,
        skipinit: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.gamma = ACTIVATION_GAMMA.get(activation, 1.7)
        self.base_act = activation_from_name(activation)
        # deep-quad stem: /4 spatial
        in_chs = 3
        self.stem = []
        for i, (chs, st) in enumerate(zip(stem_chs, (2, 1, 1, 2))):
            conv = ScaledStdConv(in_chs, chs, kernel_size=3, stride=st, padding=1, gamma=1.0)
            self.add_module(f"stem_conv{i}", conv)
            self.stem.append(conv)
            in_chs = chs
        total_blocks = sum(depths)
        block_idx = 0
        expected_std = 1.0
        self.blocks = []
        for stage, (depth, chs) in enumerate(zip(depths, channels)):
            for b in range(depth):
                keep_prob = 1.0 - drop_path_rate * block_idx / max(total_blocks - 1, 1)
                block = NFBlock(
                    in_chs,
                    chs,
                    stride=2 if (b == 0 and stage > 0) else 1,
                    beta=1.0 / expected_std,
                    alpha=alpha,
                    bottle_ratio=bottle_ratio,
                    group_size=group_size,
                    attn_type=attn_type,
                    keep_prob=keep_prob if drop_path_rate > 0 else 1.0,
                    gamma=self.gamma,
                    activation=activation,
                    skipinit=skipinit,
                )
                self.add_module(f"stage{stage}_block{b}", block)
                self.blocks.append(block)
                in_chs = chs
                if b == 0:
                    expected_std = 1.0  # transition resets variance tracking
                expected_std = (expected_std**2 + alpha**2) ** 0.5
                block_idx += 1
        final_chs = int(channels[-1] * final_mult)
        self.final_conv = ScaledStdConv(in_chs, final_chs, kernel_size=1, padding=0, gamma=1.0)
        self.dropout = Dropout(drop_rate)
        self.fc = Linear(final_chs, num_classes, std=0.01, dtype=dtype, follow_input=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-initialize every parameter from ``generator`` (module order)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return self.base_act(x) * self.gamma  # gamma-folded act (timm convention)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC images -> (B, num_classes) float32 logits."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
        kernels = kernel_path(x, self.base_act, [*self.stem, self.final_conv]) is None
        if kernels:
            *stem, final = _standardized([*self.stem, self.final_conv], x.dtype)
            for conv, weight in zip(self.stem[:-1], stem):
                x = _conv_act(conv, weight, x, self.gamma)
            x = _conv(self.stem[-1], stem[-1], x, bias=True)
        else:
            for conv in self.stem[:-1]:
                x = self.act(conv(x))
            x = self.stem[-1](x)
        for block in self.blocks:
            x = block(x)
        x = _conv_act(self.final_conv, final, x, self.gamma) if kernels else self.act(self.final_conv(x))
        x = self.dropout(x.mean(dim=(2, 3)))
        return self.fc(x).float()


def eca_nfnet_l0(drop_rate: float = 0.0, drop_path_rate: float = 0.0, **kwargs) -> NFNet:
    """ECA-NFNet-L0 (the reference trains timm's, 15.eca_nfnet_l0.yaml)."""
    kwargs.pop("pretrained", None)
    return NFNet(
        depths=(1, 2, 6, 3),
        channels=(256, 512, 1536, 1536),
        attn_type="eca",
        drop_rate=drop_rate,
        drop_path_rate=drop_path_rate,
        **kwargs,
    )


def eca_nfnet_l1(drop_rate: float = 0.0, drop_path_rate: float = 0.0, **kwargs) -> NFNet:
    kwargs.pop("pretrained", None)
    return NFNet(
        depths=(2, 4, 12, 6),
        channels=(256, 512, 1536, 1536),
        attn_type="eca",
        drop_rate=drop_rate,
        drop_path_rate=drop_path_rate,
        **kwargs,
    )
