"""Attention modules (port of ``sota_imagenet_tpu/models/attention.py``:
_l2norm :22, SE :27, SEVar3 :44, SEVar3Mod :62, ECA :77, XCA :100, UFO :141,
FCA :189, get_attn :234-254).

SE, SEVar3, ECA and FCA pool the activations to one float32 vector per
sample, compute a sigmoid gate from it in float32, and multiply the
activations by the gate cast to their dtype. XCA and UFO attend channels to
channels: per head, a C'xC' matrix of the q and k rows over the H*W tokens
(cost linear in H*W). Their products are the JAX ``jnp.einsum(...,
preferred_element_type=float32)``: computed in the operands' dtype and
returned as float32 (``_einsum_f32``), so a float64 net rounds them to
float32 as the JAX one does.

Tensors are NCHW. The JAX (B, H, W, 3C) -> (B, HW, 3, heads, C') reshape of
the qkv projection splits channel s*C + h*C' + c'; the NCHW (B, 3C, H, W) ->
(B, 3, heads, C', HW) reshape here splits it the same way.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.models.layers import Conv, Dropout, Linear, ScaledStdConv


def _l2norm(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim``, the norm taken as sqrt(sum(x^2)) as in the JAX function (attention.py:22)."""
    return x / x.square().sum(dim=dim, keepdim=True).sqrt().clamp(min=eps)


def _einsum_f32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(equation, a, b, preferred_element_type=float32)``: the product in the operands' dtype, as float32."""
    return torch.einsum(equation, a, b).to(torch.float32)


class SE(nn.Module):
    """Squeeze-and-Excitation with reduction (two lecun-normal Dense layers)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(channels // reduction, 8)
        self.fc1 = Linear(channels, mid, std=None)
        self.fc2 = Linear(mid, channels, std=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3))
        gate = torch.sigmoid(self.fc2(F.relu(self.fc1(s)))).to(x.dtype)
        return x * gate[:, :, None, None]


class SEVar3(nn.Module):
    """SE without dimensionality reduction (ECA paper SE-Var3): one 1x1 conv
    on the pooled vector, weight-standardized if ``scaled``."""

    def __init__(self, channels: int, scaled: bool = False):
        super().__init__()
        if scaled:
            self.conv = ScaledStdConv(channels, channels, kernel_size=1, padding=0)
        else:
            self.conv = Conv(channels, channels, 1, 1, 0, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.float().mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv(s)).to(x.dtype)


class SEVar3Mod(nn.Module):
    """Reference SEVar3_Mod (model.py:624-655): SEVar3 when the width does not
    change, else a zero scalar, so that the calling block's sum skips it."""

    def __init__(self, in_chs: int, out_chs: int, scaled: bool = False):
        super().__init__()
        self.se = SEVar3(out_chs, scaled=scaled) if in_chs == out_chs else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.se is None:
            return torch.zeros((), dtype=x.dtype, device=x.device)
        return self.se(x)


class ECA(nn.Module):
    """Efficient Channel Attention: a 1-D conv of ``kernel_size`` taps (padding
    ``k // 2``, no bias) over the pooled channel vector. ``weight`` is
    (1, 1, k), lecun-normal (fan-in 1 in the JAX (k, 1, 1) layout)."""

    def __init__(self, channels: int = 0, kernel_size: int = 3):
        super().__init__()
        del channels  # the gate's width follows the input
        self.kernel_size = kernel_size
        self.weight = nn.Parameter(torch.empty(1, 1, kernel_size))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        std = math.sqrt(1.0 / self.kernel_size) / 0.87962566103423978  # lecun_normal, fan_in = k * 1
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

    def gate_logits(self, s: torch.Tensor) -> torch.Tensor:
        """The 1-D conv over a pooled (B, C) vector."""
        return F.conv1d(s[:, None, :], self.weight.to(s.dtype), padding=self.kernel_size // 2)[:, 0, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim=(2, 3))  # (B, C)
        return x * torch.sigmoid(self.gate_logits(s)).to(x.dtype)[:, :, None, None]


class XCA(nn.Module):
    """Cross-covariance attention (reference XCA_mod, model.py:471-528; XCiT
    arXiv:2106.09681). Per head, the C'xC' matrix of the float32 l2-normalised
    q and k rows (over the tokens) times ``temperature``, softmax over its
    last axis [-> ``attn_drop``], multiplies v (with ``v_norm``: v
    l2-normalised over the channels in float32, times ``temperature2``), with
    attn cast to v's dtype. [-> ``proj`` 1x1 ScaledStdConv -> ``proj_drop``]
    [-> + x with ``residual``]. ``qkv`` is a 1x1 ScaledStdConv to 3C."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 8,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        last_proj: bool = False,
        residual: bool = True,
        v_norm: bool = False,
    ):
        super().__init__()
        self.num_heads, self.residual, self.v_norm = num_heads, residual, v_norm
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.temperature2 = nn.Parameter(torch.ones(num_heads, 1, 1)) if v_norm else None
        self.qkv = ScaledStdConv(dim, 3 * dim, kernel_size=1, padding=0)
        self.attn_drop = Dropout(attn_drop) if attn_drop else None
        self.proj = ScaledStdConv(dim, dim, kernel_size=1, padding=0) if last_proj else None
        self.proj_drop = Dropout(proj_drop) if last_proj and proj_drop else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for t in (self.temperature, self.temperature2):
            if t is not None:
                nn.init.ones_(t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q, k, v = self.qkv(x).reshape(b, 3, self.num_heads, c // self.num_heads, h * w).unbind(1)
        q, k = _l2norm(q.to(torch.float32), -1), _l2norm(k.to(torch.float32), -1)
        attn = torch.softmax(_einsum_f32("bhcn,bhdn->bhcd", q, k) * self.temperature, dim=-1)
        if self.attn_drop is not None:
            attn = self.attn_drop(attn)
        if self.v_norm:
            v = _l2norm(v.to(torch.float32), -2) * self.temperature2
        out = _einsum_f32("bhcd,bhdn->bhcn", attn.to(v.dtype), v).to(x.dtype).reshape(b, c, h, w)
        if self.proj is not None:
            out = self.proj(out)
            if self.proj_drop is not None:
                out = self.proj_drop(out)
        return x + out if self.residual else out


class ChannelLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(use_bias=False, use_scale=True, dtype=x.dtype)``
    over the channels of an NCHW tensor: eps 1e-6 (torch's default is 1e-5),
    mean and the one-pass variance max(E[x^2] - E[x]^2, 0) in at least
    float32, (x - mean) * (rsqrt(var + eps) * scale) in that precision, then
    cast to the input's dtype. The scale is ``weight``."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf.square().mean(dim=1, keepdim=True) - mean.square()).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype).view(1, -1, 1, 1)
        return ((xf - mean) * mul).to(x.dtype)


class UFO(nn.Module):
    """UFO-ViT attention (reference UFO_mod, model.py:530-588; arXiv:2109.14382):
    softmax-free. [``prenorm``: ChannelLayerNorm, whose output is then the x
    of the rest, residual included ->] ``qkv`` (a 1x1 Conv with bias to 3C)
    -> q, k, v in float32 [-> q, k / HW^0.25 with ``qk_norm``] -> per head,
    q@k^T l2-normalised over its last axis, times ``temperature`` [->
    ``attn_drop``] -> times v l2-normalised over the channels, times
    ``temperature2`` -> cast to x's dtype [-> hard_silu with
    ``prelast_act``] [-> ``proj`` 1x1 ScaledStdConv to ``out_dim`` ->
    ``proj_drop``] [-> + x with ``residual``]."""

    def __init__(
        self,
        dim: int,
        out_dim: Optional[int] = None,
        num_heads: int = 8,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        last_proj: bool = False,
        residual: bool = True,
        qk_norm: bool = False,
        prelast_act: bool = False,
        prenorm: bool = False,
    ):
        super().__init__()
        self.num_heads, self.residual, self.qk_norm, self.prelast_act = num_heads, residual, qk_norm, prelast_act
        self.prenorm = ChannelLayerNorm(dim) if prenorm else None
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.temperature2 = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Conv(dim, 3 * dim, 1, 1, 0, use_bias=True)
        self.attn_drop = Dropout(attn_drop) if attn_drop else None
        self.proj = ScaledStdConv(dim, out_dim or dim, kernel_size=1, padding=0) if last_proj else None
        self.proj_drop = Dropout(proj_drop) if last_proj and proj_drop else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.temperature)
        nn.init.ones_(self.temperature2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.prenorm is not None:
            x = self.prenorm(x)
        b, c, h, w = x.shape
        qkv = self.qkv(x).reshape(b, 3, self.num_heads, c // self.num_heads, h * w).to(torch.float32)
        q, k, v = qkv.unbind(1)
        if self.qk_norm:
            q, k = q / (h * w) ** 0.25, k / (h * w) ** 0.25
        attn = _l2norm(_einsum_f32("bhcn,bhdn->bhcd", q, k), -1) * self.temperature
        if self.attn_drop is not None:
            attn = self.attn_drop(attn)
        v_hat = _l2norm(v, -2) * self.temperature2
        out = _einsum_f32("bhcd,bhdn->bhcn", attn, v_hat).to(x.dtype).reshape(b, c, h, w)
        if self.prelast_act:
            out = F.hardswish(out)
        if self.proj is not None:
            out = self.proj(out)
            if self.proj_drop is not None:
                out = self.proj_drop(out)
        return x + out if self.residual else out


def _dct_bases(n: int, h: int, w: int, device) -> torch.Tensor:
    """The first ``n`` low-frequency 2-D DCT-II bases at h x w in FcaNet's
    zigzag order, (n, h, w) float32. Computed from the input's size at every
    call, as the JAX module does: a constant, not state."""
    uv = sorted(((u, v) for u in range(4) for v in range(4)), key=lambda p: (p[0] + p[1], p[0]))[:n]
    iy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    ix = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    return torch.stack([torch.cos(math.pi * u * iy)[:, None] * torch.cos(math.pi * v * ix)[None, :] for u, v in uv])


class FCA(nn.Module):
    """Frequency channel attention (FcaNet, arXiv:2012.11879; the legacy
    ``attn_type: fca`` / ``fca-eca`` configs). The activations, in float32,
    are pooled against ``num_freq`` low-frequency DCT bases, channel group g
    against basis g, then gated by an SE bottleneck (``fc1``/``fc2``, the JAX
    Dense_0/Dense_1) or, with ``eca``, ECA's 1-D conv of 3 taps (``eca``);
    the gate is sigmoid(logits / ``temperature``)."""

    def __init__(self, channels: int = 0, num_freq: int = 16, reduction: int = 16, temperature: float = 1.0,
                 eca: bool = False):
        super().__init__()
        self.num_freq, self.temperature = num_freq, temperature
        if eca:
            self.eca, self.fc1, self.fc2 = ECA(kernel_size=3), None, None
        else:
            mid = max(channels // reduction, 8)
            self.eca, self.fc1, self.fc2 = None, Linear(channels, mid, std=None), Linear(mid, channels, std=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = min(self.num_freq, c)
        group = torch.arange(c, device=x.device) * n // c  # channel -> its basis
        sel = _dct_bases(n, h, w, x.device)[group]  # (C, H, W)
        s = torch.einsum("bchw,chw->bc", x.to(torch.float32), sel) / (h * w)
        s = self.eca.gate_logits(s) if self.eca is not None else self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s / self.temperature)[:, :, None, None].to(x.dtype)


_ATTN = {
    "se": lambda chs, **kw: SE(chs, **kw),
    "eca": lambda chs, **kw: ECA(chs, **kw),
    "eca9": lambda chs, **kw: ECA(chs, kernel_size=9, **kw),
    "sevar3": lambda chs, **kw: SEVar3(chs, **kw),
    "se-var3": lambda chs, **kw: SEVar3(chs, **kw),
    "xca": lambda chs, **kw: XCA(chs, **kw),
    "ufo": lambda chs, **kw: UFO(chs, **kw),
    "fca": lambda chs, **kw: FCA(chs, **kw),
    "fca-eca": lambda chs, **kw: FCA(chs, eca=True, **kw),
}


def get_attn(name: Optional[str]) -> Callable[..., Optional[nn.Module]]:
    """pytorch_tools get_attn equivalent: name -> constructor taking the channels."""
    if name is None:
        return lambda chs, **kw: None
    key = name.strip().strip("'\"").lower()
    if key not in _ATTN:
        raise KeyError(f"unknown attention {name!r}; known: {sorted(_ATTN)}")
    return _ATTN[key]
