"""Plain PyTorch training steps that the benchmark holds the program's first
steps against, and the readings both sides are compared by.

Everything here is written from the recipe's published semantics and
imports nothing of the code under test:

* the train augment of the recipe (DALI's ops, in their order): a gaussian
  blur of window 11 with a drawn sigma; a colour twist as one linear map in
  YIQ space (hue, saturation, contrast, brightness) rounded to uint8; a
  grayscale of ITU-R 601 luma; up to ``re_count`` erase boxes of value 128;
  the normalize (x - 127.5) / 51; a horizontal mirror;
* CutmixMixup (partner of row i is row B-1-i; mixup blends by lam, cutmix
  pastes the partner's box of area 1 - lam around a drawn centre and mixes
  the labels by the clipped box's area);
* cross-entropy with label smoothing over one-hot labels;
* SGD with momentum and coupled weight decay, and AdamW with decoupled
  weight decay, as torch documents them; the phase schedule (linear or
  cosine between epoch marks, per step); an EMA of parameters and buffers.

The random values (augment uniforms, blur sigmas, mixup draws, drop masks)
are the program's draws, recorded as it made them and handed in here: the
reference follows those draws and works out every derived quantity (colour
matrices, boxes, gaussian taps, blends) itself.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

MEAN, STD = 127.5, 51.0
RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.321), (0.211, -0.523, 0.311))
YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647), (1.0, -1.107, 1.705))


def u8_round(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0)


def colour_matrices(u: torch.Tensor, ct_prob: float, contrast=(0.7, 1.3), brightness=(0.7, 1.3)):
    """Per image 3x3 matrix and offset of DALI's colour twist from the
    uniforms u[:, 0:5] (coin, brightness, contrast, hue in [-20, 20] deg,
    saturation in [0.7, 1.3]); identity where the coin says no."""
    b = brightness[0] + u[:, 1] * (brightness[1] - brightness[0])
    c = contrast[0] + u[:, 2] * (contrast[1] - contrast[0])
    h = (-20.0 + u[:, 3] * 40.0) * (math.pi / 180.0)
    s = 0.7 + u[:, 4] * 0.6
    dev = u.device
    yiq2rgb, rgb2yiq = torch.tensor(YIQ2RGB, device=dev), torch.tensor(RGB2YIQ, device=dev)
    rot = torch.zeros(u.shape[0], 3, 3, device=dev)
    rot[:, 0, 0] = 1.0
    rot[:, 1, 1], rot[:, 1, 2] = s * torch.cos(h), s * torch.sin(h)
    rot[:, 2, 1], rot[:, 2, 2] = -s * torch.sin(h), s * torch.cos(h)
    a = (b * c)[:, None, None] * (yiq2rgb @ rot @ rgb2yiq)
    off = b * 128.0 * (1.0 - c)
    on = u[:, 0] < ct_prob
    a = torch.where(on[:, None, None], a, torch.eye(3, device=dev).expand_as(a))
    return a, torch.where(on, off, torch.zeros_like(off))


def gaussian_blur(img: torch.Tensor, sigmas: torch.Tensor, window: int = 11) -> torch.Tensor:
    """(B, H, W, 3) float -> the separable gaussian of each row's sigma, zero padded."""
    r = window // 2
    xs = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-0.5 * (xs[None, :] / sigmas[:, None].clamp(min=1e-3)) ** 2)
    k = k / k.sum(1, keepdim=True)
    b, h, w, c = img.shape
    x = img.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    kk = k.repeat_interleave(c, 0)
    x = F.conv2d(x, kk.view(b * c, 1, window, 1), padding=(r, 0), groups=b * c)
    x = F.conv2d(x, kk.view(b * c, 1, 1, window), padding=(0, r), groups=b * c)
    return x.reshape(b, c, h, w).permute(0, 2, 3, 1)


def twist_gray_erase_normalize(img_u8: torch.Tensor, u: torch.Tensor, aug: dict) -> torch.Tensor:
    """The colour twist, grayscale, erase and normalize of the recipe, from
    the per-image uniforms ``u`` (B, 7 + 4 * re_count), as float32."""
    x = img_u8.to(torch.float32)
    bsz, h, w, _ = x.shape
    if aug["color_twist_prob"] > 0:
        a, off = colour_matrices(u, aug["color_twist_prob"], aug["contrast_range"], aug["brightness_range"])
        x = u8_round(torch.einsum("bij,bhwj->bhwi", a, x) + off[:, None, None, None])
    if aug["gray_prob"] > 0:
        luma = u8_round(0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])
        gray = (u[:, 5] < aug["gray_prob"])[:, None, None, None]
        x = torch.where(gray, luma[..., None].expand_as(x), x)
    if aug["re_prob"] > 0:
        py = (torch.arange(h, device=x.device, dtype=torch.float32) / h)[None, :, None]
        px = (torch.arange(w, device=x.device, dtype=torch.float32) / w)[None, None, :]
        mask = torch.zeros(bsz, h, w, dtype=torch.bool, device=x.device)
        for k in range(aug["re_count"]):
            c = 7 + 4 * k
            ay, ax = u[:, c, None, None], u[:, c + 1, None, None]
            sy, sx = 0.05 + 0.20 * u[:, c + 2, None, None], 0.05 + 0.20 * u[:, c + 3, None, None]
            mask |= (py >= ay) & (py < ay + sy) & (px >= ax) & (px < ax + sx)
        mask &= (u[:, 6] < aug["re_prob"])[:, None, None]
        x = torch.where(mask[..., None], torch.full_like(x, 128.0), x)
    return (x - MEAN) / STD


def cutmix_mixup(images: torch.Tensor, labels: torch.Tensor, d: dict):
    """CutmixMixup of a batch from its draws (apply, use_cutmix, lam_m, lam_c, cy, cx)."""
    _, h, w, _ = images.shape
    flip_x, flip_y = images.flip(0), labels.flip(0)
    if not bool(d["apply"]):
        return images, labels
    if bool(d["use_cutmix"]):
        ratio = math.sqrt(1.0 - float(d["lam_c"]))
        ch, cw = int(ratio * h), int(ratio * w)
        cy, cx = int(d["cy"]), int(d["cx"])
        y0, y1 = min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h)
        x0, x1 = min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w)
        out = images.clone()
        out[:, y0:y1, x0:x1] = flip_x[:, y0:y1, x0:x1]
        lam = 1.0 - (y1 - y0) * (x1 - x0) / (h * w)
        return out, lam * labels + (1.0 - lam) * flip_y
    lam = float(d["lam_m"])
    return lam * images + (1.0 - lam) * flip_x, lam * labels + (1.0 - lam) * flip_y


def smoothed_ce(logits: torch.Tensor, soft: torch.Tensor, smoothing: float) -> torch.Tensor:
    k = logits.shape[-1]
    target = soft * (1.0 - smoothing) + smoothing / k
    return -(target * F.log_softmax(logits.float(), -1)).sum(-1).mean()


def phase_lr(phases: List[dict], step: int, steps_per_epoch: int) -> float:
    """The phase schedule at ``step``: each phase interpolates its lr pair
    (linear or half-cosine) over its epoch span; the last phase begun wins."""
    ep = step / steps_per_epoch
    lr = phases[0]["lr"][0]
    for ph in phases:
        e0, e1 = ph["ep"]
        a, b = ph["lr"]
        t = min(max((ep - e0) / max(e1 - e0, 1e-9), 0.0), 1.0)
        val = b + (a - b) * 0.5 * (1 + math.cos(math.pi * t)) if ph.get("mode") == "cos" else a + (b - a) * t
        if ep >= e0:
            lr = val
    return lr


class Optimizer:
    """SGD (momentum, coupled decay) or AdamW (decoupled decay), per leaf."""

    def __init__(self, kind: str, params: Dict[str, torch.Tensor], decay: Dict[str, float], hp: dict):
        self.kind, self.params, self.decay, self.hp = kind, params, decay, hp
        self.state: Dict[str, dict] = {n: {} for n in params}
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        for n, p in self.params.items():
            g, wd, st = grads[n], self.decay[n], self.state[n]
            if self.kind == "sgd":
                d = g + wd * p
                st["buf"] = d.clone() if "buf" not in st else self.hp["momentum"] * st["buf"] + d
                st["first"] = st.get("first", d)
                p.sub_(lr * st["buf"])
            else:
                b1, b2 = self.hp["betas"]
                p.mul_(1.0 - lr * wd)
                st["m"] = (1 - b1) * g if "m" not in st else b1 * st["m"] + (1 - b1) * g
                st["v"] = (1 - b2) * g * g if "v" not in st else b2 * st["v"] + (1 - b2) * g * g
                st["first"] = st.get("first", g)
                mhat, vhat = st["m"] / (1 - b1 ** self.t), st["v"] / (1 - b2 ** self.t)
                p.sub_(lr * mhat / (vhat.sqrt() + self.hp["eps"]))


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Optional[set] = None) -> tuple:
    """max over leaves of |prog - ref| / max(ref, median ref), with the leaf that gives it."""
    names = [n for n in ref if keep is None or n in keep]
    med = float(np.median([ref[n] for n in names]))
    worst, at = 0.0, None
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at


class _FP8(torch.autograd.Function):
    """x rounded to float8 e4m3 with one per-tensor scale (amax to 448), and
    its gradient rounded the same way on the way back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _BF16(torch.autograd.Function):
    """x rounded to bfloat16, and its gradient the same way on the way back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_quant(x: torch.Tensor) -> torch.Tensor:
    """The configuration's own precision at the same holding points: a
    second witness of what rounding alone does to a number."""
    return _BF16.apply(x)


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: every activation, weight and gradient that
    passes a rounding point held in float8 e4m3, as the program holds them
    in bfloat16."""
    return _FP8.apply(x)
