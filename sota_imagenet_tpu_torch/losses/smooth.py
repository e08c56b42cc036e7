"""Classification losses (port of ``sota_imagenet_tpu/losses/smooth.py``:22-187;
pytorch_tools.losses equivalents).

The default criterion is cross-entropy with label smoothing over one-hot
device labels (reference arg_parser.py:140-142 + dali one_hot,
dali_dataloader.py:123). Targets may be integer class ids, one-hot, or soft
distributions. Every loss runs in float32 whatever the logits' dtype
(float64 for float64 logits).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch.losses.base import Loss
from sota_imagenet_tpu_torch.parallel.mesh import data_count
from sota_imagenet_tpu_torch.utils.misc import at_least_f32


def _as_soft_targets(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    if target.dim() == 1 or target.shape[-1] != num_classes:
        return F.one_hot(target.long(), num_classes).to(torch.float32)
    return at_least_f32(target)


def _smooth(soft: torch.Tensor, smoothing: float, num_classes: int) -> torch.Tensor:
    return soft * (1.0 - smoothing) + smoothing / num_classes if smoothing > 0 else soft


class CrossEntropyLoss(Loss):
    """CE with label smoothing + optional temperature
    (pytorch_tools.losses.smooth.CrossEntropyLoss). ``normalize``
    L2-normalizes each logit vector before the (tempered) softmax."""

    def __init__(
        self,
        smoothing: float = 0.0,
        temperature: Optional[float] = None,
        normalize: bool = False,
        reduction: str = "mean",
    ):
        self.smoothing = smoothing
        self.temperature = temperature
        self.normalize = normalize
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = at_least_f32(logits)
        if self.normalize:
            logits = logits / torch.clamp(torch.linalg.vector_norm(logits, dim=-1, keepdim=True), min=1e-12)
        if self.temperature is not None:
            logits = logits / self.temperature
        num_classes = logits.shape[-1]
        soft = _smooth(_as_soft_targets(target, num_classes), self.smoothing, num_classes)
        logp = F.log_softmax(logits, dim=-1)
        per_sample = -torch.sum(soft * logp, dim=-1)
        return _reduce(per_sample, self.reduction)


class FocalLoss(Loss):
    """Multiclass focal loss over soft targets (pytorch_tools.losses.FocalLoss):
    -sum(t * alpha * (1 - p)^gamma * log p) per sample."""

    def __init__(self, gamma: float = 2.0, alpha: Optional[float] = None, reduction: str = "mean"):
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = at_least_f32(logits)
        soft = _as_soft_targets(target, logits.shape[-1])
        logp = F.log_softmax(logits, dim=-1)
        focal = (1.0 - torch.exp(logp)) ** self.gamma * logp
        if self.alpha is not None:
            focal = self.alpha * focal
        per_sample = -torch.sum(soft * focal, dim=-1)
        return _reduce(per_sample, self.reduction)


class BinaryFocalLoss(Loss):
    """Sigmoid (binary, per-class) focal loss over one-hot targets, the legacy
    ``criterion: focal`` / ``a-focal``. ``alpha`` < 0 disables the alpha
    weighting (else positives weigh ``alpha``, negatives ``1 - alpha``);
    ``combine_thr`` > 0 is the Reduced Focal Loss (arXiv:1903.01347): plain
    BCE while p_t < thr, the factor ``((1 - p_t) / (1 - thr))^gamma`` above;
    ``temperature`` divides the logits first."""

    def __init__(
        self,
        gamma: float = 2.0,
        alpha: float = -1.0,
        combine_thr: float = 0.0,
        temperature: Optional[float] = None,
        smoothing: float = 0.0,
        reduction: str = "mean",
    ):
        self.gamma = gamma
        self.alpha = alpha
        self.combine_thr = combine_thr
        self.temperature = temperature
        self.smoothing = smoothing
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = at_least_f32(logits)
        if self.temperature is not None:
            logits = logits / self.temperature
        t = _smooth(_as_soft_targets(target, logits.shape[-1]), self.smoothing, logits.shape[-1])
        bce = -(t * F.logsigmoid(logits) + (1 - t) * F.logsigmoid(-logits))
        p = torch.sigmoid(logits)
        p_t = p * t + (1 - p) * (1 - t)
        if self.combine_thr > 0:
            scaled = ((1.0 - p_t) / (1.0 - self.combine_thr)) ** self.gamma
            focal = torch.where(p_t < self.combine_thr, torch.ones_like(scaled), scaled)
        else:
            focal = (1.0 - p_t) ** self.gamma
        loss = focal * bce
        if self.alpha >= 0:
            loss = (self.alpha * t + (1 - self.alpha) * (1 - t)) * loss
        return _reduce(torch.sum(loss, dim=-1), self.reduction)


class BinaryKLDivLoss(Loss):
    """Per-class binary KL divergence between sigmoid(logits) and soft targets,
    both clipped to [eps, 1 - eps] (pytorch_tools.losses.BinaryKLDivLoss; the
    loss of FixMatchLoss). ``smoothing`` smooths one-hot targets first. With
    ``reduction='none'`` it keeps the (batch, classes) matrix, which the
    hard-negative wrappers take the top-k of."""

    def __init__(self, reduction: str = "mean", eps: float = 1e-7, smoothing: float = 0.0):
        self.reduction = reduction
        self.eps = eps
        self.smoothing = smoothing

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = at_least_f32(logits)
        t = _smooth(_as_soft_targets(target, logits.shape[-1]), self.smoothing, logits.shape[-1])
        t = torch.clamp(at_least_f32(t), self.eps, 1.0 - self.eps)
        p = torch.clamp(torch.sigmoid(logits), self.eps, 1.0 - self.eps)
        kl = t * torch.log(t / p) + (1.0 - t) * torch.log((1.0 - t) / (1.0 - p))
        return _reduce(kl, self.reduction)


class SigmoidLoss(Loss):
    """Binary CE over one-hot targets, summed over the classes of a sample
    (the 'sigmoid' criterion of BResNet50_encoder.yaml:41)."""

    def __init__(self, smoothing: float = 0.0, reduction: str = "mean"):
        self.smoothing = smoothing
        self.reduction = reduction

    def __call__(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        logits = at_least_f32(logits)
        soft = _smooth(_as_soft_targets(target, logits.shape[-1]), self.smoothing, logits.shape[-1])
        per_class = -(soft * F.logsigmoid(logits) + (1 - soft) * F.logsigmoid(-logits))
        return _reduce(torch.sum(per_class, dim=-1), self.reduction)


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        # the global batch's sum: N ranks average their losses and gradients, so each returns N times its share
        return x.sum() * data_count()
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")
