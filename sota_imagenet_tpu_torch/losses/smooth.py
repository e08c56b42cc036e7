"""Cross-entropy with label smoothing (port of ``sota_imagenet_tpu/losses/smooth.py``
:22-61,180).

The default criterion is cross-entropy with label smoothing over one-hot
device labels (reference arg_parser.py:140-142 + dali one_hot,
dali_dataloader.py:123). Targets may be integer class ids, one-hot, or soft
distributions. The loss runs in float32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch.losses.base import Loss


def _as_soft_targets(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    if target.dim() == 1 or target.shape[-1] != num_classes:
        return F.one_hot(target.long(), num_classes).to(torch.float32)
    return target.to(torch.promote_types(target.dtype, torch.float32))


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
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        if self.normalize:
            logits = logits / torch.clamp(torch.linalg.vector_norm(logits, dim=-1, keepdim=True), min=1e-12)
        if self.temperature is not None:
            logits = logits / self.temperature
        num_classes = logits.shape[-1]
        soft = _as_soft_targets(target, num_classes)
        if self.smoothing > 0:
            soft = soft * (1.0 - self.smoothing) + self.smoothing / num_classes
        logp = F.log_softmax(logits, dim=-1)
        per_sample = -torch.sum(soft * logp, dim=-1)
        return _reduce(per_sample, self.reduction)


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction {reduction!r}")
