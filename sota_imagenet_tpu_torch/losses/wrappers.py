"""Loss wrappers (port of ``sota_imagenet_tpu/losses/wrappers.py``:14-51;
reference utils.py:7-77)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch.losses.base import Loss
from sota_imagenet_tpu_torch.losses.smooth import BinaryKLDivLoss
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.utils.misc import at_least_f32


def _top_k_mean(raw: torch.Tensor, pct: float) -> torch.Tensor:
    """The mean of the largest ``max(int(pct * C), 1)`` values of each row of a
    (B, C) loss (``lax.top_k`` runs over the last axis)."""
    k = max(int(pct * raw.shape[-1]), 1)
    return torch.topk(raw, k, dim=-1).values.mean()


class HardNegativeWrapper(Loss):
    """Per-sample hard-negative mining over a ``reduction='none'`` loss
    (reference utils.py:7-26): the hardest ``hard_pct`` of each sample's
    per-class losses, averaged."""

    def __init__(self, loss: Loss, hard_pct: float = 0.02):
        self.loss = loss
        self.hard_pct = hard_pct

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        return _top_k_mean(self.loss(y_pred, y_true), self.hard_pct)


class FixMatchLoss(Loss):
    """Semi-supervised consistency loss (reference utils.py:55-77): the first
    half of the batch is pulled toward the detached sigmoid of the second
    half's logits (binary KL, per class), plus ``hard_weight`` times the same
    loss against the second half's labels; each takes the top ``hard_pct``
    of the classes of a sample. In float32.

    Over N ranks the batch is this rank's rows [r*b, (r+1)*b) of the global
    one (of each global microbatch under accumulation), and global row i
    still pairs with row i + B/2, which may sit on another rank: the detached
    sigmoids and the labels of the second half cross ranks
    (``parallel.mesh.global_rows``), and each rank sums the top-k values of
    its first-half rows over the global count. That share is scaled by N, so
    the step's mean over the ranks of the gradients and of the loss is the
    global loss's."""

    def __init__(self, hard_weight: float = 0.01, hard_pct: float = 0.01):
        self.criterion = BinaryKLDivLoss(reduction="none")
        self.hard_weight = hard_weight
        self.hard_pct = hard_pct

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        y_pred = at_least_f32(y_pred)
        if y_true.dim() == 1:
            y_true = F.one_hot(y_true.long(), y_pred.shape[-1]).to(torch.float32)
        world = par.data_count()
        if world == 1:
            half = y_pred.shape[0] // 2
            raw_soft = self.criterion(y_pred[:half], torch.sigmoid(y_pred[half:]).detach())
            raw_hard = self.criterion(y_pred[:half], y_true[half:])
            return _top_k_mean(raw_soft, self.hard_pct) + self.hard_weight * _top_k_mean(raw_hard, self.hard_pct)
        b, classes = y_pred.shape
        half, lo = b * world // 2, b * par.data_index()
        first = min(max(half - lo, 0), b)  # this rank's rows of the first half
        targets = torch.cat([torch.sigmoid(y_pred).detach(), y_true.to(y_pred.dtype)], -1)
        soft, hard = par.global_rows(targets, half, 2 * half, "fixmatch")[lo : lo + first].split(classes, -1)
        k = max(int(self.hard_pct * classes), 1)
        top_sum = lambda raw: torch.topk(raw, k, dim=-1).values.sum()
        local = top_sum(self.criterion(y_pred[:first], soft)) + self.hard_weight * top_sum(
            self.criterion(y_pred[:first], hard)
        )
        return local * (world / (half * k))
