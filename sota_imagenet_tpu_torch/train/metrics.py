"""Classification metrics (port of ``sota_imagenet_tpu/train/metrics.py``:12-32;
pt.metrics.Accuracy equivalent, reference train.py:130). They return device
tensors; the Runner reduces them once per epoch."""

from __future__ import annotations

from typing import Dict

import torch


def accuracy_topk(logits: torch.Tensor, target: torch.Tensor, k: int = 1, mean: bool = True) -> torch.Tensor:
    """Percentage of samples whose target class is in the top-k logits.
    Soft/mixed targets reduce via argmax. mean=False returns the per-sample
    0/100 vector."""
    labels = target if target.dim() == 1 else torch.argmax(target, dim=-1)
    k = min(k, logits.shape[-1])  # Acc@5 on <5-class toy problems
    if k == 1:
        hit = torch.argmax(logits, dim=-1) == labels
    else:
        topk = torch.topk(logits, k, dim=-1).indices
        hit = (topk == labels[:, None]).any(dim=-1)
    per_sample = hit.to(torch.float32) * 100.0
    return per_sample.mean() if mean else per_sample


def classification_metrics(logits: torch.Tensor, target: torch.Tensor, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "loss": loss.detach().to(torch.float32),
        "Acc@1": accuracy_topk(logits, target, 1),
        "Acc@5": accuracy_topk(logits, target, 5),
    }
