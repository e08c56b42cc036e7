"""BatchNorm (port of the default branch of ``sota_imagenet_tpu/models/norms.py``
``BatchNorm``, norms.py:143-192).

Convention kept from the JAX package (flax ``nn.BatchNorm``): the running
variance EMAs the BIASED batch variance, where ``nn.BatchNorm2d`` EMAs the
unbiased one (factor n/(n-1), n = batch*H*W). Momentum is torch's
(new = (1-m)*old + m*batch, m = cfg.bn_momentum = 0.1). Statistics and the
normalize run in float32 whatever the activation dtype; the output takes the
activation dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm2d over NCHW with flax's biased running variance.

    Train mode normalizes with the batch statistics (one ``native_batch_norm``
    pass, which also returns the batch mean and inverse std) and updates the
    running buffers in place from those; eval mode normalizes with the
    running buffers. Parameter and buffer names follow ``nn.BatchNorm2d``
    (weight, bias, running_mean, running_var), without num_batches_tracked."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator  # deterministic init (ones / zeros)
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps).to(dt)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = (invstd.float().pow(-2) - self.eps).clamp_(min=0.0)  # biased batch variance
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.float(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return y.to(dt)
