"""Weight transforms (port of ``sota_imagenet_tpu/models/parametrize.py``:
``backward_weight_norm`` :172-187). The forward parametrizations (weight
standardization, spectral norm) are not ported yet: ROADMAP.md Queue 1
items 9 and 10d."""

from __future__ import annotations

import torch

from sota_imagenet_tpu_torch.utils.weights import kernel_parameters


@torch.no_grad()
def backward_weight_norm(model: torch.nn.Module) -> None:
    """Backward centered weight normalization, applied to the parameters after
    each optimizer step (reference WeightNorm callback, callbacks.py:104-123):
    each output filter of every kernel with at least 64 elements gets zero
    mean and unit L2 norm, computed in float32 and cast back. A filter is a
    row of the port's (O, ...) kernel, a column of the JAX (..., O) one."""
    for w in kernel_parameters(model).values():
        if w.dim() < 2 or w.numel() < 64:
            continue
        mat = w.reshape(w.shape[0], -1).float()
        mat = mat - mat.mean(dim=1, keepdim=True)
        mat = mat / torch.linalg.vector_norm(mat, dim=1, keepdim=True).clamp(min=1e-12)
        w.copy_(mat.reshape(w.shape))
