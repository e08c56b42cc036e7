"""Metric-learning losses and sphere-normalized heads (port of
``sota_imagenet_tpu/losses/angular.py``; reference angular_losses.py).

The model ends with a sphere-normalized head (``SphereLinearLayer``,
``SphereMLPLayer``) whose outputs are cosines, and the criterion works on
those cosines (AdaCos, the margin losses, the auxiliary sphere losses).
AdaCos's running B, median cosine and scale are an explicit state: a dict
of float32 0-d device tensors that the train step threads through its
microbatches (``TrainState.loss_state``), never updated in place.

Every loss computes in float32 (float64 for float64 inputs), with the
reference's clamps (angular_losses.py:81,328). Their reductions over the
batch are over the global batch where ranks share it (``parallel/mesh.py``):
the sphere head's BatchNorm, AdaCos's B and median, the masked means of the
auxiliary losses. The heads take their
cosines in float32 whatever the activation dtype, as the JAX heads'
``preferred_element_type=float32`` products: a float64 head computes its
product in float64 and rounds it to float32, as XLA does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sota_imagenet_tpu_torch.losses.base import Loss, StatefulLoss
from sota_imagenet_tpu_torch.losses.smooth import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.layers import Linear
from sota_imagenet_tpu_torch.parallel.mesh import all_reduce_, data_count, gather_rows, global_mean
from sota_imagenet_tpu_torch.utils.misc import at_least_f32, sqrt

EPS = 1e-7


def _to_onehot_and_idx(target: torch.Tensor, num_classes: int):
    if target.dim() == 1:
        idx = target.long()
        return F.one_hot(idx, num_classes).to(torch.float32), idx
    onehot = at_least_f32(target)
    return onehot, onehot.argmax(dim=-1)


def _true(cosine: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each row's value at its class."""
    return cosine.gather(1, idx[:, None])[:, 0]


def _l2norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp(sqrt(x.square().sum(dim=dim, keepdim=True)), min=1e-12)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a vector: for an even count the mean of the two middle
    values, as (lo + hi) * 0.5 (``torch.median`` would return the lower)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


# --------------------------------------------------------------------------- #
# Heads (model-side modules)
# --------------------------------------------------------------------------- #


def _cosines(feat: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos(features, class weights): both l2-normalized (the weight over its
    embedding axis, 0), the product in their promoted dtype, rounded to float32."""
    xf = _l2norm(at_least_f32(feat))
    wf = _l2norm(weight, dim=0)
    dt = torch.promote_types(xf.dtype, wf.dtype)
    return (xf.to(dt) @ wf.to(dt)).to(torch.float32)


class _SphereWeight(nn.Module):
    """The class weights of a sphere head, flax's layout (embedding, classes),
    float32, xavier-uniform."""

    def __init__(self, embedding_size: int, num_classes: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embedding_size, num_classes))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        fan_in, fan_out = self.weight.shape
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        nn.init.uniform_(self.weight, -limit, limit, generator=generator)


class SphereLinearLayer(_SphereWeight):
    """Linear layer on the unit hyper-sphere (reference angular_losses.py:202-214):
    (B, embedding) features -> (B, classes) float32 cosines."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _cosines(x, self.weight)


class FlaxBatchNorm(nn.Module):
    """flax's own ``nn.BatchNorm`` over the last axis of (B, C) features, not
    the repo's: momentum 0.99 in flax's convention (running = 0.99 running +
    0.01 batch), eps 1e-5, var = max(E[x^2] - E[x]^2, 0) (biased, into the
    running variance too), statistics in at least float32, normalize as
    (x - mean) * (rsqrt(var + eps) * scale) + bias. Its momentum is fixed:
    the config's ``bn_momentum`` does not reach it."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator  # ones / zeros
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = at_least_f32(x)
            mean = global_mean(xf, 0)
            var = (global_mean(xf * xf, 0) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        mul = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        return (x.to(dt) - mean.to(dt)) * mul + self.bias.to(dt)


class SphereMLPLayer(_SphereWeight):
    """A SimCLR-style projector, then the sphere head (reference
    angular_losses.py:217-245): in training (or with ``val_projector``)
    fc1 (no bias) -> FlaxBatchNorm -> act (relu, else hard_silu) -> fc2 (bias)
    -> cosines; in eval the cosines of the features themselves. The
    projector computes in the promotion of the features' dtype and float32."""

    def __init__(self, embedding_size: int, num_classes: int, hidden_size: int = 4096, act: str = "relu",
                 val_projector: bool = False):
        super().__init__(embedding_size, num_classes)
        self.act = F.relu if act == "relu" else F.hardswish
        self.val_projector = val_projector
        self.fc1 = Linear(embedding_size, hidden_size, std=None, use_bias=False)
        self.bn = FlaxBatchNorm(hidden_size)
        self.fc2 = Linear(hidden_size, embedding_size, std=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.fc2(self.act(self.bn(self.fc1(x)))) if self.training or self.val_projector else x
        return _cosines(feat, self.weight)


# --------------------------------------------------------------------------- #
# Margin criteria on cosine logits
# --------------------------------------------------------------------------- #


class AdditiveAngularMarginLoss(Loss):
    """ArcFace margin on cosine logits (reference angular_losses.py:98-146)."""

    def __init__(self, final_criterion: Optional[Loss] = None, s: float = 10.0, m: float = 0.2):
        self.s, self.m = s, m
        self.cos_m, self.sin_m = math.cos(m), math.sin(m)
        self.th = math.cos(math.pi - m)
        self.mm = math.sin(math.pi - m) * m
        self.final_criterion = final_criterion or CrossEntropyLoss()

    def __call__(self, cosine: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        cosine = at_least_f32(cosine)
        onehot, _ = _to_onehot_and_idx(y_true, cosine.shape[-1])
        sine = sqrt(torch.clamp(1.0 - cosine**2, min=0.0))
        phi = cosine * self.cos_m - sine * self.sin_m
        phi = torch.where(cosine > self.th, phi, cosine - self.mm)
        output = (onehot * phi + (1.0 - onehot) * cosine) * self.s
        return self.final_criterion(output, y_true)


class LargeMarginCosineLoss(Loss):
    """CosFace margin on cosine logits (reference angular_losses.py:149-199)."""

    def __init__(self, final_criterion: Optional[Loss] = None, s: float = 30.0, m: float = 0.40):
        self.s, self.m = s, m
        self.final_criterion = final_criterion or CrossEntropyLoss()

    def __call__(self, cosine: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        cosine = at_least_f32(cosine)
        onehot, _ = _to_onehot_and_idx(y_true, cosine.shape[-1])
        output = (onehot * (cosine - self.m) + (1.0 - onehot) * cosine) * self.s
        return self.final_criterion(output, y_true)


class AngularPenaltySMLoss(Loss):
    """The arcface / sphereface / cosface margin softmax on cosine logits
    (reference angular_losses.py:13-95)."""

    _default_values = {"arcface": (64.0, 0.5), "sphereface": (64.0, 1.35), "cosface": (30.0, 0.4)}

    def __init__(self, loss_type: str = "arcface", s: Optional[float] = None, m: Optional[float] = None, **_):
        if loss_type not in self._default_values:
            raise ValueError(f"loss_type must be one of {sorted(self._default_values)}")
        ds, dm = self._default_values[loss_type]
        self.s, self.m = s or ds, m or dm
        self.loss_type = loss_type

    def __call__(self, cosine: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        wf = at_least_f32(cosine)
        onehot, idx = _to_onehot_and_idx(y_true, wf.shape[-1])
        true_cos = _true(wf, idx)
        tc = torch.clamp(true_cos, -1.0 + EPS, 1.0 - EPS)
        if self.loss_type == "cosface":
            numerator = self.s * (true_cos - self.m)
        elif self.loss_type == "arcface":
            numerator = self.s * torch.cos(torch.arccos(tc) + self.m)
        else:  # sphereface
            numerator = self.s * torch.cos(self.m * torch.arccos(tc))
        # exp(num) + the sum over the other classes of exp(s * cos)
        denom = torch.exp(numerator) + torch.sum(torch.exp(self.s * wf) * (1.0 - onehot), dim=1)
        return -torch.mean(numerator - torch.log(denom))


class AdaCos(StatefulLoss):
    """AdaCos with a running-median adaptive scale and an optional margin
    (reference angular_losses.py:248-334). Per call, from the state (B,
    median cosine, s) and a batch of cosines:

        B_batch = sum over the non-target cosines of exp(cos * s) / batch
        B = momentum B + (1 - momentum) B_batch
        cos_med = momentum cos_med + (1 - momentum) median(target cosines)
        s = min(log B / (max(cos_med, 0.7) - margin), max_s)

    and the loss is ``final_criterion`` of the (margin) logits times the new
    s (``fixed_s`` if given), the scale held out of the gradient. The new
    state is returned, detached; nothing reads it on the host."""

    def __init__(
        self,
        final_criterion: Optional[Loss] = None,
        margin: float = 0.0,
        max_s: float = 20.0,
        fixed_s: Optional[float] = None,
        momentum: float = 0.95,
        arc_logits: bool = False,
        arc_margin: bool = False,
    ):
        if arc_logits and not arc_margin:
            raise ValueError("arc_logits=True requires arc_margin=True")
        self.final_criterion = final_criterion or CrossEntropyLoss()
        self.margin = margin
        self.max_s = max_s
        self.fixed_s = fixed_s
        self.momentum = momentum
        self.arc_logits = arc_logits
        self.arc_margin = arc_margin

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "running_B": torch.tensor(1000.0, **f32),  # initial s ~ 10
            "running_cos": torch.tensor(0.7, **f32),  # ~ cos(pi / 4)
            "prev_s": torch.tensor(float(np.float32(self.max_s)), **f32),
        }

    def __call__(self, cosine: torch.Tensor, y_true: torch.Tensor, state=None):
        state = state if state is not None else self.init_state(cosine.device)
        cosine = at_least_f32(cosine)
        onehot, idx = _to_onehot_and_idx(y_true, cosine.shape[-1])
        neg_mask = onehot == 0
        with torch.no_grad():
            # over the global batch: the ranks' sums, and the median of every rank's target cosines
            b_sum = all_reduce_(torch.where(neg_mask, torch.exp(cosine * state["prev_s"]), 0.0).sum(), "loss")
            b_batch = b_sum / (cosine.shape[0] * data_count())
            med_cos = _median(gather_rows(_true(cosine, idx), "loss"))
            running_b = state["running_B"] * self.momentum + b_batch * (1 - self.momentum)
            running_cos = state["running_cos"] * self.momentum + med_cos * (1 - self.momentum)
            prev_s = torch.log(running_b) / (torch.clamp(running_cos, min=0.7) - self.margin)
            prev_s = torch.clamp(prev_s, max=self.max_s)  # blows up early without the cap
        new_state = {"running_B": running_b, "running_cos": running_cos, "prev_s": prev_s}
        if self.arc_logits:
            theta = torch.arccos(torch.clamp(cosine, -1.0 + EPS, 1.0 - EPS))
            logits = -torch.where(neg_mask, theta, theta + self.margin)
        else:
            logits = torch.where(neg_mask, cosine, cosine - self.margin)
        scale = self.fixed_s if self.fixed_s is not None else prev_s
        return self.final_criterion(logits * scale, onehot), new_state


# --------------------------------------------------------------------------- #
# Auxiliary sphere losses
# --------------------------------------------------------------------------- #


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The mean of ``values`` where ``mask`` over the global batch; 0 where
    the mask is empty. Over N ranks each returns N times its share of the
    sum over the global count, so the mean of the ranks' losses, and of
    their gradients, is the global one."""
    cnt = all_reduce_(mask.sum(), "loss")
    mean = torch.where(mask, values, 0.0).sum() * data_count() / torch.clamp(cnt, min=1)
    return torch.where(cnt > 0, mean, torch.zeros_like(mean))


class SphereMAELoss(Loss):
    """Mean angle to the true class over the samples above ``threshold``
    (reference angular_losses.py:418-439)."""

    def __init__(self, threshold: float = 0.2):
        self.threshold = threshold

    def __call__(self, cosine, y_true):
        cosine = at_least_f32(cosine)
        _, idx = _to_onehot_and_idx(y_true, cosine.shape[-1])
        theta = torch.arccos(torch.clamp(_true(cosine, idx), -1 + EPS, 1 - EPS))
        return _masked_mean(theta, theta > self.threshold)


class SphereCosMAELoss(Loss):
    """The cosine-space variant (reference angular_losses.py:442-464)."""

    def __init__(self, threshold: float = 0.98):
        self.threshold = threshold

    def __call__(self, cosine, y_true):
        cosine = at_least_f32(cosine)
        _, idx = _to_onehot_and_idx(y_true, cosine.shape[-1])
        tc = _true(cosine, idx)
        mask = tc < self.threshold
        cnt = all_reduce_(mask.sum(), "loss")  # over the global batch, as _masked_mean
        loss = 1.0 - torch.where(mask, tc, 0.0).sum() * data_count() / torch.clamp(cnt, min=1)
        return torch.where(cnt > 0, loss, torch.zeros_like(loss))


def _inter(cosine: torch.Tensor, onehot: torch.Tensor, eta: float) -> torch.Tensor:
    """NegativeContrastive's term: log1p of the sum over the negatives of exp(cos * s), averaged."""
    s = float(np.log(eta / (1 - eta))) + torch.log(torch.tensor(cosine.shape[1], dtype=torch.float32,
                                                                device=cosine.device))
    neg = torch.where(onehot == 0, cosine, -1.0)
    return torch.mean(torch.log1p(torch.sum(torch.exp(neg * s), dim=-1)))


def _intra(tc: torch.Tensor, threshold: float) -> torch.Tensor:
    """D-Softmax's term: log1p(exp((threshold - true cos) * 16)), averaged."""
    return torch.mean(torch.log1p(torch.exp((threshold - tc) * 16.0)))


class NegativeContrastive(Loss):
    """Spreads the negative classes (reference angular_losses.py:467-484)."""

    def __init__(self, eta: float = 0.999):
        self.eta = eta

    def __call__(self, cosine, y_true):
        cosine = at_least_f32(cosine)
        onehot, _ = _to_onehot_and_idx(y_true, cosine.shape[-1])
        return _inter(cosine, onehot, self.eta)


class DSoftmax_intra(Loss):
    """Pulls the true-class cosine toward a threshold (reference angular_losses.py:487-511)."""

    def __init__(self, threshold: float = 0.90):
        self.threshold = threshold

    def __call__(self, cosine, y_true):
        cosine = at_least_f32(cosine)
        _, idx = _to_onehot_and_idx(y_true, cosine.shape[-1])
        return _intra(_true(cosine, idx), self.threshold)


class MyLoss1(Loss):
    """D-Softmax's intra term plus NegativeContrastive's inter term, weighted
    (reference angular_losses.py:514-569)."""

    def __init__(self, w_intra: float = 1.0, w_inter: float = 1.0, intra_threshold: float = 0.9, eta: float = 0.999):
        self.w_intra, self.w_inter = w_intra, w_inter
        self.intra_threshold = intra_threshold
        self.eta = eta

    def __call__(self, cosine, y_true):
        cosine = at_least_f32(cosine)
        onehot, idx = _to_onehot_and_idx(y_true, cosine.shape[-1])
        l_inter = _inter(cosine, onehot, self.eta)
        l_intra = _intra(_true(cosine, idx), self.intra_threshold)
        return l_intra * self.w_intra + l_inter * self.w_inter


class ArcCosSoftmax(CrossEntropyLoss):
    """CE over the negative angles (reference angular_losses.py:572-576)."""

    def __call__(self, y_pred, y_true):
        return super().__call__(-torch.arccos(torch.clamp(at_least_f32(y_pred), -1 + EPS, 1 - EPS)), y_true)


class ArcCosSoftmaxCenter(CrossEntropyLoss):
    """ArcCos CE plus ``center_weight`` times the mean squared true-class angle
    (reference angular_losses.py:601-616)."""

    def __init__(self, *args, center_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.center_weight = center_weight

    def __call__(self, y_pred, y_true):
        theta = torch.arccos(torch.clamp(at_least_f32(y_pred), -1 + EPS, 1 - EPS))
        cce = super().__call__(-theta, y_true)
        _, idx = _to_onehot_and_idx(y_true, y_pred.shape[-1])
        center = torch.mean(theta.gather(1, idx[:, None]) ** 2)
        return cce + self.center_weight * center
