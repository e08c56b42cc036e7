"""Loss base class with arithmetic (port of ``sota_imagenet_tpu/losses/base.py``
:13-69; pytorch_tools.losses.Loss equivalent).

The reference's auxiliary-loss callbacks rebuild the criterion as
``criterion + aux_loss * weight`` (reference callbacks.py:200-203); ``+`` and
``*`` on loss objects keep that pattern.
"""

from __future__ import annotations

import torch


class Loss:
    def __call__(self, *args, **kwargs) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def __add__(self, other: "Loss") -> "Loss":
        return SumLoss(self, other)

    def __mul__(self, w: float) -> "Loss":
        return WeightedLoss(self, w)

    __rmul__ = __mul__


class SumLoss(Loss):
    def __init__(self, a: Loss, b: Loss):
        self.a, self.b = a, b

    def __call__(self, *args, **kwargs):
        return self.a(*args, **kwargs) + self.b(*args, **kwargs)


class WeightedLoss(Loss):
    def __init__(self, loss: Loss, weight: float):
        self.loss, self.weight = loss, weight

    def __call__(self, *args, **kwargs):
        return self.loss(*args, **kwargs) * self.weight


class StatefulLoss(Loss):
    """A loss with running statistics (AdaCos's running B, median cosine and
    scale). The state is a dict of device tensors that the train step
    threads through its microbatches (``TrainState.loss_state``): a call
    returns the loss and the new state and changes nothing in place."""

    def init_state(self, device=None):
        return {}

    def __call__(self, logits, target, state=None):  # -> (loss, new_state)
        raise NotImplementedError


def call_criterion(criterion, logits, target, state=None):
    """Uniform invocation for stateful and stateless losses."""
    if isinstance(criterion, StatefulLoss):
        return criterion(logits, target, state)
    return criterion(logits, target), state


class FnLoss(Loss):
    """Wrap a plain callable as a Loss."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)
