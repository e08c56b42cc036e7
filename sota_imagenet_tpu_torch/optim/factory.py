"""Optimizer factory: config dict → ``torch.optim`` optimizer (port of
``sota_imagenet_tpu/optim/factory.py``:86-101,217).

The JAX package builds ``optax.chain(add_decayed_weights(wd, mask),
trace(momentum, nesterov), scale_by_learning_rate(lr))``: decayed weights
are added to the gradient, then the momentum trace b = m·b + g, then -lr·b.
That is ``torch.optim.SGD`` with ``dampening=0``; the weight-decay mask
becomes two parameter groups. The learning rate is set on the groups by the
train step from the phase schedule (train/schedule.py), so the optimizer is
built with lr 0 and the config's ``lr`` is ignored, as in the JAX package.

``adamw`` is optax's chain ``scale_by_adam`` -> masked
``add_decayed_weights`` -> ``scale_by_learning_rate`` (factory.py:104-117):
p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). ``torch.optim.AdamW``
computes p * (1 - lr * wd) - lr * m_hat / (sqrt(v_hat) + eps), the same
value to rounding, with eps outside the square root in both. ``badam`` is
the JAX package's alias for it (its LAMB switch is not ported).

SGD and AdamW are ported; the other optimizers of the JAX package raise
naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch

from sota_imagenet_tpu_torch.registry import NotPortedError

_OPTIM_ALIASES = {
    "torch.optim._multi_tensor.SGD": "sgd",
    "torch.optim.SGD": "sgd",
    "SGD": "sgd",
    "torch.optim.AdamW": "adamw",
    "torch.optim._multi_tensor.AdamW": "adamw",
    "AdamW": "adamw",
    "Adam": "adamw",
    "badam.BAdam": "badam",
    "BAdam": "badam",
    # legacy flat-schema names (the fused_* prefix meant apex multi-tensor variants of the same math)
    "fused_sgd": "sgd",
    "fused_adam": "adamw",
}


def _param_groups(named, weight_decay: float, wd_mask: Optional[Mapping[str, bool]]) -> list:
    """One group, or two where ``wd_mask`` (name -> apply decay) takes some parameters out of the decay."""
    if wd_mask is None:
        return [{"params": [p for _, p in named], "weight_decay": weight_decay}]
    groups = [
        {"params": [p for n, p in named if wd_mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not wd_mask[n]], "weight_decay": 0.0},
    ]
    return [g for g in groups if g["params"]]


def sgd(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    wd_mask: Optional[Mapping[str, bool]] = None,
    **_: Any,
) -> torch.optim.SGD:
    """SGD with coupled L2 decay (grad += wd·param before momentum). ``wd_mask``
    maps parameter name → apply decay; None decays every parameter (BN and
    biases included), as the JAX package does without ``filter_from_wd``."""
    groups = _param_groups(list(named_params), weight_decay, wd_mask)
    return torch.optim.SGD(groups, lr=0.0, momentum=momentum, dampening=0.0, nesterov=nesterov)


def adamw(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    wd_mask: Optional[Mapping[str, bool]] = None,
    **_: Any,
) -> torch.optim.AdamW:
    """Adam with decoupled weight decay; ``wd_mask`` as in ``sgd``."""
    groups = _param_groups(list(named_params), weight_decay, wd_mask)
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=eps)


def badam(named_params, lamb_mode: bool = False, lamb: bool = False, **kw) -> torch.optim.AdamW:
    """bonlime's BAdam: AdamW, with a LAMB trust-ratio switch that is not ported."""
    if lamb or lamb_mode:
        raise NotPortedError("optimizer 'lamb' (badam with lamb=true)", "Queue 1 item 10")
    return adamw(named_params, **kw)


_BUILDERS = {"sgd": sgd, "adamw": adamw, "badam": badam}


def build_optimizer(
    optim_cfg: Dict[str, Any],
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    wd_mask: Optional[Mapping[str, bool]] = None,
) -> torch.optim.Optimizer:
    """Build from a config node like {_target_: sgd, momentum: 0.9, ...}."""
    cfg = dict(optim_cfg)
    target = str(cfg.pop("_target_", "sgd"))
    name = _OPTIM_ALIASES.get(target, target if target in _BUILDERS else target.rsplit(".", 1)[-1].lower())
    if name not in _BUILDERS:
        raise NotPortedError(f"optimizer {target!r}", "Queue 1 item 10", f"ported: {sorted(_BUILDERS)}")
    cfg.pop("lr", None)
    if cfg.pop("lookahead", False):
        raise NotPortedError("optim.lookahead", "Queue 1 item 10")
    for k in ("lookahead_k", "lookahead_alpha"):
        cfg.pop(k, None)
    return _BUILDERS[name](named_params, wd_mask=wd_mask, **cfg)
