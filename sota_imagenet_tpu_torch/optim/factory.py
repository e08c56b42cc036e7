"""Optimizer factory: config dict → ``torch.optim`` optimizer (port of
``sota_imagenet_tpu/optim/factory.py``:86-101,217).

The JAX package builds ``optax.chain(add_decayed_weights(wd, mask),
trace(momentum, nesterov), scale_by_learning_rate(lr))``: decayed weights
are added to the gradient, then the momentum trace b = m·b + g, then -lr·b.
That is ``torch.optim.SGD`` with ``dampening=0``; the weight-decay mask
becomes two parameter groups. The learning rate is set on the groups by the
train step from the phase schedule (train/schedule.py), so the optimizer is
built with lr 0 and the config's ``lr`` is ignored, as in the JAX package.

Only SGD is ported; the other optimizers of the JAX package raise a KeyError
naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch

_OPTIM_ALIASES = {
    "torch.optim._multi_tensor.SGD": "sgd",
    "torch.optim.SGD": "sgd",
    "SGD": "sgd",
    "fused_sgd": "sgd",  # legacy flat-schema name (apex multi-tensor SGD)
}


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
    named = list(named_params)
    if wd_mask is None:
        groups = [{"params": [p for _, p in named], "weight_decay": weight_decay}]
    else:
        groups = [
            {"params": [p for n, p in named if wd_mask[n]], "weight_decay": weight_decay},
            {"params": [p for n, p in named if not wd_mask[n]], "weight_decay": 0.0},
        ]
        groups = [g for g in groups if g["params"]]
    return torch.optim.SGD(groups, lr=0.0, momentum=momentum, dampening=0.0, nesterov=nesterov)


_BUILDERS = {"sgd": sgd}


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
        raise KeyError(
            f"optimizer {target!r} is not ported to sota_imagenet_tpu_torch yet (ROADMAP.md Queue 1 item 10 "
            f"ports the optimizer zoo with its recipe families); ported: {sorted(_BUILDERS)}"
        )
    cfg.pop("lr", None)
    if cfg.pop("lookahead", False):
        raise NotImplementedError("optim.lookahead is not ported yet (ROADMAP.md Queue 1 item 10)")
    for k in ("lookahead_k", "lookahead_alpha"):
        cfg.pop(k, None)
    return _BUILDERS[name](named_params, wd_mask=wd_mask, **cfg)
