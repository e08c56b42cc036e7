"""``debug_nans``: stop at the first NaN (the counterpart of JAX's
``jax_debug_nans``, which the JAX CLI turns on, cli.py:123-124).

Three places are watched, and each raises ``FloatingPointError``:

  * a forward: a hook on every module checks its floating outputs and names
    the first module whose output holds a NaN (hooks run innermost first, so
    that is the module that made it);
  * a backward: ``torch.autograd.set_detect_anomaly(True)`` checks every
    backward function's outputs, and its error is raised again as a
    FloatingPointError naming that function;
  * the step's new parameters.

An inf alone raises nothing, as with ``jax_debug_nans``. Nothing here
changes a value: a run that meets no NaN computes what it computes without
the guard. Each check reads the device, so the guard is for debugging.
"""

from __future__ import annotations

from typing import Callable, List

import torch
from torch.utils._pytree import tree_leaves


def _has_nan(tensors) -> bool:
    flags = [torch.isnan(t).any() for t in tensors if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return bool(torch.stack(flags).any()) if flags else False


def watch_forward(model: torch.nn.Module) -> List[torch.utils.hooks.RemovableHandle]:
    """A forward hook on every module of ``model`` that raises on a NaN output; the hooks' handles."""

    def hook_for(name: str):
        def hook(module, args, output):
            if _has_nan(tree_leaves(output)):
                raise FloatingPointError(
                    f"debug_nans: NaN in the forward output of {name or 'the model'} ({type(module).__name__})"
                )

        return hook

    return [m.register_forward_hook(hook_for(n)) for n, m in model.named_modules()]


def check_step(train_step: Callable) -> Callable:
    """``train_step`` with its backward under anomaly detection and its new parameters checked."""

    def step(state, batch):
        try:
            with torch.autograd.set_detect_anomaly(True):
                state, metrics = train_step(state, batch)
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(f"debug_nans: NaN in the backward: {e}") from e
        named = list(state.model.named_parameters())
        if _has_nan([p for _, p in named]):
            bad = [n for n, p in named if bool(torch.isnan(p).any())]
            raise FloatingPointError(f"debug_nans: NaN in the new parameters of step {state.step}: {bad[:8]}")
        return state, metrics

    return step
