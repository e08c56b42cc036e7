"""Component registry: maps string names to Python callables.

The port's copy of ``sota_imagenet_tpu/registry.py``. Configs instantiate
models and criteria by ``_target_`` name (hydra's convention, reference
train.py:64,81,92,143), resolved through this explicit registry — no
``eval()``.

Registered names are case-sensitive. Aliases let configs written against the
reference keep working (e.g. ``pytorch_tools.models.resnet50`` → ``resnet50``).
Every name of the JAX package's registry resolves here; an unknown name
raises ``KeyError``, as there (registry.py:73 of the JAX package).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}
_ALIASES: Dict[str, str] = {}


def register(name: Optional[str] = None, *, aliases: tuple = ()):
    """Decorator: register a callable under ``name`` (defaults to __name__)."""

    def deco(fn: Callable) -> Callable:
        key = name or fn.__name__
        if key in _REGISTRY and _REGISTRY[key] is not fn:
            raise ValueError(f"duplicate registry entry: {key!r}")
        _REGISTRY[key] = fn
        for a in aliases:
            _ALIASES[a] = key
        return fn

    return deco


def resolve(target: str) -> Callable:
    """Resolve a target string to a callable.

    Resolution order:
      1. exact registry name,
      2. alias table,
      3. last dotted component as a registry name.

    Unlike the JAX package's registry there is no import of a
    fully-qualified path: such a path may name a module of the JAX package,
    which the port never imports. Any other name raises ``KeyError``.
    """
    _populate()
    if target in _REGISTRY:
        return _REGISTRY[target]
    if target in _ALIASES:
        return _REGISTRY[_ALIASES[target]]
    tail = target.rsplit(".", 1)[-1]
    if tail in _REGISTRY:
        return _REGISTRY[tail]
    if tail in _ALIASES:
        return _REGISTRY[_ALIASES[tail]]
    raise KeyError(f"unknown target {target!r}; known: {sorted(_REGISTRY)[:20]}...")


_POPULATED = False


def _populate() -> None:
    """Import all modules that register components (idempotent)."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    for mod in (
        "sota_imagenet_tpu_torch.models",
        "sota_imagenet_tpu_torch.losses",
        "sota_imagenet_tpu_torch.train.callbacks",
    ):
        try:
            importlib.import_module(mod)
        except ImportError:
            _POPULATED = False
            raise
