"""Training state (port of ``sota_imagenet_tpu/train/state.py``:13).

The JAX TrainState is an immutable pytree of arrays. Here the same fields
are held by PyTorch objects updated in place: ``model`` carries the params
and the BN running buffers (``batch_stats``), ``optimizer`` the momentum
buffers (``opt_state``), ``ema`` a copy of the model whose params and
buffers are the EMA (``ema_params`` / ``ema_batch_stats``). ``step`` is the
global optimizer step, a host int (the lr schedule reads it on the host).
``generator`` is the device generator of the step's random draws (mixup,
dropout, drop-path); each step seeds it from ``seed`` and ``step``, so
neither needs to be in a checkpoint beyond the step. ``loss_state`` holds
the running statistics of a stateful criterion (AdaCos), a dict of device
tensors that each train step replaces (None for a stateless one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[torch.nn.Module] = None
    generator: Optional[torch.Generator] = None
    seed: int = 0
    loss_state: Optional[Dict[str, torch.Tensor]] = None
