"""Small utilities (port of parts of ``sota_imagenet_tpu/utils/misc.py``;
pytorch_tools.utils.misc equivalents used by the reference at train.py:56,84,96)."""

from __future__ import annotations

import random
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: None
    means ``cuda``, and a CUDA device without a GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def process_index() -> int:
    """This process's rank among the processes that share a run (for
    ``jax.process_index()``): the ``torch.distributed`` rank when a process
    group is up, else 0. Loaders shard their files by it."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def process_count() -> int:
    """How many processes share a run (for ``jax.process_count()``): the
    ``torch.distributed`` world size when a process group is up, else 1."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs (reference pt.utils.misc.set_random_seed,
    train.py:56). Model init and augment draws use explicit generators."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def count_parameters(model: torch.nn.Module) -> int:
    """Total number of trainable scalars (reference train.py:96 logs it in millions)."""
    return sum(p.numel() for p in model.parameters())


def filter_from_weight_decay(named_params: Iterable[Tuple[str, torch.Tensor]], skip_list: Sequence[str]) -> Dict[str, bool]:
    """Mask name → apply weight decay (misc.py:139). A parameter is excluded
    if it has ndim <= 1 (biases, norm scales) or its name contains any of
    ``skip_list`` (case-insensitive). Names are the port's torchvision-style
    names (``layer1.0.conv1.weight``), where the JAX package matches flax
    paths; the ndim rule, which decides every ResNet parameter, is the same."""
    skip = [s.lower() for s in skip_list]
    return {n: not (p.dim() <= 1 or any(s in n.lower() for s in skip)) for n, p in named_params}
