"""Small utilities (port of parts of ``sota_imagenet_tpu/utils/misc.py``;
pytorch_tools.utils.misc equivalents used by the reference at train.py:56,84,96)."""

from __future__ import annotations

import os
import random
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: None
    means this rank's card, ``cuda:{LOCAL_RANK % device_count}`` (ranks past
    the cards share them), and a CUDA device without a GPU present raises."""
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())
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


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 if it is float64 (the JAX ``at_least_f32``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of a float32 ``x``, as
    XLA's ``jnp.sqrt``.

    PyTorch's CPU kernels of ``sqrt`` (and ``_foreach_sqrt``, ``rsqrt``,
    ``pow(0.5)``) do not round every result correctly on every host: on
    some x86 CPUs many float32 values come out one ulp off. A
    float32 tensor on the CPU therefore takes its root in float64 and is
    rounded once to float32. That is the correctly rounded float32 root even
    where the float64 root is itself one float64 ulp off, as it can be on
    such a host: the exact root of a float32 lies at least
    2^-50 (relative) from a float32 rounding boundary, and a float64 ulp is
    2^-52. Every other tensor takes ``torch.sqrt``: a float64 root's
    one-ulp faults (1e-16 relative) are below every tolerance that holds a
    float64 run, and CUDA's float32 ``sqrt`` rounds to nearest (nvcc's
    default ``-prec-sqrt=true``), so the card computes the same number
    without the detour and this helper does not route it."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return x.double().sqrt().float()
    return torch.sqrt(x)


def foreach_sqrt_(tensors) -> None:
    """``torch._foreach_sqrt_`` with the rounding of ``sqrt`` above: in place,
    float32 CPU tensors through float64, the rest through the multi-tensor
    kernel."""
    fix = [t for t in tensors if t.dtype == torch.float32 and t.device.type == "cpu"]
    rest = [t for t in tensors if not (t.dtype == torch.float32 and t.device.type == "cpu")]
    for t in fix:
        t.copy_(sqrt(t))
    if rest:
        torch._foreach_sqrt_(rest)
