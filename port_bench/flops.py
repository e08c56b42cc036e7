"""Forward FLOPs of the reference networks, counted on the meta device.

The count is of the benchmark's own plain reference model, so it does not
depend on what implements the step: a convolution or matrix product of
M x N x K counts 2 M N K, as ``torch.utils.flop_counter`` counts them.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def _count(arch: str, image_size: int, kw: tuple) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference import models

    with torch.device("meta"):
        model = models.build(arch, **dict(kw)).eval()
        x = torch.empty(1, image_size, image_size, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x)
    return float(counter.get_total_flops())


def forward_flops(arch: str, image_size: int, kwargs: dict = None) -> float:
    """FLOPs of one image's forward pass at ``image_size``."""
    return _count(arch, int(image_size), tuple(sorted((kwargs or {}).items())))
