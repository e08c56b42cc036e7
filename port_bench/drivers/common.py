"""Pieces both drivers take from the code under test, built the way the
port's CLI builds them, and the benchmark's own seeded images."""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np

from port_bench import harness


def load_config(config_name: str, overrides: List[str] = ()):
    """The configuration file's resolved config over the port's schema
    defaults, with test overrides on top."""
    from sota_imagenet_tpu_torch import config as C

    spec = harness.load_json("configs", config_name)
    cfg = C.merge(C.load(None, strict_env=False), spec["config"])
    if overrides:
        cfg = C.apply_overrides(cfg, list(overrides))
    return cfg, spec


def backend_flags(torch, device) -> None:
    """The CLI's flags on a card: float32 in full float32, cuDNN's autotuner on."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True


def reference_shapes(arch: str, **kw) -> Dict[str, tuple]:
    import torch

    from port_bench.reference import models

    with torch.device("meta"):
        m = models.build(arch, **kw)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


class SeededImages:
    """``n_images`` distinct uint8 (H, W, 3) crops and their labels, made on
    ``device`` from the seed a batch at a time (batch j from its own stream,
    so any batch can be made again), handed out on the host as a loader of
    ``length`` batches that cycles through them. ``keep`` holds the batches
    in host memory (a pool that is handed out again and again)."""

    def __init__(self, torch, n_images: int, batch_size: int, image_size: int, seed: int, device, *,
                 length: int = 0, num_classes: int = 1000, keep: bool = False):
        if n_images % batch_size:
            raise ValueError("n_images must be a multiple of the batch size")
        self.torch, self.device, self.seed = torch, device, seed
        self.batch_size, self.image_size, self.num_classes = batch_size, image_size, num_classes
        self.n_batches = n_images // batch_size
        self.length = length or self.n_batches
        self._kept = [self.host_batch(j) for j in range(self.n_batches)] if keep else None

    def device_batch(self, j: int):
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(harness.sub_seed(self.seed, 1000 + j))
        s, b = self.image_size, self.batch_size
        imgs = torch.randint(0, 256, (b, s, s, 3), generator=g, device=self.device, dtype=torch.uint8)
        labels = torch.randint(0, self.num_classes, (b,), generator=g, device=self.device, dtype=torch.int64)
        return imgs, labels

    def host_batch(self, j: int):
        imgs, labels = self.device_batch(j)
        return imgs.cpu().numpy(), labels.cpu().numpy().astype(np.int32)

    def __len__(self):
        return self.length

    def __iter__(self):
        for i in range(self.length):
            j = i % self.n_batches
            yield self._kept[j] if self._kept is not None else self.host_batch(j)


def fingerprints(torch, imgs_u8) -> "torch.Tensor":
    """One int64 hash per row of a sample of its bytes: each byte times its
    own random 63-bit weight, summed with wrap-around, so two rows of random
    pixels share a hash with odds of about 2**-60."""
    flat = imgs_u8.reshape(imgs_u8.shape[0], -1)[:, ::17].to(torch.int64)
    g = torch.Generator().manual_seed(0x5EED)
    w = torch.randint(1, 2 ** 62, (flat.shape[1],), generator=g, dtype=torch.int64).to(flat.device) * 2 + 1
    return (flat * w).sum(1)


def settle() -> None:
    """Collect set-up's garbage and freeze what is left, so that the
    collector's full passes over set-up's objects (an export leaves many)
    do not run inside the window."""
    gc.collect()
    gc.freeze()


def quantile(values: List[float], q: float) -> float:
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
