"""Input pipeline: host loader + device feed + stage manager (port of
``sota_imagenet_tpu/data/pipeline.py``: SyntheticLoader :44, DeviceFeed
:391-519, build_loader :599, DataManager :650).

Layering (replaces DALI, reference dali_dataloader.py):

  host loader (synthetic)                      — yields uint8 NHWC + int labels
    └─ DeviceFeed: pinned host memory → H2D on a side CUDA stream → device
       augment (ops/augment.py, the fused CUDA kernel) → prefetch
         └─ batches {'image': (B,H,W,3) bf16 on the device, 'label': one-hot f32}

Only the synthetic backend is ported in this slice; the folder/tfrecord/
packed backends, rectangular val and the device cache raise
NotImplementedError naming the ROADMAP item. Single process: the global
batch is the process batch.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
from typing import List, Optional

import numpy as np
import torch

from sota_imagenet_tpu_torch.config import ConfigNode, DataStage, parse_stages
from sota_imagenet_tpu_torch.ops.augment import build_train_augment, build_val_augment
from sota_imagenet_tpu_torch.utils.logging import get_logger


class SyntheticLoader:
    """Deterministic fake-data loader for tests and benches; the same numpy
    draws as the JAX package's SyntheticLoader, so both see the same pixels."""

    def __init__(self, batch_size: int, image_size: int, num_classes: int = 1000, length: int = 32, seed: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.length = length
        rng = np.random.default_rng(seed)
        # small pool of fake images reused across batches (keeps host cost ~0)
        self._pool = rng.integers(0, 256, size=(4, batch_size, image_size, image_size, 3), dtype=np.uint8)
        self._labels = rng.integers(0, num_classes, size=(4, batch_size), dtype=np.int32)

    def __len__(self):
        return self.length

    def __iter__(self):
        for i in range(self.length):
            j = i % self._pool.shape[0]
            yield self._pool[j], self._labels[j]


class DeviceFeed:
    """Wraps a host loader: transfer + device augment + prefetch.

    A background thread iterates the host loader and pins each batch (the
    DALI worker-thread role). The consumer copies it to the device on a side
    CUDA stream, makes the current stream wait for the copy (and records the
    batch on it, so the allocator does not recycle it early), and runs the
    augment on the current stream as it hands the batch out. The copies of
    the next ``prefetch`` batches are queued before the current batch is
    consumed, so they overlap the device's work on it. ``seed`` seeds the
    augment's generator on the device."""

    def __init__(self, host_loader, augment_fn, *, device, seed: int = 0, prefetch: int = 2, label_divisor: int = 1):
        self.host = host_loader
        self.augment = augment_fn
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.prefetch = max(prefetch, 1)
        # legacy `classes_divisor` (config.LoaderConfig): merge every
        # `label_divisor` consecutive labels; -1 pad labels stay -1
        self.label_divisor = max(int(label_divisor), 1)

    @property
    def batch_size(self):
        return self.host.batch_size

    def __len__(self):
        return len(self.host)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.host, "set_epoch"):
            self.host.set_epoch(epoch)

    def _to_device(self, images: torch.Tensor, labels: torch.Tensor, copy_stream):
        if copy_stream is None:
            return images, labels
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(copy_stream):
            images_d = images.to(self.device, non_blocking=True)
            labels_d = labels.to(self.device, non_blocking=True)
        current.wait_stream(copy_stream)
        images_d.record_stream(current)
        labels_d.record_stream(current)
        return images_d, labels_d

    def __iter__(self):
        pin = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in self.host:
                    if len(item) > 2:
                        raise NotImplementedError("masked / meta host batches are not ported yet (ROADMAP.md Queue 1 item 12)")
                    images, labels = item
                    if self.label_divisor > 1:
                        labels = np.where(labels >= 0, labels // self.label_divisor, labels)
                    images = torch.from_numpy(np.ascontiguousarray(images))
                    labels = torch.from_numpy(np.asarray(labels, np.int64))
                    if pin:
                        images, labels = images.pin_memory(), labels.pin_memory()
                    if not put((images, labels)):
                        return  # consumer abandoned the epoch (e.g. debug mode)
                put(end)
            except BaseException as e:  # surface host errors to the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        copy_stream = torch.cuda.Stream(self.device) if pin else None
        pending: List[tuple] = []  # device (images, labels) whose copies are queued
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                pending.append(self._to_device(*item, copy_stream))
                if len(pending) > self.prefetch:
                    # the augment is queued when the batch is handed out: on
                    # the one compute stream it would run in this order anyway,
                    # and every augment launched belongs to a consumed batch
                    yield self.augment(self.generator, *pending.pop(0))
            while pending:
                yield self.augment(self.generator, *pending.pop(0))
        finally:
            stop.set()
            thread.join(timeout=30)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to sota_imagenet_tpu_torch yet (ROADMAP.md {item})")


def _build_host_loader(loader_cfg: ConfigNode, is_train: bool):
    backend = loader_cfg.get("backend", "auto")
    root = loader_cfg.get("root_data_dir", "")
    if backend == "auto":
        if loader_cfg.get("use_packed", False):
            backend = "packed"
        elif loader_cfg.get("use_tfrecords", False):
            backend = "tfrecord"
        elif root and os.path.isdir(os.path.join(root, "train" if is_train else "val")):
            backend = "folder"
        else:
            backend = "synthetic"
    if backend == "synthetic":
        return SyntheticLoader(
            batch_size=loader_cfg.batch_size, image_size=loader_cfg.image_size, num_classes=loader_cfg.num_classes
        )
    if backend in ("folder", "packed", "tfrecord"):
        raise _not_ported(f"the {backend!r} data backend", "Queue 1 items 6 and 12")
    raise ValueError(f"unknown data backend {backend!r}")


def build_loader(loader_cfg: ConfigNode, is_train: bool, *, device, seed: int = 0, out_dtype=torch.bfloat16):
    if loader_cfg.get("device_cache", False):
        raise _not_ported("loader.device_cache", "Queue 1 item 12")
    if not is_train and loader_cfg.get("rectangular", False):
        raise _not_ported("val_loader.rectangular", "Queue 1 item 12")
    if is_train and loader_cfg.get("device_resample", False):
        raise _not_ported("loader.device_resample", "Queue 1 item 12")
    host = _build_host_loader(loader_cfg, is_train)
    # legacy classes_divisor: labels are merged host-side (DeviceFeed), so the
    # one-hot width shrinks to the effective class count
    divisor = max(int(loader_cfg.get("classes_divisor", 1) or 1), 1)
    eff_classes = -(-int(loader_cfg.num_classes) // divisor)
    if is_train:
        aug = build_train_augment(
            num_classes=eff_classes,
            blur_prob=loader_cfg.get("blur_prob", 0.0),
            gray_prob=loader_cfg.get("gray_prob", 0.0),
            color_twist_prob=loader_cfg.get("color_twist_prob", 0.0),
            contrast_range=tuple(loader_cfg.get("contrast_range", (0.7, 1.3))),
            brightness_range=tuple(loader_cfg.get("brightness_range", (0.7, 1.3))),
            re_prob=loader_cfg.get("re_prob", 0.0),
            re_count=loader_cfg.get("re_count", 3),
            out_dtype=out_dtype,
        )
    else:
        aug = build_val_augment(num_classes=eff_classes, out_dtype=out_dtype)
    return DeviceFeed(
        host, aug, device=device, seed=seed, prefetch=loader_cfg.get("prefetch", 2), label_divisor=divisor
    )


class DataManager:
    """Stage-based loader rebuild for progressive training
    (reference DaliDataManager, dali_dataloader.py:189-239)."""

    def __init__(self, cfg: ConfigNode, *, device, seed: int = 0, out_dtype=torch.bfloat16):
        self.cfg = cfg
        self.device = device
        self.seed = seed
        self.out_dtype = out_dtype
        self.stages: List[DataStage] = parse_stages(cfg.run.stages)
        self.tot_epochs = max(s.end for s in self.stages)
        self.loader = None
        self.val_loader = None
        self.start_epoch: Optional[int] = None
        self.end_epoch: Optional[int] = None

    def __len__(self):
        return len(self.stages)

    def set_stage(self, idx: int) -> None:
        stage = self.stages[idx]
        self.start_epoch = stage.start
        self.end_epoch = stage.end
        if stage.extra_args is None and self.loader is not None:
            return  # only lr changed (dali_dataloader.py:217-218)
        train_cfg = copy.deepcopy(self.cfg.loader)
        val_cfg = copy.deepcopy(self.cfg.val_loader)
        if stage.extra_args is not None:
            for k, v in dict(stage.extra_args).items():
                train_cfg[k] = v
        if val_cfg.get("follow_train_size", True):
            val_cfg["image_size"] = train_cfg["image_size"]  # val follows train (dali_dataloader.py:228)
        val_cfg["classes_divisor"] = train_cfg.get("classes_divisor", 1)
        get_logger().info(
            f"Loader changed. New data config: image_size={train_cfg['image_size']} batch_size={train_cfg['batch_size']}"
        )
        kw = dict(device=self.device, out_dtype=self.out_dtype)
        self.loader = build_loader(train_cfg, True, seed=self.seed, **kw)
        self.val_loader = build_loader(val_cfg, False, seed=self.seed + 1, **kw)
