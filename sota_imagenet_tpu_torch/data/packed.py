"""Decode-free "packed" records: pre-decoded fixed-size uint8 samples (port
of ``sota_imagenet_tpu/data/packed.py``:61-298).

The dataset-prep tool decodes each JPEG once, applies the train crop
(decode.decode_train: DALI's RandomResizedCrop distribution and the
triangular/cubic resize) or the val resize + centre crop (decode.decode_val),
and stores the raw uint8 pixels. The training-time loader then only reads
and copies: mmap'd shard -> proto field walk -> np.frombuffer -> one copy
into the batch array, with no JPEG decode and no resize on the host.

Trade-off, as in the JAX package: the train crop is baked at build time, one
per (image, build); ``crops_per_image > 1`` stores K independent crops per
source image, which the loader treats as distinct samples. Flip, colour
twist, grayscale, blur, erase and mixup still run per step on the device.

File layout (records.py framing, its .idx format, the seed-42 shuffle,
128/16 shards), byte for byte what the JAX package writes for the same tree
and decoder:
    <out>/train_packed/train-00000-of-00128 + <out>/train_packed_indexes/*.idx
    <out>/val_packed/val-00000-of-00016     + <out>/val_packed_indexes/*.idx
Each record is a tf.train.Example with image/raw (H*W*3 uint8 bytes),
image/height, image/width, image/class/label, image/filename.
"""

from __future__ import annotations

import mmap
import multiprocessing
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from sota_imagenet_tpu_torch.data import decode as D
from sota_imagenet_tpu_torch.data import native
from sota_imagenet_tpu_torch.data.records import (
    SHUFFLE_SEED,
    TRAIN_SHARDS,
    VAL_SHARDS,
    decode_example,
    encode_example,
    read_index,
    write_tfrecord,
)
from sota_imagenet_tpu_torch.parallel.mesh import data_count, data_index

# a shard of the records is a data rank's (the JAX loader calls these by jax's names)
process_count, process_index = data_count, data_index

__all__ = ["create_packed_records", "PackedLoader", "packed_dirs"]


def packed_dirs(root: str, split: str) -> Tuple[str, str]:
    return os.path.join(root, f"{split}_packed"), os.path.join(root, f"{split}_packed_indexes")


def _encode_packed(args) -> bytes:
    (path, label, key, is_train, image_size, min_area, random_interpolation, interpolation, full_crop) = args
    if is_train:
        # a generator per sample, keyed (seed, crop replica, source index) like
        # the JPEG loaders' (seed, epoch, index)
        rng = np.random.default_rng(key)
        img = D.decode_train(
            path,
            rng,
            image_size,
            min_area=min_area,
            random_interpolation=random_interpolation,
            interpolation=interpolation,
        )
    else:
        img = D.decode_val(path, image_size, full_crop=full_crop)
    img = np.ascontiguousarray(img, dtype=np.uint8)
    return encode_example(
        {
            "image/raw": img.tobytes(),
            "image/height": int(img.shape[0]),
            "image/width": int(img.shape[1]),
            "image/class/label": int(label),
            "image/filename": os.path.basename(path).encode(),
        }
    )


def _write_shard(task) -> int:
    shard_path, index_path, items = task
    return write_tfrecord(shard_path, (_encode_packed(it) for it in items), index_path)


def create_packed_records(
    data_dir: str,
    out_dir: Optional[str] = None,
    image_size: int = 224,
    *,
    train_shards: int = TRAIN_SHARDS,
    val_shards: int = VAL_SHARDS,
    workers: int = 8,
    seed: int = SHUFFLE_SEED,
    min_area: float = 0.08,
    random_interpolation: bool = False,
    interpolation: str = "triangular",
    full_crop: bool = False,
    crops_per_image: int = 1,
    splits: Tuple[str, ...] = ("val", "train"),
) -> None:
    """ImageFolder tree -> decode-free packed shards.

    A deterministic shuffle with ``seed`` and linspace shard bounds (reference
    create_records.py:37,55-56). Train samples get the random crop and resize
    of decode.decode_train from ``np.random.default_rng((seed, replica,
    index))``; val samples decode.decode_val's resize and centre crop. With
    ``workers > 1`` the shards are written by a pool of spawned processes
    (never forked: the caller may hold CUDA), each of which imports only
    decode, records and their helpers; the bytes do not depend on it."""
    from sota_imagenet_tpu_torch.data.pipeline import scan_image_folder

    out_dir = out_dir or data_dir
    for split in splits:
        n_shards = val_shards if split == "val" else train_shards
        is_train = split == "train"
        files, labels, _ = scan_image_folder(os.path.join(data_dir, split))
        order = np.arange(len(files))
        np.random.default_rng(seed).shuffle(order)
        k = crops_per_image if is_train else 1
        items = []
        for rep in range(k):
            for i in order:
                items.append(
                    (
                        files[i],
                        labels[i],
                        (seed, rep, int(i)),
                        is_train,
                        image_size,
                        min_area,
                        random_interpolation,
                        interpolation,
                        full_crop,
                    )
                )
        if k > 1:  # keep crop replicas of one image out of the same shard
            np.random.default_rng(seed + 1).shuffle(items)
        rec_dir, idx_dir = packed_dirs(out_dir, split)
        for d in (rec_dir, idx_dir):
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
        bounds = np.linspace(0, len(items), n_shards + 1).astype(int)
        tasks = []
        for s in range(n_shards):
            name = f"{split}-{s:05d}-of-{n_shards:05d}"
            tasks.append(
                (os.path.join(rec_dir, name), os.path.join(idx_dir, name + ".idx"), items[bounds[s] : bounds[s + 1]])
            )
        if workers > 1:
            native.available()  # build the native decoder here once, not with a make racing in every writer
            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                pool.map(_write_shard, tasks)
        else:
            for t in tasks:
                _write_shard(t)


class PackedLoader:
    """Decode-free train/val loader over packed shards.

    Per batch: mmap'd payload slice -> proto field walk -> np.frombuffer (a
    view) -> one copy into the batch array, the per-image page-in and copy on
    ``workers`` threads (numpy's copies release the GIL). Per-process
    sharding (entries[rank::world_size]), a per-epoch shuffle from ``seed +
    epoch``, and drop-last for train; val (``drop_last=False``) pads its
    tail batch with its last image, label -1, and yields a sample mask with
    every batch, as FolderLoader does."""

    def __init__(
        self,
        root: str,
        *,
        is_train: bool,
        batch_size: int,
        image_size: int,
        workers: int = 6,
        seed: int = 42,
        drop_last: bool = True,
        **_,
    ):
        split = "train" if is_train else "val"
        rec_dir, idx_dir = packed_dirs(root, split)
        self.entries: List[Tuple[str, int, int]] = []  # (shard_path, payload_off, payload_len)
        for name in sorted(os.listdir(rec_dir)):
            idx_path = os.path.join(idx_dir, name + ".idx")
            if not os.path.exists(idx_path):
                idx_path = os.path.join(idx_dir, name)
            for off, size in read_index(idx_path):
                # framing: 8 B length + 4 B crc | payload | 4 B crc (records.py)
                self.entries.append((os.path.join(rec_dir, name), off + 12, size - 16))
        pi, pc = process_index(), process_count()
        self.entries = self.entries[pi::pc]
        self.is_train = is_train
        self.batch_size = batch_size
        self.image_size = image_size
        self.workers = max(workers, 1)
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._mmaps = {}
        self._mmap_lock = threading.Lock()
        if self.entries:
            img, _ = self._load_one(self.entries[0])
            if img.shape[0] != image_size or img.shape[1] != image_size:
                raise ValueError(
                    f"packed {split} records store {img.shape[0]}x{img.shape[1]} px but the loader "
                    f"wants {image_size}; rebuild with create_packed_records(image_size={image_size}) "
                    f"(one packed tree per progressive-resize stage, like the reference's "
                    f"pre-resized source trees, resize_imagenet.py)"
                )

    def __len__(self):
        n = len(self.entries) // self.batch_size
        if not self.drop_last and len(self.entries) % self.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _payload(self, entry) -> memoryview:
        path, off, ln = entry
        mm = self._mmaps.get(path)
        if mm is None:
            with self._mmap_lock:  # worker threads race the first touch
                mm = self._mmaps.get(path)
                if mm is None:
                    with open(path, "rb") as f:
                        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    self._mmaps[path] = mm
        return memoryview(mm)[off : off + ln]

    def _load_one(self, entry) -> Tuple[np.ndarray, int]:
        ex = decode_example(bytes(self._payload(entry)))
        h, w = int(ex["image/height"]), int(ex["image/width"])
        img = np.frombuffer(ex["image/raw"], np.uint8).reshape(h, w, 3)
        return img, int(ex["image/class/label"])

    def __iter__(self):
        order = np.arange(len(self.entries))
        if self.is_train:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        pool = ThreadPoolExecutor(self.workers) if self.workers > 1 else None
        try:
            yield from self._iter_batches(order, pool)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)
        self.epoch += 1

    def _iter_batches(self, order, pool):
        bs, size = self.batch_size, self.image_size
        for b in range(len(self)):
            idxs = order[b * bs : (b + 1) * bs]
            imgs = np.empty((len(idxs), size, size, 3), np.uint8)
            labels = np.empty((len(idxs),), np.int32)
            loads = (
                pool.map(lambda i: self._load_one(self.entries[i]), idxs)
                if pool is not None
                else (self._load_one(self.entries[i]) for i in idxs)
            )
            for j, (img, label) in enumerate(loads):
                imgs[j] = img  # the one copy per image
                labels[j] = label
            if not self.drop_last and len(idxs) < bs:
                n_real = len(idxs)
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], bs - n_real, axis=0)])
                labels = np.concatenate([labels, np.full(bs - n_real, -1, np.int32)])
                mask = np.zeros((bs,), np.float32)
                mask[:n_real] = 1.0
                yield imgs, labels, mask
            elif not self.drop_last:
                yield imgs, labels, np.ones((bs,), np.float32)
            else:
                yield imgs, labels
