"""Input pipeline: host loaders + device feed + stage manager (port of
``sota_imagenet_tpu/data/pipeline.py``: SyntheticLoader :44,
scan_image_folder :67, FolderLoader :81-286, RectValLoader :294-388,
DeviceFeed :391-519, _build_host_loader :527, build_loader :599,
DataManager :650; and TFRecordLoader, data/records.py :351-571).

Layering (replaces DALI, reference dali_dataloader.py):

  host loader (synthetic | folder | rectangular val | packed, data/packed.py
  | tfrecord)
      — yields (uint8 NHWC, int labels[, meta or val mask])
    └─ DeviceFeed: pinned host memory → H2D on a side CUDA stream → device
       augment (ops/augment.py: the device resample when the loader ships
       canvases, then the fused CUDA kernel) → prefetch
    └─ or, with loader.device_cache, DeviceCacheFeed (data/device_cache.py):
       the whole split copied to the card once, then a gather and the same
       augment every step
         └─ batches {'image': (B,H,W,3) bf16 on the device, 'label': one-hot f32
                     [, 'mask': f32 (B,) for padded val batches]}

Per-rank sharding (``process_index``/``process_count`` here are the data
axis's ``parallel/mesh.data_index``/``data_count``: a spatial or model rank
loads its data rank's rows; one process unless a torch.distributed group is up): each of N data ranks loads
batches of B/N, and the synthetic and folder loaders give rank r rows
[r*B/N, (r+1)*B/N) of the batch one process would load with the global B, so N
ranks train on what one process trains on (the layout of the JAX
package's make_array_from_process_local_data; its own folder and tfrecord
loaders read files[rank::N] instead). The tfrecord loader splits the same
way. The rectangular val loader, the packed loader and
the device cache keep a shard per rank, as the JAX package's do; the val
metrics are masked sums over the ranks, so they do not depend on it. The augment's draws are the rank's own (the rank folded
into the feed's seed).
"""

from __future__ import annotations

import copy
import json
import math
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sota_imagenet_tpu_torch.config import ConfigNode, DataStage, parse_stages
from sota_imagenet_tpu_torch.data import decode as D
from sota_imagenet_tpu_torch.data import native
from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
from sota_imagenet_tpu_torch.data.packed import PackedLoader
from sota_imagenet_tpu_torch.ops.augment import build_train_augment, build_val_augment
from sota_imagenet_tpu_torch.parallel.mesh import data_count, data_index, rank_seed
from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.logging import get_logger

# the loaders' shard of the batch is their data rank's (the JAX loaders call these by jax's names)
process_count, process_index = data_count, data_index

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class SyntheticLoader:
    """Deterministic fake-data loader for tests and benches; the same numpy
    draws as the JAX package's SyntheticLoader, so both see the same pixels.
    ``batch_size`` is this rank's; the pool is drawn at the global batch and
    the rank keeps its rows."""

    def __init__(self, batch_size: int, image_size: int, num_classes: int = 1000, length: int = 32, seed: int = 0):
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_classes = num_classes
        self.length = length
        rng = np.random.default_rng(seed)
        pc, rows = process_count(), slice(process_index() * batch_size, (process_index() + 1) * batch_size)
        # small pool of fake images reused across batches (keeps host cost ~0)
        pool = rng.integers(0, 256, size=(4, batch_size * pc, image_size, image_size, 3), dtype=np.uint8)
        labels = rng.integers(0, num_classes, size=(4, batch_size * pc), dtype=np.int32)
        self._pool, self._labels = np.ascontiguousarray(pool[:, rows]), np.ascontiguousarray(labels[:, rows])

    def __len__(self):
        return self.length

    def __iter__(self):
        for i in range(self.length):
            j = i % self._pool.shape[0]
            yield self._pool[j], self._labels[j]


def scan_image_folder(root: str) -> Tuple[List[str], List[int], List[str]]:
    """ImageFolder layout: root/<class>/<img>. Labels by sorted class dirs
    (the reference synset->label rule, create_records.py:151-155)."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    files, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fn in sorted(os.listdir(cdir)):
            if fn.lower().endswith(IMG_EXTENSIONS):
                files.append(os.path.join(cdir, fn))
                labels.append(idx)
    return files, labels, classes


class FolderLoader:
    """Parallel host decode over an ImageFolder tree (train or val).

    Train: a per-epoch shuffle from ``seed + epoch``, and each image's crop
    and filter from ``np.random.default_rng((seed, epoch, index))``, so the
    JAX loader and this one yield the same batches. Four ways to decode, as
    in the JAX package: the native C executor, double-buffered (batch b+1
    decodes while batch b is consumed), with the resize on the host or, with
    ``device_resample``, DCT-scaled canvases plus meta (sh, sw, filt) for the
    device resample; else a thread pool over decode.py (PIL where the native
    library is missing), again host- or device-resampled. Val: no shuffle,
    every image once; the tail batch is padded with its last image (label
    -1) and every batch carries a sample mask."""

    def __init__(
        self,
        root: str,
        *,
        is_train: bool,
        batch_size: int,
        image_size: int,
        min_area: float = 0.08,
        random_interpolation: bool = False,
        interpolation: str = "triangular",
        full_crop: bool = False,
        workers: int = 6,
        seed: int = 42,
        drop_last: bool = True,
        device_resample: bool = False,
    ):
        self.files, self.labels, self.classes = self._scan(root, is_train)
        self.is_train = is_train
        # device-resample split (train only): batches become (canvas_imgs,
        # labels, meta) with meta = per-sample (sh, sw, filt)
        self.device_resample = bool(device_resample) and is_train
        self.meta_kind = "resample" if self.device_resample else None
        self.batch_size = batch_size
        self.image_size = image_size
        self.min_area = min_area
        self.random_interpolation = random_interpolation
        self.interpolation = interpolation  # base train resize filter (legacy `resize_method: cubic`)
        self.full_crop = full_crop
        self.workers = max(workers, 1)
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        # this rank's rows of each global batch (replaces shard_id/num_shards, dali_dataloader.py:47)
        self.rank, self.global_batch = process_index(), batch_size * process_count()

    @staticmethod
    def _scan(root: str, is_train: bool) -> tuple:
        return scan_image_folder(root)

    def __len__(self):
        n = len(self.files) // self.global_batch
        if not self.drop_last and len(self.files) % self.global_batch:
            n += 1
        return n

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _train_kw(self) -> dict:
        return dict(
            min_area=self.min_area, random_interpolation=self.random_interpolation, interpolation=self.interpolation
        )

    def _decode_one(self, path: str, rng: np.random.Generator):
        """One image through decode.py: a uint8 crop, or with device_resample
        (canvas, sh, sw, filt)."""
        if not self.is_train:
            return D.decode_val(path, self.image_size, full_crop=self.full_crop)
        if self.device_resample:
            return D.decode_train_scaled(path, rng, self.image_size, **self._train_kw())
        return D.decode_train(path, rng, self.image_size, **self._train_kw())

    def _batch_executor(self) -> Optional[native.BatchExecutor]:
        """Native batch executor (one C call per batch) for the train path."""
        if not self.is_train:
            return None
        if not hasattr(self, "_exec"):
            self._exec = native.BatchExecutor(workers=self.workers) if native.available() else None
        return self._exec

    def _fetch(self, idxs) -> Tuple[list, List[int]]:
        """The images of ``idxs`` as decode.py takes them (here their paths) and their labels."""
        return [self.files[i] for i in idxs], [self.labels[i] for i in idxs]

    def _fallback_rng(self, idx: int, rng: np.random.Generator) -> np.random.Generator:
        """The generator of an image the C core could not decode: one of its own (the JAX FolderLoader's)."""
        return np.random.default_rng((self.seed, self.epoch, int(idx), 1))

    def _submit_batch_native(self, srcs, rngs) -> tuple:
        """Read bytes + sample crops + submit to the C executor; non-blocking.
        Returns (ticket, filts): filts feed the device-resample meta (the C
        resize uses them directly in host-resample mode)."""
        datas, crops, filts = [], [], []
        for src, rng in zip(srcs, rngs):
            data = D._read_bytes(src)
            dims = native.jpeg_dims(data)
            if dims is None:
                crops.append((0, 0, 1, 1))  # fails in C -> PIL decode in _wait_batch_native
            else:
                crops.append(D.sample_random_crop(rng, dims[0], dims[1], min_area=self.min_area))
            datas.append(data)
            filts.append(D.pick_filter(rng, self.random_interpolation, self.interpolation))
        if self.device_resample:
            canvas = D.resample_canvas(self.image_size)
            return self._exec.submit_scaled(datas, crops, self.image_size, canvas), filts
        return self._exec.submit(datas, crops, filts, (self.image_size, self.image_size)), filts

    def _wait_batch_native(self, ticket, idxs, srcs, rngs, filts) -> tuple:
        """(imgs, meta): meta is None in host-resample mode. The images the C
        core could not decode (non-JPEGs) are decoded again with PIL
        (``_fallback_rng``)."""
        if self.device_resample:
            imgs, failed, dims = self._exec.wait_scaled(ticket)
            meta = np.concatenate([dims, np.asarray(filts, np.int32)[:, None]], axis=1)
        else:
            (imgs, failed), meta = self._exec.wait(ticket), None
        D.count_decoded("native", len(idxs) - len(failed))
        for fi in failed:
            path, rng = srcs[fi], self._fallback_rng(idxs[fi], rngs[fi])
            if self.device_resample:
                img, sh, sw, filt = D.decode_train_scaled(path, rng, self.image_size, use_native=False, **self._train_kw())
                imgs[fi], meta[fi] = img, (sh, sw, filt)
            else:
                imgs[fi] = D.decode_train(path, rng, self.image_size, use_native=False, **self._train_kw())
        return imgs, meta

    def __iter__(self) -> Iterator[tuple]:
        order = np.arange(len(self.files))
        if self.is_train:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        bs, gb = self.batch_size, self.global_batch
        n_batches = len(self)

        def batch_idxs(b):
            # this rank's rows of global batch b; a val tail may leave it none, and then it pads with the
            # global batch's last image, as the one process pads its tail
            whole = order[b * gb : (b + 1) * gb]
            idxs = whole[self.rank * bs : (self.rank + 1) * bs]
            idxs = idxs if len(idxs) else whole[-1:]
            return idxs, [np.random.default_rng((self.seed, self.epoch, int(i))) for i in idxs]

        use_native = self._batch_executor() is not None
        with ThreadPoolExecutor(self.workers) as pool:
            pending = None  # ((ticket, filts), idxs) of the batch decoding in C
            if use_native and n_batches:
                idxs0, rngs0 = batch_idxs(0)
                srcs0, labs0 = self._fetch(idxs0)
                pending = (self._submit_batch_native(srcs0, rngs0), idxs0, srcs0, rngs0, labs0)
            for b in range(n_batches):
                if use_native:
                    (ticket, filts), idxs, srcs, rngs, labs = pending
                    if b + 1 < n_batches:
                        idxs1, rngs1 = batch_idxs(b + 1)
                        srcs1, labs1 = self._fetch(idxs1)
                        pending = (self._submit_batch_native(srcs1, rngs1), idxs1, srcs1, rngs1, labs1)
                    stacked, meta = self._wait_batch_native(ticket, idxs, srcs, rngs, filts)
                else:
                    idxs, rngs = batch_idxs(b)
                    srcs, labs = self._fetch(idxs)
                    parts = list(pool.map(lambda a: self._decode_one(*a), zip(srcs, rngs)))
                    if self.device_resample:
                        stacked = np.stack([p[0] for p in parts])
                        meta = np.asarray([p[1:] for p in parts], np.int32)
                    else:
                        stacked, meta = np.stack(parts), None
                n_real = max(min(len(self.files) - b * gb - self.rank * bs, bs), 0)
                if stacked.shape[0] < bs:  # pad the tail batch (only when drop_last=False)
                    pad = bs - stacked.shape[0]
                    stacked = np.concatenate([stacked, np.repeat(stacked[-1:], pad, axis=0)])
                    if meta is not None:  # keep batch dims consistent for DeviceFeed
                        meta = np.concatenate([meta, np.repeat(meta[-1:], pad, axis=0)])
                labels = np.full((bs,), -1, np.int32)
                labels[:n_real] = labs[:n_real]
                if meta is not None:
                    yield stacked, labels, meta
                elif not self.drop_last:
                    # padded samples carry mask 0 so the masked eval step
                    # scores them as absent, not wrong. The mask is yielded
                    # for full batches too: every val batch has one form.
                    mask = np.zeros((bs,), np.float32)
                    mask[:n_real] = 1.0
                    yield stacked, labels, mask
                else:
                    yield stacked, labels
        self.epoch += 1


class TFRecordLoader(FolderLoader):
    """The reference's own data format: JPEG records in TFRecord shards with
    DALI-style ``.idx`` files (port of records.py:351-571 of the JAX package;
    the DALI tfrecord reader, dali_dataloader.py:48-62), as ``records
    tfrecord`` writes them (``data/records.create_records``): ``root`` holds
    ``{split}_records`` and ``{split}_indexes``. The records of every shard,
    in name order, are the images; each batch reads its records and decodes
    them as ``FolderLoader`` decodes files, with the same shuffle
    (``seed + epoch``), per-image generators ``(seed, epoch, index)``, native
    and PIL paths, device-resample canvases and val padding. An image the C
    core cannot decode is decoded with PIL from its own, already drawn,
    generator, as the JAX loader does. Over ranks each takes its rows of the
    global batch, as ``FolderLoader`` does (the JAX loader reads
    ``entries[rank::N]`` instead), so N ranks load what one process loads."""

    @staticmethod
    def _scan(root: str, is_train: bool) -> tuple:
        from sota_imagenet_tpu_torch.data.records import read_index

        split = "train" if is_train else "val"
        rec_dir, idx_dir = os.path.join(root, f"{split}_records"), os.path.join(root, f"{split}_indexes")
        entries = []  # (shard path, offset)
        for name in sorted(os.listdir(rec_dir)):
            idx_path = os.path.join(idx_dir, name + ".idx")
            if not os.path.exists(idx_path):
                idx_path = os.path.join(idx_dir, name)
            entries += [(os.path.join(rec_dir, name), off) for off, _ in read_index(idx_path)]
        return entries, None, None

    @property
    def entries(self) -> List[Tuple[str, int]]:
        return self.files

    def _fetch(self, idxs) -> Tuple[list, List[int]]:
        from sota_imagenet_tpu_torch.data.records import decode_example, read_record_at

        examples = [decode_example(read_record_at(*self.files[i])) for i in idxs]
        return [ex["image/encoded"] for ex in examples], [int(ex["image/class/label"]) for ex in examples]

    def _fallback_rng(self, idx: int, rng: np.random.Generator) -> np.random.Generator:
        return rng


class RectValLoader:
    """Rectangular validation (closes the reference's TODO,
    dali_dataloader.py:5): images are grouped by aspect ratio into three
    static shapes (tall/square/wide centre crops at near-native aspect).
    Every image is evaluated exactly once: the last batch of each bucket is
    zero-padded and carries a sample mask the eval step uses for exact
    weighted metrics."""

    # (path, mtime) -> (w, h) header cache, shared across stage rebuilds (the
    # bucket thresholds depend on image_size, the image dimensions do not).
    # Keyed by mtime so replacing a val file within a process is seen.
    _WH_CACHE: Dict[Tuple[str, float], Tuple[int, int]] = {}
    # persisted (w, h) table next to the dataset, {relpath: [w, h, mtime]}:
    # the JAX package's format and name, so either package reads the other's
    _SIDECAR = ".rectval_wh.json"

    def __init__(self, root: str, *, batch_size: int, image_size: int, workers: int = 6, **_):
        from PIL import Image

        self.files, self.labels, self.classes = scan_image_folder(root)
        self.batch_size = batch_size
        self.image_size = image_size
        self.workers = max(workers, 1)
        self.buckets, thresh = D.rect_buckets(image_size)
        # bucket the full (sorted) file list identically on every process, so
        # all processes see the same batch counts and shape sequence
        cache = RectValLoader._WH_CACHE
        sidecar = os.path.join(root, RectValLoader._SIDECAR)
        try:
            with open(sidecar) as f:
                for rel, (w, h, mt) in json.load(f).items():
                    cache[(os.path.join(root, rel), float(mt))] = (int(w), int(h))
        except (OSError, ValueError):
            pass
        keys = [(f, os.path.getmtime(f)) for f in self.files]
        missing = [k for k in keys if k not in cache]
        if missing:

            def read_wh(key):
                with Image.open(key[0]) as im:  # header-only read
                    return im.size

            with ThreadPoolExecutor(self.workers) as pool:
                for k, wh in zip(missing, pool.map(read_wh, missing)):
                    cache[k] = wh
            if process_index() == 0:
                try:  # atomic write; losing the race is harmless (same content)
                    table = {os.path.relpath(f, root): [*cache[(f, mt)], mt] for f, mt in keys}
                    tmp = sidecar + f".tmp{os.getpid()}"
                    with open(tmp, "w") as out:
                        json.dump(table, out)
                    os.replace(tmp, sidecar)
                except OSError:
                    pass
        self.by_bucket = {k: [] for k in self.buckets}
        for (f, mt), lab in zip(keys, self.labels):
            w, h = cache[(f, mt)]
            self.by_bucket[D.bucket_of(w, h, thresh)].append((f, lab))
        # each process takes an interleaved shard of every bucket, padded to a
        # globally identical batch count (trailing batches may be all padding
        # on some processes; the sample mask keeps the metrics exact)
        pi, pc = process_index(), process_count()
        self.my_bucket = {k: items[pi::pc] for k, items in self.by_bucket.items()}
        self.batches_per_bucket = {
            k: math.ceil(math.ceil(len(items) / pc) / batch_size) if items else 0
            for k, items in self.by_bucket.items()
        }

    def __len__(self):
        return sum(self.batches_per_bucket.values())

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        bs = self.batch_size
        with ThreadPoolExecutor(self.workers) as pool:
            for name, hw in self.buckets.items():
                items = self.my_bucket[name]
                for i in range(self.batches_per_bucket[name]):
                    chunk = items[i * bs : (i + 1) * bs]
                    imgs = list(pool.map(lambda it: D.decode_val_rect(it[0], self.image_size, hw), chunk))
                    n = len(chunk)
                    images = np.zeros((bs, hw[0], hw[1], 3), np.uint8)
                    if n:
                        images[:n] = np.stack(imgs)
                    labels = np.zeros((bs,), np.int64)
                    labels[:n] = [it[1] for it in chunk]
                    mask = np.zeros((bs,), np.float32)
                    mask[:n] = 1.0
                    yield images, labels, mask


class DeviceFeed:
    """Wraps a host loader: transfer + device augment + prefetch.

    A background thread iterates the host loader and pins each batch (the
    DALI worker-thread role). The consumer copies it to the device on a side
    CUDA stream, makes the current stream wait for the copy (and records the
    batch on it, so the allocator does not recycle it early), and runs the
    augment on the current stream as it hands the batch out. The copies of
    the next ``prefetch`` batches are queued before the current batch is
    consumed, so they overlap the device's work on it. ``seed``, with the
    rank folded in, seeds the augment's generator on the device. Spans
    (``utils/trace.py``): ``feed.host_batch`` and ``feed.pin`` on the
    producer's thread, ``feed.queue_wait``, ``feed.h2d`` and
    ``feed.augment`` on the consumer's.

    A host batch is (images, labels) or (images, labels, third): with the
    loader's ``meta_kind == "resample"`` the third is the per-sample (sh, sw,
    filt) the augment's device resample takes; otherwise it is the val
    sample mask, handed out as ``batch["mask"]``."""

    def __init__(self, host_loader, augment_fn, *, device, seed: int = 0, prefetch: int = 2, label_divisor: int = 1):
        self.host = host_loader
        self.augment = augment_fn
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(rank_seed(seed))
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

    def _to_device(self, tensors: tuple, copy_stream) -> tuple:
        if copy_stream is None:
            return tensors
        current = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(copy_stream):
            on_device = tuple(t.to(self.device, non_blocking=True) for t in tensors)
        current.wait_stream(copy_stream)
        for t in on_device:
            t.record_stream(current)
        return on_device

    def _hand_out(self, tensors: tuple, resample: bool) -> dict:
        with trace.span("feed.augment"):
            if resample:
                return self.augment(self.generator, *tensors)
            batch = self.augment(self.generator, *tensors[:2])
        if len(tensors) > 2:  # padded val: the per-sample validity mask
            batch["mask"] = tensors[2]
        return batch

    def __iter__(self):
        pin = self.device.type == "cuda"
        resample = getattr(self.host, "meta_kind", None) == "resample"
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
                items = iter(self.host)
                while True:
                    with trace.span("feed.host_batch"):
                        item = next(items, end)
                    if item is end:
                        break
                    images, labels = item[0], item[1]
                    if self.label_divisor > 1:
                        labels = np.where(labels >= 0, labels // self.label_divisor, labels)
                    tensors = [torch.from_numpy(np.ascontiguousarray(images)), torch.from_numpy(np.asarray(labels, np.int64))]
                    if len(item) > 2:  # int32 resample meta, or the f32 val mask
                        tensors.append(torch.from_numpy(np.ascontiguousarray(item[2])))
                    if pin:
                        with trace.span("feed.pin"):
                            tensors = [t.pin_memory() for t in tensors]
                    if not put(tuple(tensors)):
                        return  # consumer abandoned the epoch (e.g. debug mode)
                put(end)
            except BaseException as e:  # surface host errors to the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        copy_stream = torch.cuda.Stream(self.device) if pin else None
        pending: List[tuple] = []  # device tensors of batches whose copies are queued
        try:
            while True:
                with trace.span("feed.queue_wait"):
                    item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                with trace.span("feed.h2d"):
                    pending.append(self._to_device(item, copy_stream))
                if len(pending) > self.prefetch:
                    # the augment is queued when the batch is handed out: on
                    # the one compute stream it would run in this order anyway,
                    # and every augment launched belongs to a consumed batch
                    yield self._hand_out(pending.pop(0), resample)
            while pending:
                yield self._hand_out(pending.pop(0), resample)
        finally:
            stop.set()
            thread.join(timeout=30)


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
    batch_size = loader_cfg.batch_size // max(process_count(), 1)
    if backend == "synthetic":
        return SyntheticLoader(batch_size=batch_size, image_size=loader_cfg.image_size, num_classes=loader_cfg.num_classes)
    if backend == "folder":
        if not is_train and loader_cfg.get("rectangular", False):
            return RectValLoader(
                os.path.join(root, "val"),
                batch_size=batch_size,
                image_size=loader_cfg.image_size,
                workers=loader_cfg.get("workers", 6),
            )
        return FolderLoader(
            os.path.join(root, "train" if is_train else "val"),
            is_train=is_train,
            batch_size=batch_size,
            image_size=loader_cfg.image_size,
            min_area=loader_cfg.get("min_area", 0.08),
            random_interpolation=loader_cfg.get("random_interpolation", False),
            interpolation=loader_cfg.get("interpolation", "triangular"),
            full_crop=loader_cfg.get("full_crop", False),
            workers=loader_cfg.get("workers", 6),
            # val evaluates every image: the tail batch is padded + masked so
            # the metrics stay exact (the reference sidestepped this with a
            # batch-divisibility requirement, arg_parser.py:59-61)
            drop_last=is_train,
            device_resample=is_train and bool(loader_cfg.get("device_resample", False)),
        )
    if backend == "packed":
        return PackedLoader(
            root,
            is_train=is_train,
            batch_size=batch_size,
            image_size=loader_cfg.image_size,
            workers=loader_cfg.get("workers", 6),
            drop_last=is_train,  # val: pad + mask the tail (see FolderLoader)
        )
    if backend == "tfrecord":
        return TFRecordLoader(
            root,
            is_train=is_train,
            batch_size=batch_size,
            image_size=loader_cfg.image_size,
            min_area=loader_cfg.get("min_area", 0.08),
            random_interpolation=loader_cfg.get("random_interpolation", False),
            interpolation=loader_cfg.get("interpolation", "triangular"),
            full_crop=loader_cfg.get("full_crop", False),
            workers=loader_cfg.get("workers", 6),
            drop_last=is_train,  # val: pad + mask the tail (see FolderLoader)
            device_resample=is_train and bool(loader_cfg.get("device_resample", False)),
        )
    raise ValueError(f"unknown data backend {backend!r}")


def build_loader(loader_cfg: ConfigNode, is_train: bool, *, device, seed: int = 0, out_dtype=torch.bfloat16):
    if not is_train and loader_cfg.get("device_cache", False) and loader_cfg.get("rectangular", False):
        # RectValLoader yields batches of three static shapes; a fixed-shape
        # device cache cannot hold them. Rejected before the val tree is scanned.
        raise ValueError(
            "val_loader.device_cache is incompatible with val_loader.rectangular "
            "(the cache stores one fixed shape; use the square masked val or drop device_cache)"
        )
    host = _build_host_loader(loader_cfg, is_train)
    # legacy classes_divisor: labels are merged host-side (DeviceFeed), so the
    # one-hot width shrinks to the effective class count
    divisor = max(int(loader_cfg.get("classes_divisor", 1) or 1), 1)
    eff_classes = -(-int(loader_cfg.num_classes) // divisor)
    if is_train:
        aug = build_train_augment(
            num_classes=eff_classes,
            resample_to=loader_cfg.image_size if getattr(host, "meta_kind", None) == "resample" else None,
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
    if loader_cfg.get("device_cache", False):
        return DeviceCacheFeed(
            host,
            aug,
            device=device,
            seed=seed,
            label_divisor=divisor,
            is_train=is_train,
            fill_chunk_mb=loader_cfg.get("fill_chunk_mb", 256),
        )
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
        # accumulate_steps multiplies the effective batch (the reference runner
        # accumulated over loader batches): the loader's batch is
        # accumulate_steps x batch_size, and the train step splits it into
        # microbatches of the configured size (pipeline.py:682-687 of the JAX package)
        accum = int(self.cfg.run.get("accumulate_steps", 1) or 1)
        if accum > 1:
            train_cfg["batch_size"] = int(train_cfg["batch_size"]) * accum
        if val_cfg.get("follow_train_size", True):
            val_cfg["image_size"] = train_cfg["image_size"]  # val follows train (dali_dataloader.py:228)
        val_cfg["classes_divisor"] = train_cfg.get("classes_divisor", 1)
        get_logger().info(
            f"Loader changed. New data config: image_size={train_cfg['image_size']} batch_size={train_cfg['batch_size']}"
        )
        kw = dict(device=self.device, out_dtype=self.out_dtype)
        self.loader = build_loader(train_cfg, True, seed=self.seed, **kw)
        self.val_loader = build_loader(val_cfg, False, seed=self.seed + 1, **kw)
