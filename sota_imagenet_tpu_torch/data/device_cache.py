"""Device-resident dataset cache: feed the train loop from card memory (port
of ``sota_imagenet_tpu/data/device_cache.py``:46-558).

* Fill (once per stage, at first use): the host loader's whole local split
  is copied into a preallocated uint8 tensor on the card, images ``(N, H,
  W, 3)`` and labels ``(N,)``, and for val a validity vector. One 80 GB
  H100 holds the smoke tree and the rehearsal corpora; ImageNet at 224 px
  (1.28M crops, ~193 GB) it does not.
* Every step: the step's row of sample indices (copied to the card once per
  epoch), ``torch.index_select`` of the batch from the cache, and the
  augment ``build_loader`` built (for train, the fused_aug kernel on the
  card). No host decode and no host-to-device image traffic. Spans
  (``utils/trace.py``): ``feed.cache_fill``, and ``feed.gather`` and
  ``feed.augment`` a step.

Sampling, as in the JAX package: each data shard draws its own permutation of
its resident samples every epoch, from ``np.random.default_rng((0x5EED,
epoch, shard))`` (DDP's sampler contract); val is one sequential sweep with
exact masked coverage. One card per process, so this process holds one data
shard, global shard ``data_index()`` of ``data_count()`` (the data axis;
a spatial or model rank holds its data rank's shard); the stream
routing of the JAX fill (row i on local shard i % shards_here) is kept, with
one local shard.

The train crops are baked into the records it caches (data/packed.py);
flip, colour, erase and mixup stay per step on the card.

Not ported, on purpose (ROADMAP.md Queue 3): ``fused_step``/``iter_stubs``
(XLA compiles gather, augment and step into one program; here the same
launches go in order on one stream) and ``input_cost_fraction`` (it reads
XLA's HLO cost model, which PyTorch lacks).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.logging import get_logger
from sota_imagenet_tpu_torch.parallel.mesh import data_count, data_index, rank_seed


class DeviceCacheFeed:
    """Iterator that can stand in for DeviceFeed.

    ``host_loader`` is iterated once, at the first ``len()`` or ``iter()``,
    to fill the cache; it must yield ``(images_u8, labels[, mask])`` batches
    of final crops (packed or folder loaders), so the device-resample split,
    whose batches are canvases plus meta, is refused.

    Train (``is_train=True``): per-shard permutations, the tail trimmed to
    whole batches (drop-last), masked pad rows of the host batches dropped.
    Val: every real sample stored once, the shard padded (label -1, validity
    0) up to whole batches, and every batch carries ``mask``."""

    def __init__(
        self,
        host_loader,
        augment_fn,
        *,
        device,
        seed: int = 0,
        label_divisor: int = 1,
        is_train: bool = True,
        fill_chunk_mb: float = 256,
        **_,
    ):
        if getattr(host_loader, "meta_kind", None) == "resample":
            raise ValueError("loader.device_cache is incompatible with loader.device_resample (cache stores final crops)")
        self.augment = augment_fn
        self.device = torch.device(device)
        # the augment's draws, seeded as DeviceFeed's (threefry's fold_in per step cannot be matched)
        self.generator = torch.Generator(device=self.device).manual_seed(rank_seed(seed))
        self.label_divisor = max(int(label_divisor), 1)
        self.is_train = is_train
        self.fill_chunk_mb = float(fill_chunk_mb)  # fractional MB allowed (tests)
        self.batch_size = host_loader.batch_size * max(data_count(), 1)
        self.epoch = 0
        self._n_data = max(data_count(), 1)  # data shards: one per data rank
        self._bs_local = self.batch_size // self._n_data
        # lazy fill: a resume that skips a stage, or an evaluate-only run that
        # never iterates the train feed, pays no copy of the split
        self._host = host_loader
        self.images = self.labels = self._valid = None
        self._n_per_shard = 0
        self.fill_s = self.fill_mb = 0.0

    # ---- fill ----------------------------------------------------------------
    #
    # Shard routing (both fill paths): filtered stream row i lives on local
    # shard i % S at position i // S. Under the train drop-last rule (n_per =
    # n_valid // S) the rows kept are stream rows [0, n_per * S), and a
    # chunk's routing is known when it arrives, which lets the chunked path
    # copy into the preallocated buffer with ~one chunk of host memory.

    def ensure_filled(self) -> None:
        if self.images is not None:
            return
        host_loader, self._host = self._host, None
        with trace.span("feed.cache_fill"):
            t0 = time.perf_counter()
            if self.fill_chunk_mb > 0:
                self.fill_mb = self._fill_chunked(host_loader)
            else:
                self.fill_mb = self._fill_monolithic(host_loader)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.fill_s = time.perf_counter() - t0
        mode = f"chunked {self.fill_chunk_mb} MB" if self.fill_chunk_mb > 0 else "monolithic"
        get_logger().info(
            f"Device cache: {self._n_per_shard} x {self._n_data} samples "
            f"({self.fill_mb * self._n_data:.0f} MB global, {self.fill_mb:.0f} MB/device-shard) "
            f"filled in {self.fill_s:.1f}s over data={self._n_data} ({mode})"
        )

    @staticmethod
    def _interleave(arr: np.ndarray, shards: int) -> np.ndarray:
        """Rearrange rows so position d*n_per + p holds stream row p*shards + d
        (rows must be a multiple of shards)."""
        n_per = arr.shape[0] // shards
        return np.ascontiguousarray(arr.reshape(n_per, shards, *arr.shape[1:]).swapaxes(0, 1)).reshape(
            arr.shape[0], *arr.shape[1:]
        )

    def _harmonized_n_per(self, n_per: int) -> int:
        """Every process must hold the same count, or their step counts differ
        and the first collective hangs: train trims to the smallest (drop-last),
        val pads to the largest (the pads are masked)."""
        if self._n_data == 1:
            return n_per
        counts = [None] * self._n_data
        torch.distributed.all_gather_object(counts, n_per)
        lo, hi = min(counts), max(counts)
        if lo != hi:
            get_logger().warning(
                f"device_cache per-shard counts differ across processes {counts}: "
                + ("trimming to the min (drop-last)" if self.is_train else "padding to the max (masked)")
            )
        return lo if self.is_train else hi

    def _filter_item(self, item):
        """(imgs, labs[, mask]) host batch -> its valid rows, labels divided.
        Masked pad rows (validity 0, label -1) are dropped: cached, a train
        feed would train on their all-zero one-hots."""
        imgs, labs = item[0], np.asarray(item[1]).astype(np.int64)
        valid = (item[2] > 0.5) if len(item) > 2 else None
        if valid is not None and not valid.all():
            imgs, labs = imgs[valid], labs[valid]
        if self.label_divisor > 1:
            labs = np.where(labs >= 0, labs // self.label_divisor, labs)
        return imgs, labs

    def _val_n_per(self, n_valid: int, shards_here: int) -> int:
        """Exact val quota: every real sample once, shards padded up to whole
        per-device batches."""
        q = -(-n_valid // shards_here)
        return -(-q // self._bs_local) * self._bs_local

    @staticmethod
    def _oom_hint(bytes_per_shard: float) -> str:
        return (
            f"loader.device_cache does not fit: {bytes_per_shard / 1e9:.2f} GB/device-shard of "
            f"images (+activations/params/optimizer). Shard over more cards (mesh.data, ROADMAP.md Queue 1 "
            f"item 8), cache a pre-resized smaller tree, or fall back to streaming (loader.use_packed without "
            f"device_cache). ImageNet's 1.28M train crops at 224 px take ~193 GB: no single 80 GB H100 holds them."
        )

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the card: the cache's only copies after the fill
        (the index rows, once an epoch)."""
        return torch.from_numpy(array).to(self.device)

    def _fill_monolithic(self, host_loader) -> float:
        """Whole-split fill in one copy (fill_chunk_mb: 0): holds 2-3x the
        split in host memory for a moment; the chunked default does not."""
        imgs_l, labs_l = [], []
        for item in host_loader:
            i, l = self._filter_item(item)
            imgs_l.append(i)
            labs_l.append(l)
        if not imgs_l:
            raise ValueError(
                "loader.device_cache: the host loader yielded no batches on this process "
                "(empty data shard?) — the cache cannot even infer the image shape"
            )
        imgs = np.concatenate(imgs_l, axis=0)
        labs = np.concatenate(labs_l, axis=0)
        del imgs_l, labs_l
        shards_here = 1  # one card per process
        validity = None
        if self.is_train:
            n_per = self._harmonized_n_per(imgs.shape[0] // shards_here)
            keep = n_per * shards_here
            imgs, labs = imgs[:keep], labs[:keep]
        else:
            n_per = self._harmonized_n_per(self._val_n_per(imgs.shape[0], shards_here))
            # pads: label -1 and validity 0, so the weighted metrics skip them;
            # zero images, as the chunked path's buffer starts
            total = n_per * shards_here
            validity = np.zeros((total,), np.float32)
            validity[: imgs.shape[0]] = 1.0
            pad = total - imgs.shape[0]
            if pad:
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                labs = np.concatenate([labs, np.full(pad, -1, np.int64)])
            validity = self._interleave(validity, shards_here)
        self._n_per_shard = n_per
        imgs = self._interleave(imgs, shards_here)
        labs = self._interleave(labs, shards_here)
        try:
            self.images = torch.from_numpy(imgs).to(self.device)
        except torch.cuda.OutOfMemoryError as e:
            raise torch.cuda.OutOfMemoryError(self._oom_hint(imgs.nbytes / shards_here)) from e
        self.labels = torch.from_numpy(labs).to(self.device)
        self._valid = None if validity is None else torch.from_numpy(validity).to(self.device)
        return imgs.nbytes / 1e6

    def _fill_chunked(self, host_loader) -> float:
        """Streamed fill: host batches are filtered, placed in shard-major
        order into one reusable staging buffer of ~fill_chunk_mb (pinned on a
        card), and copied into the preallocated cache a round at a time. Each
        copy is asynchronous and records an event that the next round waits
        on before it writes the staging buffer again. Every process runs the
        same number of rounds (bounded from len(host_loader))."""
        shards_here = 1  # one card per process
        it = iter(host_loader)
        try:
            first = next(it)
        except StopIteration:
            raise ValueError(
                "loader.device_cache: the host loader yielded no batches on this process "
                "(empty data shard?) — the cache cannot even infer the image shape"
            )
        img_shape = tuple(first[0].shape[1:])
        row_bytes = int(np.prod(img_shape))  # uint8
        # upper bound on this process's rows: every host batch full
        n_up = len(host_loader) * host_loader.batch_size
        if self._n_data > 1:
            ups = [None] * self._n_data
            torch.distributed.all_gather_object(ups, n_up)
            n_up = max(ups)
        # a chunk of ~fill_chunk_mb, a multiple of shards_here, no larger than the (shard-rounded) split
        chunk_bytes = max(1, int(self.fill_chunk_mb * (1 << 20)))
        chunk_rows = max(1, chunk_bytes // row_bytes // shards_here) * shards_here
        chunk_rows = min(chunk_rows, -(-n_up // shards_here) * shards_here)
        k = chunk_rows // shards_here  # rows per shard per round
        n_rounds = -(-n_up // chunk_rows)
        cap = n_rounds * k  # per-shard capacity
        try:
            # local until the fill completes: a failed fill must not leave a
            # half-built cache that ensure_filled would take as done
            imgs_buf = torch.zeros((shards_here * cap,) + img_shape, dtype=torch.uint8, device=self.device)
            labs_buf = torch.full((shards_here * cap,), -1, dtype=torch.int64, device=self.device)
        except torch.cuda.OutOfMemoryError as e:
            raise torch.cuda.OutOfMemoryError(self._oom_hint(float(cap) * row_bytes)) from e
        imgs_v = imgs_buf.view((shards_here, cap) + img_shape)
        labs_v = labs_buf.view(shards_here, cap)

        pin = self.device.type == "cuda"
        staging_i = torch.zeros((chunk_rows,) + img_shape, dtype=torch.uint8, pin_memory=pin)
        staging_l = torch.full((chunk_rows,), -1, dtype=torch.int64, pin_memory=pin)
        chunk_i, chunk_l = staging_i.numpy(), staging_l.numpy()
        copied = None  # event after the last copy out of the staging buffers
        # dest[j]: where chunk-local stream offset j goes (stream row r * chunk_rows + j)
        j = np.arange(chunk_rows)
        dest = (j % shards_here) * k + j // shards_here
        fill_pos = 0  # chunk-local stream offset already placed
        carry = None  # the rest of a batch that straddles the chunk boundary
        n_valid = 0
        done = False
        t0 = time.perf_counter()

        def flush(r):
            nonlocal fill_pos, copied
            if fill_pos < chunk_rows:  # a partial or pad chunk: zero image, label -1
                tail = dest[fill_pos:]
                chunk_i[tail] = 0
                chunk_l[tail] = -1
            imgs_v[:, r * k : (r + 1) * k].copy_(staging_i.view((shards_here, k) + img_shape), non_blocking=pin)
            labs_v[:, r * k : (r + 1) * k].copy_(staging_l.view(shards_here, k), non_blocking=pin)
            if pin:
                copied = torch.cuda.Event()
                copied.record()
            fill_pos = 0

        r = 0
        log_every = max(1, n_rounds // 10)
        while r < n_rounds:
            if copied is not None:
                copied.synchronize()  # the last copy has read the staging buffers
                copied = None
            while not done and fill_pos < chunk_rows:
                if carry is not None:
                    imgs, labs = carry
                    carry = None
                else:
                    item = first if first is not None else next(it, None)
                    first = None
                    if item is None:
                        done = True
                        break
                    imgs, labs = self._filter_item(item)
                    n_valid += imgs.shape[0]
                take = min(chunk_rows - fill_pos, imgs.shape[0])
                d = dest[fill_pos : fill_pos + take]
                chunk_i[d] = imgs[:take]
                chunk_l[d] = labs[:take]
                fill_pos += take
                if take < imgs.shape[0]:
                    carry = (imgs[take:], labs[take:])
            if done and fill_pos == 0 and self._n_data == 1:
                break  # all written; the rest of the capacity keeps its zeros and -1
            # a process whose data ran out early keeps copying pad chunks, so
            # every process runs the same rounds
            flush(r)
            r += 1
            if r % log_every == 0 or r == n_rounds:
                mb = n_valid * row_bytes / 1e6
                rate = mb / max(time.perf_counter() - t0, 1e-9)
                get_logger().info(f"Device cache fill: round {r}/{n_rounds}, {n_valid} rows ({mb:.0f} MB, {rate:.0f} MB/s)")
        if copied is not None:
            copied.synchronize()

        if self.is_train:
            n_per = self._harmonized_n_per(n_valid // shards_here)
        else:
            n_per = self._harmonized_n_per(self._val_n_per(n_valid, shards_here))
            # stream rows [0, n_valid) are real; the pads and the unwritten
            # capacity are masked (4 bytes a row, built on the host)
            v = np.zeros((cap * shards_here,), np.float32)
            v[:n_valid] = 1.0
            self._valid = self._to_device(self._interleave(v, shards_here))
        if n_per > cap:
            raise AssertionError(f"device_cache fill accounting: n_per {n_per} > capacity {cap}")
        self._n_per_shard = n_per
        self.images, self.labels = imgs_buf, labs_buf
        return n_valid * row_bytes / 1e6

    # ---- steps ---------------------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        """The epoch seeds the per-shard permutation, so a resumed run replays
        the order the uninterrupted run drew (DDP's set_epoch)."""
        self.epoch = int(epoch)

    def __len__(self):
        self.ensure_filled()
        return self._n_per_shard // self._bs_local

    def index_rows(self) -> np.ndarray:
        """This epoch's (steps, local batch) sample indices into the cache: a
        permutation per shard from (0x5EED, epoch, global shard) for train
        (which advances the epoch), a sequential sweep for val."""
        self.ensure_filled()
        steps = len(self)
        if self.is_train:
            shard = data_index()  # this data rank's one shard, of data_count()
            perm = np.random.default_rng((0x5EED, self.epoch, shard)).permutation(self._n_per_shard)
            self.epoch += 1
        else:
            perm = np.arange(self._n_per_shard)
        return perm[: steps * self._bs_local].reshape(steps, self._bs_local)

    def __iter__(self):
        rows = self._to_device(self.index_rows())  # one copy an epoch
        for idx in rows:
            with trace.span("feed.gather"):
                images, labels = torch.index_select(self.images, 0, idx), torch.index_select(self.labels, 0, idx)
            with trace.span("feed.augment"):
                batch = self.augment(self.generator, images, labels)
            if not self.is_train:
                batch["mask"] = torch.index_select(self._valid, 0, idx)
            yield batch
