"""The port's device cache (``sota_imagenet_tpu_torch.data.device_cache``) on
the CPU: the counterparts of tests/test_device_cache.py that do not need a
mesh, and the port against a one-device JAX ``DeviceCacheFeed``.

Contract: one epoch visits every resident sample once, from a permutation
seeded by (0x5EED, epoch, shard); the gathered rows are the resident
samples; the fill is lazy; streams are deterministic and ``set_epoch``
resumes them; val covers every real sample once with masked pads; train
drops the masked pad rows of its host batches; the chunked fill gives what
the monolithic one gives, at every chunk size; ``build_loader`` dispatches to
the cache; ``Runner.fit`` through the cache equals ``Runner.fit`` through
``DeviceFeed`` on the same rows. Against JAX (an identity augment on both
sides): the same index rows and the same gathered uint8, labels and masks,
exactly; and the train augment of a gathered batch with the JAX draws fed
in, as tests/test_torch_aug.py holds it (one uint8 step on at most 0.1% of
the values, at FMA ties)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.data.device_cache import DeviceCacheFeed as JDeviceCacheFeed
from sota_imagenet_tpu.ops.pallas_aug import draw_augment_scalars as jax_draw_scalars
from sota_imagenet_tpu.ops.pallas_aug import pallas_augment
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.constants import DATA_MEAN, DATA_STD
from sota_imagenet_tpu_torch.data import pipeline as P
from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
from sota_imagenet_tpu_torch.ops.augment import build_train_augment, build_val_augment
from sota_imagenet_tpu_torch.ops.fused_aug import fused_augment

TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_synthetic.yaml")
N, BS, SZ = 64, 16, 8


class IndexLoader:
    """Host loader stub: every pixel of sample i has value i; label = i."""

    def __init__(self, n=N, bs=BS, size=SZ):
        self.batch_size = bs
        self.n = n
        self.size = size

    def __len__(self):
        return self.n // self.batch_size

    def __iter__(self):
        for b in range(len(self)):
            idx = np.arange(b * self.batch_size, (b + 1) * self.batch_size)
            imgs = np.broadcast_to(idx[:, None, None, None], (len(idx), self.size, self.size, 3)).astype(np.uint8)
            yield imgs.copy(), idx.astype(np.int32)


class IndexValLoader:
    """Masked val stub: 52 real samples, the tail batch padded (the 3-tuple
    of the masked loaders: the last index repeated, label -1, mask 0)."""

    def __init__(self, n=52, bs=BS, size=SZ):
        self.batch_size = bs
        self.n = n
        self.size = size

    def __len__(self):
        return -(-self.n // self.batch_size)

    def __iter__(self):
        for b in range(len(self)):
            lo = b * self.batch_size
            real = min(self.batch_size, self.n - lo)
            idx = np.concatenate([np.arange(lo, lo + real), np.full(self.batch_size - real, lo + real - 1)])
            imgs = np.broadcast_to(idx[:, None, None, None], (self.batch_size, self.size, self.size, 3)).astype(np.uint8)
            labs = np.where(np.arange(self.batch_size) < real, idx, -1).astype(np.int32)
            yield imgs.copy(), labs, (np.arange(self.batch_size) < real).astype(np.float32)


def _val_aug(num_classes=N):
    return build_val_augment(num_classes=num_classes, out_dtype=torch.float32)


def _identity(generator, images, labels):
    return {"image": images, "label": labels}


def _feed(host=None, aug=None, **kw):
    return DeviceCacheFeed(IndexLoader() if host is None else host, aug or _val_aug(), device="cpu", **kw)


def _labels(batch):
    return batch["label"].argmax(-1).tolist()


def test_epoch_covers_every_resident_sample_once():
    feed = _feed()
    assert len(feed) == N // BS
    for _ in range(2):
        seen = [lab for batch in feed for lab in _labels(batch)]
        assert sorted(seen) == list(range(N))


def test_gathered_images_match_resident_samples():
    for batch in _feed():
        px = batch["image"][:, 0, 0, 0].numpy() * DATA_STD + DATA_MEAN  # invert the val normalize
        np.testing.assert_allclose(px, _labels(batch), atol=0.01)
        assert (batch["image"] == batch["image"][:, :1, :1, :1]).all(), "every pixel of a sample is its index"


def test_fill_is_lazy():
    feed = _feed()
    assert feed.images is None and feed._host is not None
    assert len(feed) == N // BS
    assert feed.images is not None and feed._host is None
    assert feed.images.dtype == torch.uint8 and tuple(feed.images.shape) == (N, SZ, SZ, 3)
    assert feed.fill_mb == N * SZ * SZ * 3 / 1e6 and feed.fill_s > 0


def test_epoch_streams_are_deterministic_and_set_epoch_resumes():
    f1, f2 = _feed(), _feed()
    e0 = [_labels(b) for b in f1]
    assert e0 == [_labels(b) for b in f2]
    e1 = [_labels(b) for b in f1]
    assert e0 != e1, "the permutation is epoch-seeded"
    list(f1)  # a continuous run, on to its 4th epoch
    resumed = _feed()
    resumed.set_epoch(3)
    assert [_labels(b) for b in f1] == [_labels(b) for b in resumed]


def test_index_rows_are_the_seeded_permutation():
    feed = _feed()
    for epoch in range(2):
        want = np.random.default_rng((0x5EED, epoch, 0)).permutation(N).reshape(N // BS, BS)
        np.testing.assert_array_equal(feed.index_rows(), want)
    assert feed.epoch == 2


def test_val_cache_exact_coverage_with_ragged_tail():
    feed = _feed(IndexValLoader(), is_train=False)
    assert len(feed) == 4  # 52 real samples padded to 64 = 4 batches of 16
    for _ in range(2):  # val sweeps are identical epoch to epoch
        seen, mask_total = [], 0.0
        for batch in feed:
            labs, mask = np.asarray(_labels(batch)), batch["mask"].numpy()
            mask_total += mask.sum()
            seen.extend(labs[mask > 0.5])
            assert (batch["label"][mask < 0.5] == 0).all(), "pads are all-zero one-hot rows"
        assert mask_total == 52.0
        assert sorted(seen) == list(range(52))


@pytest.mark.parametrize("fill_chunk_mb", [0, 1 / 1024.0, 256], ids=["monolithic", "chunk_1kb", "chunk_256mb"])
def test_train_cache_drops_masked_pad_rows(fill_chunk_mb):
    """A masked 3-tuple host loader feeding a train cache: its pad rows
    (validity 0, label -1) are dropped at fill, not cached."""
    feed = _feed(IndexValLoader(), is_train=True, fill_chunk_mb=fill_chunk_mb)
    seen = [lab for batch in feed for lab in _labels(batch)]
    assert feed._n_per_shard == 52 and len(seen) == 48  # 52 resident, 3 full batches a epoch
    assert len(set(seen)) == 48 and set(seen) <= set(range(52))


def _epoch_batches(feed):
    return [{k: v.numpy().copy() for k, v in b.items()} for b in feed]


@pytest.mark.parametrize("chunk_kb", [1, 4, 7, 1 << 18])  # many rounds, a few, ragged, one chunk
@pytest.mark.parametrize("split", ["train", "val"])
def test_chunked_fill_equals_monolithic(split, chunk_kb):
    """The chunked fill (a preallocated cache, one reused staging buffer)
    gives the monolithic fill's cache and batch streams, with carried
    remainders across rounds; val with its ragged tail and masks."""
    kw = dict(is_train=split == "train")
    host = IndexLoader if split == "train" else IndexValLoader
    mono = _feed(host(), fill_chunk_mb=0, **kw)
    chunk = _feed(host(), fill_chunk_mb=chunk_kb / 1024.0, **kw)
    assert len(mono) == len(chunk) and mono._n_per_shard == chunk._n_per_shard
    n = mono._n_per_shard
    assert torch.equal(mono.images[:n], chunk.images[:n]) and torch.equal(mono.labels[:n], chunk.labels[:n])
    if split == "val":
        assert torch.equal(mono._valid[:n], chunk._valid[:n])
    for _ in range(2):
        for a, b in zip(_epoch_batches(mono), _epoch_batches(chunk)):
            assert a.keys() == b.keys() == ({"image", "label"} if split == "train" else {"image", "label", "mask"})
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_labels_are_divided_at_fill_and_pads_stay_minus_one():
    feed = _feed(IndexValLoader(), aug=_identity, is_train=False, label_divisor=4)
    labels = torch.cat([b["label"] for b in feed]).tolist()
    assert labels[:52] == [i // 4 for i in range(52)] and labels[52:] == [-1] * 12


@pytest.mark.parametrize("fill_chunk_mb", [0, 256], ids=["monolithic", "chunked"])
def test_rejects_the_resample_split_and_an_empty_host(fill_chunk_mb):
    class Resample(IndexLoader):
        meta_kind = "resample"

    with pytest.raises(ValueError, match="device_resample"):
        _feed(Resample())
    with pytest.raises(ValueError, match="yielded no batches"):
        len(_feed(IndexLoader(n=0), fill_chunk_mb=fill_chunk_mb))


@pytest.mark.parametrize("fill_chunk_mb", [0, 256], ids=["monolithic", "chunked"])
def test_out_of_memory_names_the_cache_and_its_size(monkeypatch, fill_chunk_mb):
    """The fill never falls back to streaming: an allocation that runs out of
    card memory raises torch.cuda.OutOfMemoryError with the hint."""
    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(torch, "from_numpy" if fill_chunk_mb == 0 else "zeros", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="loader.device_cache does not fit: .*193 GB"):
        len(_feed(fill_chunk_mb=fill_chunk_mb))


def test_interleave_and_val_quota_match_jax():
    arr = np.arange(24 * 2).reshape(24, 2)
    for shards in (1, 3, 4):
        np.testing.assert_array_equal(DeviceCacheFeed._interleave(arr, shards), JDeviceCacheFeed._interleave(arr, shards))
    feed = _feed()
    for n_valid, shards in ((52, 1), (52, 4), (64, 1), (1, 2)):
        jax_quota = -(-(-(-n_valid // shards)) // BS) * BS  # device_cache.py:175-179 with bs_local = BS
        assert feed._val_n_per(n_valid, shards) == jax_quota


# --------------------------------------------------------------------------- #
# build_loader, Runner
# --------------------------------------------------------------------------- #


def _cfg(*overrides):
    base = ["loader.backend=synthetic", "val_loader.backend=synthetic", "loader.image_size=8", "loader.batch_size=16",
            "val_loader.batch_size=16", "loader.num_classes=10", "val_loader.num_classes=10"]
    return TC.load(TINY, overrides=[*base, *overrides], strict_env=False)


def test_build_loader_dispatches_to_cache():
    cfg = _cfg("loader.device_cache=true", "loader.fill_chunk_mb=1")
    feed = P.build_loader(cfg.loader, True, device="cpu", seed=5, out_dtype=torch.float32)
    assert isinstance(feed, DeviceCacheFeed) and feed.is_train and feed.fill_chunk_mb == 1.0
    batch = next(iter(feed))
    assert tuple(batch["image"].shape) == (16, 8, 8, 3) and batch["image"].dtype == torch.float32
    assert tuple(batch["label"].shape) == (16, 10)
    cfg = _cfg("val_loader.device_cache=true")
    val = P.build_loader(cfg.val_loader, False, device="cpu", out_dtype=torch.float32)
    assert isinstance(val, DeviceCacheFeed) and not val.is_train and set(next(iter(val))) == {"image", "label", "mask"}


def test_rectangular_val_cache_rejected():
    cfg = _cfg("val_loader.device_cache=true", "val_loader.rectangular=true")
    with pytest.raises(ValueError, match="rectangular"):
        P.build_loader(cfg.val_loader, False, device="cpu")


class RowsLoader(IndexLoader):
    """The rows the cache draws, streamed in the same order by a host loader:
    the permutation of (0x5EED, epoch, 0), re-derived here."""

    def __init__(self):
        super().__init__()
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        perm = np.random.default_rng((0x5EED, self.epoch, 0)).permutation(N)
        for b in range(len(self)):
            idx = perm[b * BS : (b + 1) * BS]
            yield np.broadcast_to(idx[:, None, None, None], (BS, SZ, SZ, 3)).astype(np.uint8).copy(), idx.astype(np.int32)


def _runner():
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train.loop import Runner

    torch.manual_seed(0)
    model = CModel(layer_config=[
        {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
        {"module": "ReLU"},
        {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
        {"module": "Linear", "args": [8, N]},
    ])
    runner = Runner(model, CrossEntropyLoss(smoothing=0.1),
                    lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters()),
                    lr_phases=[{"ep": (0, 2), "lr": (0.1, 0.1), "mode": "linear"}], input_dtype=torch.float32,
                    device="cpu")
    runner.init_state(seed=0)
    return runner


def test_runner_fit_through_the_cache_equals_fit_through_device_feed(monkeypatch):
    """Two epochs, a stochastic augment (erase, colour twist) from the same
    seeded generator: the weights and every metric come out the same."""
    from sota_imagenet_tpu_torch.train import loop

    def aug():
        return build_train_augment(num_classes=N, out_dtype=torch.float32, re_prob=0.5, color_twist_prob=0.5)

    logged = []
    monkeypatch.setattr(loop, "get_logger", lambda: type("Log", (), {"info": staticmethod(logged.append)}))
    cached, streamed = _runner(), _runner()
    tm_a, _ = cached.fit(_feed(aug=aug(), seed=3), epochs=2)
    assert logged == ["Device-cache input path: gather + augment on the device"]
    tm_b, _ = streamed.fit(P.DeviceFeed(RowsLoader(), aug(), device="cpu", seed=3), epochs=2)
    assert len(logged) == 1
    for a, b in zip(cached.state.model.state_dict().values(), streamed.state.model.state_dict().values()):
        assert torch.equal(a, b)
    for k in ("loss", "Acc@1", "grad_norm"):
        assert tm_a[k] == tm_b[k], k
    # the fill is reported with the fit's first epoch only
    assert "cache_fill_s" not in tm_a and "cache_mb" not in tm_a and "cache_fill_s" not in tm_b


def test_fill_time_and_size_land_in_the_first_epochs_metrics():
    runner = _runner()
    seen = []

    from sota_imagenet_tpu_torch.train.callbacks import Callback

    class Record(Callback):
        def on_epoch_end(self, epoch, train_metrics, val_metrics):
            seen.append(dict(train_metrics))

    runner.callbacks.append(Record())
    feed = _feed(aug=build_train_augment(num_classes=N, out_dtype=torch.float32))
    runner.fit(feed, epochs=2)
    assert seen[0]["cache_mb"] == feed.fill_mb == N * SZ * SZ * 3 / 1e6 and seen[0]["cache_fill_s"] == feed.fill_s
    assert "cache_mb" not in seen[1]


# --------------------------------------------------------------------------- #
# Against the JAX DeviceCacheFeed on one device
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1), ("data", "spatial", "model"))


def _jax_identity(key, images, labels):
    return {"image": images, "label": labels}


@pytest.mark.parametrize("fill_chunk_mb", [0, 2 / 1024.0], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_index_rows_and_gathered_batches_match_jax(mesh1, split, fill_chunk_mb):
    is_train = split == "train"
    host = IndexLoader if is_train else IndexValLoader
    port = _feed(host(), aug=_identity, is_train=is_train, fill_chunk_mb=fill_chunk_mb)
    ref = JDeviceCacheFeed(host(), mesh1, _jax_identity, is_train=is_train, fill_chunk_mb=fill_chunk_mb)
    assert len(port) == len(ref) and port._n_per_shard == ref._n_per_shard
    for _ in range(2):
        rows = port.index_rows()
        port.epoch -= is_train  # iterate the same epoch's rows once more
        jax_rows = [np.asarray(idx) for _, idx in ref.iter_stubs()]
        np.testing.assert_array_equal(rows, np.stack(jax_rows))
        ref.epoch -= is_train
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(rows)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            np.testing.assert_array_equal(g["image"].numpy(), np.asarray(w["image"]))
            np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))
            if not is_train:
                np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(w["mask"]))


def test_train_augment_of_a_gathered_batch_matches_pallas_with_the_jax_draws():
    """A batch gathered from the cache through the port's kernel wrapper (its
    plain version on the CPU) and through the interpreted Pallas kernel, both
    with the scalars JAX draws: one uint8 step at most, on at most 0.1% of
    the values (XLA:CPU's FMA at rounding ties, tests/test_torch_aug.py)."""
    kw = dict(color_twist_prob=0.4, gray_prob=0.2, re_prob=0.3, re_count=3)
    rng = np.random.default_rng(0)

    class Pixels(IndexLoader):
        def __iter__(self):
            for b in range(len(self)):
                yield rng.integers(0, 256, (BS, SZ, SZ, 3), np.uint8), np.arange(b * BS, (b + 1) * BS, dtype=np.int32)

    feed = _feed(Pixels(), aug=_identity)
    batch = next(iter(feed))
    imgs = batch["image"]
    assert imgs.is_contiguous() and imgs.dtype == torch.uint8
    scalars = np.array(jax_draw_scalars(jax.random.PRNGKey(3), BS, **kw))
    want = np.asarray(pallas_augment(jnp.asarray(imgs.numpy()), jnp.asarray(scalars), out_dtype=jnp.float32,
                                     interpret=True, **kw))
    got = fused_augment(imgs, torch.from_numpy(scalars), out_dtype=torch.float32, **kw).numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 / DATA_STD + 1e-3 and np.mean(diff > 0) <= 1e-3
