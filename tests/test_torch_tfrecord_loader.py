"""The TFRecord path of the port (``data/records.create_records``, the
``records tfrecord`` subcommand, ``data/pipeline.TFRecordLoader`` and the
``tfrecord`` backend) against the JAX package's (records.py:267-571), on a
small JPEG tree written from a seed (one PNG and one grayscale JPEG per
split: the PNG fails in the native core and is decoded with PIL).

* The shards and ``.idx`` files the port writes, through ``records
  tfrecord`` (its worker pool) and through ``create_records`` in one
  process, equal the JAX package's byte for byte.
* ``TFRecordLoader``'s train batches (host resize and device-resample
  canvases with their meta) over two epochs, and its val batches (the
  padded, masked tail), equal the JAX loader's bit for bit, with the native
  core and with PIL.
* ``cli.main`` on ``tiny_synthetic`` with ``loader.use_tfrecords=true``
  trains on the records and scores every val image once; an eval resumed
  from its ``model_last.ckpt`` reproduces its val metrics exactly.
* Two gloo ranks load, row for row, what one process loads.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sota_imagenet_tpu.data import native as jnative
from sota_imagenet_tpu.data import records as JR
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.data import native
from sota_imagenet_tpu_torch.data import pipeline as P
from sota_imagenet_tpu_torch.data import records as R
from sota_imagenet_tpu_torch.tools.ranks import run_ranks
from sota_imagenet_tpu_torch.train.callbacks import Callback

from test_torch_dist_workers import tfrecord_batches

TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_synthetic.yaml")
N_TRAIN, N_VAL, CLASSES, SHARDS = 30, 13, 3, (3, 2)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for split, n in (("train", N_TRAIN), ("val", N_VAL)):
        for i in range(n):
            d = root / split / f"class_{i % CLASSES}"
            os.makedirs(d, exist_ok=True)
            w, h = (int(v) for v in rng.integers(32, 97, 2))
            img = Image.fromarray(rng.integers(0, 256, (4, 5, 3), np.uint8)).resize((w, h), Image.BILINEAR)
            if i == 3:
                img.save(d / f"{i:03d}.png")
            elif i == 4:
                img.convert("L").save(d / f"{i:03d}.jpg", quality=90)
            else:
                img.save(d / f"{i:03d}.jpg", quality=90)
    return str(root)


@pytest.fixture(scope="module")
def records(tree, tmp_path_factory):
    """The JAX package's records of the tree (train in 3 shards, val in 2)."""
    out = str(tmp_path_factory.mktemp("jax_records"))
    JR.create_records(tree, out, train_shards=SHARDS[0], val_shards=SHARDS[1], workers=1)
    return out


def _files(root):
    return {os.path.relpath(p, root): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(root, "*", "*")))}


def test_create_records_is_byte_equal_to_jax(tree, records, tmp_path):
    R.create_records(tree, str(tmp_path / "one"), train_shards=SHARDS[0], val_shards=SHARDS[1], workers=1)
    want = _files(records)
    assert len(want) == 2 * sum(SHARDS) and _files(str(tmp_path / "one")) == want
    # the default shard counts through the subcommand, its worker pool writing them
    cli.records_main(["tfrecord", tree, "--out", str(tmp_path / "cli"), "--workers", "2"])
    JR.create_records(tree, str(tmp_path / "jax_default"), workers=1)
    got = _files(str(tmp_path / "cli"))
    assert len(got) == 2 * (R.TRAIN_SHARDS + R.VAL_SHARDS) and got == _files(str(tmp_path / "jax_default"))


@pytest.fixture(params=["pil", "native"])
def decoder(request, monkeypatch):
    if request.param == "native":
        if not native.available():
            pytest.skip("native/libimgpipe.so cannot be built here")
        assert jnative.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    return request.param


def _epochs(loader, epochs=2):
    out = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        out.append([tuple(np.asarray(a) for a in b) for b in loader])
    return out


def _assert_equal(got, want, resample):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g[1], w[1])
        if resample:
            np.testing.assert_array_equal(g[2], w[2])  # (sh, sw, filt)
            for img, jimg, (sh, sw, _) in zip(g[0], w[0], g[2]):
                # the native core leaves a canvas past its valid extent unwritten
                np.testing.assert_array_equal(img[:sh, :sw], jimg[:sh, :sw])
        else:
            np.testing.assert_array_equal(g[0], w[0])
            if len(g) > 2:
                np.testing.assert_array_equal(g[2], w[2])  # val mask


@pytest.mark.parametrize("mode", ["train", "device_resample", "val"])
def test_loader_batches_equal_jax(records, decoder, mode):
    is_train = mode != "val"
    kw = dict(is_train=is_train, batch_size=8 if is_train else 5, image_size=16, workers=2, random_interpolation=True,
              drop_last=is_train, device_resample=mode == "device_resample")
    port, ref = P.TFRecordLoader(records, **kw), JR.TFRecordLoader(records, **kw)
    assert len(port.entries) == len(ref.entries) == (N_TRAIN if is_train else N_VAL) and len(port) == len(ref)
    assert port.meta_kind == ref.meta_kind
    got, want = _epochs(port), _epochs(ref)
    for g, w in zip(got, want):
        _assert_equal(g, w, mode == "device_resample")
    if mode == "val":  # 13 images: two batches of 5 and a tail of 3 padded with the last, label -1
        assert [int(b[2].sum()) for b in got[0]] == [5, 5, 3] and list(got[0][-1][1][3:]) == [-1, -1]
    else:
        labels = [np.concatenate([b[1] for b in ep]) for ep in got]
        assert not np.array_equal(labels[0], labels[1]), "the shuffle changes with the epoch"


def _overrides(root):
    return ["loader.use_tfrecords=true", "val_loader.use_tfrecords=true", "loader.backend=auto",
            "val_loader.backend=auto", f"loader.root_data_dir={root}", f"val_loader.root_data_dir={root}",
            "loader.batch_size=8", "val_loader.batch_size=5", "loader.workers=2", "val_loader.workers=2",
            "log.tensorboard=false"]


class _Weights(Callback):
    """Each val pass's real sample count, read off its batches' masks."""

    def on_begin(self):
        self.per_pass = []

    def on_epoch_begin(self, epoch):
        self.per_pass.append(0.0)
        step = self.runner._eval_step_ema if self.runner.ema_decay else self.runner._eval_step
        if not getattr(step, "probed", False):
            def probed(state, batch, step=step):
                self.per_pass[-1] += float(batch["mask"].sum())
                return step(state, batch)

            probed.probed = True
            self.runner._eval_step = probed


def test_cli_trains_on_records_and_resumes_exactly(records, tmp_path):
    assert isinstance(P._build_host_loader(TC.load(TINY, overrides=_overrides(records)).loader, True), P.TFRecordLoader)
    probe = _Weights()
    val = cli.main(["-c", TINY, *_overrides(records), f"log.dir={tmp_path / 'train'}"], device="cpu", callbacks=[probe])
    assert all(math.isfinite(v) for v in val.values())
    assert probe.per_pass[-1] == N_VAL  # every record of val scored once, the padded tail masked
    (ckpt,) = glob.glob(os.path.join(tmp_path, "train", "*", "*", "model_last.ckpt"))
    again = cli.main(["-c", TINY, *_overrides(records), f"log.dir={tmp_path / 'eval'}", "run.evaluate=true",
                      f"run.resume={ckpt}"], device="cpu")
    assert again == val


@pytest.mark.parametrize("mode", ["train", "val"])
def test_two_ranks_load_what_one_process_loads(records, tmp_path, mode):
    is_train = mode == "train"
    args = (records, is_train, 8 if is_train else 6, 16, False)
    one = tfrecord_batches(*args)
    ranks = run_ranks(tfrecord_batches, 2, args, tmp_dir=str(tmp_path))
    for epoch in range(2):
        assert len(ranks[0][epoch]) == len(ranks[1][epoch]) == len(one[epoch])
        for b, want in enumerate(one[epoch]):
            for part in range(len(want)):
                got = np.concatenate([ranks[0][epoch][b][part], ranks[1][epoch][b][part]])
                np.testing.assert_array_equal(got, want[part], err_msg=f"epoch {epoch} batch {b} part {part}")
