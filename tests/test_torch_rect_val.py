"""Rectangular validation in the port (``RectValLoader``), the masked branch
of its eval step and the weighted mean of ``Runner.evaluate``, against the
JAX package's.

Exact: the three aspect buckets, the files in each, the batches, labels and
masks (every image once, each bucket's tail zero-padded), the per-process
shards, and the ``.rectval_wh.json`` sidecar, which each package reads from
the other. The masked eval step's Acc@1, Acc@5 and loss are within 1e-6 of
JAX's on the same weights and batch (both float32), with ``_weight`` exact,
an all-padding batch included; ``Runner.evaluate`` over the whole
rectangular val pass agrees with JAX's to the same 1e-6."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sota_imagenet_tpu.config import parse_stages as jax_parse_stages
from sota_imagenet_tpu.data import pipeline as JP
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.ops.augment import build_val_augment as jax_val_augment
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu.train.loop import Runner as JRunner
from sota_imagenet_tpu.train.schedule import phases_from_stages as jax_phases
from sota_imagenet_tpu_torch.data import pipeline as P
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.ops.augment import build_val_augment
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.loop import Runner, reduce_metrics
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

SHAPES = [(60, 100), (100, 60), (64, 64), (90, 70), (50, 120), (80, 80), (120, 50), (70, 90)] * 3
CLASSES = 10
LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, CLASSES]},
]


def _write_corpus(root):
    rng = np.random.default_rng(0)
    for c in range(CLASSES):
        os.makedirs(os.path.join(root, f"class_{c}"), exist_ok=True)
    for i, (h, w) in enumerate(SHAPES):
        img = Image.fromarray(rng.integers(0, 256, (4, 5, 3), np.uint8)).resize((w, h), Image.BILINEAR)
        stem = os.path.join(root, f"class_{i % CLASSES}", f"{i:03d}")
        if i == 3:
            img.save(stem + ".png")
        elif i == 4:
            img.convert("L").save(stem + ".jpg", quality=95)
        else:
            img.save(stem + ".jpg", quality=95)
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_corpus(tmp_path_factory.mktemp("rectval"))


@pytest.fixture()
def fresh_caches(monkeypatch):
    """Both packages' (path, mtime) -> (w, h) caches empty for this test."""
    monkeypatch.setattr(P.RectValLoader, "_WH_CACHE", {})
    monkeypatch.setattr(JP.RectValLoader, "_WH_CACHE", {})


def test_buckets_batches_and_masks_match_jax(corpus):
    port = P.RectValLoader(corpus, batch_size=4, image_size=32, workers=2)
    ref = JP.RectValLoader(corpus, batch_size=4, image_size=32, workers=2)
    assert port.buckets == ref.buckets
    assert port.by_bucket == ref.by_bucket and port.batches_per_bucket == ref.batches_per_bucket
    assert len(port) == len(ref)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(port)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert sum(int(m.sum()) for _, _, m in got) == len(SHAPES), "every image once"
    assert {b[0].shape[1:3] for b in got} == set(port.buckets.values()), "all three buckets are filled"


def test_process_shards_match_jax(corpus, monkeypatch):
    shards = []
    for pi in range(3):
        monkeypatch.setattr(P, "process_index", lambda pi=pi: pi)
        monkeypatch.setattr(P, "process_count", lambda: 3)
        monkeypatch.setattr(jax, "process_index", lambda pi=pi: pi)
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        port = P.RectValLoader(corpus, batch_size=2, image_size=32, workers=2)
        ref = JP.RectValLoader(corpus, batch_size=2, image_size=32, workers=2)
        assert port.my_bucket == ref.my_bucket and port.batches_per_bucket == ref.batches_per_bucket
        shards.append(port)
    assert len({len(s) for s in shards}) == 1, "every process runs the same number of batches"
    seen = sorted(f for s in shards for items in s.my_bucket.values() for f, _ in items)
    assert seen == sorted(shards[0].files)


def _sidecar(root):
    with open(os.path.join(root, ".rectval_wh.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_other_s_sidecar(tmp_path, fresh_caches, monkeypatch, writer):
    root = _write_corpus(tmp_path / "val")
    first, second = (P, JP) if writer == "port" else (JP, P)
    built = first.RectValLoader(root, batch_size=4, image_size=32, workers=2)
    table = _sidecar(root)
    assert set(table) == {os.path.relpath(f, root) for f in built.files}
    assert all(len(v) == 3 for v in table.values())  # [w, h, mtime]

    def no_header_reads(*a, **kw):
        raise AssertionError("the sidecar should have answered every (w, h)")

    monkeypatch.setattr(Image, "open", no_header_reads)
    other = second.RectValLoader(root, batch_size=4, image_size=32, workers=2)
    assert other.by_bucket == built.by_bucket
    monkeypatch.undo()
    P.RectValLoader._WH_CACHE.clear()
    JP.RectValLoader._WH_CACHE.clear()
    os.remove(os.path.join(root, ".rectval_wh.json"))
    second.RectValLoader(root, batch_size=4, image_size=32, workers=2)
    assert _sidecar(root) == table, "both packages write the same table"


def test_only_process_0_writes_the_sidecar(tmp_path, fresh_caches, monkeypatch):
    root = _write_corpus(tmp_path / "val")
    monkeypatch.setattr(P, "process_index", lambda: 1)
    monkeypatch.setattr(P, "process_count", lambda: 2)
    P.RectValLoader(root, batch_size=4, image_size=32, workers=2)
    assert not os.path.exists(os.path.join(root, ".rectval_wh.json"))


def test_a_replaced_file_is_read_again(tmp_path, fresh_caches):
    root = _write_corpus(tmp_path / "val")
    P.RectValLoader(root, batch_size=4, image_size=32, workers=2)
    path = os.path.join(root, "class_0", "000.jpg")  # (60, 100): wide
    Image.new("RGB", (40, 100)).save(path)
    os.utime(path, (1e9, 1e9))
    loader = P.RectValLoader(root, batch_size=4, image_size=32, workers=2)
    assert path in [f for f, _ in loader.by_bucket["tall"]]


# --------------------------------------------------------------------------- #
# The masked eval step and the weighted mean, against JAX on the same weights
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def models():
    jmodel = JCModel(layer_config=LAYERS)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), train=False)
    model = CModel(layer_config=LAYERS)
    model.load_state_dict(flax_to_torch_model(model, jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jmodel, variables, model


def _states(models):
    jmodel, variables, model = models
    jstate = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats={}, opt_state=None)
    state = steps.init_state(model, lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()), device="cpu")
    model.load_state_dict(flax_to_torch_model(model, jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jstate, state


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 0, 0, 0], [0] * 8, [1] * 8, [0, 1, 0, 1, 1, 0, 0, 1]],
                         ids=["tail", "all_padding", "full", "scattered"])
def test_masked_eval_step_matches_jax(models, mask):
    jstate, state = _states(models)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((8, 32, 40, 3)).astype(np.float32)
    labels = np.where(np.asarray(mask) > 0, rng.integers(0, CLASSES, 8), -1)
    onehot = np.array(jax.nn.one_hot(jnp.asarray(labels), CLASSES, dtype=jnp.float32))
    mask = np.asarray(mask, np.float32)
    crit = dict(smoothing=0.1)
    jm = jax.jit(jsteps.build_eval_step(models[0], JCrossEntropyLoss(**crit), input_dtype=jnp.float32))(
        jstate, {"image": jnp.asarray(images), "label": jnp.asarray(onehot), "mask": jnp.asarray(mask)}
    )
    tm = steps.build_eval_step(CrossEntropyLoss(**crit), input_dtype=torch.float32)(
        state, {"image": torch.from_numpy(images), "label": torch.from_numpy(onehot), "mask": torch.from_numpy(mask)}
    )
    assert set(tm) == set(jm) == {"loss", "Acc@1", "Acc@5", "_weight"}
    assert float(tm["_weight"]) == float(jm["_weight"]) == mask.sum()
    for k in ("loss", "Acc@1", "Acc@5"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, atol=1e-6, err_msg=k)
        assert np.isfinite(float(tm[k]))


def test_a_criterion_without_reduction_scores_the_full_batch(models):
    _, state = _states(models)

    def plain_ce(logits, target):
        return CrossEntropyLoss()(logits, target)

    images = torch.randn((4, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    labels = torch.eye(CLASSES)[torch.tensor([1, 2, 3, 4])]
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    m = steps.build_eval_step(plain_ce, input_dtype=torch.float32)(state, {"image": images, "label": labels, "mask": mask})
    full = steps.build_eval_step(plain_ce, input_dtype=torch.float32)(state, {"image": images, "label": labels})
    assert float(m["loss"]) == float(full["loss"]) and float(m["_weight"]) == 2.0


def test_reduce_metrics_weights_by_the_real_count():
    rows = [
        {"loss": torch.tensor(1.0), "Acc@1": torch.tensor(50.0), "_weight": torch.tensor(4.0)},
        {"loss": torch.tensor(3.0), "Acc@1": torch.tensor(100.0), "_weight": torch.tensor(1.0)},
        {"loss": torch.tensor(9.0), "Acc@1": torch.tensor(0.0), "_weight": torch.tensor(0.0)},  # all padding
    ]
    got = reduce_metrics(rows)
    assert got == {"loss": (4.0 + 3.0) / 5.0, "Acc@1": (200.0 + 100.0) / 5.0}
    assert reduce_metrics([rows[2]]) == {"loss": 0.0, "Acc@1": 0.0}, "an all-padding pass divides by max(0, 1)"
    assert reduce_metrics([{"loss": torch.tensor(1.0)}, {"loss": torch.tensor(2.0)}]) == {"loss": 1.5}


def test_runner_evaluate_over_rectangular_val_matches_jax(models, corpus, mesh8):
    jmodel, variables, model = models
    crit = dict(smoothing=0.1)
    jrunner = JRunner(
        jmodel, JCrossEntropyLoss(**crit), lambda sched: jax_build_optimizer({"_target_": "sgd"}, sched),
        lr_phases=jax_phases(jax_parse_stages([dict(start=0, end=1, lr=[0.1, 0.1])])), input_dtype=jnp.float32,
    )
    jrunner.init_state((8, 32, 32, 3))
    jrunner.state = jrunner.state.replace(params=variables["params"])
    runner = Runner(
        model, CrossEntropyLoss(**crit), lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()),
        lr_phases=[{"ep": (0, 1), "lr": (0.1, 0.1), "mode": "linear"}], input_dtype=torch.float32, device="cpu",
    )
    runner.init_state()
    model.load_state_dict(flax_to_torch_model(model, jax.tree_util.tree_map(np.asarray, variables["params"])))
    kw = dict(batch_size=8, image_size=32, workers=2)
    want = jrunner.evaluate(JP.DeviceFeed(JP.RectValLoader(corpus, **kw), mesh8,
                                          jax_val_augment(num_classes=CLASSES, out_dtype=jnp.float32)))
    got = runner.evaluate(P.DeviceFeed(P.RectValLoader(corpus, **kw),
                                       build_val_augment(num_classes=CLASSES, out_dtype=torch.float32), device="cpu"))
    assert set(got) == set(want) == {"loss", "Acc@1", "Acc@5"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
