"""Spatial partitioning (``mesh.spatial``, ``parallel/spatial.py``) on gloo
ranks, against the JAX package's single-device step and against unsharded
torch, in float64.

* The partitioned ops on bands of H, four spatial ranks over an H of 13
  (bands of 3, 3, 3 and 4 rows; a 9x9 halo spans two ranks), against the
  unsharded op: ``conv2d`` for k in {1, 3, 5, 7, 9}, strides 1 and 2,
  dilation 2 and depthwise groups; max pooling (its -inf edge) and average
  pooling; a pad then a strided depthwise conv (BlurPool, zero and reflect
  pads); the mean over H and W; GroupNorm; BatchNorm's ``::2`` subsample.
  The output, and the gradients of sum(out * cotangent) for the input and
  the weight, within 1e-12 relative.
* The train step of JAX tests/test_spatial.py's model (a strided conv,
  BatchNorm, ReLU, a max pool, a conv, the global pool and a Dense head;
  SGD with momentum and weight decay, EMA 0.9; two steps of a global batch
  of 8 at 32 px) on data=1 x spatial=2 and data=2 x spatial=2 ranks: loss,
  grad_norm, the new weights, BatchNorm's buffers and the EMA against the
  JAX float64 step at ``TRAJ_TOL`` (1e-7 and 1e-6: the JAX float64 step
  keeps float32 scalars), against the port's one-process step within 1e-10
  relative, and every rank's state equal bit for bit.
  ``Conv1x1BNStats`` in train mode, stride 1 and 2 (its strided subsample
  rebalanced over the bands), through ``conv1x1_stats``'s plain version:
  its statistics are float32 sums, so within 1e-6.
* A CModel with a ConvActBlock's XCA (attention over every position): the
  spatial step gathers the full H (``spatial_gather``) and equals the
  one-process port step within 1e-7 (ScaledStdConv standardises in
  float32 even in a float64 net).
* Eval (JAX tests/test_spatial.py:117-127): a masked batch of rectangular
  64x48 images (a padded row) on data=1 x spatial=2, Acc@1 and Acc@5 equal
  to the one-process eval exactly and the loss within 1e-12; and a
  resnet18 forward at 64 px on two spatial ranks (JAX
  tests/test_spatial.py:130-148) against the JAX forward within 1e-10 and
  the one-process port within 1e-12.
* An op that mixes rows and that the mode does not know raises
  ``SpatialError`` naming it.
* ``cli.main`` on ``configs/exp/1.r50_baseline.yaml`` with ``mesh.spatial=2``
  (a small CModel at 128 px, the smallest size the extent guard takes): ten
  steps, a finite loss, both ranks' weights equal.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models import resnet18 as jresnet18
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch.config import instantiate
from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch, flax_to_torch_model

import test_torch_mesh_workers as W
from test_torch_train_step import TRAJ_TOL

N_STEPS, BATCH, SIZE, CLASSES, LR = 2, 8, 32, 10, 0.1
SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "MaxPool2d", "args": [2, 2]},
    {"module": "conv3x3", "args": [8, 8]},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]
XCA_LAYERS = [
    {"module": "ConvActBlock", "args": [3, 8], "kwargs": {"stride": 2, "attn_kwargs": {"num_heads": 2}}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]


def _ops():
    """(kind, x, w, kwargs, cotangent) of each partitioned op."""
    rng = np.random.default_rng(0)
    cases = []
    for kind, k, kw in [
        ("conv", 1, {}), ("conv", 1, dict(stride=2)), ("conv", 3, dict(padding=1)), ("conv", 3, dict(padding=1, stride=2)),
        ("conv", 5, dict(padding=2)), ("conv", 7, dict(padding=3, stride=2)), ("conv", 9, dict(padding=4)),
        ("conv", 3, dict(padding=2, dilation=2)), ("conv", 3, dict(padding=1, groups=4)),
        ("conv", 3, dict(padding=1, stride=2, groups=4)),
        ("max_pool", 1, dict(kernel_size=3, stride=2, padding=1)), ("avg_pool", 1, dict(kernel_size=2, stride=2)),
        ("avg_pool", 1, dict(kernel_size=3, stride=1, padding=1)), ("blur", 3, {}), ("blur", 3, dict(mode="reflect")),
        ("mean", 1, {}), ("group_norm", 1, {}), ("subsample", 1, {}), ("fused_stats", 1, {}),
        ("fused_stats", 1, dict(stride=2)),
    ]:
        x = rng.standard_normal((2, 4, 13, 11))
        groups = kw.get("groups", 1) if kind == "conv" else 4 if kind == "blur" else 1
        w = rng.standard_normal((8 if kind == "fused_stats" else 4, 4 // groups, k, k))
        cot = rng.standard_normal(tuple(W._op(kind, torch.from_numpy(x), torch.from_numpy(w), kw).shape))
        cases.append((kind, x, w, kw, cot))
    return cases


OPS = _ops()
OP_IDS = [f"{c[0]}{c[2].shape[-1]}-" + "-".join(f"{k}{v}" for k, v in c[3].items()) for c in OPS]


def _batches():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


@functools.lru_cache(maxsize=None)
def _jax_init():
    with jax.enable_x64(True):
        v = JCModel(layer_config=LAYERS).init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v["params"]), jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"]))


def _init_of(model_cfg, seed=0):
    model = instantiate(copy.deepcopy(model_cfg)) if isinstance(model_cfg, dict) else model_cfg()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: (v.double() if v.is_floating_point() else v).numpy().copy() for k, v in model.state_dict().items()}


def _spec(model_cfg, init, **kw):
    return {"model": model_cfg, "init": init, "dtype": "float64", "optim": SGD, "lr": LR, "ema_decay": 0.9,
            "criterion": {"_target_": "CrossEntropyLoss", "smoothing": 0.1}, "batches": list(zip(*_batches())), **kw}


def _jax_spec(**kw):
    params, stats = _jax_init()
    init = {k: v.numpy().copy() for k, v in flax_to_torch_model(instantiate({"_target_": "CModel", "layer_config": copy.deepcopy(LAYERS)}), params, stats).items()}
    return _spec({"_target_": "CModel", "layer_config": LAYERS}, init, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX single-device float64 step on the global batches: metrics, and the final weights, buffers and EMA."""
    params0, stats0 = _jax_init()
    images, labels = _batches()
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        sched = lambda s: jnp.asarray(LR, jnp.float32)
        tx = jax_build_optimizer(SGD, sched)
        params, stats = f64(params0), f64(stats0)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params), ema_params=params, ema_batch_stats=stats)
        step = jax.jit(jsteps.build_train_step(JCModel(layer_config=LAYERS), JCrossEntropyLoss(smoothing=0.1), tx, sched,
                                               ema_decay=0.9, input_dtype=jnp.float64))
        metrics = []
        for i in range(N_STEPS):
            state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])}, jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        model = instantiate({"_target_": "CModel", "layer_config": copy.deepcopy(LAYERS)})
        conv = lambda p, s: {k: v.numpy() for k, v in flax_to_torch_model(model, host(p), host(s)).items()}
        return {"metrics": metrics, "model": conv(state.params, state.batch_stats),
                "ema": conv(state.ema_params, state.ema_batch_stats)}


def _eval_specs():
    rng = np.random.default_rng(2)
    rect = {"image": rng.standard_normal((4, 64, 48, 3)), "label": np.eye(CLASSES)[rng.integers(0, CLASSES, 4)],
            "mask": np.array([1.0, 1.0, 1.0, 0.0])}
    r18 = {"_target_": "resnet18", "num_classes": CLASSES}
    return [
        {"model": {"_target_": "CModel", "layer_config": LAYERS}, "init": _jax_spec()["init"], "batch": rect, "spatial": 2},
        {"model": r18, "init": _r18_init(), "spatial": 2,
         "batch": {"image": _r18_images(), "label": np.eye(CLASSES)[[0, 1, 2, 3]]}},
    ]


@functools.lru_cache(maxsize=None)
def _r18_jax():
    model = jresnet18(num_classes=CLASSES)
    with jax.enable_x64(True):
        v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)), train=False)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        logits = model.apply(v, jnp.asarray(_r18_images()), train=False)
    return v, np.asarray(logits)


def _r18_images():
    return np.random.default_rng(3).standard_normal((4, 64, 64, 3))


def _r18_init():
    v, _ = _r18_jax()
    return {k: t.numpy().copy() for k, t in flax_to_torch(v["params"], v["batch_stats"], layers=(2, 2, 2, 2),
                                                          bottleneck=False).items()}


LEGS2 = {
    "spatial_2": lambda: _jax_spec(spatial=2),
    "xca_spatial_2": lambda: _spec({"_target_": "CModel", "layer_config": XCA_LAYERS},
                                   _init_of({"_target_": "CModel", "layer_config": XCA_LAYERS}), spatial=2),
}
LEGS4 = {"data_2_spatial_2": lambda: _jax_spec(spatial=2)}


CLI = ["-c", "configs/exp/1.r50_baseline.yaml", "loader.backend=synthetic", "val_loader.backend=synthetic",
       "model={_target_: CModel, layer_config: [[-1, 1, conv3x3, [3, 8], {stride: 2}], [-1, 1, BatchNorm2d, 8], "
       "[-1, 1, ReLU], [-1, 1, conv3x3, [8, 16], {stride: 2}], [-1, 1, BatchNorm2d, 16], "
       "[-1, 1, FastGlobalAvgPool2d, [], {flatten: true}], [-1, 1, Linear, [16, 1000]]]}", "loader.image_size=128",
       "val_loader.image_size=128", "loader.batch_size=2", "val_loader.batch_size=2", "run.bf16=false", "debug=true",
       "log.tensorboard=false", "run.stages=[{start: 0, end: 1, lr: [0.01, 0.0]}]", "mesh.spatial=2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks (the data=1 x spatial=2 legs, the evals, the CLI)
    and one of four (the ops over four bands, the data=2 x spatial=2 leg)."""
    tmp = tmp_path_factory.mktemp("rdzv")
    two_specs = {n: f() for n, f in LEGS2.items()}
    four_specs = {n: f() for n, f in LEGS4.items()}
    evals = _eval_specs()
    cli = CLI + [f"log.dir={tmp / 'logs'}"]
    two = run_ranks(W.suite, 2, ([], list(two_specs.values()), evals, cli), tmp_dir=str(tmp))
    four = run_ranks(W.suite, 4, (OPS, list(four_specs.values()), []), tmp_dir=str(tmp))
    return {
        "spec": {**two_specs, **four_specs},
        "ranks": {**{n: [r["legs"][i] for r in two] for i, n in enumerate(two_specs)},
                  **{n: [r["legs"][i] for r in four] for i, n in enumerate(four_specs)}},
        "one": {n: train_steps(s) for n, s in {**two_specs, "data_2_spatial_2": four_specs["data_2_spatial_2"]}.items()},
        "ops": four[0]["ops"], "evals": [r["evals"] for r in two], "eval_specs": evals,
        "unhandled": two[0]["unhandled"], "cli": [r["cli"] for r in two],
    }


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _rel_delta(got: dict, want: dict, init: dict) -> float:
    keys = [k for k in init if init[k].dtype.kind == "f"]
    err = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    ref = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    return (err / max(ref, 1e-300)) ** 0.5


@pytest.mark.parametrize("i", range(len(OPS)), ids=OP_IDS)
def test_partitioned_op_equals_the_unsharded_op(runs, i):
    kind, x, w, kw, cot = OPS[i]
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    y = W._op(kind, xt, wt, kw)
    (y * torch.from_numpy(cot)).sum().backward()
    got = runs["ops"][i]
    tol = 1e-6 if kind == "fused_stats" else 1e-12  # float32 sums, summed band by band
    assert _rel(got["y"], y.detach().numpy()) < tol
    assert _rel(got["dx"], xt.grad.numpy()) < tol
    if wt.grad is not None:
        assert _rel(got["dw"], wt.grad.numpy()) < tol


@pytest.mark.parametrize("name", ["spatial_2", "data_2_spatial_2"])
def test_spatial_step_matches_the_jax_step(runs, name):
    want = _jax_run()
    got = runs["ranks"][name][0]
    init = runs["spec"][name]["init"]
    for i in range(N_STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=TRAJ_TOL["loss"], err_msg=f"{i} {k}")
    assert _rel_delta(got["model"], want["model"], init) < TRAJ_TOL["state"]
    assert _rel_delta(got["ema"], want["ema"], init) < TRAJ_TOL["state"]
    buffers = [k for k in init if "running" in k]
    assert buffers and all(_rel(got["model"][k], want["model"][k]) < TRAJ_TOL["state"] for k in buffers)
    assert got["collectives"].get("halo") and got["collectives"].get("bn")


@pytest.mark.parametrize("name", list(LEGS2) + list(LEGS4))
def test_spatial_step_equals_one_process_and_every_rank_agrees(runs, name):
    ranks, one = runs["ranks"][name], runs["one"][name]
    init = runs["spec"][name]["init"]
    for r in ranks[1:]:
        for k, v in ranks[0]["model"].items():
            np.testing.assert_array_equal(r["model"][k], v, err_msg=k)
    # ScaledStdConv standardises its kernel in float32 even in a float64 net (as the JAX one), so the XCA trunk's
    # two runs agree to float32's noise; the others to float64's
    tol = 1e-7 if name.startswith("xca") else 1e-10
    assert _rel_delta(ranks[0]["model"], one["model"], init) < tol
    assert _rel_delta(ranks[0]["ema"], one["ema"], init) < tol
    for a, b in zip(ranks[0]["metrics"], one["metrics"]):
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=tol)
    if name.startswith("xca"):
        assert ranks[0]["collectives"].get("spatial_gather")
    else:
        assert not ranks[0]["collectives"].get("spatial_gather")


def test_masked_rectangular_eval_equals_one_process(runs):
    spec = runs["eval_specs"][0]
    want = W.evaluate({**spec, "spatial": 1})
    for r in runs["evals"]:
        got = r[0]["metrics"]
        assert got["Acc@1"] == want["metrics"]["Acc@1"] and got["Acc@5"] == want["metrics"]["Acc@5"]
        assert got["_weight"] == want["metrics"]["_weight"] == 3.0
        np.testing.assert_allclose(got["loss"], want["metrics"]["loss"], rtol=1e-12)
        assert _rel(r[0]["logits"], want["logits"]) < 1e-12


def test_resnet18_forward_matches_jax_and_one_process(runs):
    _, jax_logits = _r18_jax()
    want = W.evaluate({**runs["eval_specs"][1], "spatial": 1})
    for r in runs["evals"]:
        assert _rel(r[1]["logits"], jax_logits) < 1e-10
        assert _rel(r[1]["logits"], want["logits"]) < 1e-12


def test_an_op_the_mode_does_not_know_raises(runs):
    assert "cannot partition cumsum" in runs["unhandled"]


def test_cli_trains_r50_baseline_on_spatial_ranks(runs):
    r0, r1 = runs["cli"]
    assert np.isfinite(r0["val"]["loss"]) and r0["val"] == r1["val"]
    for k, v in r0["model"].items():
        np.testing.assert_array_equal(r1["model"][k], v, err_msg=k)
