"""Head tensor parallelism (``mesh.model``, ``parallel/tp.py``) on gloo ranks,
against the JAX package's single-device step, in float64.

* The spec rules, case for case (JAX tests/test_tp.py:58-75): the port's
  ``shard_axes`` and the JAX ``tp_sharding`` agree on every leaf of the JAX
  test's tree, and on a fused-statistics ResNet-50 only ``fc`` is sharded
  (its ``fconv1``/``fconv3`` do not match ``fc``), read off the weights plan.
* The TP step (JAX tests/test_tp.py:78-115): a resnet18 cut to one block a
  stage at 32 px, SGD with
  momentum and weight decay, EMA 0.9, two steps of a global batch of 8, on
  data=1 x model=2 and data=2 x model=2 ranks: loss, grad_norm, the new
  weights and the EMA against the JAX float64 step at ``TRAJ_TOL`` (the JAX
  float64 step keeps float32 scalars), and against the one-process port
  within 1e-10; every rank holds its 500 classes of ``fc`` and the same
  whole model.
* TP composed with ZeRO-1 (JAX tests/test_tp.py:30-56): data=2 x model=2
  with ``mesh.zero1`` equals the run without it bit for bit, and its
  optimizer state dict holds the whole head.
* A sphere head under TP: a CModel with a ``SphereLinearLayer`` (its class
  dim sharded through ``mesh.tp_params``) trained with AdaCos, whose batch
  terms read the gathered cosines: against the JAX step at the sphere
  heads' tolerances (tests/test_torch_ddp_step.py) and AdaCos's state too.
* LAMB's per-layer trust ratios over a sharded head: equal to the
  one-process port within 1e-10 (the norms summed over the model ranks).
* A checkpoint of a TP run through ``cli.main`` (``1.r50_baseline.yaml``,
  ``mesh.model=2``) holds the whole head, and one process without TP
  evaluates it to the TP run's final val metrics.
"""

import copy
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.losses import AdaCos as JAdaCos
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.resnet import BasicBlock as JBasicBlock
from sota_imagenet_tpu.models.resnet import ResNet as JResNet
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sota_imagenet_tpu.parallel.mesh import tp_sharding
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.config import instantiate
from sota_imagenet_tpu_torch.models.resnet import resnet50
from sota_imagenet_tpu_torch.parallel import tp
from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_legs, train_steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch, flax_to_torch_model

import test_torch_mesh_workers as W
from test_torch_ddp_step import ADACOS, ADACOS_TOL
from test_torch_train_step import TRAJ_TOL

N_STEPS, BATCH, SIZE, CLASSES, LR = 2, 8, 32, 10, 0.1
SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
SPHERE = yaml.safe_load("""
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, BatchNorm2d, 8]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, SphereLinearLayer, [8, 10]]
""")


def test_tp_spec_rules():
    tree = {
        "fc": {"kernel": (16, 1000), "bias": (1000,)},
        "conv": {"kernel": (3, 3, 8, 1000)},  # no pattern match
        "head": {"kernel": (16, 10)},  # 10 % 4 != 0 -> replicated
        "fconv3": {"kernel": (1, 1, 8, 1000)},  # a component, not a substring: not 'fc'
        "head_fc1": {"kernel": (16, 1000)},
    }
    leaves = {f"{m}/{k}": s for m, d in tree.items() for k, s in d.items()}
    got = tp.shard_axes(leaves, 4)
    assert got == {"fc/kernel": 1, "fc/bias": 0, "conv/kernel": None, "head/kernel": None, "fconv3/kernel": None,
                   "head_fc1/kernel": 1}
    jax_specs = tp_sharding(jax_create_mesh(data=2, model=4), jax.tree_util.tree_map(jnp.zeros, tree,
                                                                                      is_leaf=lambda t: isinstance(t, tuple)))
    for path, axis in got.items():
        m, k = path.split("/")
        spec = tuple(jax_specs[m][k].spec)
        assert (axis is not None) == ("model" in spec), path
        if axis is not None:
            assert spec[axis] == "model", path
    assert tp.shard_axes(leaves, 1) == {p: None for p in leaves}  # one model rank: nothing sharded
    assert tp.shard_axes({"Dense_0/kernel": (4, 8)}, 2, ["dense"]) == {"Dense_0/kernel": 1}  # mesh.tp_params


def test_only_the_head_of_a_fused_resnet50_is_sharded():
    with torch.device("meta"):
        model = resnet50(fused_stats=True)
    assert tp.tp_spec(model, 2) == {"fc.weight": 0, "fc.bias": 0}
    assert tp.tp_spec(model, 3) == {}  # 1000 classes do not split in 3


def _batches():
    rng = np.random.default_rng(0)
    return rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3)), np.eye(CLASSES)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]


@functools.lru_cache(maxsize=None)
def _r18_init():
    model = JResNet(block=JBasicBlock, layers=(1, 1, 1, 1), num_classes=CLASSES)
    with jax.enable_x64(True):
        v = model.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v["params"]), jax.tree_util.tree_map(np.asarray, v["batch_stats"])


@functools.lru_cache(maxsize=None)
def _sphere_init():
    with jax.enable_x64(True):
        v = JCModel(layer_config=SPHERE).init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v["params"]), jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"]))


def _r18_torch(params, stats):
    return {k: v.numpy().copy() for k, v in flax_to_torch(params, stats, layers=(1, 1, 1, 1), bottleneck=False).items()}


def _sphere_torch(params, stats):
    model = instantiate({"_target_": "CModel", "layer_config": copy.deepcopy(SPHERE)})
    return {k: v.numpy().copy() for k, v in flax_to_torch_model(model, params, stats).items()}


def _spec(kind, **kw):
    sphere = kind == "sphere"
    params, stats = (_sphere_init if sphere else _r18_init)()
    return {"model": {"_target_": "CModel", "layer_config": SPHERE} if sphere else W.resnet10,
            "init": (_sphere_torch if sphere else _r18_torch)(params, stats), "dtype": "float64", "optim": SGD,
            "lr": LR, "ema_decay": 0.0 if sphere else 0.9, "batches": list(zip(*_batches())),
            "criterion": {"_target_": "adacos", **ADACOS} if sphere else {"_target_": "CrossEntropyLoss", "smoothing": 0.1},
            **kw}


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    sphere = kind == "sphere"
    params0, stats0 = (_sphere_init if sphere else _r18_init)()
    images, labels = _batches()
    ema = 0.0 if sphere else 0.9
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        sched = lambda s: jnp.asarray(LR, jnp.float32)
        tx = jax_build_optimizer(SGD, sched)
        params, stats = f64(params0), f64(stats0)
        crit = JAdaCos(**ADACOS) if sphere else JCrossEntropyLoss(smoothing=0.1)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                                  ema_params=params if ema else None, ema_batch_stats=stats if ema else None,
                                  loss_state=crit.init_state() if sphere else None)
        model = JCModel(layer_config=SPHERE) if sphere else JResNet(block=JBasicBlock, layers=(1, 1, 1, 1), num_classes=CLASSES)
        step = jax.jit(jsteps.build_train_step(model, crit, tx, sched, ema_decay=ema, input_dtype=jnp.float64))
        metrics = []
        for i in range(N_STEPS):
            state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])}, jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        conv = _sphere_torch if sphere else _r18_torch
        return {"metrics": metrics, "model": conv(host(state.params), host(state.batch_stats)),
                "ema": conv(host(state.ema_params), host(state.ema_batch_stats)) if ema else None,
                "loss_state": {k: float(v) for k, v in state.loss_state.items()} if sphere else None}


LEGS2 = {
    "model_2": lambda: _spec("r18", model_axis=2),
    "sphere_model_2": lambda: _spec("sphere", model_axis=2, tp_params=["SphereLinearLayer"]),
    "lamb_model_2": lambda: _spec("r18", model_axis=2, optim={"_target_": "lamb", "weight_decay": 1e-2}),
}
LEGS4 = {
    "data_2_model_2": lambda: _spec("r18", model_axis=2),
    "data_2_model_2_zero1": lambda: _spec("r18", model_axis=2, zero1=True),
}
CLI = ["-c", "configs/exp/1.r50_baseline.yaml", "loader.backend=synthetic", "val_loader.backend=synthetic",
       "model={_target_: resnet18}", "loader.image_size=32", "val_loader.image_size=32", "loader.batch_size=4",
       "val_loader.batch_size=4", "run.bf16=false", "debug=true", "log.tensorboard=false", "log.save_optim=true",
       "run.stages=[{start: 0, end: 1, lr: [0.01, 0.0]}]"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rdzv")
    two_specs = {n: f() for n, f in LEGS2.items()}
    four_specs = {n: f() for n, f in LEGS4.items()}
    argv = CLI + [f"log.dir={tmp / 'logs'}", "mesh.model=2"]
    two = run_ranks(W.cli_then_legs, 2, (argv, list(two_specs.values())), tmp_dir=str(tmp))
    four = run_ranks(train_legs, 4, (list(four_specs.values()),), tmp_dir=str(tmp))
    return {
        "spec": {**two_specs, **four_specs},
        "ranks": {**{n: [r["legs"][i] for r in two] for i, n in enumerate(two_specs)},
                  **{n: [r[i] for r in four] for i, n in enumerate(four_specs)}},
        "one": {n: train_steps({**s, "model_axis": 1}) for n, s in {**two_specs, "data_2_model_2": four_specs["data_2_model_2"]}.items()},
        "cli": [r["cli"] for r in two], "log_dir": str(tmp / "logs"),
    }


def _rel_delta(got: dict, want: dict, init: dict) -> float:
    keys = [k for k in init if init[k].dtype.kind == "f"]
    err = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    ref = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    return (err / max(ref, 1e-300)) ** 0.5


@pytest.mark.parametrize("name", ["model_2", "data_2_model_2", "sphere_model_2"])
def test_tp_step_matches_the_jax_step(runs, name):
    sphere = name.startswith("sphere")
    want = _jax_run("sphere" if sphere else "r18")
    got = runs["ranks"][name][0]
    init = runs["spec"][name]["init"]
    tol = ({"loss": ADACOS_TOL["loss"], "grad_norm": ADACOS_TOL["grad_norm"], "state": ADACOS_TOL["weights"]} if sphere
           else {"loss": TRAJ_TOL["loss"], "grad_norm": TRAJ_TOL["loss"], "state": TRAJ_TOL["state"]})
    for i in range(N_STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=tol[k], err_msg=f"{i} {k}")
    assert _rel_delta(got["model"], want["model"], init) < tol["state"]
    if want["ema"] is not None:
        assert _rel_delta(got["ema"], want["ema"], init) < tol["state"]
    if sphere:
        for k, v in want["loss_state"].items():
            np.testing.assert_allclose(float(got["loss_state"][k]), v, rtol=ADACOS_TOL["state"], err_msg=k)
        assert got["shards"] == {"layers.3.0.weight": [1, 10]}
    else:
        assert got["shards"] == {"fc.weight": [0, CLASSES], "fc.bias": [0, CLASSES]}
        assert got["bytes"]["fc.weight"] == 5 * 512 * 8  # this rank's 5 classes of 10, float64
    assert got["collectives"].get("tp_gather") and got["collectives"].get("tp_reduce")


@pytest.mark.parametrize("name", ["model_2", "data_2_model_2", "sphere_model_2", "lamb_model_2"])
def test_tp_step_equals_one_process_and_every_rank_agrees(runs, name):
    ranks, one = runs["ranks"][name], runs["one"][name]
    init = runs["spec"][name]["init"]
    for r in ranks[1:]:
        for k, v in ranks[0]["model"].items():
            np.testing.assert_array_equal(r["model"][k], v, err_msg=k)
    tol = 1e-7 if name.startswith("sphere") else 1e-10  # the sphere head's cosines are float32
    assert _rel_delta(ranks[0]["model"], one["model"], init) < tol
    for a, b in zip(ranks[0]["metrics"], one["metrics"]):
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=tol)


def test_tp_composes_with_zero1_bit_for_bit(runs):
    sharded, replicated = runs["ranks"]["data_2_model_2_zero1"], runs["ranks"]["data_2_model_2"]
    for r in range(4):
        for k, v in replicated[r]["model"].items():
            np.testing.assert_array_equal(sharded[r]["model"][k], v, err_msg=k)
    mom = sharded[0]["optimizer"]["state"]
    assert any(np.shape(st.get("momentum_buffer")) == (CLASSES, 512) for st in mom.values())
    assert sharded[0]["collectives"].get("params") and not replicated[0]["collectives"].get("params")


def test_a_tp_checkpoint_resumes_without_tp(runs):
    r0, r1 = runs["cli"]
    assert r0["val"] == r1["val"] and np.isfinite(r0["val"]["loss"])
    ckpt = sorted(glob.glob(os.path.join(runs["log_dir"], "*", "*", "model_last.ckpt")))[-1]
    disk = torch.load(ckpt, map_location="cpu", weights_only=True)["state"]
    assert disk["model"]["fc.weight"].shape == (1000, 512)
    assert disk["optimizer"]["state"][max(disk["optimizer"]["state"])]["momentum_buffer"].shape[0] == 1000
    run_dir = os.path.dirname(ckpt)
    metrics = cli.main(CLI + [f"log.dir={runs['log_dir']}_eval", "run.evaluate=true", f"run.resume={ckpt}"], device="cpu")
    assert metrics == r0["val"], (metrics, r0["val"], run_dir)
