"""``FixMatchLoss`` over several ranks (``losses/wrappers.py`` with
``parallel/mesh.global_rows``) against the JAX package's single-device step
on the global batch, in the manner of tests/test_torch_ddp_step.py: 2, 3 and 4
gloo ranks, ``accumulate_steps`` 1 and 2, float64, three steps of a global
batch of 24 at 8 px on a small CModel with sync-BN.

Global row i of each microbatch pairs with row i + half, which sits on
another rank (2 ranks: rank 0 with rank 1; 4 ranks: rank r with rank r + 2;
3 ranks: rank 1 holds rows of both halves). Loss and grad_norm within
``TRAJ_TOL`` of JAX's (1e-7, as the one-process float64 step is held); the
change of the weights within relative L2 ``TRAJ_TOL["state"]``; N ranks
against the port's one process within 1e-10, the loss metric one float32
rounding apart at most, and every rank's weights equal bit for bit.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.losses import FixMatchLoss as JFixMatchLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_legs, train_steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

from test_torch_train_step import TRAJ_TOL

N_STEPS, BATCH, SIZE, CLASSES, LR = 3, 24, 8, 10, 0.05
LAYERS = yaml.safe_load("""
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, BatchNorm2d, 8]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [8, 10]]
""")
SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
FIXMATCH = {"hard_weight": 0.5, "hard_pct": 0.2}
ACCUMULATE = (1, 2)


def _batches():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


@functools.lru_cache(maxsize=None)
def _jax_init():
    with jax.enable_x64(True):
        v = JCModel(layer_config=LAYERS).init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, v["params"]), jax.tree_util.tree_map(np.asarray, dict(v["batch_stats"]))


@functools.lru_cache(maxsize=None)
def _jax_run(accumulate):
    params0, stats0 = _jax_init()
    images, labels = _batches()
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        sched = lambda s: jnp.asarray(LR, jnp.float32)
        tx = jax_build_optimizer(SGD, sched)
        params, stats = f64(params0), f64(stats0)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params))
        step = jax.jit(jsteps.build_train_step(JCModel(layer_config=LAYERS), JFixMatchLoss(**FIXMATCH), tx, sched,
                                               accumulate_steps=accumulate, input_dtype=jnp.float64))
        metrics = []
        for i in range(N_STEPS):
            state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])},
                            jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        model = flax_to_torch_model(CModel(layer_config=copy.deepcopy(LAYERS)), host(state.params),
                                    host(state.batch_stats))
    return {"metrics": metrics, "model": {k: v.numpy() for k, v in model.items()}}


def _spec(accumulate):
    params, stats = _jax_init()
    init = flax_to_torch_model(CModel(layer_config=copy.deepcopy(LAYERS)), params, stats)
    return {
        "model": {"_target_": "CModel", "layer_config": LAYERS}, "init": {k: v.numpy().copy() for k, v in init.items()},
        "dtype": "float64", "optim": SGD, "lr": LR, "accumulate_steps": accumulate,
        "criterion": {"_target_": "FixMatchLoss", **FIXMATCH}, "batches": list(zip(*_batches())),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = [_spec(a) for a in ACCUMULATE]
    ranks = {world: run_ranks(train_legs, world, (specs,), tmp_dir=str(tmp_path_factory.mktemp(f"rdzv{world}")))
             for world in (2, 3, 4)}
    return {"spec": specs, "ranks": ranks, "one": [train_steps(s) for s in specs]}


def _rel_delta(got: dict, want: dict, init: dict) -> float:
    keys = [k for k in init if init[k].dtype.kind == "f"]
    err = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    ref = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    return (err / max(ref, 1e-300)) ** 0.5


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("accumulate", ACCUMULATE)
def test_fixmatch_over_ranks_matches_the_jax_step_on_the_global_batch(runs, world, accumulate):
    i = ACCUMULATE.index(accumulate)
    want, init = _jax_run(accumulate), runs["spec"][i]["init"]
    got = runs["ranks"][world][0][i]
    for s in range(N_STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][s][k], want["metrics"][s][k], rtol=TRAJ_TOL["loss"],
                                       err_msg=f"step {s} {k}")
    assert _rel_delta(got["model"], want["model"], init) < TRAJ_TOL["state"]
    assert _rel_delta(want["model"], init, {k: np.zeros_like(v) for k, v in init.items()}) > 1e-4  # it trained


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("accumulate", ACCUMULATE)
def test_fixmatch_over_ranks_equals_one_process(runs, world, accumulate):
    i = ACCUMULATE.index(accumulate)
    ranks, one, init = [r[i] for r in runs["ranks"][world]], runs["one"][i], runs["spec"][i]["init"]
    for r in ranks[1:]:
        for k, v in ranks[0]["model"].items():
            np.testing.assert_array_equal(r["model"][k], v, err_msg=k)
    assert _rel_delta(ranks[0]["model"], one["model"], init) < 1e-10
    for a, b in zip(ranks[0]["metrics"], one["metrics"]):
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-10)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2**-23)  # a float32 metric: one rounding apart at most
    assert ranks[0]["collectives"]["fixmatch"] == N_STEPS * accumulate  # one exchange a criterion call
