"""The port's train step on two gloo ranks, in float64, against the JAX
package's single-device step on the global batch (what the JAX mesh
computes: its step runs on a global array sharded over ``data``) and against
the port's own step in one process.

Each leg takes three steps of a global batch of 16 (8 rows a rank) at 8 px,
from the JAX model's initial weights:

  * ``bn_global_ema_cutmix``: a small CModel with BatchNorm, ABN, a
    PreBasicBlock of EstimatedABNs and VarEMA (use: true), sync-BN, EMA 0.9,
    and CutmixMixup on the JAX step's own draws (the partner of global row i
    is global row 15-i, on the other rank);
  * ``bn_local``: ``run.bn_stats=local`` over the two ranks (the JAX step with
    ``set_bn_stats_groups(2)`` on one device);
  * ``bn_4_accumulate_2``: 4 statistics groups and two microbatches (each
    rank takes its half of each of the JAX step's microbatches);
  * ``sam_accumulate_2``: unit-wise SAM and two microbatches: the gradients
    are averaged after each pass, so the perturbation reads the global one;
  * ``adacos``: a sphere head with its projector's BatchNorm
    (SphereMLPLayer) and AdaCos, whose B and median are the global batch's;
  * ``zero1_adai`` and ``zero1_adais``: ZeRO-1 under Adai and AdaiS, whose
    means over every parameter are summed over the shards.

Tolerances: loss and grad_norm rtol 1e-7 at each step, the change of the
weights, buffers and EMA over the three steps within relative L2 1e-6:
``TRAJ_TOL`` of tests/test_torch_train_step.py, which holds the one-process
float64 step to the JAX one. The sphere head's cosines are float32 in both
packages, so ``adacos`` takes tests/test_torch_adacos_step.py's tolerances
(loss and AdaCos's state rtol 1e-5, grad_norm 1e-4, the weights 1e-4), and
AdaiS keeps float32 second moments, whose mean the shards sum in another
order: its weights within 1e-6 of JAX's. The two-rank step equals the
one-process port step within relative L2 1e-10, with both ranks' states
equal bit for bit; ``adacos`` (float32 cosines) and ``zero1_adais`` (the
float32 mean summed as two shards' partial sums; 1.1e-8 measured on the
CPU) within 1e-7.

ZeRO-1 under SGD (the first leg's options), AdamW and Lookahead(SGD) equals
the replicated two-rank run bit for bit (JAX tests/test_zero1.py:47), and a
ZeRO-1 optimizer's state dict is the unsharded one's: its keys, shapes and
dtypes are those of the replicated run's optimizer.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.losses import AdaCos as JAdaCos
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models import norms as jnorms
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_legs, train_steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

from test_torch_train_step import TRAJ_TOL

N_STEPS, BATCH, SIZE, CLASSES, LR = 3, 16, 8, 10, 0.05
BN_LAYERS = yaml.safe_load("""
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, BatchNorm2d, 8]
- [-1, 1, ABN, 8]
- [-1, 1, PreBasicBlock, [8, 8], {norm_layer: estimated_abn}]
- [-1, 1, VarEMA, [], {use: true}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [8, 10]]
""")
SPHERE_LAYERS = yaml.safe_load("""
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, BatchNorm2d, 8]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, SphereMLPLayer, [8, 10], {hidden_size: 16}]
""")
SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
MIX = dict(cutmix_alpha=1.0, mixup_alpha=0.2, prob=1.0)
SAM = {"kind": "asam_unitwise", "rho": 0.05, "eta": 0.01, "bn_from_perturbed": True}
ADACOS = {"margin": 0.0, "max_s": 20}
LEGS = {
    "bn_global_ema_cutmix": dict(ema_decay=0.9, mixup=True),
    "bn_local": dict(bn_stats=2),
    "bn_4_accumulate_2": dict(bn_stats=4, accumulate_steps=2),
    "sam_accumulate_2": dict(accumulate_steps=2, sam=SAM),
    "adacos": dict(layers=SPHERE_LAYERS),
    "zero1_adai": dict(zero1=True, optim={"_target_": "adai", "weight_decay": 1e-4}),
    "zero1_adais": dict(zero1=True, optim={"_target_": "adais", "weight_decay": 1e-4}),
}
# ZeRO-1 against the replicated run, port only: the options of each pair (SGD's replicated side is the first leg)
ZERO_PAIRS = {
    "sgd": dict(ema_decay=0.9, mixup=True),
    "adamw": dict(optim={"_target_": "adamw", "weight_decay": 1e-2}),
    "lookahead_sgd": dict(optim={**SGD, "lookahead": True, "lookahead_k": 2}),
}
ADACOS_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "state": 1e-5, "weights": 1e-4}


def _batches():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


def _jax_draws(run_key):
    """The cutmix/mixup values the JAX step draws at each step (steps.py:258-259 and :66), in float64 as it does."""
    out = []
    for i in range(N_STEPS):
        with jax.enable_x64(True):
            out.append(_jax_draw(run_key, i))
    return out


def _jax_draw(run_key, i):
    """The values of step ``i``."""
    k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, i), 3)
    k_apply, k_choice, k_lam_m, k_lam_c, k_box = jax.random.split(k_mix, 5)
    return {
        "apply": np.array(jax.random.bernoulli(k_apply, MIX["prob"])),
        "use_cutmix": np.array(jax.random.bernoulli(k_choice, 0.5)),
        "lam_m": np.array(jax.random.beta(k_lam_m, MIX["mixup_alpha"], MIX["mixup_alpha"])),
        "lam_c": np.array(jax.random.beta(k_lam_c, MIX["cutmix_alpha"], MIX["cutmix_alpha"])),
        "cy": np.array(jax.random.randint(k_box, (), 0, SIZE)),
        "cx": np.array(jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, SIZE)),
    }


def _options(name):
    leg = {**LEGS, **{f"zero1_{k}": {**v, "zero1": True} for k, v in ZERO_PAIRS.items()},
           **{f"replicated_{k}": v for k, v in ZERO_PAIRS.items()}}[name]
    return {"layers": BN_LAYERS, "optim": SGD, "bn_stats": 1, "accumulate_steps": 1, "ema_decay": 0.0,
            "mixup": False, "sam": None, "zero1": False, **leg}


@functools.lru_cache(maxsize=None)
def _jax_init(layers_key: str):
    layers = yaml.safe_load(layers_key)
    with jax.enable_x64(True):
        variables = JCModel(layer_config=layers).init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    return (jax.tree_util.tree_map(np.asarray, variables["params"]),
            jax.tree_util.tree_map(np.asarray, dict(variables.get("batch_stats", {}))))


def _port_model(layers):
    return CModel(layer_config=copy.deepcopy(layers))


def _spec(name):
    o = _options(name)
    params, stats = _jax_init(yaml.safe_dump(o["layers"]))
    model = _port_model(o["layers"])
    init = {k: v.numpy().copy() for k, v in flax_to_torch_model(model, params, stats).items()}
    sphere = o["layers"] is SPHERE_LAYERS
    return {
        "model": {"_target_": "CModel", "layer_config": o["layers"]}, "init": init, "dtype": "float64",
        "optim": o["optim"], "zero1": o["zero1"], "lr": LR, "accumulate_steps": o["accumulate_steps"],
        "ema_decay": o["ema_decay"], "sam": o["sam"], "bn_stats": o["bn_stats"],
        "criterion": {"_target_": "adacos", **ADACOS} if sphere else {"_target_": "CrossEntropyLoss", "smoothing": 0.1},
        "mixup": {**MIX, "draws": _jax_draws(jax.random.PRNGKey(1))} if o["mixup"] else None,
        "batches": list(zip(*_batches())),
    }


def _jax_run(name):
    """The JAX single-device step on the global batches: per-step metrics, and the final
    weights, buffers, EMA and criterion state in the port's layout."""
    o = _options(name)
    params0, stats0 = _jax_init(yaml.safe_dump(o["layers"]))
    sphere = o["layers"] is SPHERE_LAYERS
    images, labels = _batches()
    jnorms.set_bn_stats_groups(o["bn_stats"])
    try:
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
            jmodel = JCModel(layer_config=o["layers"])
            sched = lambda s: jnp.asarray(LR, jnp.float32)
            tx = jax_build_optimizer(o["optim"], sched)
            params, stats = f64(params0), f64(stats0)
            crit = JAdaCos(**ADACOS) if sphere else JCrossEntropyLoss(smoothing=0.1)
            ema = o["ema_decay"]
            state = jsteps.TrainState(
                step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                ema_params=params if ema else None, ema_batch_stats=stats if ema else None,
                loss_state=crit.init_state() if sphere else None,
            )
            mixup_fn = functools.partial(jsteps.cutmix_mixup, **MIX) if o["mixup"] else None
            step = jax.jit(jsteps.build_train_step(
                jmodel, crit, tx, sched, accumulate_steps=o["accumulate_steps"], ema_decay=ema, mixup_fn=mixup_fn,
                sam=o["sam"], input_dtype=jnp.float64,
            ))
            metrics = []
            for i in range(N_STEPS):
                state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])},
                                jax.random.PRNGKey(1))
                metrics.append({k: float(v) for k, v in m.items()})
            host = lambda t: jax.tree_util.tree_map(np.asarray, t)
            model = _port_model(o["layers"])
            out = {"metrics": metrics, "model": flax_to_torch_model(model, host(state.params), host(state.batch_stats))}
            out["ema"] = flax_to_torch_model(model, host(state.ema_params), host(state.ema_batch_stats)) if ema else None
            out["loss_state"] = {k: float(v) for k, v in state.loss_state.items()} if sphere else None
    finally:
        jnorms.set_bn_stats_groups(1)
    return {k: ({n: np.asarray(t) for n, t in v.items()} if k in ("model", "ema") and v is not None else v)
            for k, v in out.items()}


RUN_LEGS = list(LEGS) + [f"zero1_{k}" for k in ZERO_PAIRS] + [f"replicated_{k}" for k in ZERO_PAIRS if k != "sgd"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every leg on two ranks (one spawn), and in one process here."""
    specs = {name: _spec(name) for name in RUN_LEGS}
    two = run_ranks(train_legs, 2, ([specs[n] for n in RUN_LEGS],), tmp_dir=str(tmp_path_factory.mktemp("rdzv")))
    return {
        "spec": specs,
        "two": {n: [two[r][i] for r in range(2)] for i, n in enumerate(RUN_LEGS)},
        "one": {n: train_steps(specs[n]) for n in LEGS},
    }


def _rel_delta(got: dict, want: dict, init: dict) -> float:
    """Relative L2 of the change from ``init``: the got change against the wanted one, over every float tensor."""
    keys = [k for k in init if init[k].dtype.kind == "f"]
    err = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in keys)
    ref = sum(float(np.sum((want[k] - init[k]) ** 2)) for k in keys)
    return (err / max(ref, 1e-300)) ** 0.5


@pytest.mark.parametrize("name", list(LEGS))
def test_two_ranks_match_the_jax_step_on_the_global_batch(runs, name):
    want = _jax_run(name)
    got = runs["two"][name][0]
    init = runs["spec"][name]["init"]
    sphere = name == "adacos"
    tol = {"loss": ADACOS_TOL["loss"], "grad_norm": ADACOS_TOL["grad_norm"]} if sphere else {
        "loss": TRAJ_TOL["loss"], "grad_norm": TRAJ_TOL["loss"]}
    for i in range(N_STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got["metrics"][i][k], want["metrics"][i][k], rtol=tol[k], err_msg=f"step {i} {k}")
    state_tol = ADACOS_TOL["weights"] if sphere else TRAJ_TOL["state"]
    assert _rel_delta(got["model"], want["model"], init) < state_tol
    if want["ema"] is not None:
        assert _rel_delta(got["ema"], want["ema"], init) < state_tol
    if sphere:
        for k, v in want["loss_state"].items():
            np.testing.assert_allclose(float(got["loss_state"][k]), v, rtol=ADACOS_TOL["state"], err_msg=k)
        assert want["loss_state"]["running_B"] != 1000.0
    # the weights moved
    assert _rel_delta(want["model"], init, {k: np.zeros_like(v) for k, v in init.items()}) > 1e-4


@pytest.mark.parametrize("name", list(LEGS))
def test_two_ranks_equal_one_process_and_each_other(runs, name):
    (r0, r1), one = runs["two"][name], runs["one"][name]
    init = runs["spec"][name]["init"]
    for k in r0["model"]:
        np.testing.assert_array_equal(r0["model"][k], r1["model"][k], err_msg=k)
    tol = 1e-7 if name in ("adacos", "zero1_adais") else 1e-10
    assert _rel_delta(r0["model"], one["model"], init) < tol
    if one["ema"] is not None:
        assert _rel_delta(r0["ema"], one["ema"], init) < tol
    for a, b in zip(r0["metrics"], one["metrics"]):
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=tol)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2**-23)  # a float32 metric: one rounding apart at most


@pytest.mark.parametrize("optim", list(ZERO_PAIRS))
def test_zero1_equals_the_replicated_run_bit_for_bit(runs, optim):
    sharded = runs["two"][f"zero1_{optim}"]
    replicated = runs["two"]["bn_global_ema_cutmix" if optim == "sgd" else f"replicated_{optim}"]
    for r in range(2):
        for k, v in replicated[r]["model"].items():
            np.testing.assert_array_equal(sharded[r]["model"][k], v, err_msg=k)
    # the sharded run's state dict is the unsharded optimizer's: same entries, shapes and dtypes
    def layout(sd):
        if isinstance(sd, np.ndarray):
            return (sd.shape, str(sd.dtype))
        if isinstance(sd, dict):
            return {k: layout(v) for k, v in sd.items() if k != "param_groups"}
        return type(sd).__name__

    assert layout(sharded[0]["optimizer"]) == layout(replicated[0]["optimizer"])
    assert sharded[0]["collectives"].get("params") and not replicated[0]["collectives"].get("params")
