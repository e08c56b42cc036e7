"""Three train steps of the port (sota_imagenet_tpu_torch.train.steps) against
the JAX package's build_train_step, from identical weights and batches: a
truncated Bottleneck ResNet, label-smoothing CE (0.1), SGD (momentum 0.9,
wd 3e-5), EMA 0.9, linear warmup.

The JAX reference runs in float64 (as tests/test_trajectory_parity.py runs
it): in float32, XLA:CPU's gradient of this small net is ~1% off a float64
truth (measured: input-gradient relative error 9.4e-3 at batch 16, 64 px),
where the port's float32 gradient is 1.8e-6 off — an f32-vs-f32 comparison
would measure the reference's rounding, not the port. The port runs in
float32 (the trainer's precision with run.bf16=false) and in float64.

The float32 run uses a smooth activation (SiLU) where the float64 run keeps
ReLU, the production activation: a float32 rounding of ~1e-7 moves a
pre-activation lying that close to zero across the ReLU kink, and one such
flip moves the gradient by far more than 1e-4 (with ReLU at batch 32, this
test's float32 grad_norm at step 3 was 2.8e-4 off with one CPU thread and
within 1e-4 with eight).

Tolerances: per-step loss, grad_norm and lr within rtol 1e-4 (port f32) /
1e-7 (port f64); final params, BN buffers (biased running variance) and the
EMA trees within relative L2 1e-4 / 1e-7. Both weight-decay modes of the JAX
CLI are held: no mask (every parameter decayed, the r50_baseline case) and
``filter_from_wd`` (ndim <= 1 parameters excluded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.resnet import Bottleneck as JBottleneck
from sota_imagenet_tpu.models.resnet import ResNet as JResNet
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu.train.schedule import make_lr_schedule as jax_make_lr_schedule
from sota_imagenet_tpu.utils.misc import filter_from_weight_decay as jax_filter_wd
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.schedule import make_lr_schedule
from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch

N_STEPS, BATCH, SIZE, CLASSES = 3, 16, 32, 10
LAYOUT = dict(layers=(1, 1, 1, 1), bottleneck=True)
OPTIM = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
PHASES = [{"ep": (0, 1), "lr": (0.001, 0.01), "mode": "linear"}]
EMA = 0.9
TOL = {"float32": 1e-4, "float64": 1e-7}
ACT = {"float32": "silu", "float64": "relu"}
WD_FILTERS = {"decay_all": None, "filter_from_wd": []}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several workers share the
    cores, and oversubscribed OpenMP threads slow these small CPU runs by
    one to two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got: dict, want: dict) -> float:
    a = np.concatenate([np.asarray(got[k], np.float64).reshape(-1) for k in sorted(want)])
    b = np.concatenate([np.asarray(want[k], np.float64).reshape(-1) for k in sorted(want)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(sd):
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v).copy() for k, v in sd.items()}


def _batches():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


CASES = [(wd, dtype) for wd in WD_FILTERS for dtype in sorted(TOL)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{wd}-{dtype}" for wd, dtype in CASES])
def jax_run(request):
    """The JAX reference trajectory in float64 with the case's activation:
    initial weights, per-step metrics, final state (numpy, port layout)."""
    wd_name, dtype = request.param
    wd_filter = WD_FILTERS[wd_name]
    images, labels = _batches()
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jmodel = JResNet(block=JBottleneck, layers=LAYOUT["layers"], num_classes=CLASSES, norm_act=ACT[dtype])
        sched = jax_make_lr_schedule(PHASES, steps_per_epoch=4)
        variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
        params, stats = to64(variables["params"]), to64(variables["batch_stats"])
        mask = jax_filter_wd(params, wd_filter) if wd_filter is not None else None
        tx = jax_build_optimizer(OPTIM, sched, wd_mask=mask)
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
            ema_params=params, ema_batch_stats=stats,
        )
        step = jax.jit(
            jsteps.build_train_step(jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, ema_decay=EMA, input_dtype=jnp.float64)
        )
        metrics = []
        for i in range(N_STEPS):
            batch = {"image": jnp.asarray(images[i], jnp.float64), "label": jnp.asarray(labels[i], jnp.float64)}
            state, m = step(state, batch, jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        return {
            "dtype": dtype,
            "wd_filter": wd_filter,
            "init": flax_to_torch(host(params), host(stats), **LAYOUT),
            "metrics": metrics,
            "final": _np(flax_to_torch(host(state.params), host(state.batch_stats), **LAYOUT)),
            "final_ema": _np(flax_to_torch(host(state.ema_params), host(state.ema_batch_stats), **LAYOUT)),
        }


def test_three_steps_match_jax(jax_run):
    dtype = jax_run["dtype"]
    tol, tdt = TOL[dtype], getattr(torch, dtype)
    images, labels = _batches()
    wd_filter = jax_run["wd_filter"]
    model = ResNet(block=Bottleneck, layers=LAYOUT["layers"], num_classes=CLASSES, norm_act=ACT[dtype])
    mask = filter_from_weight_decay(model.named_parameters(), wd_filter) if wd_filter is not None else None
    state = steps.init_state(
        model, lambda m: build_optimizer(OPTIM, m.named_parameters(), wd_mask=mask), device="cpu", ema_decay=EMA
    )
    for m in (state.model, state.ema):
        m.load_state_dict(jax_run["init"])
        m.to(tdt)
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), make_lr_schedule(PHASES, steps_per_epoch=4), ema_decay=EMA, input_dtype=tdt
    )
    for i in range(N_STEPS):
        batch = {"image": torch.from_numpy(images[i]).to(tdt), "label": torch.from_numpy(labels[i]).to(tdt)}
        state, m = tstep(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), jax_run["metrics"][i][k], rtol=tol, err_msg=f"step {i} {k}")
    assert state.step == N_STEPS
    # weight-decay mask: one group decays everything, filter_from_wd splits off the 1-d params
    assert len(state.optimizer.param_groups) == (1 if wd_filter is None else 2)

    want, want_ema = jax_run["final"], jax_run["final_ema"]
    got, got_ema = _np(state.model.state_dict()), _np(state.ema.state_dict())
    params = [k for k in want if "running" not in k]
    buffers = [k for k in want if "running" in k]
    for name, keys, g, w in (("params", params, got, want), ("bn", buffers, got, want), ("ema", list(want), got_ema, want_ema)):
        err = _rel_l2({k: g[k] for k in keys}, {k: w[k] for k in keys})
        assert err < tol, f"{name}: relative L2 {err}"
    # the steps really moved the weights (the comparison is not of two no-ops)
    assert _rel_l2({k: want[k] for k in params}, _np({k: jax_run["init"][k] for k in params})) > 1e-3


@pytest.mark.parametrize("mode", ["linear", "cos", "poly"])
def test_lr_schedule_matches_jax(mode):
    phases = [{"ep": (0, 2), "lr": (0.001, 1.0), "mode": "linear"}, {"ep": (2, 5), "lr": (1.0, 0.0), "mode": mode}]
    for base_epoch, base_step in ((0, 0), (2, 7)):
        j = jax_make_lr_schedule(phases, steps_per_epoch=7, base_epoch=base_epoch, base_step=base_step)
        t = make_lr_schedule(phases, steps_per_epoch=7, base_epoch=base_epoch, base_step=base_step)
        for step in range(base_step, base_step + 40):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, atol=1e-7, err_msg=f"step {step}")


def test_eval_step_matches_jax():
    rng = np.random.default_rng(1)
    images = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, BATCH)]
    jmodel = JResNet(block=JBottleneck, layers=LAYOUT["layers"], num_classes=CLASSES)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(2))
    jstate = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None
    )
    crit = dict(smoothing=0.1)
    jm = jax.jit(jsteps.build_eval_step(jmodel, JCrossEntropyLoss(**crit), input_dtype=jnp.float32))(
        jstate, {"image": jnp.asarray(images, jnp.float32), "label": jnp.asarray(labels, jnp.float32)}
    )
    model = ResNet(block=Bottleneck, layers=LAYOUT["layers"], num_classes=CLASSES)
    state = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu")
    state.model.load_state_dict(
        flax_to_torch(jax.tree_util.tree_map(np.asarray, jstate.params), jax.tree_util.tree_map(np.asarray, jstate.batch_stats), **LAYOUT)
    )
    tm = steps.build_eval_step(CrossEntropyLoss(**crit), input_dtype=torch.float32)(
        state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    )
    for k in ("loss", "Acc@1", "Acc@5"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
