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
``filter_from_wd`` (ndim <= 1 parameters excluded).

The NFNet/AdamW recipe's step features are held at the end of the file: two
float32 steps of a small NFNet with ``accumulate_steps=2``, EMA, AdamW,
``filter_from_wd=[gain]`` and CutmixMixup on the JAX step's own draws; and
one float64 step of a ResNet-18 layout whose BN buffers chain through the
two microbatches."""

import functools

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
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch, flax_to_torch_model

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


# One f32 step of ResNet((1,1,1,1), fused_stats=True) against the JAX step in
# f32 (SiLU, batch 16 at 32 px, as above). conv1x1_stats takes bf16 products
# even in an f32 net, on both sides, with f32 sums in other orders: a y near a
# bf16 rounding boundary rounds the other way, and train-mode BN carries that
# on, so the f32 tolerances above do not hold. Measured by this test (CPU,
# one thread): loss 3.7e-5, grad_norm 4.5e-4, the parameters' update
# (relative L2) 1.4e-2 and the BN buffers 1.9e-4 off the JAX step.
FUSED_TOL = {"loss": 5e-4, "grad_norm": 5e-3, "update": 5e-2, "bn": 2e-3}


@pytest.fixture(scope="module")
def jax_fused_step():
    """One JAX train step of the fused net in f32, its Pallas kernel
    interpreted (the JAX Conv1x1BNStats calls it without ``interpret``)."""
    import functools

    from sota_imagenet_tpu.ops import pallas_conv_stats as jcs

    images, labels = _batches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcs, "conv1x1_stats_nhwc", functools.partial(jcs.conv1x1_stats_nhwc, interpret=True))
        jmodel = JResNet(block=JBottleneck, layers=LAYOUT["layers"], num_classes=CLASSES, norm_act="silu", fused_stats=True)
        sched = jax_make_lr_schedule(PHASES, steps_per_epoch=4)
        variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
        params, stats = variables["params"], variables["batch_stats"]
        tx = jax_build_optimizer(OPTIM, sched)
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
            ema_params=params, ema_batch_stats=stats,
        )
        step = jax.jit(
            jsteps.build_train_step(jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, ema_decay=EMA, input_dtype=jnp.float32)
        )
        batch = {"image": jnp.asarray(images[0], jnp.float32), "label": jnp.asarray(labels[0], jnp.float32)}
        state, m = step(state, batch, jax.random.PRNGKey(1))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        return {
            "init": flax_to_torch(host(params), host(stats), **LAYOUT),
            "metrics": {k: float(v) for k, v in m.items()},
            "final": _np(flax_to_torch(host(state.params), host(state.batch_stats), **LAYOUT)),
        }


def test_fused_stats_step_matches_jax(jax_fused_step):
    images, labels = _batches()
    model = ResNet(block=Bottleneck, layers=LAYOUT["layers"], num_classes=CLASSES, norm_act="silu", fused_stats=True)
    state = steps.init_state(
        model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu", ema_decay=EMA
    )
    for m in (state.model, state.ema):
        m.load_state_dict(jax_fused_step["init"])
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), make_lr_schedule(PHASES, steps_per_epoch=4), ema_decay=EMA, input_dtype=torch.float32
    )
    batch = {"image": torch.from_numpy(images[0]).float(), "label": torch.from_numpy(labels[0]).float()}
    state, m = tstep(state, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), jax_fused_step["metrics"][k], rtol=FUSED_TOL[k], err_msg=k)
    want, init = jax_fused_step["final"], _np(jax_fused_step["init"])
    got = _np(state.model.state_dict())
    params = [k for k in want if "running" not in k]
    buffers = [k for k in want if "running" in k]
    update = _rel_l2({k: got[k] - init[k] for k in params}, {k: want[k] - init[k] for k in params})
    bn = _rel_l2({k: got[k] for k in buffers}, {k: want[k] for k in buffers})
    assert update < FUSED_TOL["update"], f"parameter update: relative L2 {update}"
    assert bn < FUSED_TOL["bn"], f"bn: relative L2 {bn}"
    assert any(k.endswith("fdown.running_var") for k in buffers)  # the fused layout was compared


# --------------------------------------------------------------------------- #
# The NFNet/AdamW recipe's step: accumulation, mixup, EMA, AdamW, the gain mask
# --------------------------------------------------------------------------- #

NF = dict(depths=(1, 2), channels=(64, 128), stem_chs=(8, 8, 16, 32), group_size=32, num_classes=CLASSES)
NF_OPTIM = {"_target_": "adamw", "weight_decay": 1e-3, "eps": 1e-6}
NF_MIX = dict(cutmix_alpha=1.0, mixup_alpha=0.2, prob=1.0)
NF_STEPS, NF_EMA, ACCUM = 2, 0.9, 2
# Two float32 steps against the JAX float32 steps (SiLU, no norm layers): loss
# rtol 1e-5, grad_norm rtol 1e-3, updated params and EMA within relative L2 1e-4.
NF_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "state": 1e-4}


def _nonzero_gains(params, rng):
    """skipinit gains are zero at init, which switches every branch off: draw them, and the ECA kernels."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf)
        if name.endswith("skipinit_gain"):
            leaf = np.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
        elif "ECA_0" in name:
            leaf = rng.standard_normal(leaf.shape).astype(leaf.dtype)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _jax_mixup_draws(key, h, w):
    """What the JAX cutmix_mixup draws from ``key`` (steps.py:66-103), as the port's draws."""
    k_apply, k_choice, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    draws = {
        "apply": jax.random.bernoulli(k_apply, NF_MIX["prob"]),
        "use_cutmix": jax.random.bernoulli(k_choice, 0.5),
        "lam_m": jax.random.beta(k_lam_m, NF_MIX["mixup_alpha"], NF_MIX["mixup_alpha"]),
        "lam_c": jax.random.beta(k_lam_c, NF_MIX["cutmix_alpha"], NF_MIX["cutmix_alpha"]),
        "cy": jax.random.randint(k_box, (), 0, h),
        "cx": jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, w),
    }
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def jax_nfnet_steps():
    """NF_STEPS JAX float32 steps of the small NFNet with the recipe's step
    features, and the mixup draws each step made from its key."""
    from sota_imagenet_tpu.models.nfnet import NFNet as JNFNet

    images, labels = _batches()
    rng = np.random.default_rng(7)
    jmodel = JNFNet(**NF)
    sched = jax_make_lr_schedule(PHASES, steps_per_epoch=4)
    params = _nonzero_gains(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)["params"], rng)
    tx = jax_build_optimizer(NF_OPTIM, sched, wd_mask=jax_filter_wd(params, ["gain"]))
    state = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={}, opt_state=tx.init(params),
        ema_params=params, ema_batch_stats={},
    )
    step = jax.jit(
        jsteps.build_train_step(
            jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, accumulate_steps=ACCUM, ema_decay=NF_EMA,
            mixup_fn=functools.partial(jsteps.cutmix_mixup, **NF_MIX), input_dtype=jnp.float32,
        )
    )
    run_key = jax.random.PRNGKey(1)
    metrics, draws = [], []
    for i in range(NF_STEPS):
        k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, i), 3)  # steps.py:258-259
        draws.append(_jax_mixup_draws(k_mix, SIZE, SIZE))
        batch = {"image": jnp.asarray(images[i], jnp.float32), "label": jnp.asarray(labels[i], jnp.float32)}
        state, m = step(state, batch, run_key)
        metrics.append({k: float(v) for k, v in m.items()})
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"init": params, "metrics": metrics, "draws": draws, "final": host(state.params), "final_ema": host(state.ema_params)}


def test_nfnet_accumulated_adamw_mixup_ema_steps_match_jax(jax_nfnet_steps):
    from sota_imagenet_tpu_torch.models import NFNet

    images, labels = _batches()
    model = NFNet(**NF)
    mask = filter_from_weight_decay(model.named_parameters(), ["gain"])
    state = steps.init_state(
        model, lambda m: build_optimizer(NF_OPTIM, m.named_parameters(), wd_mask=mask), device="cpu", ema_decay=NF_EMA
    )
    init = flax_to_torch_model(model, jax_nfnet_steps["init"])
    for m in (state.model, state.ema):
        m.load_state_dict(init)
    fed = iter(jax_nfnet_steps["draws"])
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), make_lr_schedule(PHASES, steps_per_epoch=4), accumulate_steps=ACCUM,
        ema_decay=NF_EMA, input_dtype=torch.float32,
        mixup_fn=lambda gen, im, lb: steps.apply_cutmix_mixup(im, lb, next(fed), NF_MIX["cutmix_alpha"], NF_MIX["mixup_alpha"]),
    )
    for i in range(NF_STEPS):
        batch = {"image": torch.from_numpy(images[i]).float(), "label": torch.from_numpy(labels[i]).float()}
        state, m = tstep(state, batch)
        want = jax_nfnet_steps["metrics"][i]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=NF_TOL[k], err_msg=f"step {i} {k}")
        for k in ("lr", "Acc@1", "Acc@5"):  # the metrics see all the logits of the step
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-6, err_msg=f"step {i} {k}")
    assert state.step == NF_STEPS  # one optimizer step per train step, whatever the microbatches
    assert all(int(s["step"]) == NF_STEPS for s in state.optimizer.state.values())
    want = _np(flax_to_torch_model(model, jax_nfnet_steps["final"]))
    want_ema = _np(flax_to_torch_model(model, jax_nfnet_steps["final_ema"]))
    got, got_ema = _np(state.model.state_dict()), _np(state.ema.state_dict())
    assert _rel_l2(got, want) < NF_TOL["state"] and _rel_l2(got_ema, want_ema) < NF_TOL["state"]
    # per group too: the decayed kernels, and the gains the mask keeps out of the decay
    for frag in ("weight", "gain"):
        keys = [k for k in want if frag in k]
        assert _rel_l2({k: got[k] for k in keys}, {k: want[k] for k in keys}) < NF_TOL["state"], frag
    assert _rel_l2(want, _np(init)) > 1e-3 and _rel_l2(want_ema, want) > 1e-4  # weights moved; the EMA lags them


def test_train_step_seeds_the_generator_from_seed_and_step():
    """Dropout and drop-path draw from the state's generator, which each step
    seeds from (seed, step): a state resumed at a step draws what the
    uninterrupted run drew, and another seed draws something else."""
    from sota_imagenet_tpu_torch.models import NFNet

    images, labels = _batches()
    batch = {"image": torch.from_numpy(images[0]).float(), "label": torch.from_numpy(labels[0]).float()}

    def run(seed, first_step, n):
        model = NFNet(**NF, drop_rate=0.3, drop_path_rate=0.5)
        state = steps.init_state(model, lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()), device="cpu", seed=seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("skipinit_gain"):
                    p.fill_(1.0)
        state.step = first_step
        tstep = steps.build_train_step(CrossEntropyLoss(), lambda i: 0.0, accumulate_steps=ACCUM, input_dtype=torch.float32)
        return [float(tstep(state, batch)[1]["loss"]) for _ in range(n)]

    whole = run(0, 0, 3)
    assert run(0, 2, 1) == whole[2:]  # lr 0: the weights stand still, only the draws differ by step
    assert len(set(whole)) == 3 and run(1, 0, 1) != whole[:1]


@pytest.fixture(scope="module")
def jax_resnet18_accumulated_step():
    """One JAX float64 step of a BasicBlock ResNet with accumulate_steps 2 and 1."""
    from sota_imagenet_tpu.models.resnet import BasicBlock as JBasicBlock

    images, labels = _batches()
    out = {}
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jmodel = JResNet(block=JBasicBlock, layers=(1, 1, 1, 1), num_classes=CLASSES)
        sched = jax_make_lr_schedule(PHASES, steps_per_epoch=4)
        variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
        params, stats = to64(variables["params"]), to64(variables["batch_stats"])
        tx = jax_build_optimizer(OPTIM, sched)
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        out["init"] = flax_to_torch(host(params), host(stats), layers=(1, 1, 1, 1), bottleneck=False)
        for accum in (ACCUM, 1):
            state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params))
            step = jax.jit(
                jsteps.build_train_step(
                    jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, accumulate_steps=accum, input_dtype=jnp.float64
                )
            )
            batch = {"image": jnp.asarray(images[0], jnp.float64), "label": jnp.asarray(labels[0], jnp.float64)}
            state, m = step(state, batch, jax.random.PRNGKey(1))
            out[accum] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "final": _np(flax_to_torch(host(state.params), host(state.batch_stats), layers=(1, 1, 1, 1), bottleneck=False)),
            }
    return out


def test_bn_buffers_chain_through_the_microbatches_as_in_jax(jax_resnet18_accumulated_step):
    from sota_imagenet_tpu_torch.models.resnet import BasicBlock

    ref = jax_resnet18_accumulated_step
    images, labels = _batches()
    model = ResNet(block=BasicBlock, layers=(1, 1, 1, 1), num_classes=CLASSES)
    state = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu")
    model.load_state_dict(ref["init"])
    model.to(torch.float64)
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), make_lr_schedule(PHASES, steps_per_epoch=4), accumulate_steps=ACCUM, input_dtype=torch.float64
    )
    state, m = tstep(state, {"image": torch.from_numpy(images[0]), "label": torch.from_numpy(labels[0])})
    want = ref[ACCUM]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), want["metrics"][k], rtol=1e-7, err_msg=k)
    got = _np(state.model.state_dict())
    buffers = [k for k in got if "running" in k]
    params = [k for k in got if "running" not in k]
    assert _rel_l2({k: got[k] for k in buffers}, {k: want["final"][k] for k in buffers}) < 1e-7
    assert _rel_l2({k: got[k] for k in params}, {k: want["final"][k] for k in params}) < 1e-7
    # two microbatches update the buffers twice: not what one pass over the whole batch leaves
    whole = ref[1]["final"]
    assert _rel_l2({k: got[k] for k in buffers}, {k: whole[k] for k in buffers}) > 1e-3


# --------------------------------------------------------------------------- #
# The float64 trajectory gate: nine steps in the three variants of
# tests/test_trajectory_parity.py (plain SGD; EMA + cutmix/mixup; AdamW)
# --------------------------------------------------------------------------- #

TRAJ_STEPS, TRAJ_BATCH, TRAJ_WD, TRAJ_EMA = 9, 8, 1e-2, 0.99
TRAJ_OPTIM = {
    "sgd": {"_target_": "sgd", "momentum": 0.9, "weight_decay": TRAJ_WD},
    "adamw": {"_target_": "adamw", "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": TRAJ_WD},
}
TRAJ_PEAK = {"sgd": 0.02, "adamw": 1e-3}  # tests/test_trajectory_parity.py:159
TRAJ_MIX = dict(cutmix_alpha=1.0, mixup_alpha=0.2, prob=1.0)
# Tolerances: loss (a float32 metric in both packages) and grad_norm rtol 1e-7
# at every step; the change of the params, BN buffers and EMA over the nine
# steps within relative L2 1e-6, except AdamW's params: 1e-5. Measured by this
# test (CPU): grad_norm within 2e-8, state 4.1e-8 (plain), and AdamW's params
# 1.34e-6, all of it in a few weights: AdamW divides each gradient element by
# its running RMS + eps (1e-8), so an element whose gradient lies below eps
# moves by lr/eps = 1e5 times its float64 rounding difference (with eps 1e-4
# the same run is 7.6e-8 apart).
TRAJ_TOL = {"loss": 1e-7, "state": 1e-6, "adamw_params": 1e-5}
R18_1 = dict(layers=(1, 1, 1, 1), bottleneck=False)


def _traj_batches():
    """Four batches, cycled: the trajectory test's inputs (normal images, a
    shifted label per sample)."""
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (4, TRAJ_BATCH, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[np.stack([(np.arange(TRAJ_BATCH) + i) % CLASSES for i in range(4)])]
    return images, labels


def _traj_phases(optim):
    return [{"ep": (0, 1), "lr": (TRAJ_PEAK[optim] / 20, TRAJ_PEAK[optim]), "mode": "linear"}]


@pytest.fixture(scope="module", params=["plain", "ema_mixup", "adamw"])
def jax_trajectory(request):
    """The JAX float64 trajectory of a ReLU ResNet (one BasicBlock a stage):
    per-step metrics, the mixup draws each step took from its key, and the
    initial and final states (numpy, port layout)."""
    from sota_imagenet_tpu.models.resnet import BasicBlock as JBasicBlock

    variant = request.param
    optim = "adamw" if variant == "adamw" else "sgd"
    mixed = variant == "ema_mixup"
    ema = TRAJ_EMA if mixed else 0.0
    images, labels = _traj_batches()
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        jmodel = JResNet(block=JBasicBlock, layers=R18_1["layers"], num_classes=CLASSES)
        sched = jax_make_lr_schedule(_traj_phases(optim), steps_per_epoch=20)
        variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
        params, stats = to64(variables["params"]), to64(variables["batch_stats"])
        tx = jax_build_optimizer(TRAJ_OPTIM[optim], sched, wd_mask=jax_filter_wd(params, []))
        state = jsteps.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
            ema_params=params if ema else None, ema_batch_stats=stats if ema else None,
        )
        mixup_fn = functools.partial(jsteps.cutmix_mixup, **TRAJ_MIX) if mixed else None
        step = jax.jit(jsteps.build_train_step(jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, ema_decay=ema,
                                               mixup_fn=mixup_fn, input_dtype=jnp.float64))
        run_key = jax.random.PRNGKey(1)
        metrics, draws = [], []
        for i in range(TRAJ_STEPS):
            if mixed:
                k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, i), 3)  # steps.py:258-259
                k_apply, k_choice, k_lam_m, k_lam_c, k_box = jax.random.split(k_mix, 5)  # steps.py:66
                d = {
                    "apply": jax.random.bernoulli(k_apply, TRAJ_MIX["prob"]),
                    "use_cutmix": jax.random.bernoulli(k_choice, 0.5),
                    "lam_m": jax.random.beta(k_lam_m, TRAJ_MIX["mixup_alpha"], TRAJ_MIX["mixup_alpha"]),
                    "lam_c": jax.random.beta(k_lam_c, TRAJ_MIX["cutmix_alpha"], TRAJ_MIX["cutmix_alpha"]),
                    "cy": jax.random.randint(k_box, (), 0, SIZE),
                    "cx": jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, SIZE),
                }
                draws.append({k: torch.from_numpy(np.array(v)) for k, v in d.items()})
            b = i % images.shape[0]
            batch = {"image": jnp.asarray(images[b], jnp.float64), "label": jnp.asarray(labels[b], jnp.float64)}
            state, m = step(state, batch, run_key)
            metrics.append({k: float(v) for k, v in m.items()})
        return {
            "variant": variant, "optim": optim, "ema": ema, "metrics": metrics, "draws": draws,
            "init": flax_to_torch(host(params), host(stats), **R18_1),
            "final": _np(flax_to_torch(host(state.params), host(state.batch_stats), **R18_1)),
            "final_ema": _np(flax_to_torch(host(state.ema_params), host(state.ema_batch_stats), **R18_1)) if ema else None,
        }


def _rel_l2_delta(got: dict, want: dict, init: dict, keys) -> float:
    """Relative L2 of the port's change from ``init`` against the JAX change."""
    return _rel_l2({k: got[k] - init[k] for k in keys}, {k: want[k] - init[k] for k in keys})


def test_nine_float64_steps_track_jax(jax_trajectory):
    """The port's build_train_step in float64 against JAX's for nine steps
    (the mixup variant on the JAX step's own draws), at TRAJ_TOL."""
    from sota_imagenet_tpu_torch.models.resnet import BasicBlock

    ref = jax_trajectory
    images, labels = _traj_batches()
    model = ResNet(block=BasicBlock, layers=R18_1["layers"], num_classes=CLASSES)
    mask = filter_from_weight_decay(model.named_parameters(), [])
    state = steps.init_state(model, lambda m: build_optimizer(TRAJ_OPTIM[ref["optim"]], m.named_parameters(), wd_mask=mask),
                             device="cpu", ema_decay=ref["ema"])
    for m in (state.model, state.ema) if ref["ema"] else (state.model,):
        m.load_state_dict(ref["init"])
        m.to(torch.float64)
    fed = iter(ref["draws"])
    mixup_fn = None
    if ref["draws"]:
        mixup_fn = lambda gen, im, lb: steps.apply_cutmix_mixup(im, lb, next(fed), TRAJ_MIX["cutmix_alpha"], TRAJ_MIX["mixup_alpha"])
    tstep = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), make_lr_schedule(_traj_phases(ref["optim"]), steps_per_epoch=20),
                                   ema_decay=ref["ema"], mixup_fn=mixup_fn, input_dtype=torch.float64)
    for i in range(TRAJ_STEPS):
        b = i % images.shape[0]
        state, m = tstep(state, {"image": torch.from_numpy(images[b]), "label": torch.from_numpy(labels[b])})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), ref["metrics"][i][k], rtol=TRAJ_TOL["loss"], err_msg=f"step {i} {k}")
        # the JAX schedule evaluates in float32, the port's in float64
        np.testing.assert_allclose(float(m["lr"]), ref["metrics"][i]["lr"], rtol=2**-23, err_msg=f"step {i} lr")
    init = _np(ref["init"])
    got = _np(state.model.state_dict())
    params = [k for k in init if "running" not in k and "num_batches" not in k]
    buffers = [k for k in init if "running" in k]
    errs = {"params": _rel_l2_delta(got, ref["final"], init, params), "bn": _rel_l2_delta(got, ref["final"], init, buffers)}
    if ref["ema"]:
        errs["ema"] = _rel_l2_delta(_np(state.ema.state_dict()), ref["final_ema"], init, params + buffers)
    tol = {k: TRAJ_TOL["state"] for k in errs}
    if ref["optim"] == "adamw":
        tol["params"] = TRAJ_TOL["adamw_params"]
    assert all(errs[k] < tol[k] for k in errs), (errs, tol)
    assert _rel_l2({k: ref["final"][k] for k in params}, {k: init[k] for k in params}) > 1e-3  # the weights moved
