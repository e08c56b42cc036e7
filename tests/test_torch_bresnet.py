"""The activated-BN family, the JAX ResNet's option set and BResNet-50 in the
port against the JAX package, on the same inputs and weights.

Norms (ABN, frozenabn, ABN with swish_hard, AGN at two widths,
EstimatedABN, BatchNorm's ``subsample``): each JAX module is initialised,
every leaf of its params and batch_stats drawn anew from a numpy seed, and
``flax_to_torch_model`` carries them over; float32, train and eval mode:
output, input gradient and running statistics within 1e-5 of the largest
reference value, parameter gradients within 1e-4 (tests/test_torch_nondeep.py's
``compare``).

ResNet options, each alone on a depth-cut net (two stages of one block): the
space2depth stem, the deep stem, antialias, ECA, ``bn_subsample``, ``agn``,
and the drop rates on the JAX package's own dropout and drop-path masks,
then ``bresnet50`` cut to one block per stage, with all of them. Kernels from the JAX
init, the norms' leaves drawn from a seed. Float64 on both sides (XLA:CPU's
float32 conv gradients are ~1e-2 off a float64 truth,
tests/test_torch_train_step.py), one train-mode forward and backward:
output, input gradient, parameter gradients and running statistics within
1e-6 of the largest reference value (the port's BatchNorm EMAs the batch
statistics in float32), 1e-5 with ECA: the JAX ECA takes its gate in
float32 (attention.py:86), which moves this float64 net's gradients by
~2e-6 of their largest value.

One train step of the depth-cut bresnet50 recipe against the JAX step:
weight standardisation (gamma 1.72), SGD (momentum 0.9, wd 3e-5), EMA 0.9,
cutmix (prob 1) on the JAX step's own draws, drop rates 0.2/0.2 on its
masks, label smoothing 0.1; float64 but for the standardisation, which
both packages run in float32. Loss within rtol 1e-6, grad_norm 1e-5, the
updated weights, running statistics and EMA within relative L2 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models import norms as JN
from sota_imagenet_tpu.models import resnet as JR
from sota_imagenet_tpu.models.parametrize import ParametrizedModel as JParametrizedModel
from sota_imagenet_tpu.models.parametrize import weight_standardization_fn as jax_ws_fn
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models import norms as TN
from sota_imagenet_tpu_torch.models import resnet as TR
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, weight_standardization_fn
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model
from tests.test_torch_nondeep import _feed_torch_masks, _record_jax_masks
from tests.test_torch_nondeep import compare as compare_f32

NET_TOL = 1e-6
ECA_TOL = 1e-5  # the JAX ECA's float32 gate moves a float64 net's gradients by ~2e-6
STEP_TOL = {"loss": 1e-6, "grad_norm": 1e-5, "state": 1e-6}
C = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# The activated-BN family
# --------------------------------------------------------------------------- #

NORMS = {
    "abn": (lambda: JN.ABN(), lambda: TN.ABN(C), (2, 6, 6, C)),
    "frozenabn": (lambda: JN._NORMS["frozenabn"](), lambda: TN.norm_from_name("frozenabn")(C), (2, 6, 6, C)),
    "abn_swish_hard": (lambda: JN.ABN(activation="swish_hard"), lambda: TN.ABN(C, activation="swish_hard"),
                       (2, 6, 6, C)),
    "agn": (lambda: JN.AGN(), lambda: TN.AGN(C), (2, 6, 6, C)),
    "agn_24": (lambda: JN.AGN(activation="swish"), lambda: TN.AGN(24, activation="swish"), (2, 6, 6, 24)),
    "estimated_abn": (lambda: JN.EstimatedABN(), lambda: TN.EstimatedABN(C), (2, 6, 6, C)),
    "bn_subsample_2": (lambda: JN.BatchNorm(subsample=2), lambda: TN.BatchNorm(C, subsample=2), (4, 8, 8, C)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_matches_jax(name, train):
    jmod, tmod, shape = NORMS[name]
    compare_f32(jmod(), tmod(), shape, train=train)


def test_frozen_and_estimated_abn_statistics():
    """frozenabn leaves its statistics in training; EstimatedABN normalizes a
    train forward with the statistics from before it, then moves them."""
    x = torch.randn(4, C, 5, 5)
    frozen = TN.norm_from_name("frozenabn")(C).train()
    frozen.running_mean.fill_(0.5)
    frozen(x)
    assert torch.all(frozen.running_mean == 0.5) and torch.all(frozen.running_var == 1.0)
    est = TN.EstimatedABN(C, activation="identity").train()
    y = est(x)
    torch.testing.assert_close(y, x / (1 + 1e-5) ** 0.5)  # the initial statistics: mean 0, var 1
    torch.testing.assert_close(est.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))


# --------------------------------------------------------------------------- #
# ResNet options
# --------------------------------------------------------------------------- #

BRESNET = dict(stem_type="space2depth", antialias=True, attn_type="eca", norm_act="leaky_relu", drop_rate=0.2,
               drop_connect_rate=0.2)
OPTIONS = {
    "space2depth_stem": ("Bottleneck", dict(stem_type="space2depth")),
    "deep_stem": ("BasicBlock", dict(stem_type="deep")),
    "antialias": ("Bottleneck", dict(antialias=True)),
    "antialias_basic": ("BasicBlock", dict(antialias=True)),
    "eca": ("BasicBlock", dict(attn_type="eca")),
    "bn_subsample": ("Bottleneck", dict(bn_subsample=2)),
    "agn": ("BasicBlock", dict(norm_layer="agn", norm_act="leaky_relu")),
    "drop_rates": ("Bottleneck", dict(drop_rate=0.3, drop_connect_rate=0.5)),
    "bresnet50_1111": ("Bottleneck", BRESNET),
}
BATCH, SIZE, CLASSES = 4, 32, 10
FULL_DEPTH_CUT = (1, 1, 1, 1)


def _randomized_norms(variables, rng):
    """The JAX init's kernels; every norm leaf drawn from ``rng`` (scales near
    1, variances in [0.5, 1.5]), in float64 but for ECA's kernel (the JAX ECA
    computes its gate in float32)."""

    def leaf(path, a):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = keys[-1]
        if name == "scale":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, a.shape)
        elif name in ("bias", "mean") and not keys[0] == "fc":
            a = rng.standard_normal(a.shape) * 0.2
        return np.asarray(a, np.float32 if any("ECA" in k for k in keys) else np.float64)

    return {k: jax.tree_util.tree_map_with_path(leaf, v) for k, v in variables.items()}


def _init(jmod):
    return jax.jit(lambda k: jmod.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nets(block: str, options: dict, layers=(1, 1)):
    kw = dict(block=getattr(JR, block), layers=layers, num_classes=CLASSES, **options)
    return JR.ResNet(**kw), TR.ResNet(**{**kw, "block": getattr(TR, block)})


def _close(got, want, what, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_resnet_option_train_forward_and_gradients_match_jax(option, monkeypatch):
    block, options = OPTIONS[option]
    jmod, tmod = _nets(block, options, FULL_DEPTH_CUT if option == "bresnet50_1111" else (1, 1))
    masks = _record_jax_masks(monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3))
    with jax.enable_x64(True):
        variables = _randomized_norms(_init(jmod), rng)
        params, stats = variables["params"], variables.get("batch_stats", {})

        cot = rng.standard_normal((BATCH, CLASSES)).astype(np.float32)  # the logits are float32 (resnet.py:316)

        @jax.jit
        def fwd_bwd(p, xj):
            def f(p, xj):
                v = {"params": p, "batch_stats": stats} if stats else {"params": p}
                return jmod.apply(v, xj, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(3)})

            out, vjp, upd = jax.vjp(f, p, xj, has_aux=True)
            return (out, *vjp(jnp.asarray(cot)), upd)

        want, want_gp, want_dx, updated = _host(fwd_bwd(params, jnp.asarray(x)))
    drops = options.get("drop_rate", 0) > 0
    # a drop-path mask per block but the first (its keep_prob is 1), then the head's dropout
    assert len(masks) == (len(jmod.layers) if drops else 0)
    _feed_torch_masks(monkeypatch, masks)
    tol = ECA_TOL if options.get("attn_type") else NET_TOL
    tmod.double().load_state_dict(flax_to_torch_model(tmod, _host(params), _host(stats)))
    tmod.train()
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = tmod(leaf)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), want, "output", tol)
    _close(leaf.grad.numpy(), want_dx, "input gradient", tol)
    want_grads = flax_to_torch_model(tmod, want_gp, stats)
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), f"gradient of {name}", tol)
    new = flax_to_torch_model(tmod, params, updated.get("batch_stats", {}))
    for k, b in tmod.named_buffers():
        if k in new:
            _close(b.numpy(), new[k].numpy(), f"statistic {k}", tol)


def test_bresnet50_eval_forward_matches_jax():
    jmod, tmod = _nets("Bottleneck", BRESNET, FULL_DEPTH_CUT)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, SIZE, SIZE, 3))
    with jax.enable_x64(True):
        variables = _randomized_norms(_init(jmod), rng)
        want = np.asarray(jax.jit(lambda v, xj: jmod.apply(v, xj, train=False))(variables, jnp.asarray(x)))
    tmod.double().load_state_dict(flax_to_torch_model(tmod, _host(variables["params"]), _host(variables["batch_stats"])))
    with torch.no_grad():
        _close(tmod.eval()(torch.from_numpy(x)).numpy(), want, "eval output", ECA_TOL)


def test_full_bresnet50_maps_every_jax_leaf():
    """The port's own bresnet50 takes every leaf of the JAX bresnet50's trees
    (shapes only: no compile), with the JAX names (registry)."""
    from sota_imagenet_tpu.models.resnet import bresnet50 as jbresnet50

    shapes = jax.eval_shape(lambda: jbresnet50().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = registry.resolve("bresnet50")()
    sd = flax_to_torch_model(model, zeros["params"], zeros["batch_stats"])
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes)) == sum(v.numel() for v in sd.values())
    assert sum(p.numel() for p in model.parameters()) == 25_575_320


def test_resnet_option_errors_as_jax():
    with pytest.raises(ValueError, match="fused_stats"):
        TR.resnet50(fused_stats=True, bn_subsample=2)
    with pytest.raises(ValueError, match="stem_type"):
        TR.resnet50(stem_type="s2d")


# --------------------------------------------------------------------------- #
# One train step of the depth-cut bresnet50 recipe
# --------------------------------------------------------------------------- #

MIX = dict(cutmix_alpha=1.0, mixup_alpha=0.0, prob=1.0)
OPTIM = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
GAMMA, LR, EMA = 1.72, 0.2, 0.9


def _jax_cutmix_draws(key, h, w):
    """What the JAX cutmix_mixup draws from ``key`` with mixup off (steps.py:66-103), as the port's draws."""
    k_apply, k_choice, _, k_lam_c, k_box = jax.random.split(key, 5)
    draws = {
        "apply": jax.random.bernoulli(k_apply, MIX["prob"]),
        "use_cutmix": jax.random.bernoulli(k_choice, 1.0),
        "lam_m": jnp.float32(1.0),
        "lam_c": jax.random.beta(k_lam_c, MIX["cutmix_alpha"], MIX["cutmix_alpha"]),
        "cy": jax.random.randint(k_box, (), 0, h),
        "cx": jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, w),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _rel_l2(got: dict, want: dict) -> float:
    a = np.concatenate([np.asarray(got[k], np.float64).reshape(-1) for k in sorted(want)])
    b = np.concatenate([np.asarray(want[k], np.float64).reshape(-1) for k in sorted(want)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bresnet50_recipe_step_matches_jax(monkeypatch):
    jmodel, tmodel = _nets("Bottleneck", BRESNET, FULL_DEPTH_CUT)
    masks = _record_jax_masks(monkeypatch)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((8, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[rng.integers(0, CLASSES, 8)]
    with jax.enable_x64(True):
        variables = _randomized_norms(_init(jmodel), rng)
        params, stats = variables["params"], variables["batch_stats"]
        tx = jax_build_optimizer(OPTIM, lambda count: LR)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params), ema_params=params, ema_batch_stats=stats)
        step = jax.jit(jsteps.build_train_step(
            JParametrizedModel(jmodel, jax_ws_fn(GAMMA)), JCrossEntropyLoss(smoothing=0.1), tx, lambda count: LR,
            ema_decay=EMA, mixup_fn=functools.partial(jsteps.cutmix_mixup, **MIX), input_dtype=jnp.float64,
        ))
        run_key = jax.random.PRNGKey(1)
        k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, 0), 3)  # steps.py:258-259
        draws = _jax_cutmix_draws(k_mix, SIZE, SIZE)
        state, m = step(state, {"image": jnp.asarray(images), "label": jnp.asarray(labels)}, run_key)
        want_m = {k: float(v) for k, v in m.items()}
        final = (_host(state.params), _host(state.batch_stats), _host(state.ema_params), _host(state.ema_batch_stats))
    assert len(masks) == 4
    _feed_torch_masks(monkeypatch, masks)
    model = ParametrizedModel(tmodel, weight_standardization_fn(GAMMA))
    tstate = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu", ema_decay=EMA)
    init = flax_to_torch_model(tmodel, _host(params), _host(stats))
    model.double().load_state_dict(init)
    tstate.ema.double().load_state_dict(init)
    assert list(model.state_dict()) == list(tmodel.state_dict())  # the wrapper adds no names
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), lambda i: LR, ema_decay=EMA, input_dtype=torch.float64,
        mixup_fn=lambda gen, im, lb: steps.apply_cutmix_mixup(im, lb, draws, MIX["cutmix_alpha"], MIX["mixup_alpha"]),
    )
    tstate, tm = tstep(tstate, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tm["loss"]), want_m["loss"], rtol=STEP_TOL["loss"])
    np.testing.assert_allclose(float(tm["grad_norm"]), want_m["grad_norm"], rtol=STEP_TOL["grad_norm"])
    got = {k: v.numpy() for k, v in tstate.model.state_dict().items()}
    want = {k: v.numpy() for k, v in flax_to_torch_model(tmodel, final[0], final[1]).items()}
    assert _rel_l2(got, want) < STEP_TOL["state"]
    got_ema = {k: v.numpy() for k, v in tstate.ema.state_dict().items()}
    want_ema = {k: v.numpy() for k, v in flax_to_torch_model(tmodel, final[2], final[3]).items()}
    assert _rel_l2(got_ema, want_ema) < STEP_TOL["state"]
    assert _rel_l2(want, {k: v.numpy() for k, v in init.items()}) > 1e-4  # the step moved the weights
