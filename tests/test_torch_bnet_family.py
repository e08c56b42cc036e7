"""The BNet family (models/bnet.py) and the SE / ResNeXt ResNets in the port
against the JAX package, on the same inputs and weights.

Structure at full width, without numbers: ``jax.eval_shape`` of ``init`` for
every factory of the family, the four ResNet variants and exp48's and exp99's
``model:`` blocks, beside the port's model built on the meta device; every
flax leaf maps to exactly one state_dict entry of the converted shape
(``flax_to_torch_model`` raises on a leaf left over or a key left
unproduced), and the parameter counts are equal.

Numerics, depth-cut: one block per stage, widths / 16, 32 px, batch 4,
float64 on both sides, every leaf drawn from a numpy seed
(tests/test_torch_nondeep.py's ``_randomized``). Each case is a BNet whose
options together cover every block plan (XX, Btl, IR, Custom_2, Sep2, Sep3,
Dark and their Pre_ variants), every stem (default, s2d, deep, genet,
dark), every head (and ``head_norm_act: none``), every ``dim_reduction``,
``filter_steps``, ``groups_width`` with ``no_groups_with_stride``,
``antialias``, ``force_residual``/``force_expansion``, ``init_zero``, SE with
its ``reduction``, and CSP stages with and without ``x2_transition``; in
train and eval mode: output, input gradient and every parameter gradient
within 1e-9 of the largest reference value, the running statistics within
1e-6 (the port's BatchNorm EMAs the batch statistics in float32; the
tolerances of tests/test_torch_bnet.py). Where the JAX package computes in
float32 inside a float64 net (SE's gate, attention.py:36-39; the l2 norm of
``normalize``, bnet.py:401; the sphere heads' cosines) the tolerance is
1e-5, as tests/test_torch_bresnet.py's ECA_TOL; 1e-3 for the SE case,
whose draw saturates the float32 gates (SATURATED_SE_TOL).

Two train steps through each package's ``train_step``, float64, on a
depth-cut exp48 (SGD, EMA, CutmixMixup on the JAX step's own draws) and a
depth-cut exp57 (weight standardisation through ``ParametrizedModel``,
AdamP): loss within rtol 1e-6, grad_norm 1e-5, the weights, running
statistics and EMA within relative L2 1e-6; exp57's projected set is the
JAX rule's on the flax leaves (tests/test_torch_zoo.py) and holds every
standardised kernel."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu import registry as JR
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models import bnet as JBN
from sota_imagenet_tpu.models.parametrize import ParametrizedModel as JParametrizedModel
from sota_imagenet_tpu.models.parametrize import weight_standardization_fn as jax_ws_fn
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch import registry as TR
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models import bnet as TBN
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, weight_standardization_fn
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.utils.weights import _TO_FLAX, _plan, flax_ranks, flax_to_torch_model, unit_dims
from tests.test_torch_bresnet import _jax_cutmix_draws, _rel_l2
from tests.test_torch_nondeep import _randomized
from tests.test_torch_zoo import _fires

TOL = 1e-9
OUT_TOL = 1.2e-7  # the logits are float32 in both packages: one float32 rounding of the largest
# SE's gate, normalize's norm and the sphere cosines are float32 in both packages
F32_INSIDE_TOL = 1e-5
# on se_reduction's draw the gates saturate: the port's float32 SE moves its own SE gradients by up to 1.75e-4 of
# their largest against a float64 SE, so two packages' float32 gates may part by twice that
SATURATED_SE_TOL = 1e-3
STAT_TOL = 1e-6
STEP_TOL = {"loss": 1e-6, "grad_norm": 1e-5, "state": 1e-6}
SIZE, BATCH = 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# Structure at full width
# --------------------------------------------------------------------------- #

FACTORIES = ["simpl_resnet34", "simpl_resnet50", "simpl_preactresnet34", "csp_simpl_resnet34", "simpl_dark",
             "csp_simpl_dark", "genet_normal", "GENet_normal", "se_resnet50", "pytorch_tools.models.se_resnet50",
             "resnext50_32x4d", "resnext101_32x4d", "se_resnext50_32x4d"]
CONFIGS = {"exp48": "configs/old_exp/exp85-114/exp48.GEnet_no_dim_red_ctmx.yaml",
           "exp99": "configs/old_exp/exp85-114/exp99.BNet_adacos_margin.yaml"}


def check_structure(jmodel, tmodel_fn, size: int = 64):
    """Every flax leaf of ``jmodel``'s init (shapes only) maps to one state_dict
    entry of the meta-built port model, of the converted shape; equal
    parameter counts. Returns the count."""
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                                jnp.zeros((1, size, size, 3)), train=False))
    zeros = lambda t: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), t)  # noqa: E731
    params, stats = zeros(shapes["params"]), zeros(shapes.get("batch_stats", {}))
    with torch.device("meta"):
        tmodel = tmodel_fn()
    sd = flax_to_torch_model(tmodel, params, stats)  # raises on a leaf or key left over
    want = tmodel.state_dict()
    assert set(sd) == set(want)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in want.items()}
    n = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n == sum(p.numel() for p in tmodel.parameters())
    return n


@pytest.mark.parametrize("name", FACTORIES)
def test_factory_maps_every_flax_leaf_at_full_width(name):
    check_structure(JR.resolve(name)(), lambda: TR.resolve(name)())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_config_model_maps_every_flax_leaf_at_full_width(config):
    from sota_imagenet_tpu_torch import cli

    jcfg = JC.to_dict(JC.load(CONFIGS[config], strict_env=False).model)
    tcfg = TC.load(CONFIGS[config], strict_env=False)
    n = check_structure(JC.instantiate(jcfg), lambda: cli.build_model(tcfg))
    assert sum(1 for m in cli.build_model(tcfg).modules() if isinstance(m, TBN.BNetBlock)) == 14
    assert n == {"exp48": 21_577_576, "exp99": 16_650_344}[config]


# --------------------------------------------------------------------------- #
# Numerics, depth-cut, float64
# --------------------------------------------------------------------------- #


def _fan_in_kernels(tree, rng):
    """``_randomized``, but each kernel drawn N(0, 2 / fan_in): a full-depth net keeps its scale."""
    out = _randomized(tree, rng)
    flat, treedef = jax.tree_util.tree_flatten_with_path(out)
    leaves = [rng.standard_normal(a.shape) * np.sqrt(2.0 / np.prod(a.shape[:-1]))
              if str(getattr(path[-1], "key", "")) == "kernel" else a for path, a in flat]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def compare_model(jmod, tmod, tol: float = TOL, seed: int = 0, modes=(False, True), draw=_randomized):
    """``tmod`` against ``jmod`` on NHWC images, float64, every leaf drawn from a
    seed by ``draw`` (only the shapes of the JAX init are taken), in eval
    and in train mode (``modes``) from one jitted JAX function: output, input
    and parameter gradients of sum(out * r), and in train mode the running
    statistics. Both models return float32 logits, so the output is held to
    a float32 rounding (OUT_TOL); the gradients, float64 from the float32
    cotangent, to ``tol``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3))
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda xj: jmod.init(jax.random.PRNGKey(0), xj, train=False), jnp.asarray(x))
        cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), draw(t, rng))  # noqa: E731
        params, stats = cast(shapes["params"]), cast(shapes.get("batch_stats", {}))
        cot = rng.standard_normal((BATCH, jmod.num_classes)).astype(np.float32)

        @jax.jit
        def fwd_bwd(p, xj):
            def f(train):
                def g(p, xj):
                    v = {"params": p, "batch_stats": stats}
                    if train:
                        return jmod.apply(v, xj, train=True, mutable=["batch_stats"])
                    return jmod.apply(v, xj, train=False), {}
                out, vjp, upd = jax.vjp(g, p, xj, has_aux=True)
                return (out, *vjp(jnp.asarray(cot)), upd)
            return [f(train) for train in modes]

        runs = jax.tree_util.tree_map(np.asarray, fwd_bwd(params, jnp.asarray(x)))
    tmod.double()
    for train, (want, want_gp, want_dx, updated) in zip(modes, runs):
        mode = "train" if train else "eval"
        tmod.load_state_dict(flax_to_torch_model(tmod, params, stats))
        tmod.zero_grad(set_to_none=True)
        leaf = torch.from_numpy(x).requires_grad_(True)
        out = tmod.train(train)(leaf)
        (out * torch.from_numpy(cot)).sum().backward()
        _close(out.detach().numpy(), want, f"{mode} output", max(OUT_TOL, tol))
        _close(leaf.grad.numpy(), want_dx, f"{mode} input gradient", tol)
        want_grads = flax_to_torch_model(tmod, want_gp, stats)
        for name, p in tmod.named_parameters():
            # sphere_mlp's projector runs in train mode only: its eval gradient is zero (None here)
            got = p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))
            _close(got, want_grads[name].numpy(), f"{mode} gradient of {name}", tol)
        if train and stats:
            new = flax_to_torch_model(tmod, params, updated["batch_stats"])
            for k, b in tmod.named_buffers():
                if k in new:
                    _close(b.numpy(), new[k].numpy(), f"statistic {k}", STAT_TOL)


def _close(got, want, what, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


# widths / 16 of GENet's (128, 192, 640, 640 -> 8, 12, 40, 40), one block per stage
CUT = dict(layers=(1, 1, 1, 1), channels=(8, 12, 40, 40), stem_width=8, head_width=32, num_classes=10)

CASES = {
    # the post-activation plans, the default stem and head, final_act on two stages
    "post_xx_btl_ir_custom2": dict(
        block_fns=("XX", "Btl", "IR", "Custom_2"), stem_type="default", head_type="default",
        stage_args=({"final_act": True}, {"bottle_ratio": 0.25}, {"bottle_ratio": 3, "final_act": True}, {}),
    ),
    # Sep2, Sep3, Dark; the s2d stem; init_zero's scale-less BatchNorm and gamma; expand_before_head false
    # (pool_fc whatever the head type)
    "post_sep2_sep3_dark_init_zero": dict(
        layers=(1, 2, 1), channels=(8, 16, 24), block_fns=("Sep2", "Sep3", "Dark"), stem_type="s2d",
        head_type="mlp_3", expand_before_head=False, init_zero=True,
        stage_args=({"bottle_ratio": 2}, {"final_act": True}, {"bottle_ratio": 0.5}),
    ),
    # the Pre_ plans with exp48's force_residual/force_expansion (partial residuals) and a 5x5 strided dw;
    # the deep stem; mobilenetv3_norm
    "pre_xx_btl_ir_custom2": dict(
        layers=(1, 2, 2, 1), block_fns=("Pre_XX", "Pre_Btl", "Pre_IR", "Pre_Custom_2"), stem_type="deep",
        head_type="mobilenetv3_norm", norm_act="leaky_relu",
        stage_args=({"force_residual": True}, {"bottle_ratio": 0.25, "force_residual": True},
                    {"force_residual": True, "force_expansion": True, "dw_str2_kernel_size": 5}, {}),
    ),
    # Pre_Sep2, Pre_Sep3, Pre_Dark; GENet's stem (a /2 stem, stage 0 strided); antialias; mlp_bn_fc_bn
    "pre_sep2_sep3_dark_antialias": dict(
        layers=(1, 1, 2), channels=(8, 16, 24), block_fns=("Pre_Sep2", "Pre_Sep3", "Pre_Dark"), stem_type="genet",
        first_stage_stride=2, antialias=True, head_type="mlp_bn_fc_bn", norm_act="relu",
    ),
    # each dim_reduction, filter_steps; the dark stem; mlp_2 with per-layer widths
    "dim_reductions_filter_steps": dict(
        layers=(2, 3, 2), channels=(8, 16, 24), block_fns=("XX", "Pre_XX", "IR"), stem_type="dark",
        head_type="mlp_2", head_width=[24, 16],
        stage_args=({"dim_reduction": "stride & expand"},
                    {"dim_reduction": "expand -> stride", "filter_steps": 3, "force_residual": True},
                    {"dim_reduction": "s2d"}),
    ),
    # groups_width with no_groups_with_stride; default_nonorm, head_norm_act none
    "groups_width_no_groups_with_stride": dict(
        layers=(2, 2), channels=(16, 32), block_fns=("XX", "Btl"), groups_width=4, no_groups_with_stride=True,
        stage_args=({}, {"bottle_ratio": 0.5, "groups_width": 8}), head_type="default_nonorm", head_norm_act="none",
    ),
    # groups (no groups_width); the default head with head_norm_act none (its norm's activation is identity)
    "groups_head_norm_act_none": dict(
        layers=(1, 2), channels=(16, 32), block_fns=("XX", "XX"), groups=4, head_type="default", head_norm_act="none",
    ),
    # CSP stages with the doubled transition (csp_simpl_resnet34's layout); mlp_3; mobilenetv3 (the legacy flag)
    "csp_x2_transition": dict(
        layers=(2, 3), channels=(16, 32), block_fns=("XX", "XX"), csp_stages=(True, True), head_type="mlp_3",
        stage_args=({"final_act": True}, {"final_act": True}),
    ),
    "csp_single_transition_mobilenetv3": dict(
        layers=(3, 1, 2), channels=(16, 24, 32), block_fns=("Dark", "Dark", "Pre_XX"), csp_stages=(True, True, True),
        x2_transition=False, csp_block_ratio=0.25, mobilenetv3_head=True, stem_type="dark",
    ),
}
# float32 inside the JAX float64 net
F32_CASES = {
    "se_reduction": dict(attn_type="se", reduction=4, block_fns=("XX", "Btl", "Pre_IR", "IR")),
    "normalize_sphere_fc_mlp_bn_fc": dict(normalize=True, sphere_fc=True, head_type="mlp_bn_fc"),
    "sphere_mlp": dict(sphere_mlp=True, head_type="pool_fc"),
}


def _bnet_pair(opts):
    kw = {**CUT, **opts}
    return JBN.bnet(**dict(kw)), TBN.bnet(**dict(kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_bnet_case_matches_jax_in_float64(case):
    jmod, tmod = _bnet_pair(CASES[case])
    compare_model(jmod, tmod)


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_bnet_case_with_float32_inside_matches_jax(case):
    jmod, tmod = _bnet_pair(F32_CASES[case])
    compare_model(jmod, tmod, tol=SATURATED_SE_TOL if case == "se_reduction" else F32_INSIDE_TOL)


def test_cases_cover_every_plan_stem_head_and_option():
    everything = {**CASES, **F32_CASES}
    plans = {b for o in everything.values() for b in o.get("block_fns", ())}
    assert plans >= {p for k in TBN._PLANS for p in (k, "Pre_" + k)}
    assert {o.get("stem_type", "default") for o in everything.values()} >= {"default", "s2d", "deep", "genet", "dark"}
    heads = {"pool_fc" if o.get("expand_before_head") is False else o.get("head_type", "default")
             for o in everything.values()} | {"mobilenetv3" for o in everything.values() if o.get("mobilenetv3_head")}
    assert heads >= {"default", "default_nonorm", "mobilenetv3", "mobilenetv3_norm", "mlp_2", "mlp_3", "mlp_bn_fc",
                     "mlp_bn_fc_bn", "pool_fc"}
    reductions = {a.get("dim_reduction", "stride & expand")
                  for o in everything.values() for a in o.get("stage_args", ())}
    assert reductions >= {"stride & expand", "expand -> stride", "s2d"}


def test_s2d_stem_orders_channels_as_jax():
    """SpaceToDepth(4) then the stem conv on a non-symmetric input: the 48 input
    channels of the converted kernel line up with the JAX ordering (sy*4 + sx)*3 + c."""
    jmod, tmod = _bnet_pair(dict(stem_type="s2d", layers=(1,), channels=(8,), block_fns=("XX",)))
    rng = np.random.default_rng(3)
    shape = (BATCH, SIZE, SIZE, 3)
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape) % 7 + rng.random(shape)
    with jax.enable_x64(True):
        v = jax.eval_shape(lambda xj: jmod.init(jax.random.PRNGKey(0), xj, train=False), jnp.asarray(x))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), _randomized(v, rng))
        want = np.asarray(jax.jit(lambda v, xj: jmod.apply(v, xj, train=False))(v, jnp.asarray(x)))
    tmod.double().load_state_dict(flax_to_torch_model(tmod, v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tmod.eval()(torch.from_numpy(x)).numpy()
    _close(got, want, "logits", TOL)
    # the converted stem kernel is the JAX one transposed, channel for channel
    k = v["params"]["stem_conv"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(tmod.stem_conv.weight.detach().numpy(), np.transpose(k, (3, 2, 0, 1)))


def test_block_widths_and_groups_follow_jax():
    """The widths and groups each BNetBlock conv gets: Python's round (half to
    even) with the floor of 8, force_expansion's wider base, depthwise over
    the current width, 1x1 never grouped, groups_width per current width."""
    b = TBN.BNetBlock("IR", 21, 21, bottle_ratio=0.5)  # 10.5 -> 10 (half to even)
    assert b.conv0.weight.shape[0] == 10 and b.conv1.groups == 10 and b.conv2.groups == 1
    assert TBN.BNetBlock("IR", 23, 23, bottle_ratio=0.5).conv0.weight.shape[0] == 12  # 11.5 -> 12
    b = TBN.BNetBlock("IR", 64, 16, bottle_ratio=0.25, force_expansion=True)
    assert b.conv0.weight.shape[0] == 16  # max(64, 16) * 0.25
    b = TBN.BNetBlock("IR", 16, 16, bottle_ratio=0.25)
    assert b.conv0.weight.shape[0] == 8  # the floor of 8
    b = TBN.BNetBlock("Btl", 32, 64, bottle_ratio=0.5, groups_width=8)
    assert (b.conv0.groups, b.conv1.groups, b.conv2.groups) == (1, 4, 1)
    b = TBN.BNetBlock("XX", 16, 32, stride=2, dw_kernel_size=9, antialias=True)
    assert b.conv0.stride == 1 and b.blur[0] and b.conv0.weight.shape[-1] == 3
    b = TBN.BNetBlock("IR", 16, 32, stride=2, dw_kernel_size=9)
    assert b.conv1.stride == 2 and b.conv1.weight.shape[-1] == 9 and b.conv1.padding == 4


def test_unknown_block_and_head_raise_key_error():
    with pytest.raises(KeyError, match="unknown block_fn"):
        TBN.BNetBlock("Pre_Nope", 8, 8)
    with pytest.raises(KeyError, match="unknown head_type"):
        TBN.bnet(**{**CUT, "head_type": "nope"})


# --------------------------------------------------------------------------- #
# Train steps: depth-cut exp48 and exp57 through each package's step
# --------------------------------------------------------------------------- #

MIX = dict(cutmix_alpha=1.0, mixup_alpha=0.0, prob=1.0)
EMA, CLASSES = 0.9, 10
STEP_CASES = {
    # exp48: SGD (momentum 0.9, wd 3e-5), EMA, cutmix; lr 0.2
    "exp48": (CONFIGS["exp48"], {"_target_": "sgd", "weight_decay": 3e-5, "momentum": 0.9}, 0.2, None),
    # exp57: weight standardisation (init_gamma 1.72 of configs/base.yaml) and AdamP (wd 3e-5); lr 0.002
    "exp57": ("configs/old_exp/exp1-85/exp57.GENet_no_dim_red_ctmx_ws_adamp.yaml",
              {"_target_": "adamp", "weight_decay": 3e-5}, 0.002, 1.72),
}


def _cut_model_cfg(path):
    """The config's model block at widths / 16, one block per stage, 10 classes."""
    cfg = JC.to_dict(JC.load(path, strict_env=False).model)
    assert cfg.pop("_target_") == "BNet"
    cfg.update(layers=[1, 1, 1, 1], channels=[c // 16 for c in cfg["channels"]], stem_width=8,
               head_width=cfg["head_width"] // 16, num_classes=CLASSES)
    return cfg


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_fired(model, opt_model, before):
    """The JAX projection rule on each matrix (flax leaf rank > 1) of the weights ``before`` the step and the
    gradients the optimizer saw (of the raw weights), both in the flax layout."""
    plan, ranks = _plan(model), flax_ranks(model)
    grads = {n: p.grad for n, p in opt_model.named_parameters()}
    return {n for n in grads if ranks[n] > 1 and _fires(
        _TO_FLAX[plan[n][2]](before[n]).numpy(), _TO_FLAX[plan[n][2]](grads[n]).numpy())}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_recipe_step_matches_jax(case, monkeypatch):
    path, optim, lr, gamma = STEP_CASES[case]
    assert JC.load(path, strict_env=False).optim._target_ == optim["_target_"]
    mcfg = _cut_model_cfg(path)
    jmodel, tmodel = JBN.bnet(**dict(mcfg)), TBN.bnet(**dict(mcfg))
    rng = np.random.default_rng(2)
    images = rng.standard_normal((8, SIZE, SIZE, 3))
    labels = np.eye(CLASSES)[rng.integers(0, CLASSES, 8)]
    with jax.enable_x64(True):
        init = jax.eval_shape(lambda xj: jmodel.init(jax.random.PRNGKey(0), xj, train=False), jnp.asarray(images[:1]))
        rs = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), _randomized(t, rng))  # noqa: E731
        params, stats = rs(init["params"]), rs(init["batch_stats"])
        tx = jax_build_optimizer(optim, lambda count: lr)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params), ema_params=params, ema_batch_stats=stats)
        jnet = jmodel if gamma is None else JParametrizedModel(jmodel, jax_ws_fn(gamma))
        step = jax.jit(jsteps.build_train_step(
            jnet, JCrossEntropyLoss(smoothing=0.1), tx, lambda count: lr, ema_decay=EMA,
            mixup_fn=functools.partial(jsteps.cutmix_mixup, **MIX), input_dtype=jnp.float64,
        ))
        run_key = jax.random.PRNGKey(1)
        k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, 0), 3)  # steps.py:258-259
        draws = _jax_cutmix_draws(k_mix, SIZE, SIZE)
        state, m = step(state, {"image": jnp.asarray(images), "label": jnp.asarray(labels)}, run_key)
        want_m = {k: float(v) for k, v in m.items()}
        final = (_host(state.params), _host(state.batch_stats), _host(state.ema_params), _host(state.ema_batch_stats))
    model = tmodel if gamma is None else ParametrizedModel(tmodel, weight_standardization_fn(gamma))
    units = {"unit_dim": unit_dims(model), "flax_rank": flax_ranks(model)}
    tstate = steps.init_state(model, lambda m: build_optimizer(optim, m.named_parameters(), **units), device="cpu",
                              ema_decay=EMA)
    init_sd = flax_to_torch_model(tmodel, _host(params), _host(stats))
    model.double().load_state_dict(init_sd)
    tstate.ema.double().load_state_dict(init_sd)
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), lambda i: lr, ema_decay=EMA, input_dtype=torch.float64,
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
    assert _rel_l2(want, {k: v.numpy() for k, v in init_sd.items()}) > 1e-4  # the step moved the weights
    if gamma is not None:
        opt = tstate.optimizer
        names = {id(p): n for n, p in model.named_parameters()}
        projected = {names[id(p)] for p, f in zip(opt.matrix_params, opt.projected.tolist()) if f}
        assert projected == _port_fired(tmodel, model, init_sd)
        assert set(model.selected[0]) <= projected  # every standardised kernel's step was projected
