"""Adaptive gradient clipping in the port against the JAX package's ``agc``,
and train steps of narrow 80_1 trunks (the non-deep CModel family) with SGD
and AGC against the JAX ``build_train_step(grad_transform=agc(0.01))``.

AGC: the JAX ``_unitwise_norm`` takes one norm per index of the last axis of
the flax layout; the port takes its units from the weights plan
(``unit_dims``). A model with every layout of the plan (an OIHW conv kernel
for flax's HWIO, a Linear weight for flax's (in, out) Dense kernel, ECA's
(1, 1, k) kernel for flax's (k, 1, 1), XCA's (heads, 1, 1) temperatures,
1-d gains and BatchNorm scales and biases, GEM's 0-d and per-channel p)
gets gradients whose units are, alternately, far over and far under their
bound, and some zero parameters (the eps floor): the clipped gradients
equal the JAX ones within 1e-6 relative (float32 norms summed in other
orders), and each layout has a clipped and an untouched unit.

Trunk steps: the float64 trunk is 80_1's layer list at narrow widths with
``scaled: false`` and UFO without its projection (the JAX ScaledStdConv
standardises in float32 even in a float64 net), 83's GEM head, SGD with AGC
0.01 and CutmixMixup on the JAX step's own draws, three steps: loss,
grad_norm and the state within 1e-7. UFO computes q, k and v in float32 in
both packages (its ``astype(float32)``), so its products are float32 ones,
summed in other orders. The float32 trunk: ``scaled: true``, 84's and
84_1's XCA blocks, an 80_1 UFO block, config 21's NormFreeBlockTimm with XCA
(attn_drop 0.1, drop-path 0.85) and a GEM head; its dropout and drop-path
masks are the JAX step's own, recorded from ``jax.random.bernoulli`` and fed
to the port's ``draw_keep_mask``. Tolerances as the float32 NF steps
(tests/test_torch_nf_train_step.py): loss rtol 1e-5, grad_norm rtol 1e-3,
state relative L2 1e-4. Each step also holds AGC's own record: some units
clipped, some not, and none over its bound after the clip."""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.optim.factory import agc as jax_agc
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu.train.schedule import make_lr_schedule as jax_make_lr_schedule
from sota_imagenet_tpu.utils.misc import filter_from_weight_decay as jax_filter_wd
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.optim.factory import AGC, agc
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.callbacks import AdaptiveGradientClipping
from sota_imagenet_tpu_torch.train.schedule import make_lr_schedule
from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model, unit_dims
from tests.test_torch_nf_train_step import MIX, _jax_mixup_draws, _rel_l2
from tests.test_torch_nondeep import _feed_torch_masks, _randomized, _record_jax_masks


# --------------------------------------------------------------------------- #
# AGC against the JAX agc, layout by layout
# --------------------------------------------------------------------------- #

LAYOUT_MODEL = [
    [-1, 1, "ScaledStdConv2d", [3, 16], {"kernel_size": 3, "padding": 1}],  # OIHW kernel, gain, bias
    [-1, 1, "NonDeepBlock", [16, 16], {"xca_kwargs": {"num_heads": 4, "v_norm": True}}],  # BN, (4, 1, 1) temperatures
    [-1, 1, "NormFreeBlockTimm", [16, 16, 16], {"attention_type": "eca"}],  # ECA's (1, 1, 3) kernel
    [-1, 1, "GEM_pool_channel", [16], {"flatten": False}],  # (16,) p
    [-1, 1, "GEM_pool"],  # 0-d p
    [-1, 1, "nn.Linear", [16, 10]],  # (out, in) weight
]
LAYOUTS = {  # a fragment of the state key -> the layout it stands for
    "conv kernel": "0.0.weight",
    "dense kernel": "5.0.weight",
    "eca kernel": "attn.weight",
    "temperature": "temperature",
    "1-d": "gain",
    "bn scale": "norm.weight",
    "gem p": "4.0.p",
    "gem channel p": "3.0.p",
}


def _agc_case(flip: int, seed: int = 0):
    """JAX params and gradients for LAYOUT_MODEL: each unit's gradient 5x or
    1e-3x its bound clipping * max(||p||, eps), alternating over the units of
    a tensor and over the one-unit tensors, the other way round with
    ``flip``; the first conv's bias and the BN biases zero (the eps floor)."""
    rng = np.random.default_rng(seed)
    jmodel, model = JCModel(layer_config=LAYOUT_MODEL), CModel(layer_config=LAYOUT_MODEL)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 8, 3)), train=False)
    params, stats = _randomized(variables["params"], rng), variables["batch_stats"]
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves, grads = [], []
    for i, (path, p) in enumerate(flat):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        zero = name == "ScaledStdConv2d_0/bias" or name.endswith("BatchNorm_0/bias")
        p = np.zeros_like(p) if zero else p
        g = rng.standard_normal(p.shape).astype(np.float32)
        if p.ndim <= 1 or p.shape[-1] == 1:
            axes, parity = tuple(range(p.ndim)), np.asarray((i + flip) % 2)
        else:
            axes, parity = tuple(range(p.ndim - 1)), (np.arange(p.shape[-1]) + flip) % 2
        units_g = np.sqrt(np.sum(g**2, axis=axes, keepdims=True))
        units_p = np.sqrt(np.sum(p**2, axis=axes, keepdims=True))
        g = g / units_g * 0.01 * np.maximum(units_p, 1e-3) * np.where(parity, 5.0, 1e-3)
        leaves.append(np.asarray(p, np.float32))
        grads.append(np.asarray(g, np.float32))
    convert = functools.partial(flax_to_torch_model, model, batch_stats=jax.tree_util.tree_map(np.asarray, stats))
    return convert, model, treedef.unflatten(leaves), treedef.unflatten(grads)


@pytest.fixture(scope="module", params=[0, 1], ids=["even_units_clipped", "odd_units_clipped"])
def agc_case(request):
    convert, model, params, grads = _agc_case(request.param)
    want = jax.tree_util.tree_map(np.asarray, jax_agc(0.01)(grads, params))
    model.load_state_dict(convert(params))
    raw, clipped = convert(grads), convert(want)
    named = dict(model.named_parameters())
    for n, p in named.items():
        p.grad = raw[n].clone()
    clip = agc(0.01)
    clip.record = True
    with torch.no_grad():
        clip(model, list(named.values()), [p.grad for p in named.values()])
    return {"model": model, "named": named, "raw": raw, "clipped": clipped, "clip": clip}


def test_agc_matches_jax_on_every_parameter(agc_case):
    for n, p in agc_case["named"].items():
        want = agc_case["clipped"][n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=n)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_agc_layout_has_a_clipped_and_an_untouched_unit(layout):
    """The JAX clip, read through the port's layout, over the two cases: each
    layout has a unit it scaled down and one it left as it was, so a unit
    axis taken from the torch shape instead of the plan would disagree in
    test_agc_matches_jax_on_every_parameter; the eps floor's zero
    parameters are clipped to 1e-5."""
    changed, kept, floor = 0, 0, []
    for flip in (0, 1):
        convert, model, params, grads = _agc_case(flip)
        raw, clipped = convert(grads), convert(jax.tree_util.tree_map(np.asarray, jax_agc(0.01)(grads, params)))
        dims = unit_dims(model)
        keys = [n for n in raw if LAYOUTS[layout] in n]
        assert keys, layout
        for n in keys:
            a, b, d = raw[n], clipped[n], dims[n]
            pairs = [(a, b)] if a.dim() <= 1 or a.shape[d] == 1 else list(zip(a.unbind(d), b.unbind(d)))
            same = [torch.equal(x, y) for x, y in pairs]
            changed, kept = changed + same.count(False), kept + same.count(True)
        zero = [n for n in raw if n.endswith("norm.bias")]
        floor += [float(torch.linalg.vector_norm(clipped[n])) for n in zero if not torch.equal(raw[n], clipped[n])]
    assert changed and kept, (layout, changed, kept)
    assert floor and all(abs(v - 1e-5) < 1e-9 for v in floor), floor  # a zero BN bias: 0.01 * max(0, eps)


def test_agc_record_counts_units_and_bounds_them(agc_case):
    stats = agc_case["clip"].stats
    n_units = sum(1 if (p.dim() <= 1 or p.shape[d] == 1) else p.shape[d]
                  for (n, p), d in zip(agc_case["named"].items(), unit_dims(agc_case["model"]).values()))
    assert int(stats["units"]) == n_units
    assert 0 < int(stats["clipped"]) < n_units
    assert float(stats["max_ratio_after"]) <= 1.0 + 1e-6


def test_unit_dims_follow_the_plan_not_the_shape():
    model = CModel(layer_config=LAYOUT_MODEL)
    dims = unit_dims(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    eca = next(n for n in dims if n.endswith("attn.weight"))
    temp = next(n for n in dims if n.endswith("temperature"))
    assert shapes[eca] == (1, 1, 3) and dims[eca] == 0  # flax (3, 1, 1): its last axis, of size 1
    assert shapes[temp] == (4, 1, 1) and dims[temp] == -1  # the same shape in flax
    assert dims["layers.0.0.weight"] == 0 and dims["layers.5.0.weight"] == 0


def test_agc_callback_takes_the_reference_names():
    clb = registry.resolve("pytorch_tools.fit_wrapper.callbacks.AdaptiveGradientClipping")(clip_factor=0.02)
    assert isinstance(clb, AdaptiveGradientClipping) and clb.clipping == 0.02 and clb.eps == 1e-3
    opts = clb.step_options()
    assert set(opts) == {"grad_transform"} and isinstance(opts["grad_transform"], AGC)
    assert opts["grad_transform"] is clb.step_options()["grad_transform"]  # one transform for every stage
    assert AdaptiveGradientClipping(clipping=0.05).clipping == 0.05


# --------------------------------------------------------------------------- #
# Train steps of narrow 80_1 trunks with SGD and AGC
# --------------------------------------------------------------------------- #

CONFIG_80_1 = os.path.join(os.path.dirname(__file__), "..", "configs", "exp", "80_1.non-deeps_ufo-0.5_no-res.yaml")
NARROW = {128: 16, 256: 24, 384: 32, 2048: 32, 1000: 10}  # 48 stays: SpaceToDepth(4) of RGB
N_STEPS, BATCH, SIZE, CLASSES = 3, 8, 64, 10
OPTIM = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
PHASES = [{"ep": (0, 1), "lr": (0.05, 0.1)}]


@pytest.fixture(scope="module")
def model_cfg_80_1():
    jcfg = JC.to_dict(JC.load(CONFIG_80_1, strict_env=False))["model"]
    tcfg = TC.to_dict(TC.load(CONFIG_80_1, strict_env=False))["model"]
    assert jcfg == tcfg
    return tcfg


def narrow_80_1(model_cfg: dict, scaled: bool, ufo_proj: bool) -> dict:
    """80_1's model node at NARROW widths, one module per layer, two of its
    four pairs of (UFO, plain) 384-wide blocks, and 83's GEM pool for the
    average pool."""
    cfg = copy.deepcopy(model_cfg)
    layers = []
    for inputs, _, name, *rest in cfg["layer_config"]:
        args = rest[0] if rest else []
        kwargs = copy.deepcopy(rest[1]) if len(rest) > 1 else {}
        args = [NARROW.get(a, a) for a in (args if isinstance(args, list) else [args])]
        if "ufo_kwargs" in kwargs:
            kwargs["ufo_kwargs"]["last_proj"] = ufo_proj
        if name == "pt.modules.FastGlobalAvgPool2d":
            name, args, kwargs = "GEM_pool", [], {}
        layers.append([inputs, 1, name, args, kwargs])
    del layers[10:14]
    cfg["layer_config"] = layers
    cfg["extra_kwargs"]["NonDeepBlock"]["scaled"] = scaled
    cfg.pop("_target_")
    return cfg


def _batches(dtype):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3)).astype(dtype)
    labels = np.eye(CLASSES, dtype=dtype)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


def run_jax_steps(cfg, dtype, masks=None):
    images, labels = _batches(dtype)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jmodel = JCModel(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3), jdt), train=False)
    rng = np.random.default_rng(1)
    # every leaf drawn anew (BN scales and GEM's p near their inits), in the run's dtype
    variables = {k: jax.tree_util.tree_map(lambda a: a.astype(dtype), _randomized(v, rng)) for k, v in variables.items()}
    params, stats = variables["params"], variables["batch_stats"]
    sched = jax_make_lr_schedule(PHASES, steps_per_epoch=4)
    tx = jax_build_optimizer(OPTIM, sched, wd_mask=jax_filter_wd(params, ["gain"]))
    state = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
        ema_params=params, ema_batch_stats=stats,
    )
    step = jsteps.build_train_step(
        jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, mixup_fn=functools.partial(jsteps.cutmix_mixup, **MIX),
        grad_transform=jax_agc(0.01), input_dtype=jdt,
    )
    step = jax.jit(step)
    run_key = jax.random.PRNGKey(1)
    metrics, draws, step_masks = [], [], []
    for i in range(N_STEPS):
        k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, i), 3)  # steps.py:258-259
        draws.append(_jax_mixup_draws(k_mix, SIZE, SIZE))
        if masks is not None:
            masks.clear()
        state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])}, run_key)
        if masks is not None:
            step_masks.append(list(masks))
        metrics.append({k: float(v) for k, v in m.items()})
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"init": host(params), "stats": host(stats), "metrics": metrics, "draws": draws, "masks": step_masks,
            "final": host(state.params), "final_stats": host(state.batch_stats)}


def run_port_steps(cfg, dtype, jax_run, tol, monkeypatch=None):
    images, labels = _batches(dtype)
    model = CModel(**cfg).to(torch.float64 if dtype == np.float64 else torch.float32)
    mask = filter_from_weight_decay(model.named_parameters(), ["gain"])
    state = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters(), wd_mask=mask), device="cpu")
    init = flax_to_torch_model(model, jax_run["init"], jax_run["stats"])
    model.load_state_dict(init)
    clip = AdaptiveGradientClipping(clip_factor=0.01)
    clip.transform.record = True
    fed = iter(jax_run["draws"])
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), make_lr_schedule(PHASES, steps_per_epoch=4),
        input_dtype=torch.from_numpy(images[:1]).dtype, **clip.step_options(),
        mixup_fn=lambda gen, im, lb: steps.apply_cutmix_mixup(im, lb, next(fed), MIX["cutmix_alpha"], MIX["mixup_alpha"]),
    )
    clipped = []
    for i in range(N_STEPS):
        if monkeypatch is not None:
            _feed_torch_masks(monkeypatch, jax_run["masks"][i])
        state, m = tstep(state, {"image": torch.from_numpy(images[i]), "label": torch.from_numpy(labels[i])})
        want = jax_run["metrics"][i]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=tol[k], err_msg=f"step {i} {k}")
        for k in ("lr", "Acc@1", "Acc@5"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-6, err_msg=f"step {i} {k}")
        stats = clip.transform.stats
        clipped.append((int(stats["clipped"]), int(stats["units"])))
        assert float(stats["max_ratio_after"]) <= 1.0 + 1e-6  # every unit within its bound after the clip
    # AGC did something and not everything: some units clipped, some not, at every step
    assert all(0 < c < n for c, n in clipped), clipped
    want = {k: v.numpy() for k, v in flax_to_torch_model(model, jax_run["final"], jax_run["final_stats"]).items()}
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    assert _rel_l2(got, want) < tol["state"]
    for frag in ("weight", "bias", "running_mean", "running_var", ".p"):
        keys = [k for k in want if k.endswith(frag)]
        assert keys and _rel_l2({k: got[k] for k in keys}, {k: want[k] for k in keys}) < tol["state"], frag
    assert _rel_l2(want, {k: v.numpy() for k, v in init.items()}) > 1e-3  # the weights moved
    return state


def test_narrow_80_1_trunk_with_gem_and_agc_three_float64_steps_match_jax(model_cfg_80_1):
    cfg = narrow_80_1(model_cfg_80_1, scaled=False, ufo_proj=False)
    with jax.enable_x64(True):
        jax_run = run_jax_steps(cfg, np.float64)
    state = run_port_steps(cfg, np.float64, jax_run, {"loss": 1e-7, "grad_norm": 1e-7, "state": 1e-7})
    kinds = {type(m).__name__ for m in state.model.modules()}
    assert {"NonDeepBlock", "UFO", "SEVar3", "GEMPool", "SpaceToDepth", "BatchNorm", "Conv"} <= kinds
    assert "ScaledStdConv" not in kinds


def test_scaled_trunk_with_xca_ufo_and_nf_timm_xca_dropout_three_float32_steps_match_jax(model_cfg_80_1, monkeypatch):
    cfg = narrow_80_1(model_cfg_80_1, scaled=True, ufo_proj=True)
    layers = cfg["layer_config"]
    # layers 8-9: an 80_1 UFO block and a plain one; then 84's and 84_1's XCA blocks and config 21's
    # NormFreeBlockTimm with XCA, before the GEM head
    layers[9:9] = [
        [-1, 1, "NonDeepBlock", [32, 32], {"xca_kwargs": {"residual": True, "last_proj": True}}],
        [-1, 1, "NonDeepBlock", [32, 32], {"xca_kwargs": {"residual": True, "last_proj": True, "v_norm": True}}],
        [-1, 1, "NormFreeBlockTimm", [32, 32, 32]],
    ]
    cfg["extra_kwargs"]["NormFreeBlockTimm"] = {
        "activation": "swish_hard", "groups_width": 8, "alpha": 0.2, "attention_type": "xca", "regnet_attention": True,
        "attention_kwargs": {"attn_drop": 0.1, "proj_drop": 0.1}, "keep_prob": 0.85, "conv_kwargs": {"gamma": 1.7},
    }
    masks = _record_jax_masks(monkeypatch)
    jax_run = run_jax_steps(cfg, np.float32, masks=masks)
    assert all(len(m) == 2 for m in jax_run["masks"])  # the XCA's attn mask and the drop-path mask, each step
    state = run_port_steps(cfg, np.float32, jax_run, {"loss": 1e-5, "grad_norm": 1e-3, "state": 1e-4}, monkeypatch)
    kinds = {type(m).__name__ for m in state.model.modules()}
    assert {"NonDeepBlock", "UFO", "XCA", "NormFreeBlockTimm", "ScaledStdConv", "GEMPool", "Dropout"} <= kinds
