"""Three float32 train steps of a tiny CModel of the 41.nf_conv-act_lamb kind
in the port against the JAX package's build_train_step, from identical
weights and batches: ConvActBlocks with VarEMA monitors (``use: false``, as
24.nf_conv-act sets it), NormFreeBlockTimm with ECA (regnet attention),
BlurPool, a scaled 1x1 head conv and a Linear classifier; label-smoothing
CE (0.1); LAMB through ``badam`` (wd 5e-3, eps 1e-6) with ``filter_from_wd:
[gain]``; OrthoLossClb type 1 (min_filters 8, min_norm 0.1, weight 1e-2) as
the auxiliary loss; ``accumulate_steps=2``; CutmixMixup on the JAX step's
own draws; the recipe's cosine from 0.003.

SiLU stands in for swish_hard: hard-swish has kinks at -3 and 3, and a
float32 rounding that moves a pre-activation across one moves the gradient
(the "Chaos" note of ROADMAP.md). drop-path and dropout are off (keep_prob
1, rate 0): their masks come from generators that cannot agree.

Tolerances, as for the NFNet/AdamW steps of tests/test_torch_train_step.py:
per-step loss (the criterion plus the auxiliary loss, as in JAX) rtol 1e-5,
grad_norm rtol 1e-3 (XLA:CPU's float32 gradient of such a net is ~1e-4 off
a float64 truth); the updated parameters, the VarEMA statistics and each
group of parameters within relative L2 1e-4 (LAMB's first step moves each
weight by lr * trust * g / (|g| + eps), so a gradient element within
rounding of zero may move its weight the other way)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import callbacks as JCB
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu.train.schedule import make_lr_schedule as jax_make_lr_schedule
from sota_imagenet_tpu.utils.misc import filter_from_weight_decay as jax_filter_wd
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import callbacks as TCB
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.schedule import make_lr_schedule
from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

N_STEPS, BATCH, SIZE, CLASSES, ACCUM = 3, 16, 32, 10, 2
LAYERS = yaml.safe_load("""
- [-1, 1, ConvActBlock, [3, 8], {stride: 2, conv_kwargs: {gain_init: 1.0}}]
- [-1, 1, ConvActBlock, [8, 16], {conv_kwargs: {gain_init: 0.5}}]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [16, 16], {stride: 2, groups_width: 8}]
- [-1, 1, VarEMA]
- [-1, 1, "pt.modules.BlurPool", 16]
- [-1, 1, NormFreeBlockTimm, [16, 48, 32]]
- [-1, 1, NormFreeBlockTimm, [48, 48, 32]]
- [-1, 1, VarEMA]
- [-1, 1, scaled_conv1x1, [48, 64], {gamma: 2}]
- [-1, 1, 'torch.nn.SiLU']
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "torch.nn.Dropout", [0.0]]
- [-1, 1, "nn.Linear", [64, 10]]
""")
EXTRA = {
    "ConvActBlock": {"activation": "silu", "conv_kwargs": {"gamma": 2, "gain_init": 0.1, "n_heads": 1}},
    "NormFreeBlockTimm": {"activation": "silu", "groups_width": 8, "alpha": 0.2, "attention_type": "eca9",
                          "keep_prob": 1.0, "regnet_attention": True, "conv_kwargs": {"gamma": 2}},
    "VarEMA": {"use": False},
}
OPTIM = {"_target_": "badam", "lamb": True, "weight_decay": 5e-3, "eps": 1e-6}
ORTHO = dict(type=1, weight=1e-2, min_filters=8, min_norm=0.1)
MIX = dict(cutmix_alpha=1.0, mixup_alpha=0.2, prob=1.0)
PHASES = [{"ep": (0, 1), "lr": (0.003, 0.0), "mode": "cos"}]
TOL = {"loss": 1e-5, "grad_norm": 1e-3, "state": 1e-4}


def _batches():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


def _jax_mixup_draws(key, h, w):
    """What the JAX cutmix_mixup draws from ``key`` (steps.py:66-103), as the port's draws."""
    k_apply, k_choice, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    draws = {
        "apply": jax.random.bernoulli(k_apply, MIX["prob"]),
        "use_cutmix": jax.random.bernoulli(k_choice, 0.5),
        "lam_m": jax.random.beta(k_lam_m, MIX["mixup_alpha"], MIX["mixup_alpha"]),
        "lam_c": jax.random.beta(k_lam_c, MIX["cutmix_alpha"], MIX["cutmix_alpha"]),
        "cy": jax.random.randint(k_box, (), 0, h),
        "cx": jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, w),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _rel_l2(got: dict, want: dict) -> float:
    a = np.concatenate([np.asarray(got[k], np.float64).reshape(-1) for k in sorted(want)])
    b = np.concatenate([np.asarray(want[k], np.float64).reshape(-1) for k in sorted(want)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_steps():
    images, labels = _batches()
    jmodel = JCModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    sched = jax_make_lr_schedule(PHASES, steps_per_epoch=4)
    tx = jax_build_optimizer(OPTIM, sched, wd_mask=jax_filter_wd(params, ["gain"]))
    state = jsteps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
        ema_params=params, ema_batch_stats=stats,
    )
    step = jax.jit(
        jsteps.build_train_step(
            jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, accumulate_steps=ACCUM,
            mixup_fn=functools.partial(jsteps.cutmix_mixup, **MIX),
            aux_loss=JCB.OrthoLossClb(**ORTHO).step_options()["aux_loss"], input_dtype=jnp.float32,
        )
    )
    run_key = jax.random.PRNGKey(1)
    metrics, draws = [], []
    for i in range(N_STEPS):
        k_mix, _, _ = jax.random.split(jax.random.fold_in(run_key, i), 3)  # steps.py:258-259
        draws.append(_jax_mixup_draws(k_mix, SIZE, SIZE))
        state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])}, run_key)
        metrics.append({k: float(v) for k, v in m.items()})
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    aux0 = float(JCB.OrthoLossClb(**ORTHO).step_options()["aux_loss"](params))
    return {"init": host(params), "stats": host(stats), "metrics": metrics, "draws": draws, "aux0": aux0,
            "final": host(state.params), "final_stats": host(state.batch_stats)}


def test_lamb_ortho_loss_accumulated_mixup_steps_match_jax(jax_steps):
    images, labels = _batches()
    model = CModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    mask = filter_from_weight_decay(model.named_parameters(), ["gain"])
    state = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters(), wd_mask=mask), device="cpu")
    init = flax_to_torch_model(model, jax_steps["init"], jax_steps["stats"])
    model.load_state_dict(init)
    aux = TCB.OrthoLossClb(**ORTHO).step_options()["aux_loss"]
    assert float(aux(model).detach()) == pytest.approx(jax_steps["aux0"], rel=1e-5) and jax_steps["aux0"] > 0
    fed = iter(jax_steps["draws"])
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), make_lr_schedule(PHASES, steps_per_epoch=4), accumulate_steps=ACCUM,
        input_dtype=torch.float32, aux_loss=aux,
        mixup_fn=lambda gen, im, lb: steps.apply_cutmix_mixup(im, lb, next(fed), MIX["cutmix_alpha"], MIX["mixup_alpha"]),
    )
    for i in range(N_STEPS):
        state, m = tstep(state, {"image": torch.from_numpy(images[i]), "label": torch.from_numpy(labels[i])})
        want = jax_steps["metrics"][i]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=TOL[k], err_msg=f"step {i} {k}")
        for k in ("lr", "Acc@1", "Acc@5"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-6, err_msg=f"step {i} {k}")
    assert type(state.optimizer).__name__ == "Lamb" and state.step == N_STEPS
    want = _np(flax_to_torch_model(model, jax_steps["final"], jax_steps["final_stats"]))
    got = _np(state.model.state_dict())
    assert _rel_l2(got, want) < TOL["state"]
    for frag in ("weight", "gain", "bias", "std_ema", "mean_ema"):
        keys = [k for k in want if k.endswith(frag)]
        assert keys and _rel_l2({k: got[k] for k in keys}, {k: want[k] for k in keys}) < TOL["state"], frag
    init_np = _np(init)
    assert _rel_l2(want, init_np) > 1e-3  # the weights moved
    # the VarEMA monitors moved once per microbatch: 2 x 3 times
    assert all(abs(float(got[k]) - 1.0) > 1e-3 for k in got if k.endswith("std_ema"))
