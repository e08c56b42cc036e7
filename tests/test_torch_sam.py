"""The port's SAM train step (``train/steps.py``, ``SamPerturbation``; the
SAM and SAMOriginal callbacks) against the JAX package's
``build_train_step(sam=...)`` (steps.py:257-339), from the same weights and
batches, for each kind (``asam``, ``asam_unitwise``, ``sam_original``):

  * the linear setup of tests/test_sam_math.py (y = W mean(x) + b, a
    squared-error loss, SGD at lr 1: the update is the perturbed point's
    gradient), one float64 step: loss, grad_norm and weights within 1e-9
    (of each tensor's largest value);
  * a small float64 CModel whose forward reads its buffers (VarEMA with
    ``use: true`` around a 3x3 conv, a Linear head), two steps with
    ``accumulate_steps=2``, AGC and the type-1 ortho loss, SGD with momentum
    and weight decay, ``bn_from_perturbed`` true (the second pass moves the
    statistics again) and false (it starts from the step's buffers and the
    step keeps the clean pass's): loss, grad_norm, weights and buffers
    within 1e-9. The ortho loss is float32 in both packages; its weight
    (1e-4) keeps float32's rounding of its gradient below that;
  * a depth-cut 24.nf_conv-act trunk (ConvActBlocks, VarEMA monitors,
    NormFreeBlockTimm with ECA, BlurPool, the scaled 1x1 head) with its drop
    rates at 0 (the second pass's dropout key cannot be matched), the same
    step options, in float32 (F32_TOL below says why and how close).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.losses.base import FnLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.optim.factory import agc as jax_agc
from sota_imagenet_tpu.train import callbacks as JCB
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.optim.factory import agc
from sota_imagenet_tpu_torch.registry import resolve
from sota_imagenet_tpu_torch.train import callbacks as TCB
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

TOL = 1e-9
KINDS = {
    "asam": {"_target_": "SAM", "rho": 0.05},
    "asam_unitwise": {"_target_": "src.callbacks.SAM", "unitwise": True, "rho": 0.01},
    "sam_original": {"_target_": "SAMOriginal", "rho": 0.5, "eta": 0.01},
}


def _sam_options(kind: str, bn_from_perturbed: bool = True):
    """The port's callback from its config node, and the JAX callback's ``sam`` option."""
    node = dict(KINDS[kind])
    cls = node.pop("_target_")
    port = resolve(cls)(**node, bn_from_perturbed=bn_from_perturbed).step_options()["sam"]
    jcls = JCB.SAMOriginal if kind == "sam_original" else JCB.SAM
    want = jcls(**node, bn_from_perturbed=bn_from_perturbed).step_options()["sam"]
    assert port == want
    return port, want


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-12), err_msg=what)


# --------------------------------------------------------------------------- #
# The linear setup of tests/test_sam_math.py
# --------------------------------------------------------------------------- #

LINEAR = [{"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}}, {"module": "Linear", "args": [3, 4]}]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sam_step_matches_jax_on_the_linear_setup(kind):
    port_sam, jax_sam = _sam_options(kind)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4, 4, 3))
    y = rng.standard_normal((8, 4))
    with jax.enable_x64(True):
        jmodel = JCModel(layer_config=LINEAR)
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 4, 3)), train=False)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        sched = lambda s: jnp.asarray(1.0, jnp.float32)
        tx = jax_build_optimizer({"_target_": "sgd"}, sched)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                                  opt_state=tx.init(params))
        crit = FnLoss(lambda logits, labels: jnp.mean((logits - labels) ** 2))
        step = jax.jit(jsteps.build_train_step(jmodel, crit, tx, sched, input_dtype=jnp.float64, sam=jax_sam))
        new, jm = step(state, {"image": jnp.asarray(x), "label": jnp.asarray(y)}, jax.random.PRNGKey(1))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        init, final = host(params), host(new.params)
    model = CModel(layer_config=LINEAR)
    state = steps.init_state(model, lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()), device="cpu")
    model.load_state_dict(flax_to_torch_model(model, init))
    model.double()
    tstep = steps.build_train_step(lambda logits, labels: ((logits - labels) ** 2).mean(), lambda i: 1.0,
                                   input_dtype=torch.float64, sam=port_sam)
    state, m = tstep(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
    for k in ("loss", "grad_norm"):
        _close(float(m[k]), float(jm[k]), k)
    want = flax_to_torch_model(model, final)
    for k, v in model.state_dict().items():
        _close(v.numpy(), want[k].numpy(), k)
    assert not np.allclose(want["layers.1.0.weight"].numpy(), flax_to_torch_model(model, init)["layers.1.0.weight"])


# --------------------------------------------------------------------------- #
# A float64 CModel with buffers that the forward reads, and a depth-cut
# 24.nf_conv-act trunk in float32
# --------------------------------------------------------------------------- #

N_STEPS, BATCH, SIZE, CLASSES, ACCUM = 2, 8, 16, 10, 2
# VarEMA with ``use: true`` normalises by its running std (clamped, Batch-ReNorm style), so the second
# pass's gradients depend on the buffers it starts from: bn_from_perturbed shows in the weights too
SMALL = yaml.safe_load("""
- [-1, 1, VarEMA, [], {use: true}]
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, VarEMA, [], {use: true}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [8, 10]]
""")
LAYERS = yaml.safe_load("""
- [-1, 1, ConvActBlock, [3, 8], {stride: 2, conv_kwargs: {gain_init: 1.0}}]
- [-1, 1, ConvActBlock, [8, 16], {conv_kwargs: {gain_init: 0.5}}]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [16, 16], {stride: 2, groups_width: 8}]
- [-1, 1, VarEMA]
- [-1, 1, "pt.modules.BlurPool", 16]
- [-1, 1, NormFreeBlockTimm, [16, 48, 32]]
- [-1, 1, VarEMA]
- [-1, 1, scaled_conv1x1, [48, 64], {gamma: 2}]
- [-1, 1, 'torch.nn.SiLU']
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "torch.nn.Dropout", [0.0]]
- [-1, 1, "nn.Linear", [64, 10]]
""")
# 24.nf_conv-act's blocks with SiLU for swish_hard (whose kinks at -3 and 3 a float32 rounding can cross,
# tests/test_torch_nf_train_step.py) and the drop rates at 0
EXTRA = {
    "ConvActBlock": {"activation": "silu", "conv_kwargs": {"gamma": 2, "gain_init": 0.1, "n_heads": 1}},
    "NormFreeBlockTimm": {"activation": "silu", "groups_width": 8, "alpha": 0.2, "attention_type": "eca9",
                          "keep_prob": 1.0, "regnet_attention": True, "conv_kwargs": {"gamma": 2}},
    "VarEMA": {"use": False},
}
MODELS = {"small_f64": (SMALL, {}, np.float64), "trunk_24_f32": (LAYERS, EXTRA, np.float32)}
# the trunk computes in float32 (its ScaledStdConv standardises in float32 in both packages, and the JAX
# ECA takes its gate in float32, so it cannot run in float64): the tolerances of
# tests/test_torch_nf_train_step.py, loss rtol 1e-5, grad_norm rtol 1e-3, every state tensor within relative
# L2 1e-4 (XLA:CPU's float32 gradients of such a net are ~1e-4 off a float64 truth)
F32_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "state": 1e-4}
OPTIM = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
ORTHO = dict(type=1, weight=1e-4, min_filters=4, min_norm=0.1)
LR = 2.0**-4
AGC_CLIP = 0.05


def _batches(dtype):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3)).astype(dtype)
    labels = np.eye(CLASSES, dtype=dtype)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


@pytest.fixture(scope="module")
def jax_init():
    out = {}
    for name, (layers, extra, _) in MODELS.items():
        jmodel = JCModel(layer_config=layers, extra_kwargs=extra)
        variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(
            jax.random.PRNGKey(0))
        out[name] = (jax.tree_util.tree_map(np.asarray, variables["params"]),
                     jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return out


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


@pytest.mark.parametrize("bn_from_perturbed", [True, False], ids=["bn_from_perturbed", "bn_from_clean"])
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("model_name", sorted(MODELS))
def test_sam_steps_with_accumulation_agc_and_ortho_loss_match_jax(jax_init, model_name, kind, bn_from_perturbed):
    """Two steps, accumulate_steps 2, AGC and the ortho loss: float64 at 1e-9 on the small model, float32
    at F32_TOL on the 24 trunk."""
    port_sam, jax_sam = _sam_options(kind, bn_from_perturbed)
    layers, extra, dtype = MODELS[model_name]
    params0, stats0 = jax_init[model_name]
    images, labels = _batches(dtype)
    jm_all = []
    jdtype = jnp.float64 if dtype == np.float64 else jnp.float32
    with jax.enable_x64(dtype == np.float64):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdtype), t)
        jmodel = JCModel(layer_config=layers, extra_kwargs=extra)
        sched = lambda s: jnp.asarray(LR, jnp.float32)
        tx = jax_build_optimizer(OPTIM, sched)
        params, stats = cast(params0), cast(stats0)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params))
        step = jax.jit(jsteps.build_train_step(
            jmodel, JCrossEntropyLoss(smoothing=0.1), tx, sched, accumulate_steps=ACCUM, sam=jax_sam,
            aux_loss=JCB.OrthoLossClb(**ORTHO).step_options()["aux_loss"], grad_transform=jax_agc(AGC_CLIP),
            input_dtype=jdtype,
        ))
        for i in range(N_STEPS):
            state, jm = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])},
                             jax.random.PRNGKey(1))
            jm_all.append({k: float(v) for k, v in jm.items()})
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        final, final_stats = host(state.params), host(state.batch_stats)
    model = CModel(layer_config=layers, extra_kwargs=extra)
    tstate = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu")
    init = flax_to_torch_model(model, params0, stats0)
    model.load_state_dict(init)
    f64 = dtype == np.float64
    tdtype = torch.float64 if f64 else torch.float32
    model.to(tdtype)
    tstep = steps.build_train_step(
        CrossEntropyLoss(smoothing=0.1), lambda i: LR, accumulate_steps=ACCUM, sam=port_sam,
        aux_loss=TCB.OrthoLossClb(**ORTHO).step_options()["aux_loss"], grad_transform=agc(AGC_CLIP),
        input_dtype=tdtype,
    )
    for i in range(N_STEPS):
        tstate, m = tstep(tstate, {"image": torch.from_numpy(images[i]), "label": torch.from_numpy(labels[i])})
        for k in ("loss", "grad_norm"):
            if f64:
                _close(float(m[k]), jm_all[i][k], f"step {i} {k}")
            else:
                np.testing.assert_allclose(float(m[k]), jm_all[i][k], rtol=F32_TOL[k], err_msg=f"step {i} {k}")
    want = flax_to_torch_model(model, final, final_stats)
    got = model.state_dict()
    for k in want:
        if f64:
            _close(got[k].numpy(), want[k].numpy(), k)
        else:
            assert _rel_l2(got[k].numpy(), want[k].numpy()) < F32_TOL["state"], k
    # the VarEMA statistics moved
    assert all(abs(float(got[k]) - float(init[k])) > 1e-6 for k in got if k.endswith("std_ema"))


def test_sam_moves_the_buffers_by_the_perturbed_pass_only_when_asked(jax_init):
    """bn_from_perturbed: the perturbed pass's statistics are the step's; without it, the clean pass's."""
    params0, stats0 = jax_init["trunk_24_f32"]
    images, labels = _batches(np.float64)
    ends = {}
    for name, sam in (("clean", None), ("perturbed", True), ("kept", False)):
        model = CModel(layer_config=LAYERS, extra_kwargs=EXTRA)
        tstate = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu")
        model.load_state_dict(flax_to_torch_model(model, params0, stats0))
        model.double()
        opts = {} if sam is None else {"sam": {"kind": "asam", "rho": 0.05, "bn_from_perturbed": sam}}
        tstep = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda i: 0.0, input_dtype=torch.float64,
                                       **opts)
        tstep(tstate, {"image": torch.from_numpy(images[0]), "label": torch.from_numpy(labels[0])})
        ends[name] = torch.stack([b for n, b in model.named_buffers() if n.endswith("std_ema")])
    assert torch.equal(ends["kept"], ends["clean"])
    assert not torch.allclose(ends["perturbed"], ends["clean"])


def test_sam_callbacks_register_and_name_their_kind():
    assert TCB.SAM(unitwise=True, rho=0.01).step_options() == {
        "sam": {"kind": "asam_unitwise", "rho": 0.01, "bn_from_perturbed": True}}
    assert resolve("src.callbacks.SAMOriginal") is TCB.SAMOriginal
    with pytest.raises(ValueError, match="unknown SAM kind"):
        steps.build_train_step(CrossEntropyLoss(), sam={"kind": "no_such_kind"})


def test_sam_restores_the_unperturbed_weights_before_the_update():
    """With lr 0 the step leaves every weight bit for bit where it was (p + eps - eps would not)."""
    torch.manual_seed(0)
    model = CModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    tstate = steps.init_state(model, lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()),
                              device="cpu")
    before = {k: v.clone() for k, v in model.named_parameters()}
    images, labels = _batches(np.float32)
    tstep = steps.build_train_step(CrossEntropyLoss(), lambda i: 0.0, input_dtype=torch.float32,
                                   sam={"kind": "asam_unitwise", "rho": 0.5})
    tstep(tstate, {"image": torch.from_numpy(images[0]), "label": torch.from_numpy(labels[0])})
    assert all(torch.equal(before[k], v) for k, v in model.named_parameters())
    assert any(float(p.grad.abs().sum()) > 0 for p in model.parameters())
