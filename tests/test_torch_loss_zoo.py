"""The rest of the port's losses against the JAX package's, on the same numpy
inputs from a seed, and the pieces around them:

  * ``FocalLoss``, ``BinaryFocalLoss``, ``BinaryKLDivLoss`` and
    ``SigmoidLoss`` (each reduction), ``HardNegativeWrapper`` and
    ``FixMatchLoss``: value and gradient w.r.t. the logits, on class ids,
    one-hot and soft targets, in float64 at rtol 1e-10 and in float32 at
    rtol 1e-5;
  * ``FnLoss`` and the registry's names and aliases (the JAX
    ``losses/__init__.py``);
  * the masked eval step's loss for a criterion with ``reduction`` (its
    per-sample form, weighted by the mask; a (B, C) one averaged over its
    classes) and for one without (the loss of the whole batch, pads
    included), as the JAX eval step takes them (steps.py:388-398);
  * ``sigmoid_trick``: the classifier bias -log(C - 1) on every ``fc`` bias
    (ResNet), else the last bias of width C (a CModel's Linear head), as
    the JAX ``apply_sigmoid_trick``; the CLI sets the EMA's too;
  * ``utils.misc.sqrt``: the correctly rounded float32 square root that the
    optimizers take, held to numpy's on 10^5 values.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.losses import smooth as JS
from sota_imagenet_tpu.losses import wrappers as JW
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.losses import smooth as TS
from sota_imagenet_tpu_torch.losses import wrappers as TW
from sota_imagenet_tpu_torch.losses import FnLoss, angular
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.registry import resolve
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.utils.misc import foreach_sqrt_, sqrt
from sota_imagenet_tpu_torch.utils.weights import apply_sigmoid_trick, flax_to_torch_model

B, C = 8, 50
RTOL = {np.float64: 1e-10, np.float32: 1e-5}


def _inputs(dtype, target_kind, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, C)) * 3).astype(dtype)
    ids = rng.integers(0, C, B)
    if target_kind == "ids":
        return logits, ids
    if target_kind == "one_hot":
        return logits, np.eye(C, dtype=dtype)[ids]
    soft = rng.random((B, C)).astype(dtype)
    return logits, soft / soft.sum(-1, keepdims=True)


CRITERIA = {
    "focal": lambda m, r: m.FocalLoss(gamma=2.0, reduction=r),
    "focal_alpha": lambda m, r: m.FocalLoss(gamma=1.5, alpha=0.25, reduction=r),
    "binary_focal": lambda m, r: m.BinaryFocalLoss(reduction=r),
    "binary_focal_alpha_smooth": lambda m, r: m.BinaryFocalLoss(gamma=1.0, alpha=0.25, smoothing=0.1, reduction=r),
    "binary_focal_reduced_temp": lambda m, r: m.BinaryFocalLoss(combine_thr=0.5, temperature=0.2, reduction=r),
    "binary_kl": lambda m, r: m.BinaryKLDivLoss(reduction=r),
    "binary_kl_smooth": lambda m, r: m.BinaryKLDivLoss(reduction=r, smoothing=0.01),
    "sigmoid": lambda m, r: m.SigmoidLoss(reduction=r),
    "sigmoid_smooth": lambda m, r: m.SigmoidLoss(smoothing=0.1, reduction=r),
}


def _value_and_grad(jfn, tfn, logits, target, dtype):
    with jax.enable_x64(dtype == np.float64):
        jv, jvjp = jax.vjp(lambda x: jfn(x, jnp.asarray(target)), jnp.asarray(logits))
        cot = np.random.default_rng(1).standard_normal(np.shape(jv)).astype(dtype)
        (jg,) = jvjp(jnp.asarray(cot))
        jv, jg = np.asarray(jv), np.asarray(jg)
    x = torch.tensor(logits, requires_grad=True)
    tv = tfn(x, torch.from_numpy(np.asarray(target)))
    tv.backward(torch.from_numpy(cot))
    return tv.detach().numpy(), x.grad.numpy(), jv, jg


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("target_kind", ["ids", "one_hot", "soft"])
@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_smooth_loss_value_and_gradient_match_jax(name, target_kind, reduction, dtype):
    logits, target = _inputs(dtype, target_kind)
    tv, tg, jv, jg = _value_and_grad(CRITERIA[name](JS, reduction), CRITERIA[name](TS, reduction), logits, target,
                                     dtype)
    assert tv.shape == jv.shape and tv.dtype == jv.dtype
    np.testing.assert_allclose(tv, jv, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(jv).max())
    np.testing.assert_allclose(tg, jg, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(jg).max())


WRAPPERS = {
    "hard_negative_bkl": lambda w, s: w.HardNegativeWrapper(s.BinaryKLDivLoss(reduction="none"), hard_pct=0.1),
    "hard_negative_bkl_smooth_k1": lambda w, s: w.HardNegativeWrapper(
        s.BinaryKLDivLoss(reduction="none", smoothing=0.05), 0.01),
    "fixmatch": lambda w, s: w.FixMatchLoss(hard_weight=0.01, hard_pct=0.1),
    "fixmatch_k1": lambda w, s: w.FixMatchLoss(hard_weight=0.5, hard_pct=0.01),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("target_kind", ["ids", "one_hot", "soft"])
@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_value_and_gradient_match_jax(name, target_kind, dtype):
    """The top-k runs over the classes of each sample; FixMatch's target for the
    first half is the detached sigmoid of the second half."""
    make = WRAPPERS[name]
    logits, target = _inputs(dtype, target_kind)
    tv, tg, jv, jg = _value_and_grad(make(JW, JS), make(TW, TS), logits, target, dtype)
    np.testing.assert_allclose(tv, jv, rtol=RTOL[dtype])
    np.testing.assert_allclose(tg, jg, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(jg).max())
    if name.startswith("fixmatch"):
        assert not np.any(tg[B // 2:])  # the second half is the (detached) target only


def test_registry_names_and_aliases_of_the_jax_losses():
    for names, cls in (
        (("focal", "FocalLoss", "pytorch_tools.losses.FocalLoss"), TS.FocalLoss),
        (("binary_focal", "BinaryFocalLoss", "a-focal"), TS.BinaryFocalLoss),
        (("binary_kl", "BinaryKLDivLoss", "kld", "pytorch_tools.losses.BinaryKLDivLoss"), TS.BinaryKLDivLoss),
        (("sigmoid_loss", "SigmoidLoss", "sigmoid"), TS.SigmoidLoss),
        (("hard_negative", "HardNegativeWrapper", "src.utils.HardNegativeWrapper"), TW.HardNegativeWrapper),
        (("fixmatch", "FixMatchLoss", "src.utils.FixMatchLoss"), TW.FixMatchLoss),
        (("cross_entropy", "a-softmax", "normalized_ce"), TS.CrossEntropyLoss),
        (("adacos", "mlp_adacos"), angular.AdaCos),
    ):
        for n in names:
            assert resolve(n) is cls, n
    fn = FnLoss(lambda a, b: (a - b).square().mean())
    assert float((fn + fn * 0.5)(torch.ones(3), torch.zeros(3))) == 1.5


# --------------------------------------------------------------------------- #
# The masked eval step's loss
# --------------------------------------------------------------------------- #

HEAD = [{"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}}, {"module": "Linear", "args": [3, C]}]
EVAL_CRITERIA = {
    "cross_entropy": lambda m: m[1].CrossEntropyLoss(smoothing=0.1),
    "binary_kl": lambda m: m[1].BinaryKLDivLoss(),
    "hard_negative": lambda m: m[2].HardNegativeWrapper(m[1].BinaryKLDivLoss(reduction="none"), 0.1),
    "sigmoid": lambda m: m[1].SigmoidLoss(smoothing=0.1),
}


@pytest.mark.parametrize("name", sorted(EVAL_CRITERIA))
def test_masked_eval_loss_takes_the_per_sample_form_as_jax(name):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((B, 4, 4, 3)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    mask = np.array([1, 1, 1, 0, 1, 0, 0, 1], np.float32)
    batch = {"image": images, "label": labels, "mask": mask}
    jmodel = JCModel(layer_config=HEAD)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 4, 3)), train=False)
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats={},
                              opt_state=None)
    jcrit = EVAL_CRITERIA[name]((None, JS, JW))
    want = jsteps.build_eval_step(jmodel, jcrit, input_dtype=jnp.float32)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    model = CModel(layer_config=HEAD)
    tstate = steps.init_state(model, lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()),
                              device="cpu")
    model.load_state_dict(flax_to_torch_model(model, jax.tree_util.tree_map(np.asarray, variables["params"])))
    tcrit = EVAL_CRITERIA[name]((None, TS, TW))
    got = steps.build_eval_step(tcrit, input_dtype=torch.float32)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert hasattr(tcrit, "reduction") == hasattr(jcrit, "reduction")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert tcrit.reduction == "mean" if hasattr(tcrit, "reduction") else True  # the step copies, never edits it


# --------------------------------------------------------------------------- #
# sigmoid_trick
# --------------------------------------------------------------------------- #


def test_sigmoid_trick_sets_the_fc_bias_of_a_resnet_as_jax():
    from sota_imagenet_tpu.models import resnet18 as jresnet18
    from sota_imagenet_tpu.utils.misc import apply_sigmoid_trick as japply
    from sota_imagenet_tpu_torch.models import resnet18

    jmodel = jresnet18(num_classes=C)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, variables)
    want_params = jax.tree_util.tree_map(np.asarray, japply(host["params"]))
    model = resnet18(num_classes=C)
    model.load_state_dict(flax_to_torch_model(model, host["params"], host["batch_stats"]))
    assert apply_sigmoid_trick(model) == ["fc.bias"]
    want = flax_to_torch_model(model, want_params, host["batch_stats"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert float(model.fc.bias.detach()[0]) == pytest.approx(-np.log(C - 1), rel=1e-6)


def test_sigmoid_trick_falls_back_to_the_last_bias_of_width_c_as_jax():
    from sota_imagenet_tpu.utils.misc import apply_sigmoid_trick as japply

    layers = [{"module": "conv3x3", "args": [3, C], "kwargs": {"bias": True}}, *HEAD[:1],
              {"module": "Linear", "args": [C, C]}, {"module": "ReLU"}, {"module": "Linear", "args": [C, C]}]
    jmodel = JCModel(layer_config=layers)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 4, 3)))["params"])
    want_params = jax.tree_util.tree_map(np.asarray, japply(params, num_classes=C))
    model = CModel(layer_config=layers)
    model.load_state_dict(flax_to_torch_model(model, params))
    assert apply_sigmoid_trick(model, num_classes=C) == ["layers.4.0.bias"]
    want = flax_to_torch_model(model, want_params)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="sigmoid_trick"):
        apply_sigmoid_trick(CModel(layer_config=layers[:2]))


def test_cli_sigmoid_trick_sets_the_ema_bias_too(tmp_path):
    from sota_imagenet_tpu_torch.train.callbacks import Callback

    class Grab(Callback):
        def on_begin(self):
            st = self.runner.state
            self.bias = (st.model.state_dict()["fc.bias"].clone(), st.ema.state_dict()["fc.bias"].clone())

    grab = Grab()
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "exp", "1.r50_baseline.yaml")
    cli.main(["-c", config, "loader.backend=synthetic", "val_loader.backend=synthetic", "model={_target_: resnet18}",
              "loader.image_size=16", "loader.batch_size=2", "val_loader.batch_size=2", "run.bf16=false",
              "debug=true", "run.ema_decay=0.9", "+sigmoid_trick=true", "criterion={_target_: sigmoid}",
              "log.tensorboard=false",
              "run.stages=[{start: 0, end: 1, lr: [0.0, 0.0]}]", f"log.dir={tmp_path}"], device="cpu",
             callbacks=[grab])
    want = torch.full((1000,), -float(np.log(999)))
    assert torch.equal(grab.bias[0], want) and torch.equal(grab.bias[1], want)
    assert glob.glob(os.path.join(tmp_path, "*", "*", "model_last.ckpt"))


# --------------------------------------------------------------------------- #
# The correctly rounded float32 square root
# --------------------------------------------------------------------------- #


def test_sqrt_is_correctly_rounded_in_float32_as_numpy():
    """numpy's float32 sqrt is IEEE's (as XLA's jnp.sqrt); torch's CPU kernel is
    not on every host, which is what the helper is for."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 10, 50_000), np.exp(rng.uniform(-80, 80, 50_000))]).astype(np.float32)
    got = sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
    t = [torch.from_numpy(x.copy()), torch.from_numpy(x[:100].astype(np.float64))]
    foreach_sqrt_(t)
    np.testing.assert_array_equal(t[0].numpy(), np.sqrt(x))
    # float64 takes torch's own root, within one float64 ulp
    np.testing.assert_allclose(t[1].numpy(), np.sqrt(x[:100].astype(np.float64)), rtol=2.3e-16, atol=0)
    np.testing.assert_array_equal(float(sqrt(torch.tensor(2.0))), np.sqrt(np.float32(2.0)))
