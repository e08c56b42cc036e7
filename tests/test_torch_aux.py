"""The parameter-only pieces of the norm-free recipe against the JAX package:
the auxiliary losses (OrthoLossClb types 1 and 2, NormLossClb), the
backward weight norm (WeightNorm's post-step transform), the set of kernel
parameters they select, and OrthoInitClb.

A narrow CModel of the 24.nf_conv-act kind (ConvActBlocks, VarEMA,
NormFreeBlockTimm with ECA, a scaled 1x1 head conv, a Linear classifier)
is built in both packages; its JAX tree, drawn from a numpy seed, is
carried over by ``flax_to_torch_model``. Each loss's value and its gradient
with respect to every parameter agree within 1e-5 (relative to the
largest), float32; the weight norm's new parameters within 1e-6.
OrthoInitClb draws from another generator than the JAX package's, so it is
held to what it must do: orthonormal filters, only the kernel set touched,
the EMA copy left as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.models.parametrize import backward_weight_norm as jax_backward_weight_norm
from sota_imagenet_tpu.train import callbacks as JCB
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.models.parametrize import backward_weight_norm
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import callbacks as TCB
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.train.schedule import phases_from_stages
from sota_imagenet_tpu_torch.config import parse_stages
from sota_imagenet_tpu_torch.utils import weights as W

LAYERS = yaml.safe_load("""
- [-1, 1, ConvActBlock, [3, 8], {stride: 2}]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [8, 16], {stride: 2, groups_width: 8}]
- [-1, 1, ConvActBlock, [16, 16], {groups_width: 8}]
- [-1, 1, VarEMA]
- [-1, 1, "pt.modules.BlurPool", 16]
- [-1, 1, NormFreeBlockTimm, [16, 96, 72]]
- [-1, 1, NormFreeBlockTimm, [96, 96, 72]]
- [-1, 1, scaled_conv1x1, [96, 128], {gamma: 2}]
- [-1, 1, 'torch.nn.SiLU']
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [128, 64]]
""")
EXTRA = {
    "ConvActBlock": {"activation": "silu", "conv_kwargs": {"gamma": 2, "gain_init": 0.1}},
    "NormFreeBlockTimm": {"activation": "silu", "groups_width": 8, "attention_type": "eca9", "regnet_attention": True,
                          "conv_kwargs": {"gamma": 2}},
    "VarEMA": {"use": False},
}
TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params and batch_stats, the port's model with them)."""
    rng = np.random.default_rng(0)
    jmodel = JCModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(rng.standard_normal(a.shape) * 0.3, np.float32), variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return params, stats


def _port(params, stats) -> CModel:
    model = CModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    model.load_state_dict(W.flax_to_torch_model(model, params, stats))
    return model


def _close(got: dict, want: dict, tol: float):
    scale = max(max(np.abs(v).max() for v in want.values()), 1.0)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol * scale, err_msg=k)


def test_kernel_parameters_are_the_jax_kernel_leaves_eca_included(models):
    params, stats = models
    model = _port(params, stats)
    plan = W._plan(model)
    got = {plan[n][1] for n in W.kernel_parameters(model)}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path) for path, _ in flat if str(getattr(path[-1], "key", "")) == "kernel"}
    assert got == want
    assert any("ECA_0" in p for p in got) and any(p.startswith("Dense") or "/Dense_0/" in p for p in got)
    kinds = {n.rsplit(".", 1)[-1] for n in model.state_dict()} - {n.rsplit(".", 1)[-1] for n in W.kernel_parameters(model)}
    assert {"gain", "bias", "std_ema"} <= kinds  # what the set leaves out


def test_column_order_does_not_change_the_gram_matrix_or_the_row_norms():
    """JAX flattens an HWIO kernel to (O, H*W*I), the port an OIHW one to (O, I*H*W)."""
    hwio = np.random.default_rng(1).standard_normal((3, 3, 8, 16)).astype(np.float32)
    jmat = np.transpose(hwio, (3, 0, 1, 2)).reshape(16, -1)
    (tmat,) = TCB._iter_matrices([W._oihw(hwio)])
    assert not np.array_equal(tmat.numpy(), jmat)  # other columns in the same places
    np.testing.assert_allclose((tmat @ tmat.T).numpy(), jmat @ jmat.T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmat.norm(dim=1).numpy(), np.linalg.norm(jmat, axis=1), rtol=1e-6)


AUX = {
    "ortho_type1": (lambda m: m.OrthoLossClb(weight=1e-3, type=1, min_filters=8, min_norm=0.1)),
    "ortho_type1_min_norm_drops_some": (lambda m: m.OrthoLossClb(weight=1e-2, type=1, min_filters=16, min_norm=1.5)),
    "ortho_type2": (lambda m: m.OrthoLossClb(weight=1e-2, type=2)),
    "norm_loss": (lambda m: m.NormLossClb(weight=1e-2)),
}


@pytest.mark.parametrize("name", sorted(AUX))
def test_aux_loss_value_and_gradient_match_jax(models, name):
    params, stats = models
    jaux = AUX[name](JCB).step_options()["aux_loss"]
    value, grads = jax.value_and_grad(jaux)(jax.tree_util.tree_map(jnp.asarray, params))
    model = _port(params, stats)
    taux = AUX[name](TCB).step_options()["aux_loss"]
    loss = taux(model)
    loss.backward()
    assert loss.dtype == torch.float32 and float(value) > 0
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=TOL)
    want = W.flax_to_torch_model(model, jax.tree_util.tree_map(np.asarray, grads), stats)
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy() for n, p in model.named_parameters()}
    _close(got, {n: want[n].numpy() for n in got}, TOL)
    kernels = set(W.kernel_parameters(model))
    assert all(not got[n].any() for n in got if n not in kernels)  # gains, biases: no gradient
    assert sum(bool(got[n].any()) for n in kernels) >= 3


def test_min_norm_drops_the_kernels_under_it(models):
    """type 1 counts ||W W^T - I|| only where it exceeds min_norm * O: with a
    high min_norm some kernels drop out of the loss (and get no gradient)."""
    params, stats = models
    model = _port(params, stats)
    AUX["ortho_type1_min_norm_drops_some"](TCB).step_options()["aux_loss"](model).backward()
    graded = [n for n, p in W.kernel_parameters(model).items() if p.grad is not None and p.grad.any()]
    eligible = [n for n, p in W.kernel_parameters(model).items()
                if p.dim() in (2, 4) and 16 <= p.shape[0] <= p[0].numel()]
    assert 0 < len(graded) < len(eligible)


def test_backward_weight_norm_matches_jax(models):
    params, stats = models
    want = W.flax_to_torch_model(_port(params, stats), jax.tree_util.tree_map(np.asarray, jax_backward_weight_norm(params)), stats)
    model = _port(params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    backward_weight_norm(model)
    got = model.state_dict()
    _close({k: v.numpy() for k, v in got.items()}, {k: v.numpy() for k, v in want.items()}, 1e-6)
    normed = [k for k in got if not torch.equal(got[k], before[k])]
    assert normed and all(got[k].numel() >= 64 for k in normed)
    w = got[normed[0]].reshape(got[normed[0]].shape[0], -1)
    np.testing.assert_allclose(w.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(w.mean(dim=1).numpy(), 0.0, atol=1e-6)


def test_weight_norm_callback_is_the_post_step_transform():
    assert TCB.WeightNorm().step_options() == {"post_step_transform": backward_weight_norm}


def test_ortho_init_makes_orthonormal_filters_touches_only_kernels_and_leaves_the_ema():
    model = CModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    runner = Runner(
        model, CrossEntropyLoss(), lambda m: build_optimizer({"_target_": "lamb"}, m.named_parameters()),
        lr_phases=phases_from_stages(parse_stages([dict(start=0, end=1, lr=[0.001, 0.0])])),
        callbacks=[TCB.OrthoInitClb()], ema_decay=0.99, input_dtype=torch.float32, device="cpu",
    )
    runner.init_state(seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    runner._ensure_began()
    runner._ensure_began()  # once only
    after = model.state_dict()
    kernels = W.kernel_parameters(model)
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    assert changed == set(kernels)  # every kernel, ECA's (ndim 3) included, and nothing else
    for name, w in kernels.items():
        mat = w.detach().double().reshape(w.shape[0], -1)
        gram = mat @ mat.T if mat.shape[0] <= mat.shape[1] else mat.T @ mat
        np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]), atol=1e-5, err_msg=name)
    ema = runner.state.ema.state_dict()
    assert all(torch.equal(ema[k], before[k]) for k in ema)  # as in the JAX package: ema_params stay at init
