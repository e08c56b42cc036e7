"""The port's metric-learning losses and sphere heads (``losses/angular.py``)
against the JAX package's on the same numpy inputs from a seed:

  * each criterion's value and its gradient w.r.t. the cosines, on integer
    and on soft (mixup-like) targets, in float64 at rtol 1e-10 and in float32
    at rtol 1e-5 (the transcendental functions of XLA:CPU and of torch's CPU
    kernels differ in the last ulps);
  * AdaCos's state after five calls, each starting from the last one's state,
    with a margin and without, with ``arc_logits``, on an even batch (where
    ``torch.median`` would take the lower middle value, ``jnp.median`` the
    mean of the two);
  * the heads' forward, weights carried by ``flax_to_torch_model``, and one
    train-mode forward of ``SphereMLPLayer``: its flax BatchNorm's running
    statistics after it (momentum 0.99 in flax's sense, biased variance),
    and the head's output in eval (the features' own cosines) and in train
    (the projector's), with the head's gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.losses import angular as J
from sota_imagenet_tpu_torch.losses import angular as T
from sota_imagenet_tpu_torch.registry import resolve
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

B, C = 12, 10
RTOL = {np.float64: 1e-10, np.float32: 1e-5}


def _inputs(dtype, soft: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, C))
    cos = (logits / np.linalg.norm(logits, axis=-1, keepdims=True)).astype(dtype)
    labels = rng.integers(0, C, B)
    if soft:  # a mixup of each sample with its mirror, lam 0.7
        onehot = np.eye(C)[labels]
        return cos, (0.7 * onehot + 0.3 * onehot[::-1]).astype(dtype)
    return cos, labels


def _jax_value_and_grad(fn, cos, target):
    return jax.value_and_grad(lambda c: fn(c, jnp.asarray(target)))(jnp.asarray(cos))


def _torch_value_and_grad(fn, cos, target):
    c = torch.tensor(cos, requires_grad=True)
    loss = fn(c, torch.from_numpy(np.asarray(target)))
    loss.backward()
    return loss.detach(), c.grad


CRITERIA = {
    "arcface": lambda m: m.AdditiveAngularMarginLoss(s=10.0, m=0.2),
    "cosface": lambda m: m.LargeMarginCosineLoss(s=30.0, m=0.4),
    "angular_arcface": lambda m: m.AngularPenaltySMLoss("arcface"),
    "angular_sphereface": lambda m: m.AngularPenaltySMLoss("sphereface", s=16.0),
    "angular_cosface": lambda m: m.AngularPenaltySMLoss("cosface", s=8.0, m=0.3),
    "sphere_mae": lambda m: m.SphereMAELoss(threshold=0.5),
    "sphere_cos_mae": lambda m: m.SphereCosMAELoss(threshold=0.3),
    "negative_contrastive": lambda m: m.NegativeContrastive(eta=0.99),
    "dsoftmax_intra": lambda m: m.DSoftmax_intra(threshold=0.8),
    "myloss1": lambda m: m.MyLoss1(w_intra=0.5, w_inter=2.0, intra_threshold=0.7, eta=0.99),
    "arccos_softmax": lambda m: m.ArcCosSoftmax(smoothing=0.1),
    "arccos_softmax_center": lambda m: m.ArcCosSoftmaxCenter(smoothing=0.1, center_weight=0.5),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("soft", [False, True], ids=["ids", "soft"])
@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_value_and_gradient_match_jax(name, soft, dtype):
    cos, target = _inputs(dtype, soft)
    with jax.enable_x64(dtype == np.float64):
        jv, jg = _jax_value_and_grad(CRITERIA[name](J), cos, target)
        jv, jg = float(jv), np.asarray(jg)
    tv, tg = _torch_value_and_grad(CRITERIA[name](T), cos, target)
    assert tv.dtype == torch.float64 if dtype == np.float64 else torch.float32
    np.testing.assert_allclose(float(tv), jv, rtol=RTOL[dtype], atol=1e-12)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(jg).max())


def test_median_of_an_even_batch_is_the_mean_of_the_two_middle_values():
    x = torch.tensor([0.1, 0.9, 0.3, 0.5])
    assert float(T._median(x)) == float(jnp.median(jnp.asarray(x.numpy()))) == pytest.approx(0.4)
    assert float(torch.median(x)) == pytest.approx(0.3)  # what the port must not take


ADACOS = {
    "default": {},
    "margin": {"margin": 0.1, "max_s": 30.0},
    "arc_logits": {"margin": 0.2, "arc_logits": True, "arc_margin": True, "momentum": 0.9},
    "fixed_s": {"fixed_s": 12.0},
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kw", sorted(ADACOS))
def test_adacos_state_and_loss_over_five_calls_match_jax(kw, dtype):
    """B = 12 is even, so each call's median averages the two middle target cosines."""
    j, t = J.AdaCos(**ADACOS[kw]), T.AdaCos(**ADACOS[kw])
    j_state, t_state = j.init_state(), t.init_state()
    assert {k: float(v) for k, v in t_state.items()} == {k: float(v) for k, v in j_state.items()}
    assert all(v.dtype == torch.float32 for v in t_state.values())
    for call in range(5):
        cos, labels = _inputs(dtype, soft=call % 2 == 1, seed=call)
        with jax.enable_x64(dtype == np.float64):
            (jv, j_new), jg = jax.value_and_grad(lambda c: j(c, jnp.asarray(labels), j_state), has_aux=True)(
                jnp.asarray(cos))
            jv, jg = float(jv), np.asarray(jg)
            j_state = {k: np.asarray(v) for k, v in j_new.items()}
        c = torch.tensor(cos, requires_grad=True)
        tv, t_state = t(c, torch.from_numpy(np.asarray(labels)), t_state)
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), jv, rtol=RTOL[dtype])
        np.testing.assert_allclose(c.grad.numpy(), jg, rtol=RTOL[dtype], atol=RTOL[dtype] * np.abs(jg).max())
        for k, v in t_state.items():
            assert not v.requires_grad
            np.testing.assert_allclose(float(v), float(j_state[k]), rtol=RTOL[dtype], err_msg=f"call {call} {k}")
    assert float(t_state["prev_s"]) <= t.max_s


def test_adacos_needs_arc_margin_for_arc_logits_and_registers_its_names():
    with pytest.raises(ValueError, match="arc_margin"):
        T.AdaCos(arc_logits=True)
    for name in ("adacos", "AdaCos", "src.angular_losses.AdaCos", "mlp_adacos"):
        assert resolve(name) is T.AdaCos
    for name, cls in (("arcface", T.AdditiveAngularMarginLoss), ("cosface", T.LargeMarginCosineLoss),
                      ("angular_penalty", T.AngularPenaltySMLoss), ("arc-softmax", T.ArcCosSoftmax),
                      ("arc-softmax-center", T.ArcCosSoftmaxCenter), ("my_loss_1", T.MyLoss1),
                      ("sphere_mae", T.SphereMAELoss), ("SphereCosMAELoss", T.SphereCosMAELoss),
                      ("negative_contrastive", T.NegativeContrastive), ("DSoftmax_intra", T.DSoftmax_intra)):
        assert resolve(name) is cls


EMB, HIDDEN = 16, 24


def _head_pair(name, **kw):
    x = np.random.default_rng(3).standard_normal((B, EMB)).astype(np.float32)
    jmod = getattr(J, name)(embedding_size=EMB, num_classes=C, **kw)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    tmod = getattr(T, name)(EMB, C, **kw)
    tmod.load_state_dict(flax_to_torch_model(tmod, host["params"], host.get("batch_stats", {})))
    return x, jmod, variables, tmod


def test_sphere_linear_layer_matches_jax_in_float32_under_bf16():
    x, jmod, variables, tmod = _head_pair("SphereLinearLayer")
    assert tuple(tmod.weight.shape) == (EMB, C)  # flax's (embedding, classes)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jmod.apply(variables, jnp.asarray(x).astype(dt_j)))
        got = tmod(torch.from_numpy(x).to(dt_t))
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [{"hidden_size": HIDDEN}, {"hidden_size": HIDDEN, "act": "swish_hard",
                                                          "val_projector": True}], ids=["relu", "hard_silu_val_proj"])
def test_sphere_mlp_layer_train_step_and_eval_match_jax(kw):
    x, jmod, variables, tmod = _head_pair("SphereMLPLayer", **kw)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        x64 = jnp.asarray(x, jnp.float64)

        def loss(params):
            out, upd = jmod.apply({**v64, "params": params}, x64, train=True, mutable=["batch_stats"])
            return jnp.sum(out * jnp.arange(C)), (out, upd)

        (_, (j_train, upd)), j_grads = jax.value_and_grad(loss, has_aux=True)(v64["params"])
        j_eval = np.asarray(jmod.apply({**v64, "batch_stats": upd["batch_stats"]}, x64, train=False))
        j_stats = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
        j_grads = jax.tree_util.tree_map(np.asarray, j_grads)
        j_train = np.asarray(j_train)
    tmod.double().train()
    out = tmod(torch.from_numpy(x).double())
    (out * torch.arange(C)).sum().backward()
    # the cosines come out in float32 in both packages (preferred_element_type=float32)
    assert out.dtype == torch.float32 and j_train.dtype == np.float32
    np.testing.assert_allclose(out.detach().numpy(), j_train, rtol=1e-6, atol=1e-7)
    want = flax_to_torch_model(tmod, j_grads, j_stats)  # the gradients in the parameters' places
    for n, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=1e-5, atol=1e-6 * np.abs(want[n].numpy()).max(),
                                   err_msg=n)
    stats = flax_to_torch_model(tmod, jax.tree_util.tree_map(np.asarray, variables["params"]), j_stats)
    for k in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(tmod.state_dict()[k].numpy(), stats[k].numpy(), rtol=1e-12, atol=1e-15)
        assert not np.allclose(stats[k].numpy(), {"bn.running_mean": 0.0, "bn.running_var": 1.0}[k])
    tmod.eval()
    np.testing.assert_allclose(tmod(torch.from_numpy(x).double()).detach().numpy(), j_eval, rtol=1e-6, atol=1e-7)
