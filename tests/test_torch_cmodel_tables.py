"""The rest of the CModel table in the port against the JAX package: VGGBlock
(config 61's, with its VarEMA pre-norm and groups_width), ConvMixBlock (each
partial factor, the repaired 0.5 one included), ConvResidual (config 68's
unscaled ``[conv3x3, i, o]``, a bare scaled ``[i, o]``, a scaled 1x1),
ConvMixerBlock (k = 7, and k = 9, whose padding 3 shrinks the map and crops
the residual), Yolo5_C3 (the ``se_kwargs`` spelling, ``pre_norm``), and
FusedRepVGGBlock (with and without its identity branch), each after a small
stem in a CModel; a widening repeat of ConvActBlock (adacos_sphere's); the
sphere heads as a CModel's last layer; vgg16_bn at a small size; and
Residual.

Each JAX CModel is initialised, every leaf of its params and batch_stats is
drawn anew from a numpy seed, and ``flax_to_torch_model`` carries the trees
over. One train-mode forward of an 8 x 16 x 16 batch: the output, the
batch statistics after it, and every parameter gradient of sum(out * r)
(r random). Float32 throughout (the JAX ScaledStdConv standardises in
float32 whatever the weights' dtype): the output and the statistics within
1e-5 of the largest reference value, the gradients within 1e-4 of their
largest gradient of the model (tests/test_torch_nondeep.py says why; the
model's, because a conv bias before a BatchNorm has an exact gradient of 0
and float32 noise of its own). The blocks without a ScaledStdConv run again
in float64, at 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.models import vgg16_bn as jvgg16_bn
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.losses.angular import FlaxBatchNorm
from sota_imagenet_tpu_torch.models import blocks as TB
from sota_imagenet_tpu_torch.models.cmodel import CModel, vgg16_bn
from sota_imagenet_tpu_torch.models.layers import Activation
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

TOL, GRAD_TOL, F64_TOL = 1e-5, 1e-4, 1e-10
SHAPE = (8, 16, 16, 3)
STEM = "- [-1, 1, conv3x3, [3, 16], {bias: true}]\n"
HEAD = "- [-1, 1, FastGlobalAvgPool2d, [], {flatten: true}]\n"
MODELS = {
    "vgg_block_61": (STEM + """
- [-1, 2, VGGBlock, [16, 16], {pre_norm: "VarEMA(16)", activation: "'swish_hard'",
                                conv_kwargs: {gamma: 1.7, gain_init: 1, n_heads: 1}}]
- [-1, 1, VGGBlock, [16, 32], {pre_norm: "VarEMA(16)", groups_width: 8, conv_kwargs: {gamma: 1.7}}]
""", False),
    "conv_mix_block": (STEM + """
- [-1, 1, ConvMixBlock, [16, 32], {partial_factor: 0.5, pre_norm: "VarEMA(16)", groups_width: 8}]
- [-1, 1, ConvMixBlock, [32, 16], {partial_factor: 1, activation: silu}]
- [-1, 1, ConvMixBlock, [16, 16], {partial_factor: 0}]
""", False),
    "conv_residual_68": (STEM + """
- [-1, 1, ConvResidual, [conv3x3, 16, 24]]
- [-1, 1, nn.Hardswish]
- [-1, 1, nn.BatchNorm2d, 24]
- [-1, 1, ConvResidual, [24, 24]]
- [-1, 1, ConvResidual, [scaled_conv1x1, 24, 32]]
""", False),
    "conv_residual_plain": (STEM + """
- [-1, 1, ConvResidual, [conv3x3, 16, 24]]
- [-1, 1, nn.BatchNorm2d, 24]
- [-1, 1, ConvResidual, [conv1x1, 24, 32]]
""", True),
    "conv_mixer": ("""
- [-1, 1, nn.Conv2d, [3, 16, 4], {stride: 4}]
- [-1, 1, nn.GELU]
- [-1, 1, nn.BatchNorm2d, 16]
- [-1, 2, ConvMixerBlock, [16, 7]]
- [-1, 1, ConvMixerBlock, [16]]
""" + HEAD + "- [-1, 1, nn.Linear, [16, 10]]\n", True),
    "yolo5_c3": (STEM + """
- [-1, 1, Yolo5_C3, [16], {num_blocks: 2, block_kwargs: {se_kwargs: null, groups_width: 4}}]
- [-1, 1, Yolo5_C3, [16], {pre_norm: true, block_kwargs: {se_kwargs: {}, scaled: true}}]
- [-1, 1, Yolo5_C3, [16]]
""", False),
    "fused_repvgg": (STEM + """
- [-1, 1, FusedRepVGGBlock, [16, 16]]
- [-1, 1, FusedRepVGGBlock, [16, 24], {stride: 2, activation: silu}]
""", True),
    # adacos_sphere's widening repeat: the second copy of [8, 16] receives 16 channels
    "conv_act_widening_repeat": ("""
- [-1, 1, ConvActBlock, [3, 8], {stride: 2, activation: silu}]
- [-1, 2, ConvActBlock, [8, 16], {stride: 2, activation: silu, pre_norm: "VarEMA(8)"}]
""", False),
    "sphere_linear": (STEM + HEAD + "- [-1, 1, SphereLinearLayer, [16, 10]]\n", True),
    "sphere_mlp": (STEM + HEAD + "- [-1, 1, SphereMLPLayer, [16, 10], {hidden_size: 24}]\n", True),
}
# the sphere heads round their cosines to float32 in both packages, float64 runs too; and SphereMLPLayer's
# float32 cosines come through a BatchNorm over the batch's 8 samples (var = E[x^2] - E[x]^2 in both), whose
# cancellation lifts float32's error to 3e-5 of the largest cosine
OUT_TOL = {("sphere_linear", np.float64): 1e-7, ("sphere_mlp", np.float64): 1e-7, ("sphere_mlp", np.float32): 5e-5}
# the JAX heads' VJP of their preferred_element_type=float32 product rounds the cotangents to float32 as well
GRAD_TOL_F64_HEAD = {"sphere_linear": 1e-6, "sphere_mlp": 1e-6}


def _randomized(tree, rng, dtype):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in ("var", "std_ema"):
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * 0.5 + (1.0 if name in ("scale", "gain") else 0.0)
        leaves.append(np.asarray(v, dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30), err_msg=what)


def _compare(jmodel, tmodel, dtype, tol, grad_tol, shape=SHAPE, out_tol=None, randomize=True):
    rng = np.random.default_rng(0)
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    with jax.enable_x64(dtype == np.float64):
        variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, *shape[1:]), jdt), train=False))(
            jax.random.PRNGKey(0))
        params = _randomized(variables["params"], rng, dtype) if randomize else variables["params"]
        stats = _randomized(variables.get("batch_stats", {}), rng, dtype) if randomize else variables.get(
            "batch_stats", {})
        params, stats = (jax.tree_util.tree_map(np.asarray, t) for t in (params, stats))
        x = rng.standard_normal(shape).astype(dtype)

        def loss(p):
            out, upd = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
            r = jnp.asarray(np.random.default_rng(1).standard_normal(out.shape), out.dtype)
            return jnp.sum(out * r), (out, upd.get("batch_stats", {}))

        (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out, new_stats, grads = (jax.tree_util.tree_map(np.asarray, t) for t in (out, new_stats, grads))
    tmodel.to(torch.float64 if dtype == np.float64 else torch.float32).train()
    tmodel.load_state_dict(flax_to_torch_model(tmodel, params, stats))
    got = tmodel(torch.from_numpy(x))
    if got.dim() == 4:  # the port's NCHW view -> the JAX package's NHWC
        got = got.permute(0, 2, 3, 1)
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape).astype(out.dtype))
    (got * r).sum().backward()
    _close(got.detach().numpy(), out, out_tol or tol, "output")
    want_stats = flax_to_torch_model(tmodel, params, new_stats)
    want_grads = flax_to_torch_model(tmodel, grads, new_stats)
    state = tmodel.state_dict()  # the persistent buffers: BlurPool's filter is a constant
    buffers = {k: v for k, v in tmodel.named_buffers() if k in state}
    for k, v in buffers.items():
        _close(v.numpy(), want_stats[k].numpy(), tol, k)
    # against the largest gradient of the model: a conv bias before a BatchNorm has an exact gradient of 0
    scale = max(np.abs(want_grads[n].numpy()).max() for n, _ in tmodel.named_parameters())
    for n, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(), rtol=0, atol=grad_tol * scale,
                                   err_msg=f"grad {n}")
    return buffers


def _pair(name):
    layers = yaml.safe_load(MODELS[name][0])
    return JCModel(layer_config=layers), CModel(layer_config=layers)


CASES = [(n, np.float32) for n in sorted(MODELS)] + [(n, np.float64) for n in sorted(MODELS) if MODELS[n][1]]


@pytest.mark.parametrize("name, dtype", CASES, ids=[f"{n}-{np.dtype(d).name}" for n, d in CASES])
def test_block_train_forward_statistics_and_gradients_match_jax(name, dtype):
    jmodel, tmodel = _pair(name)
    f64 = dtype == np.float64
    grad_tol = GRAD_TOL_F64_HEAD.get(name, F64_TOL) if f64 else GRAD_TOL
    buffers = _compare(jmodel, tmodel, dtype, F64_TOL if f64 else TOL, grad_tol, out_tol=OUT_TOL.get((name, dtype)))
    if name == "conv_mixer":  # k = 9 with padding 3: 4x4 -> 2x2, the residual cropped to the centre
        assert tmodel.layers[4][0](torch.zeros((1, 16, 4, 4), dtype=tmodel.layers[0][0].weight.dtype)).shape == (
            1, 16, 2, 2)
    if name == "fused_repvgg":
        assert tmodel.layers[1][0].bn_id is not None and tmodel.layers[2][0].bn_id is None
    if name == "yolo5_c3":  # se_kwargs None turns SE off, {} leaves it on; the default has it off
        se = [[b.attn is not None for b in y[0].m] for y in tmodel.layers[1:]]
        assert se == [[False, False], [True], [False]]
    assert all(not torch.equal(b, torch.zeros_like(b)) for b in buffers.values())


def test_vgg16_bn_matches_jax_at_a_small_size():
    """Full width (13 convs with BN, the 4096-wide MLP head), 10 classes, 32 px,
    batch 2 (the five 2x2 max-pools take it to 1x1): the layer list is the
    JAX one, its eval forward matches, and so does a train step of the same
    list with the two dropouts at rate 0 (their masks cannot be matched)."""
    jmodel, tmodel = jvgg16_bn(num_classes=10), vgg16_bn(num_classes=10)
    layers = [dict(e) for e in jmodel.layer_config]
    assert [vars(s) for s in tmodel.structures] == [
        {"args": [], "kwargs": {}, "repeat": 1, "inputs": ["_prev_"], "tag": None, **e} for e in layers]
    assert sum(1 for m in tmodel.modules() if isinstance(m, TB.ConvBnAct)) == 13
    # its own initial weights (16 layers of random ones at the scale above would grow the logits to 1e4)
    rng = np.random.default_rng(0)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 32, 32, 3)), train=False))(jax.random.PRNGKey(0))
    params, stats = (jax.tree_util.tree_map(np.asarray, variables[k]) for k in ("params", "batch_stats"))
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))({"params": params, "batch_stats": stats},
                                                                           jnp.asarray(x)))
    tmodel.load_state_dict(flax_to_torch_model(tmodel, params, stats))
    _close(tmodel.eval()(torch.from_numpy(x)).detach().numpy(), want, TOL, "eval output")
    no_drop = [dict(e, args=[0.0]) if e["module"] == "Dropout" else e for e in layers]
    # 16 float32 layers, the last stage's BatchNorms over 2 samples at 2x2 and 1x1: 1e-4 of the largest value
    _compare(JCModel(layer_config=no_drop), CModel(layer_config=no_drop), np.float32, 1e-4, GRAD_TOL,
             shape=(2, 32, 32, 3), randomize=False)


def test_residual_adds_its_input():
    x = torch.randn(2, 4, 3, 3)
    torch.testing.assert_close(TB.Residual(Activation("silu"))(x), x + torch.nn.functional.silu(x))


def test_bn_momentum_does_not_reach_the_sphere_mlp_head():
    """SphereMLPLayer's BatchNorm is flax's own with momentum 0.99 whatever the
    config's bn_momentum (the JAX head builds ``nn.BatchNorm`` with its default)."""
    layers = yaml.safe_load(STEM + HEAD + "- [-1, 1, SphereMLPLayer, [16, 10], {hidden_size: 24}]\n")
    cfg = TC.load(None, overrides=["bn_momentum=0.03"], strict_env=False)
    cfg.model = {"_target_": "CModel", "layer_config": layers}
    model = cli.build_model(cfg)
    assert [m.momentum for m in model.modules() if isinstance(m, FlaxBatchNorm)] == [0.99]
