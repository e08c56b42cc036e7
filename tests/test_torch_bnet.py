"""The pre-activation BNet blocks and a depth-cut trunk of the BNet configs
(6-10) in the port against the JAX package, on the same inputs and weights.

PreBasicBlock and PreInvertedResidual with each activated norm (abn with
swish_hard as configs 6-10 set it, agn, estimated_abn, frozenabn), with
and without a width change (the partial residual), and with drop-path on
the JAX package's own masks: float32, train and eval mode, output, input
gradient and running statistics within 1e-5 of the largest reference
value, parameter gradients within 1e-4 (each sums over the batch and the
positions products that each package rounds its own way).

The trunk is config 6's layer list (SpaceToDepth, conv3x3, BlurPool,
PreBasicBlock, PreInvertedResidual, ABN swish, conv1x1, GAP, Linear) with
its ``extra_kwargs`` (swish_hard), at widths / 16 and one block per
repeat, in float64 on both sides: output, input and parameter gradients
within 1e-9 of the largest reference value, train and eval, and the
running statistics within 1e-6 (the port's BatchNorm EMAs the batch
statistics in float32). Every leaf is drawn from a seed (kernels N(0, 0.25)), so the
float64 rounding of the two packages' sums in other orders grows through
the net's 21 convs; hard-swish's kinks at -3 and 3 stay clear of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.models import blocks as JB
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.models import blocks as TB
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model
from tests.test_torch_nondeep import _feed_torch_masks, _nchw, _randomized, _record_jax_masks, _variables

C = 16
TOL = {np.float32: 1e-5, np.float64: 1e-9}
PARAM_GRAD_TOL = {np.float32: 1e-4, np.float64: 1e-9}
STAT_TOL = {np.float32: 1e-5, np.float64: 1e-6}  # the port's BatchNorm EMAs the batch statistics in float32


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _close(got, want, what, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


def compare(jmod, tmod, shape, train: bool, dtype=np.float32, seed: int = 0):
    """``tmod`` against ``jmod`` (jitted, every leaf drawn from a seed): output,
    input and parameter gradients of sum(out * r), and in train mode the
    running statistics. A CModel takes NHWC images, a block NCHW tensors."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        init = jax.jit(lambda k, xj: jmod.init(k, xj, train=False))(jax.random.PRNGKey(0), jnp.asarray(x))
        cast = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), _randomized(t, rng))  # noqa: E731
        params, stats = cast(init["params"]), cast(init.get("batch_stats", {}))
        out_shape = jax.eval_shape(lambda p, xj: jmod.apply({"params": p, "batch_stats": stats}, xj, train=False),
                                   params, jnp.asarray(x))
        cot = rng.standard_normal(out_shape.shape).astype(dtype)

        @jax.jit
        def fwd_bwd(p, xj):
            def f(p, xj):
                v = {"params": p, "batch_stats": stats}
                if train:
                    return jmod.apply(v, xj, train=True, mutable=["batch_stats"])
                return jmod.apply(v, xj, train=False), {}

            out, vjp, upd = jax.vjp(f, p, xj, has_aux=True)
            return (out, *vjp(jnp.asarray(cot)), upd)

        want, want_gp, want_dx, updated = jax.tree_util.tree_map(np.asarray, fwd_bwd(params, jnp.asarray(x)))
    nhwc = isinstance(tmod, CModel)
    tmod.to(torch.from_numpy(x).dtype).load_state_dict(flax_to_torch_model(tmod, params, stats))
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = tmod.train(train)(leaf if nhwc else leaf.permute(0, 3, 1, 2))
    (out * _nchw(cot)).sum().backward()
    _close(_nhwc(out), want, "output", TOL[dtype])
    _close(leaf.grad.numpy(), want_dx, "input gradient", TOL[dtype])
    want_grads = flax_to_torch_model(tmod, want_gp, stats)
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), f"gradient of {name}", PARAM_GRAD_TOL[dtype])
    if train and stats:
        new = flax_to_torch_model(tmod, params, updated["batch_stats"])
        for k, b in tmod.named_buffers():
            if k in new:
                _close(b.numpy(), new[k].numpy(), f"statistic {k}", STAT_TOL[dtype])

BLOCKS = {
    "pre_basic_abn_swish_hard": (lambda: JB.PreBasicBlock(in_chs=C, out_chs=C, norm_act="swish_hard"),
                                 lambda: TB.PreBasicBlock(C, C, norm_act="swish_hard")),
    "pre_basic_widen_mid": (lambda: JB.PreBasicBlock(in_chs=C, out_chs=24, mid_chs=8),
                            lambda: TB.PreBasicBlock(C, 24, mid_chs=8)),
    "pre_basic_agn": (lambda: JB.PreBasicBlock(in_chs=C, out_chs=C, norm_layer="agn", norm_act="swish"),
                      lambda: TB.PreBasicBlock(C, C, norm_layer="agn", norm_act="swish")),
    "pre_basic_estimated_abn": (lambda: JB.PreBasicBlock(in_chs=C, out_chs=C, norm_layer="estimated_abn"),
                                lambda: TB.PreBasicBlock(C, C, norm_layer="estimated_abn")),
    "pre_ir_abn_swish_hard": (lambda: JB.PreInvertedResidual(in_chs=C, out_chs=C, mid_chs=32, norm_act="swish_hard"),
                              lambda: TB.PreInvertedResidual(C, C, mid_chs=32, norm_act="swish_hard")),
    "pre_ir_widen": (lambda: JB.PreInvertedResidual(in_chs=C, out_chs=24), lambda: TB.PreInvertedResidual(C, 24)),
    "pre_ir_frozenabn": (lambda: JB.PreInvertedResidual(in_chs=C, out_chs=C, norm_layer="frozenabn"),
                         lambda: TB.PreInvertedResidual(C, C, norm_layer="frozenabn")),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_pre_activation_block_matches_jax(name, train):
    jmod, tmod = BLOCKS[name]
    compare(jmod(), tmod(), (2, 6, 6, C), train=train)


@pytest.mark.parametrize("block", ["PreBasicBlock", "PreInvertedResidual"])
def test_pre_activation_block_drop_path_on_the_jax_masks(block, monkeypatch):
    """keep_prob 0.9 (config 7): the branch of each dropped sample is zero and
    the kept ones are scaled by 1/0.9, on the masks the JAX block drew."""
    masks = _record_jax_masks(monkeypatch)
    jmod = getattr(JB, block)(in_chs=C, out_chs=C, keep_prob=0.9, norm_act="swish_hard")
    tmod = getattr(TB, block)(C, C, keep_prob=0.9, norm_act="swish_hard")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 4, 4, C)).astype(np.float32)
    params, stats = _variables(jmod, x, rng)
    masks.clear()
    want, _ = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True, mutable=["batch_stats"],
                         rngs={"dropout": jax.random.PRNGKey(4)})
    assert len(masks) == 1 and 0 < masks[0].mean() < 1
    _feed_torch_masks(monkeypatch, masks)
    tmod.load_state_dict(flax_to_torch_model(tmod, params, stats))
    with torch.no_grad():
        out = tmod.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(out), np.asarray(want), rtol=0, atol=1e-5 * np.abs(np.asarray(want)).max())


TRUNK = yaml.safe_load("""
- [-1, 1, "pt.modules.SpaceToDepth", 2]
- [-1, 1, conv3x3, [12, 8]]
- [-1, 1, "pt.modules.BlurPool", 8]
- [-1, 1, PreBasicBlock, [8, 16]]
- [-1, 1, "pt.modules.BlurPool", 16]
- [-1, 1, PreBasicBlock, [16, 24]]
- [-1, 1, PreBasicBlock, [24, 24]]
- [-1, 1, "pt.modules.BlurPool", 24]
- [-1, 1, PreInvertedResidual, [24, 40]]
- [-1, 1, PreInvertedResidual, [40, 40]]
- [-1, 1, "pt.modules.BlurPool", 40]
- [-1, 1, PreInvertedResidual, [40, 64]]
- [-1, 1, PreInvertedResidual, [64, 64]]
- [-1, 1, "pt.modules.ABN", 64, {activation: "'swish'"}]
- [-1, 1, conv1x1, [64, 160]]
- [-1, 1, "pt.modules.ABN", 160, {activation: "'swish'"}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [160, 10]]
""")
CONFIG6 = "configs/exp/6.bnet_no_dim_red.yaml"


def test_trunk_is_config_6_cut_to_size():
    """The trunk above is config 6's layer list, widths / 16, repeats 1."""
    layers = TC.to_dict(TC.load(CONFIG6, strict_env=False).model)["layer_config"]
    assert [e[2] for e in layers] == [e[2] for e in TRUNK]
    assert [e[1] for e in layers] == [1, 1, 1, 1, 1, 1, 1, 1, 1, 5, 1, 1, 4, 1, 1, 1, 1, 1]


def _extra():
    extra = JC.to_dict(JC.load(CONFIG6, strict_env=False).model)["extra_kwargs"]
    assert extra == TC.to_dict(TC.load(CONFIG6, strict_env=False).model)["extra_kwargs"]
    return extra


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_config_6_trunk_matches_jax_in_float64(train):
    extra = _extra()
    compare(JCModel(layer_config=TRUNK, extra_kwargs=extra), CModel(layer_config=TRUNK, extra_kwargs=extra),
            (2, 32, 32, 3), train=train, dtype=np.float64)
