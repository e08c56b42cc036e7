"""The port's norm zoo, norm-free blocks and the 24.nf_conv-act trunk against
the JAX package's, on the same inputs and weights.

Each JAX module is initialised, every leaf of its params and batch_stats is
drawn anew from a numpy seed (scales and gains near 1, running variances
and std EMAs in [0.5, 1.5]), and ``flax_to_torch_model`` carries the trees
over. Then, in train mode and in eval mode, float32: the output, the input
gradient of sum(out * r) (r random) and, in train mode, every running
statistic after the forward, each within 1e-5 of the largest reference
value. Blocks run with keep_prob 1, so drop-path draws nothing.

The trunk is 24.nf_conv-act's layer list read from its YAML, at narrow
widths (every width / 8 or so, group width 8 for 64) and one block per
repeat, with the head's dropout at 0, in float64 on both sides, and SiLU
for swish_hard. The JAX ScaledStdConv standardises its weight in float32
even in a float64 net, and this random net's input gradient is
ill-conditioned: rounding the port's standardised weights to float32 moves
its own input gradient by ~1e-5 relative per element, and the two packages
are ~5e-5 apart on some elements. So the trunk holds the output and the
statistics to 1e-5 of the largest value and the input gradient to a
relative L2 distance of 1e-3. Hard-swish has kinks at -3 and 3, which those
1e-7 differences can cross (the "Chaos" note of ROADMAP.md; the blocks above
hold swish_hard itself). VarEMA is held with ``use`` as the file sets it
(false: a monitor) and on."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.models import blocks as JB
from sota_imagenet_tpu.models import norms as JN
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.models import blocks as TB
from sota_imagenet_tpu_torch.models import norms as TN
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

TOL = 1e-5
SHAPE = (2, 6, 6, 16)  # NHWC
POSITIVE = ("var", "running_var", "single_running_var", "std_ema")
NEAR_ONE = ("scale", "weight", "gain", "value")


def _randomized(tree, rng):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in POSITIVE:
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * 0.5 + (1.0 if name in NEAR_ONE else 0.0)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) if a.ndim == 4 else torch.from_numpy(a)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0), err_msg=what)


def _cast(dtype):
    """Leaves to ``dtype``, but for ECA's kernel: the JAX ECA casts its input to float32 (attention.py:86)."""
    return lambda path, a: a if any("ECA" in str(getattr(k, "key", k)) for k in path) else a.astype(dtype)


def compare(jmod, tmod, shape, train: bool, seed: int = 0, dtype=np.float32, grad_rel_l2=None):
    """Hold ``tmod`` against ``jmod`` on one seeded input: output, input gradient
    (or, with ``grad_rel_l2``, its relative L2 distance), statistics."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        variables = jmod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False)
        variables = {k: jax.tree_util.tree_map_with_path(_cast(dtype), _randomized(v, rng)) for k, v in variables.items()}
        params, stats = variables.get("params", {}), variables.get("batch_stats", {})

        def f(xj):
            if train:
                return jmod.apply(variables, xj, train=True, mutable=["batch_stats"])
            return jmod.apply(variables, xj, train=False), {}

        want, vjp, updated = jax.vjp(f, jnp.asarray(x), has_aux=True)
        cot = rng.standard_normal(want.shape).astype(dtype)
        (want_dx,) = vjp(jnp.asarray(cot))
        want, want_dx = np.asarray(want), np.asarray(want_dx)
        updated = jax.tree_util.tree_map(np.asarray, updated)
    tmod.to(torch.from_numpy(x).dtype).load_state_dict(flax_to_torch_model(tmod, params, stats))
    nhwc = isinstance(tmod, CModel)  # a CModel takes NHWC images, as the JAX one; a module NCHW tensors
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = tmod.train(train)(leaf if nhwc else leaf.permute(0, 3, 1, 2))
    (out * _nchw(cot)).sum().backward()
    _close(_nhwc(out), np.asarray(want), "output")
    if grad_rel_l2 is None:
        _close(leaf.grad.numpy(), want_dx, "input gradient")
    else:
        rel = np.linalg.norm(leaf.grad.numpy() - want_dx) / np.linalg.norm(want_dx)
        assert rel < grad_rel_l2, f"input gradient: relative L2 {rel}"
    if train and stats:
        new = flax_to_torch_model(tmod, params, updated["batch_stats"])
        named = dict(tmod.named_buffers())
        buffers = {k: v for k, v in tmod.state_dict().items() if k in named}  # BlurPool's filter is not state
        assert buffers, "a module with batch_stats has buffers"
        for k, b in buffers.items():
            _close(b.numpy(), new[k].numpy(), f"statistic {k}")
            assert not torch.equal(new[k], flax_to_torch_model(tmod, params, stats)[k]), f"{k} did not move"
    return out


# --------------------------------------------------------------------------- #
# The norm zoo
# --------------------------------------------------------------------------- #

C = SHAPE[-1]
NORMS = {
    "group_norm": (lambda: JN.GroupNorm(num_groups=4), lambda: TN.GroupNorm(C, num_groups=4)),
    "scale_norm": (lambda: JN.ScaleNorm(), lambda: TN.ScaleNorm(C)),
    "scale_norm_fixed": (lambda: JN.ScaleNorm(trainable=False), lambda: TN.ScaleNorm(C, trainable=False)),
    "affine_trainable": (lambda: JN.Affine(value=1.5, trainable=True), lambda: TN.Affine(1.5, trainable=True)),
    "affine": (lambda: JN.Affine(value=2.0), lambda: TN.Affine(2.0)),
    "gain": (lambda: JN.Gain(size=C), lambda: TN.Gain(C)),
    "frn_v1": (lambda: JN.FRNv1(), lambda: TN.FRNv1(C)),
    "frn_v1_no_bias": (lambda: JN.FRNv1(use_bias=False), lambda: TN.FRNv1(C, use_bias=False)),
    "frn_v2": (lambda: JN.FRNv2(), lambda: TN.FRNv2(C)),
    "var_ema": (lambda: JN.VarEMA(), lambda: TN.VarEMA(C)),
    "var_ema_monitor": (lambda: JN.VarEMA(use=False), lambda: TN.VarEMA(C, use=False)),
    "mean_ema": (lambda: JN.MeanEMA(), lambda: TN.MeanEMA(C)),
    "identity": (lambda: JN.Identity(), lambda: TN.Identity(C)),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(NORMS))
def test_norm_matches_jax(name, train):
    jmake, tmake = NORMS[name]
    compare(jmake(), tmake(), SHAPE, train)


def test_var_ema_monitor_returns_its_input_and_updates_once_per_call_as_a_scalar_ema():
    m = TN.VarEMA(use=False).train()
    x = torch.randn(4, 3, 5, 5, dtype=torch.float64)
    assert m(x) is x and m.std_ema.shape == () and m.mean_ema.shape == ()
    want_std = 0.95 * 1.0 + 0.05 * x.std(correction=0)
    assert torch.allclose(m.std_ema.double(), want_std.float().double())
    m(x)  # a second microbatch moves it again, in order
    assert torch.allclose(m.std_ema.double(), (0.95 * want_std + 0.05 * x.std(correction=0)).float().double())


def test_norm_table_is_the_jax_table_and_the_activated_bn_family_names_its_item():
    """The table is the JAX one; the activated-BN family, which named its
    ROADMAP item before it was ported, builds the JAX classes' counterparts
    (their numbers: tests/test_torch_bresnet.py)."""
    assert set(TN._NORMS) == set(JN._NORMS)
    for name, cls in (("abn", TN.ABN), ("InplaceABN", TN.ABN), ("frozenabn", TN.ABN), ("agn", TN.AGN),
                      ("estimated_abn", TN.EstimatedABN)):
        norm = TN.norm_from_name(name)(8)
        assert type(norm) is cls and norm.weight.shape == (8,)
    assert TN.norm_from_name("frozenabn")(8).frozen and not TN.norm_from_name("abn")(8).frozen
    assert isinstance(TN.norm_from_name("'VarEMA'")(8), TN.VarEMA)
    with pytest.raises(KeyError):
        TN.norm_from_name("no_such_norm")


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #

GAMMA = {"gamma": 1.7}
BLOCKS = {
    "nf_block": (
        lambda: JB.NormFreeBlock(in_chs=16, out_chs=16, activation="silu"),
        lambda: TB.NormFreeBlock(16, 16, activation="silu"),
    ),
    "nf_block_eca_gn_grouped": (
        lambda: JB.NormFreeBlock(in_chs=16, out_chs=24, mid_chs=32, groups_width=8, activation="silu",
                                 attention_type="eca", pre_norm_group_width=8, conv_kwargs=GAMMA),
        lambda: TB.NormFreeBlock(16, 24, 32, groups_width=8, activation="silu", attention_type="eca",
                                 pre_norm_group_width=8, conv_kwargs=GAMMA),
    ),
    "nf_block_se": (
        lambda: JB.NormFreeBlock(in_chs=16, out_chs=16, activation="silu", attention_type="se", attention_gain=1.5),
        lambda: TB.NormFreeBlock(16, 16, activation="silu", attention_type="se", attention_gain=1.5),
    ),
    "nf_timm_regnet_eca9": (
        lambda: JB.NormFreeBlockTimm(in_chs=16, out_chs=32, mid_chs=24, groups_width=8, activation="swish_hard",
                                     attention_type="eca9", regnet_attention=True, conv_kwargs=GAMMA),
        lambda: TB.NormFreeBlockTimm(16, 32, 24, groups_width=8, activation="swish_hard", attention_type="eca9",
                                     regnet_attention=True, conv_kwargs=GAMMA),
    ),
    "nf_timm_eca9_after_conv3": (
        lambda: JB.NormFreeBlockTimm(in_chs=16, out_chs=32, mid_chs=24, groups_width=8, activation="silu",
                                     attention_type="eca9"),
        lambda: TB.NormFreeBlockTimm(16, 32, 24, groups_width=8, activation="silu", attention_type="eca9"),
    ),
    "nf_timm_sevar3": (
        lambda: JB.NormFreeBlockTimm(in_chs=16, out_chs=16, mid_chs=16, activation="silu", attention_type="se-var3",
                                     regnet_attention=True),
        lambda: TB.NormFreeBlockTimm(16, 16, 16, activation="silu", attention_type="se-var3", regnet_attention=True),
    ),
    "nf_timm_full_conv": (
        lambda: JB.NormFreeBlockTimm(in_chs=16, out_chs=16, mid_chs=16, groups_width=8, activation="silu",
                                     full_conv=True, conv_kwargs={"padding_mode": "reflect"}),
        lambda: TB.NormFreeBlockTimm(16, 16, 16, groups_width=8, activation="silu", full_conv=True,
                                     conv_kwargs={"padding_mode": "reflect"}),
    ),
    "nf_timm_pre_norm_gn": (
        lambda: JB.NormFreeBlockTimm(in_chs=16, out_chs=16, mid_chs=8, activation="silu", pre_norm_group_width=4),
        lambda: TB.NormFreeBlockTimm(16, 16, 8, activation="silu", pre_norm_group_width=4),
    ),
    "ema_block": (
        lambda: JB.EMABlock(in_chs=16, out_chs=16, activation="silu", groups_width=8),
        lambda: TB.EMABlock(16, 16, activation="silu", groups_width=8),
    ),
    "ema_block_remove_ema": (
        lambda: JB.EMABlock(in_chs=16, out_chs=24, activation="silu", remove_ema=True),
        lambda: TB.EMABlock(16, 24, activation="silu", remove_ema=True),
    ),
    "ema_block_conv_act": (
        lambda: JB.EMABlock(in_chs=16, out_chs=16, activation="silu", conv_act=True),
        lambda: TB.EMABlock(16, 16, activation="silu", conv_act=True),
    ),
    "conv_act_pre_scalenorm": (
        lambda: JB.ConvActBlock(in_chs=16, out_chs=16, activation="silu", pre_norm="scalenorm"),
        lambda: TB.ConvActBlock(16, 16, activation="silu", pre_norm="scalenorm"),
    ),
    "conv_act_pre_varema_stride2": (
        lambda: JB.ConvActBlock(in_chs=16, out_chs=24, stride=2, activation="silu", pre_norm="VarEMA(16)"),
        lambda: TB.ConvActBlock(16, 24, stride=2, activation="silu", pre_norm="VarEMA(16)"),
    ),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, train):
    jmake, tmake = BLOCKS[name]
    compare(jmake(), tmake(), (2, 8, 8, 16), train)


def test_nf_timm_groups_follow_the_bottleneck_width_and_only_its_3x3s_are_grouped():
    blk = TB.NormFreeBlockTimm(128, 768, 384, groups_width=64, attention_type="eca9", regnet_attention=True)
    assert tuple(blk.conv1.weight.shape) == (384, 128, 1, 1) and tuple(blk.conv3.weight.shape) == (768, 384, 1, 1)
    assert tuple(blk.conv2.weight.shape) == tuple(blk.conv2b.weight.shape) == (384, 64, 3, 3)  # 6 groups of 64
    assert blk.conv2.groups == 6 and blk.conv1.groups == blk.conv3.groups == 1


# --------------------------------------------------------------------------- #
# The 24.nf_conv-act trunk
# --------------------------------------------------------------------------- #

TRUNK_CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "exp", "24.nf_conv-act.yaml")
NARROW = {3: 3, 16: 4, 32: 8, 64: 8, 128: 16, 384: 16, 768: 32, 2304: 48, 1000: 10}


def narrow_trunk(model_cfg: dict, var_ema_use: bool = False) -> dict:
    """24.nf_conv-act's model node at narrow widths (NARROW), group width 8
    where it says 64, one module per layer, keep_prob 1 and no dropout."""
    cfg = copy.deepcopy(model_cfg)
    layers = []
    for inputs, _, name, *rest in cfg["layer_config"]:
        args = rest[0] if rest else []
        kwargs = dict(rest[1]) if len(rest) > 1 else {}
        if name == "torch.nn.Dropout":
            args = [0.0]
        else:
            args = [NARROW.get(a, a) for a in (args if isinstance(args, list) else [args])]
        if "groups_width" in kwargs:
            kwargs["groups_width"] = 8
        layers.append([inputs, 1, name, args, kwargs])
    cfg["layer_config"] = layers
    extra = cfg["extra_kwargs"]
    extra["NormFreeBlockTimm"].update(groups_width=8, keep_prob=1.0, activation="silu")
    extra["ConvActBlock"]["activation"] = "silu"
    extra["VarEMA"] = {"use": var_ema_use}
    return cfg


@pytest.fixture(scope="module")
def trunk_cfgs():
    jcfg = JC.to_dict(JC.load(TRUNK_CONFIG, strict_env=False))["model"]
    tcfg = TC.to_dict(TC.load(TRUNK_CONFIG, strict_env=False))["model"]
    assert jcfg == tcfg
    return tcfg


def build_trunks(cfg):
    cfg = dict(cfg)
    cfg.pop("_target_")
    return JCModel(**cfg), CModel(**cfg)


@pytest.mark.parametrize("var_ema_use", [False, True], ids=["var_ema_monitor", "var_ema_on"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_narrow_nf_conv_act_trunk_matches_jax(trunk_cfgs, train, var_ema_use):
    jmodel, model = build_trunks(narrow_trunk(trunk_cfgs, var_ema_use))
    out = compare(jmodel, model, (2, 64, 64, 3), train, dtype=np.float64, grad_rel_l2=1e-3)
    assert tuple(out.shape) == (2, 10)
    kinds = {type(m).__name__ for m in model.modules()}
    assert {"ConvActBlock", "NormFreeBlockTimm", "VarEMA", "ECA", "BlurPool", "ScaledStdConv"} <= kinds
