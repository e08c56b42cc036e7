"""The non-deep CModel family in the port against the JAX package: XCA, UFO,
FCA, SEVar3Mod, the GEM pools, NonDeepBlock, ConvActBlock's XCA and
NormFreeBlockTimm's XCA with dropout, each on one seeded input.

Modules: each JAX module is initialised, every leaf of its params and
batch_stats is drawn anew from a numpy seed, and ``flax_to_torch_model``
carries the trees over. In float32, train and eval mode: the output, the
input gradient and in train mode the BatchNorm statistics, each within 1e-5
of the largest reference value (float32 sums in other orders; the softmax
and the l2-norms are well conditioned here), and every parameter gradient
of sum(out * r) (r random) within 1e-4 of its largest value: a parameter's
gradient sums over the batch and the positions (128 terms here) products
that each package rounds its own way, so its float32 error grows with the
terms' scale, not with the sum's (UFO's prenorm scale came 1.03e-5 of its
largest value off). In bfloat16 (float32 parameters, as a bf16 run
has them): the output stays bfloat16 and is within 2^-6 of the largest
reference value, four bf16 ulps at the top of the range, because the two
packages round the intermediate bf16 tensors (the conv outputs, BatchNorm's,
hard_silu's) at the same places but with products and sums in other orders,
and a value one ulp apart at a bf16 rounding boundary moves by a whole ulp.

The train steps of 80_1 trunks with AGC are in tests/test_torch_agc.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.models import attention as JA
from sota_imagenet_tpu.models import blocks as JB
from sota_imagenet_tpu.models import layers as JL
from sota_imagenet_tpu_torch.models import attention as TA
from sota_imagenet_tpu_torch.models import blocks as TB
from sota_imagenet_tpu_torch.models import layers as TL
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

TOL = 1e-5
PARAM_GRAD_TOL = 1e-4
BF16_TOL = 2.0**-6
C = 16
SHAPE = (2, 6, 6, C)  # NHWC
POSITIVE = ("var", "temperature", "temperature2")
NEAR_ONE = ("scale", "gain")


def _randomized(tree, rng):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name in POSITIVE:
            v = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "p":  # GEM's exponent
            v = rng.uniform(1.5, 3.5, leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * 0.5 + (1.0 if name in NEAR_ONE else 0.0)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2) if a.ndim == 4 else torch.from_numpy(a)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


def _variables(jmod, x, rng):
    variables = jmod.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False)
    variables = {k: _randomized(v, rng) for k, v in variables.items()}
    return variables.get("params", {}), variables.get("batch_stats", {})


def compare(jmod, tmod, shape=SHAPE, train=False, seed=0):
    """Hold ``tmod`` against ``jmod`` in float32: output, input and parameter
    gradients, and in train mode the updated statistics."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    params, stats = _variables(jmod, x, rng)

    def f(p, xj):
        v = {"params": p, "batch_stats": stats} if stats else {"params": p}
        if train:
            return jmod.apply(v, xj, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
        return jmod.apply(v, xj, train=False), {}

    want, vjp, updated = jax.vjp(f, params, jnp.asarray(x), has_aux=True)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_gp, want_dx = vjp(jnp.asarray(cot))
    tmod.load_state_dict(flax_to_torch_model(tmod, params, stats))
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = tmod.train(train)(leaf.permute(0, 3, 1, 2))
    (out * _nchw(cot)).sum().backward()
    _close(_nhwc(out), np.asarray(want), "output")
    _close(leaf.grad.numpy(), np.asarray(want_dx), "input gradient")
    want_grads = flax_to_torch_model(tmod, jax.tree_util.tree_map(np.asarray, want_gp), stats)
    named = dict(tmod.named_parameters())
    assert named
    for name, p in named.items():
        _close(p.grad.numpy(), want_grads[name].numpy(), f"gradient of {name}", PARAM_GRAD_TOL)
    if train and stats:
        new = flax_to_torch_model(tmod, params, jax.tree_util.tree_map(np.asarray, updated["batch_stats"]))
        for k, b in tmod.named_buffers():
            if k in new:
                _close(b.numpy(), new[k].numpy(), f"statistic {k}")
    return out


def compare_bf16(jmod, tmod, shape=SHAPE, seed=0):
    """The forward on a bfloat16 input with float32 parameters (eval mode): the
    output stays bfloat16 and is within BF16_TOL of the JAX one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    params, stats = _variables(jmod, x, rng)
    v = {"params": params, "batch_stats": stats} if stats else {"params": params}
    want = jmod.apply(v, jnp.asarray(x, jnp.bfloat16), train=False)
    tmod.load_state_dict(flax_to_torch_model(tmod, params, stats))
    with torch.no_grad():
        out = tmod.eval()(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert want.dtype == jnp.bfloat16 and out.dtype == torch.bfloat16
    _close(_nhwc(out), np.asarray(want, np.float32), "bf16 output", BF16_TOL)


# --------------------------------------------------------------------------- #
# Attention modules and the GEM pools
# --------------------------------------------------------------------------- #

MODULES = {
    "xca": (lambda: JA.XCA(dim=C, num_heads=4), lambda: TA.XCA(C, num_heads=4)),
    "xca_v_norm_proj": (lambda: JA.XCA(dim=C, v_norm=True, last_proj=True),
                        lambda: TA.XCA(C, v_norm=True, last_proj=True)),
    "xca_no_residual_proj": (lambda: JA.XCA(dim=C, num_heads=2, residual=False, last_proj=True),
                             lambda: TA.XCA(C, num_heads=2, residual=False, last_proj=True)),
    "ufo": (lambda: JA.UFO(dim=C, num_heads=4), lambda: TA.UFO(C, num_heads=4)),
    "ufo_qk_norm_prelast_act": (lambda: JA.UFO(dim=C, qk_norm=True, prelast_act=True, residual=False),
                                lambda: TA.UFO(C, qk_norm=True, prelast_act=True, residual=False)),
    "ufo_prenorm_proj": (lambda: JA.UFO(dim=C, num_heads=4, prenorm=True, last_proj=True),
                         lambda: TA.UFO(C, num_heads=4, prenorm=True, last_proj=True)),
    "ufo_out_dim": (lambda: JA.UFO(dim=C, out_dim=24, last_proj=True, residual=False),
                    lambda: TA.UFO(C, out_dim=24, last_proj=True, residual=False)),
    "fca": (lambda: JA.FCA(channels=C, reduction=4, temperature=2.0), lambda: TA.FCA(C, reduction=4, temperature=2.0)),
    "fca_eca": (lambda: JA.FCA(channels=C, eca=True), lambda: TA.FCA(C, eca=True)),
    "fca_few_freq": (lambda: JA.FCA(channels=C, num_freq=4), lambda: TA.FCA(C, num_freq=4)),
    "sevar3_mod": (lambda: JA.SEVar3Mod(in_chs=C, out_chs=C), lambda: TA.SEVar3Mod(C, C)),
    "sevar3_mod_scaled": (lambda: JA.SEVar3Mod(in_chs=C, out_chs=C, scaled=True), lambda: TA.SEVar3Mod(C, C, scaled=True)),
    "gem": (lambda: JL.GEMPool(), lambda: TL.GEMPool()),
    "gem_keepdims": (lambda: JL.GEMPool(p=2.0, flatten=False), lambda: TL.GEMPool(p=2.0, flatten=False)),
    "gem_channel": (lambda: JL.GEMPoolChannel(), lambda: TL.GEMPoolChannel(C)),
}
# FCA's DCT bases follow the input's size: a square and an odd rectangle
SHAPES = {"fca": (SHAPE, (2, 7, 5, C)), "fca_eca": (SHAPE, (2, 7, 5, C)), "fca_few_freq": (SHAPE, (2, 4, 9, C))}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name, train):
    jmake, tmake = MODULES[name]
    for shape in SHAPES.get(name, (SHAPE,)):
        compare(jmake(), tmake(), shape, train)


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax_in_bf16(name):
    jmake, tmake = MODULES[name]
    compare_bf16(jmake(), tmake())


def test_sevar3_mod_between_widths_is_a_zero_of_the_input_dtype():
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = JA.SEVar3Mod(in_chs=8, out_chs=16).apply({}, jnp.ones((1, 4, 4, 8), jdt))
        got = TA.SEVar3Mod(8, 16)(torch.ones(1, 8, 4, 4, dtype=dt))
        assert want.shape == () and float(want) == 0.0 and want.dtype == jdt
        assert got.shape == () and float(got) == 0.0 and got.dtype == dt
    assert not list(TA.SEVar3Mod(8, 16).parameters())


def test_l2norm_is_the_jax_rule():
    x = np.random.default_rng(3).standard_normal((2, 3, 5)).astype(np.float32)
    x[0, 1] = 0.0  # a zero row: divided by eps, not NaN
    for axis in (-1, -2):
        want = JA._l2norm(jnp.asarray(x), axis=axis)
        np.testing.assert_allclose(TA._l2norm(torch.from_numpy(x), axis).numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_layer_norm_eps_and_statistics_are_flax_ones():
    """UFO's prenorm is flax's LayerNorm (eps 1e-6, one-pass variance), not
    torch's (1e-5): on a near-constant input the two eps differ visibly."""
    x = (1.0 + 1e-3 * np.random.default_rng(4).standard_normal((2, 3, 3, 8))).astype(np.float32)
    ln = JA.nn.LayerNorm(use_bias=False, use_scale=True)
    want = ln.apply({"params": {"scale": jnp.full((8,), 1.5)}}, jnp.asarray(x))
    t = TA.ChannelLayerNorm(8)
    t.weight.data.fill_(1.5)
    got = _nhwc(t(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    torch_ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (8,), torch.full((8,), 1.5))
    assert np.abs(torch_ln.numpy() - np.asarray(want)).max() > 1e-2


def test_temperatures_keep_the_jax_shape_and_fca_keeps_no_state():
    xca, ufo = TA.XCA(16, v_norm=True), TA.UFO(16, num_heads=4)
    assert tuple(xca.temperature.shape) == tuple(xca.temperature2.shape) == (8, 1, 1)
    assert tuple(ufo.temperature.shape) == (4, 1, 1)
    assert set(TA.FCA(16).state_dict()) == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    assert set(TA.FCA(16, eca=True).state_dict()) == {"eca.weight"}


@pytest.mark.parametrize("name", ["xca", "ufo", "fca", "fca-eca"])
def test_get_attn_builds_the_ported_module(name):
    mod = TA.get_attn(name)(16)
    jmod = JA.get_attn(name)(16)
    assert type(mod).__name__ == type(jmod).__name__
    out = mod(torch.randn(2, 16, 4, 4))
    assert tuple(out.shape) == (2, 16, 4, 4)


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #

SCALED = {"scaled": True, "conv_kwargs": {"gamma": 1.7}}
BLOCKS = {
    "se": (lambda: JB.NonDeepBlock(in_chs=C, out_chs=C), lambda: TB.NonDeepBlock(C, C)),
    "se_scaled_grouped": (lambda: JB.NonDeepBlock(in_chs=C, out_chs=C, groups_width=8, **SCALED),
                          lambda: TB.NonDeepBlock(C, C, groups_width=8, **SCALED)),
    "widen_no_se": (lambda: JB.NonDeepBlock(in_chs=C, out_chs=24, scaled=True),
                    lambda: TB.NonDeepBlock(C, 24, scaled=True)),
    "xca_residual_proj": (
        lambda: JB.NonDeepBlock(in_chs=C, out_chs=C, scaled=True, xca_kwargs={"residual": True, "last_proj": True}),
        lambda: TB.NonDeepBlock(C, C, scaled=True, xca_kwargs={"residual": True, "last_proj": True}),
    ),
    "xca_v_norm": (
        lambda: JB.NonDeepBlock(in_chs=C, out_chs=C, xca_kwargs={"v_norm": True, "num_heads": 4}),
        lambda: TB.NonDeepBlock(C, C, xca_kwargs={"v_norm": True, "num_heads": 4}),
    ),
    "ufo_widen": (
        lambda: JB.NonDeepBlock(in_chs=C, out_chs=24, scaled=True, ufo_kwargs={"residual": False, "qk_norm": True,
                                                                              "prelast_act": True}),
        lambda: TB.NonDeepBlock(C, 24, scaled=True, ufo_kwargs={"residual": False, "qk_norm": True, "prelast_act": True}),
    ),
    "ufo_residual_prenorm": (
        lambda: JB.NonDeepBlock(in_chs=C, out_chs=C, ufo_kwargs={"residual": True, "last_proj": True, "prenorm": True}),
        lambda: TB.NonDeepBlock(C, C, ufo_kwargs={"residual": True, "last_proj": True, "prenorm": True}),
    ),
    "no_conv3_residual": (
        lambda: JB.NonDeepBlock(in_chs=C, out_chs=24, use_conv3=False, residual=True, **SCALED),
        lambda: TB.NonDeepBlock(C, 24, use_conv3=False, residual=True, **SCALED),
    ),
    "residual_no_shuffle_frn": (
        lambda: JB.NonDeepBlock(in_chs=C, out_chs=C, residual=True, shuffle=False, groups_width=8, norm="frn"),
        lambda: TB.NonDeepBlock(C, C, residual=True, shuffle=False, groups_width=8, norm="frn"),
    ),
    "conv_act_xca": (
        lambda: JB.ConvActBlock(in_chs=C, out_chs=C, activation="silu", attn_kwargs={"num_heads": 4}),
        lambda: TB.ConvActBlock(C, C, activation="silu", attn_kwargs={"num_heads": 4}),
    ),
    # the JAX block calls its XCA without train: the dropout never runs, in training too
    "conv_act_xca_dropout_off": (
        lambda: JB.ConvActBlock(in_chs=C, out_chs=24, stride=2, activation="silu",
                                attn_kwargs={"attn_drop": 0.5, "proj_drop": 0.5, "last_proj": True}),
        lambda: TB.ConvActBlock(C, 24, stride=2, activation="silu",
                                attn_kwargs={"attn_drop": 0.5, "proj_drop": 0.5, "last_proj": True}),
    ),
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, train):
    jmake, tmake = BLOCKS[name]
    compare(jmake(), tmake(), (2, 8, 8, C), train)


@pytest.mark.parametrize("name", ["se_scaled_grouped", "xca_residual_proj", "ufo_widen"])
def test_block_matches_jax_in_bf16(name):
    jmake, tmake = BLOCKS[name]
    compare_bf16(jmake(), tmake(), (2, 8, 8, C))


def test_block_errors_are_the_jax_ones():
    with pytest.raises(ValueError, match="dimension reduction"):
        TB.NonDeepBlock(24, 16, residual=True)
    with pytest.raises(ValueError, match="XCA requires"):
        TB.NonDeepBlock(16, 24, xca_kwargs={})


def test_block_attention_defaults_and_forced_projection():
    assert isinstance(TB.NonDeepBlock(16, 16).attn, TA.SEVar3)
    assert TB.NonDeepBlock(16, 16, use_se=False).attn is None and TB.NonDeepBlock(16, 24).attn is None
    xca = TB.NonDeepBlock(16, 16, xca_kwargs={}).attn
    assert isinstance(xca, TA.XCA) and not xca.residual
    ufo = TB.NonDeepBlock(16, 24, ufo_kwargs={"last_proj": False}).attn
    assert isinstance(ufo, TA.UFO) and not ufo.residual and tuple(ufo.proj.weight.shape) == (24, 16, 1, 1)
    assert TB.ConvActBlock(16, 16, attn_kwargs={"attn_drop": 0.1}).attn.attn_drop is None


def _record_jax_masks(monkeypatch):
    """Every non-scalar jax.random.bernoulli draw (dropout and drop-path masks),
    in order, also from inside a jitted step (an ordered debug callback)."""
    masks, bernoulli = [], jax.random.bernoulli

    def recording(*a, **kw):
        out = bernoulli(*a, **kw)
        if out.ndim:
            jax.debug.callback(lambda m: masks.append(np.array(m)), out, ordered=True)
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    return masks


def _feed_torch_masks(monkeypatch, masks):
    """The port's draw_keep_mask returns the recorded JAX masks, in order. Both
    are in the same layout here: XCA's attn is (B, heads, C', C') in both
    packages, a drop-path mask (B, 1, 1, 1)."""
    fed = iter(masks)

    def feed(generator, keep_prob, shape, device):
        m = torch.from_numpy(next(fed))
        assert tuple(m.shape) == tuple(shape), (m.shape, shape)
        return m.to(device)

    monkeypatch.setattr(TL, "draw_keep_mask", feed)
    return fed


def test_nf_timm_with_xca_dropout_matches_jax_on_the_jax_masks(monkeypatch):
    """Config 21: NormFreeBlockTimm's regnet attention is an XCA with attn_drop
    0.1 (proj_drop 0.1, unused without the projection), and drop-path 0.85;
    the JAX block passes ``train``, so both fire in training."""
    masks = _record_jax_masks(monkeypatch)
    kw = dict(activation="swish_hard", groups_width=8, alpha=0.2, attention_type="xca", regnet_attention=True,
              attention_kwargs={"attn_drop": 0.1, "proj_drop": 0.1}, keep_prob=0.85, conv_kwargs={"gamma": 1.7})
    jmod = JB.NormFreeBlockTimm(in_chs=C, out_chs=C, mid_chs=C, **kw)
    tmod = TB.NormFreeBlockTimm(C, C, C, **kw)
    shape = (8, 6, 6, C)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    params, stats = _variables(jmod, x, rng)
    masks.clear()
    want, vjp = jax.vjp(lambda p, xj: jmod.apply({"params": p}, xj, train=True, rngs={"dropout": jax.random.PRNGKey(5)}),
                        params, jnp.asarray(x))
    assert [m.shape for m in masks] == [(8, 8, 2, 2), (8, 1, 1, 1)]  # attn (B, heads, C', C'), then drop-path
    assert 0 < masks[0].mean() < 1 and 0 < masks[1].mean() < 1
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_gp, want_dx = vjp(jnp.asarray(cot))
    _feed_torch_masks(monkeypatch, masks)
    tmod.load_state_dict(flax_to_torch_model(tmod, params, stats))
    leaf = torch.from_numpy(x).requires_grad_(True)
    out = tmod.train()(leaf.permute(0, 3, 1, 2))
    (out * _nchw(cot)).sum().backward()
    _close(_nhwc(out), np.asarray(want), "output")
    _close(leaf.grad.numpy(), np.asarray(want_dx), "input gradient")
    want_grads = flax_to_torch_model(tmod, jax.tree_util.tree_map(np.asarray, want_gp), stats)
    for name, p in tmod.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), f"gradient of {name}", PARAM_GRAD_TOL)
