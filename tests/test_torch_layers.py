"""The port's primitive layers and attention modules against the JAX
package's, on the same inputs and weights (made from a numpy seed; the JAX
module's initial tree gives the shapes, ``flax_to_torch_model`` carries the
values over).

float32: outputs, input gradients and weight gradients (of sum(out * r), r
random) within 1e-5 of the largest reference value. bfloat16: the output
dtype is bfloat16 and each element is within one bf16 ulp (of the larger of
the two values) of the JAX bf16 output; where a module sums many bf16
products after rounding its weight to bf16 (the convs), a weight that the
two float32 standardisations leave 1e-7 apart may round to the other bf16
neighbour, so those outputs also get an absolute slack of 2^-8 of the
output's root mean square. Three modules get more room, each for a rounding
the JAX side does and the port does not: the JAX SiLU rounds sigmoid(x) to
bf16 before the product (2 ulps); flax's avg_pool sums its window in bf16
(an absolute 2^-8 of the largest input); jnp.linspace computes the
coord_conv coordinates in bf16 arithmetic, up to a bf16 ulp off the rounded
float32 ones (4 times the weighted slack). DropPath and Dropout: identity in eval, exact
against a fed mask, and the drawn mask's mean within 5 binomial standard
deviations of keep_prob."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.models import attention as JA
from sota_imagenet_tpu.models import layers as JL
from sota_imagenet_tpu_torch.models import attention as TA
from sota_imagenet_tpu_torch.models import layers as TL
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

SHAPE = (2, 12, 12, 8)  # NHWC


def _randomized(tree, rng):
    """The same tree with every leaf drawn anew (gains near 1, the rest N(0, 0.5))."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(path[-1])
        v = rng.standard_normal(leaf.shape) * 0.5 + (1.0 if "gain" in name or "scale" in name else 0.0)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _to_nchw(a):
    return a.permute(0, 3, 1, 2) if a.dim() == 4 else a


def _to_nhwc(a):
    return a.permute(0, 2, 3, 1) if a.dim() == 4 else a


# id -> (JAX module, port module, NHWC input shape)
SSC = dict(in_chs=8, out_chs=16)
MODULES = {
    "ssc_default": (lambda: JL.ScaledStdConv(out_chs=16), lambda: TL.ScaledStdConv(**SSC), SHAPE),
    "ssc_1x1_gamma": (
        lambda: JL.ScaledStdConv(out_chs=16, kernel_size=1, padding=0, gamma=1.7),
        lambda: TL.ScaledStdConv(**SSC, kernel_size=1, padding=0, gamma=1.7),
        SHAPE,
    ),
    "ssc_norm": (lambda: JL.ScaledStdConv(out_chs=16, norm=True), lambda: TL.ScaledStdConv(**SSC, norm=True), SHAPE),
    "ssc_heads2": (lambda: JL.ScaledStdConv(out_chs=16, n_heads=2), lambda: TL.ScaledStdConv(**SSC, n_heads=2), SHAPE),
    "ssc_single_gain": (
        lambda: JL.ScaledStdConv(out_chs=16, single_gain=True),
        lambda: TL.ScaledStdConv(**SSC, single_gain=True),
        SHAPE,
    ),
    "ssc_partial": (
        lambda: JL.ScaledStdConv(out_chs=16, partial_conv=True),
        lambda: TL.ScaledStdConv(**SSC, partial_conv=True),
        SHAPE,
    ),
    "ssc_coord": (
        lambda: JL.ScaledStdConv(out_chs=16, coord_conv=True),
        lambda: TL.ScaledStdConv(**SSC, coord_conv=True),
        SHAPE,
    ),
    "ssc_groups": (lambda: JL.ScaledStdConv(out_chs=16, groups=2), lambda: TL.ScaledStdConv(**SSC, groups=2), SHAPE),
    "ssc_stride2": (lambda: JL.ScaledStdConv(out_chs=16, stride=2), lambda: TL.ScaledStdConv(**SSC, stride=2), SHAPE),
    "ssc_no_gain_no_bias": (
        lambda: JL.ScaledStdConv(out_chs=16, gain_init=None, use_bias=False),
        lambda: TL.ScaledStdConv(**SSC, gain_init=None, use_bias=False),
        SHAPE,
    ),
    "scaled_conv3x3": (lambda: JL.scaled_conv3x3(8, 16, bias=False), lambda: TL.scaled_conv3x3(8, 16, bias=False), SHAPE),
    "scaled_conv1x1": (lambda: JL.scaled_conv1x1(8, 16), lambda: TL.scaled_conv1x1(8, 16), SHAPE),
    "conv3x3": (lambda: JL.conv3x3(8, 16, stride=2, groups=2), lambda: TL.conv3x3(8, 16, stride=2, groups=2), SHAPE),
    "conv1x1": (lambda: JL.conv1x1(8, 16, bias=True), lambda: TL.conv1x1(8, 16, bias=True), SHAPE),
    "linear": (lambda: JL.linear(8, 5), lambda: TL.linear(8, 5), (4, 8)),
    "blurpool": (lambda: JL.BlurPool(), lambda: TL.BlurPool(), SHAPE),
    "blurpool_odd_filt4": (lambda: JL.BlurPool(filt_size=4), lambda: TL.BlurPool(filt_size=4), (2, 11, 11, 8)),
    "maxpool": (lambda: JL.MaxPool(), lambda: TL.MaxPool(), SHAPE),
    "avgpool": (lambda: JL.AvgPool(3, 2, 1), lambda: TL.AvgPool(3, 2, 1), SHAPE),
    "global_avgpool": (lambda: JL.FastGlobalAvgPool(), lambda: TL.FastGlobalAvgPool(), SHAPE),
    "global_avgpool_keepdims": (
        lambda: JL.FastGlobalAvgPool(flatten=False), lambda: TL.FastGlobalAvgPool(flatten=False), SHAPE
    ),
    "space_to_depth": (lambda: JL.SpaceToDepth(2), lambda: TL.SpaceToDepth(2), SHAPE),
    "channel_shuffle": (lambda: JL.ChannelShuffle(4), lambda: TL.ChannelShuffle(4), SHAPE),
    "flatten": (lambda: JL.Flatten(), lambda: TL.Flatten(), (2, 3, 5, 8)),
    "activation": (lambda: JL.Activation(act="silu"), lambda: TL.Activation(act="silu"), SHAPE),
    "eca": (lambda: JA.ECA(channels=8), lambda: TA.ECA(8), SHAPE),
    "eca9": (lambda: JA.get_attn("eca9")(8), lambda: TA.get_attn("eca9")(8), SHAPE),
    "se": (lambda: JA.SE(channels=8, reduction=2), lambda: TA.SE(8, reduction=2), SHAPE),
    "sevar3": (lambda: JA.SEVar3(channels=8), lambda: TA.SEVar3(8), SHAPE),
    "sevar3_scaled": (lambda: JA.SEVar3(channels=8, scaled=True), lambda: TA.SEVar3(8, scaled=True), SHAPE),
}
# modules that round a standardised weight to bf16 before summing products (see the docstring)
WEIGHTED = ("ssc_", "scaled_conv", "conv", "linear", "se", "eca")


@pytest.fixture(scope="module", params=sorted(MODULES))
def pair(request):
    make_j, make_t, shape = MODULES[request.param]
    rng = np.random.default_rng(sorted(MODULES).index(request.param))
    x = rng.standard_normal(shape).astype(np.float32)
    jm, tm = make_j(), make_t()
    params = _randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)).get("params", {}), rng)
    tm.load_state_dict(flax_to_torch_model(tm, params))
    return {"name": request.param, "jm": jm, "tm": tm.eval(), "params": params, "x": x, "rng": rng}


def test_float32_output_and_gradients_match_jax(pair):
    jm, tm, params, x = pair["jm"], pair["tm"], pair["params"], pair["x"]
    variables = {"params": params} if params else {}
    out_j = jm.apply(variables, jnp.asarray(x))
    r = pair["rng"].standard_normal(out_j.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jm.apply({"params": p} if p else {}, xx) * r), argnums=(0, 1))(
        params, jnp.asarray(x)
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    out_t = _to_nhwc(tm(_to_nchw(xt)))
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == out_j.shape
    (out_t * torch.from_numpy(r)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=what)

    close(out_t.detach().numpy(), out_j, "output")
    close(xt.grad.numpy(), gx, "input gradient")
    want_g = flax_to_torch_model(tm, jax.tree_util.tree_map(np.asarray, gp))
    for name, p in tm.named_parameters():
        close(p.grad.numpy(), want_g[name].numpy(), f"gradient of {name}")


def test_bfloat16_output_within_one_ulp_of_jax(pair):
    jm, tm, params, x = pair["jm"], pair["tm"], pair["params"], pair["x"]
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out_j = jm.apply({"params": params} if params else {}, xb)
    out_t = _to_nhwc(tm(_to_nchw(torch.from_numpy(x).to(torch.bfloat16))))
    assert out_j.dtype == jnp.bfloat16 and out_t.dtype == torch.bfloat16
    a = out_t.detach().float().numpy().astype(np.float64)
    b = np.asarray(out_j.astype(jnp.float32)).astype(np.float64)
    _, exp = np.frexp(np.maximum(np.abs(a), np.abs(b)))
    tol = np.ldexp(1.0, exp - 8)  # one bf16 ulp: 8 significant bits
    name = pair["name"]
    if name.startswith(WEIGHTED):
        tol = tol + (4.0 if name == "ssc_coord" else 1.0) * 2.0**-8 * np.sqrt(np.mean(b * b))
    elif name == "activation":
        tol = 2.0 * tol
    elif name == "avgpool":
        tol = tol + 2.0**-8 * np.abs(x).max()
    worst = np.max(np.abs(a - b) / tol)
    assert worst <= 1.0, f"{worst} of the tolerance"


def test_concat_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(SHAPE).astype(np.float32), rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    want = JL.Concat().apply({}, jnp.asarray(a), jnp.asarray(b))
    got = _to_nhwc(TL.Concat()(_to_nchw(torch.from_numpy(a)), _to_nchw(torch.from_numpy(b))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want2 = JL.Concat(axis=1).apply({}, jnp.asarray(a), jnp.asarray(a))
    got2 = _to_nhwc(TL.Concat(axis=1)(_to_nchw(torch.from_numpy(a)), _to_nchw(torch.from_numpy(a))))
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


def test_activation_gamma_table_is_the_jax_one():
    assert TL.ACTIVATION_GAMMA == JL.ACTIVATION_GAMMA


def test_get_attn_none_and_unknown():
    assert TA.get_attn(None)(8) is None
    with pytest.raises(KeyError):
        TA.get_attn("nope")


# --------------------------------------------------------------------------- #
# DropPath / Dropout
# --------------------------------------------------------------------------- #

DROPS = {
    "drop_path": (lambda: JL.DropPath(keep_prob=0.7), lambda: TL.DropPath(0.7), 0.7, lambda s: (s[0], 1, 1, 1)),
    "dropout": (lambda: JL.Dropout(rate=0.4), lambda: TL.Dropout(0.4), 0.6, lambda s: s),
}


@pytest.mark.parametrize("kind", sorted(DROPS))
def test_drop_is_identity_in_eval(kind):
    _, make_t, _, _ = DROPS[kind]
    x = torch.randn(4, 8, 6, 6, generator=torch.Generator().manual_seed(0))
    assert torch.equal(make_t().eval()(x), x)


@pytest.mark.parametrize("kind", sorted(DROPS))
def test_drop_matches_jax_on_the_jax_mask(kind):
    """The JAX module's own mask (read off its output: the input has no zero)
    fed to the port's apply function gives the JAX output exactly."""
    make_j, _, keep, mask_shape = DROPS[kind]
    x = np.random.default_rng(1).standard_normal((8, 6, 6, 4)).astype(np.float32)
    want = np.asarray(make_j().apply({}, jnp.asarray(x), train=True, rngs={"dropout": jax.random.PRNGKey(3)}))
    mask = want != 0
    if kind == "drop_path":  # one draw per sample
        assert all(m.all() or not m.any() for m in mask)
        mask = mask[:, :1, :1, :1]
    assert 0 < mask.mean() < 1 and mask.shape == tuple(mask_shape(x.shape))
    got = TL.apply_keep_mask(torch.from_numpy(x), torch.from_numpy(np.broadcast_to(mask, x.shape).copy()), keep)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", sorted(DROPS))
def test_drawn_mask_mean_and_generator(kind):
    _, make_t, keep, _ = DROPS[kind]
    m = make_t().train()
    x = torch.ones(4096, 4, 2, 2)
    TL.bind_generator(m, torch.Generator().manual_seed(5))
    out = m(x)
    kept = out != 0
    n = 4096 if kind == "drop_path" else x.numel()
    frac = kept.float().mean().item()
    assert abs(frac - keep) < 5 * (keep * (1 - keep) / n) ** 0.5
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / keep))
    if kind == "drop_path":  # a sample is kept or dropped whole
        per_sample = kept.flatten(1).float().mean(1)
        assert set(per_sample.tolist()) <= {0.0, 1.0}
    # the bound generator decides the draw: the same seed gives the same mask
    TL.bind_generator(m, torch.Generator().manual_seed(5))
    assert torch.equal(m(x), out)
