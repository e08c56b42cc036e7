"""The port's ResNet (sota_imagenet_tpu_torch.models.resnet) against the JAX
package's flax ResNet, from the same weights (utils/weights.flax_to_torch).

f32 on the CPU; tolerance rtol 1e-4 / atol 1e-4 on logits and updated BN
buffers: both sides compute in f32 but sum in different orders (XLA vs
oneDNN convolutions, one-pass E[x²]-E[x]² vs Welford batch variance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.models.resnet import Bottleneck as JBottleneck
from sota_imagenet_tpu.models.resnet import ResNet as JResNet
from sota_imagenet_tpu.models.resnet import resnet18 as jresnet18
from sota_imagenet_tpu.models.resnet import resnet50 as jresnet50
from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet, resnet18, resnet50
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several workers share the
    cores, and oversubscribed OpenMP threads slow these small CPU runs by
    one to two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _random_stats(stats, rng):
    """Non-trivial running stats so eval mode exercises the mapping."""
    return jax.tree_util.tree_map(
        lambda v: np.asarray(rng.uniform(0.5, 1.5, v.shape) if v.ndim else v, np.float32), stats
    )


def test_flax_to_torch_covers_every_resnet50_leaf():
    """Every leaf of the JAX resnet50 maps to a port tensor of the right
    shape, and nothing is left over on either side (shapes only: no compile)."""
    shapes = jax.eval_shape(
        lambda: jresnet50().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_torch(zeros["params"], zeros["batch_stats"])
    port = resnet50().state_dict()
    assert set(sd) == set(port)
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    n_jax = sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    assert n_jax == sum(v.numel() for v in port.values())


CASES = {
    "bottleneck_1111": (
        lambda: JResNet(block=JBottleneck, layers=(1, 1, 1, 1), num_classes=10),
        lambda: ResNet(block=Bottleneck, layers=(1, 1, 1, 1), num_classes=10),
        dict(layers=(1, 1, 1, 1), bottleneck=True),
    ),
    "resnet18": (
        lambda: jresnet18(num_classes=10),
        lambda: resnet18(num_classes=10),
        dict(layers=(2, 2, 2, 2), bottleneck=False),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(name, train):
    jmodel_fn, tmodel_fn, layout = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jmodel = jmodel_fn()
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 32, 32, 3)), train=False))(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _random_stats(variables["batch_stats"], rng)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=train, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)
    )
    jlogits, jstats = np.asarray(jout[0]), jout[1]["batch_stats"]

    tmodel = tmodel_fn()
    tmodel.load_state_dict(flax_to_torch(params, stats, **layout))
    tmodel.train(train)
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=RTOL, atol=ATOL)
    # updated BN buffers (unchanged in eval mode): biased running variance
    want = flax_to_torch(params, jstats, **layout)
    got = tmodel.state_dict()
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_dtype_policy(train):
    """The JAX package's policy (tests/test_dtype_policy.py): params stay
    float32, every conv and BatchNorm output is bf16 for a bf16 input, the
    classifier computes in float32 (flax Dense with dtype unset promotes),
    and the logits are float32."""
    from sota_imagenet_tpu_torch.models.layers import Conv, Linear
    from sota_imagenet_tpu_torch.models.norms import BatchNorm

    model = resnet50().train(train)
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, (Conv, BatchNorm, Linear)):
            m.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(name, out.dtype))
    with torch.no_grad():
        logits = model(torch.zeros((2, 32, 32, 3), dtype=torch.bfloat16))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert seen.pop("fc") == torch.float32
    assert len(seen) == 53 + 53 and set(seen.values()) == {torch.bfloat16}, seen


def test_flax_to_torch_covers_every_fused_resnet50_leaf():
    """The fused_stats layout: fconv1/fconv3/fdown plus the 3x3 conv at
    Conv_0 and its norm at _NormAct_0 map onto resnet50(fused_stats=True),
    every leaf and nothing left over (shapes only: no compile)."""
    shapes = jax.eval_shape(
        lambda: jresnet50(fused_stats=True).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)
    )
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = flax_to_torch(zeros["params"], zeros["batch_stats"])
    port = resnet50(fused_stats=True).state_dict()
    assert set(sd) == set(port)
    for k, v in port.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    assert sum(k.endswith(".scale") for k in port) == 16 * 2 + 4  # fconv1 + fconv3 per block, fdown per stage
    n_jax = sum(np.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes))
    assert n_jax == sum(v.numel() for v in port.values())


@pytest.fixture
def interpret(monkeypatch):
    """The JAX Conv1x1BNStats calls conv1x1_stats_nhwc without ``interpret``;
    on the CPU it must run interpreted."""
    import functools

    from sota_imagenet_tpu.ops import pallas_conv_stats as jcs

    monkeypatch.setattr(jcs, "conv1x1_stats_nhwc", functools.partial(jcs.conv1x1_stats_nhwc, interpret=True))


def _centred_stats(stats, rng):
    """Running means near 0 and variances near 1, so that the eval-mode
    signal survives all four stages."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            rng.uniform(0.5, 1.5, v.shape) if "var" in jax.tree_util.keystr(path) else rng.normal(0, 0.2, v.shape),
            np.float32,
        ),
        stats,
    )


# fused train mode, f32: both sides take bf16 products (conv1x1_stats casts to bf16
# even in an f32 net), with f32 sums in other orders, so a y near a bf16 rounding
# boundary rounds the other way, and train-mode BN carries that on. Measured by
# this test (CPU, one thread): logits 5.9e-3 and running buffers 1.1e-3 of
# their largest magnitude off.
FUSED_TRAIN_TOL = {"logits": 2e-2, "buffers": 5e-3}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_forward_matches_jax(interpret, train):
    """ResNet((1,1,1,1), fused_stats=True), f32, batch 8 at 64 px: logits
    and BN buffers against the JAX model. Eval mode runs no kernel and holds
    to the unfused tolerance; train mode to FUSED_TRAIN_TOL (relative to the
    largest magnitude of each tensor)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    jmodel = JResNet(block=JBottleneck, layers=(1, 1, 1, 1), num_classes=10, fused_stats=True)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _centred_stats(variables["batch_stats"], rng)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=train, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)
    )
    jlogits, jstats = np.asarray(jout[0]), jout[1]["batch_stats"]
    layout = dict(layers=(1, 1, 1, 1), bottleneck=True)
    tmodel = ResNet(block=Bottleneck, layers=(1, 1, 1, 1), num_classes=10, fused_stats=True)
    tmodel.load_state_dict(flax_to_torch(params, stats, **layout))
    tmodel.train(train)
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(x)).numpy()
    assert np.abs(jlogits).max() > 0.1  # the signal reached the classifier
    want = flax_to_torch(params, jstats, **layout)
    got = tmodel.state_dict()
    if not train:
        np.testing.assert_allclose(tlogits, jlogits, rtol=RTOL, atol=ATOL)
        for k in want:
            if "running" in k:
                assert torch.equal(got[k], want[k]), k
        return
    np.testing.assert_allclose(tlogits, jlogits, rtol=0, atol=FUSED_TRAIN_TOL["logits"] * np.abs(jlogits).max())
    for k in want:
        if "running" in k:
            w = want[k].numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=FUSED_TRAIN_TOL["buffers"] * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_bf16_dtype_policy(train):
    """With fused_stats the dtype policy holds as well: every conv, BatchNorm
    and Conv1x1BNStats output is bf16 for a bf16 input, params stay f32, the
    classifier and logits are f32."""
    from sota_imagenet_tpu_torch.models.layers import Conv, Linear
    from sota_imagenet_tpu_torch.models.norms import BatchNorm
    from sota_imagenet_tpu_torch.models.resnet import Conv1x1BNStats

    model = resnet50(fused_stats=True).train(train)
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, (Conv, BatchNorm, Linear, Conv1x1BNStats)):
            m.register_forward_hook(lambda mod, inp, out, name=name: seen.__setitem__(name, out.dtype))
    with torch.no_grad():
        logits = model(torch.zeros((2, 32, 32, 3), dtype=torch.bfloat16))
    assert logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert seen.pop("fc") == torch.float32
    # stem conv + BN, conv2 + bn2 of 16 blocks, fconv1 + fconv3 of 16 blocks, fdown of 4
    assert len(seen) == 2 + 16 * 2 + 16 * 2 + 4 and set(seen.values()) == {torch.bfloat16}, seen


def test_fused_stats_options():
    """As in the JAX package: fused_stats with bn_subsample > 1 raises
    ValueError (resnet.py:189-193); BasicBlock nets ignore fused_stats; a
    grouped Bottleneck keeps its plain conv1 and fuses conv3 and the
    downsample."""
    with pytest.raises(ValueError, match="bn_subsample"):
        resnet50(fused_stats=True, bn_subsample=2)
    assert set(resnet18(fused_stats=True).state_dict()) == set(resnet18().state_dict())
    block = ResNet(block=Bottleneck, layers=(1, 1, 1, 1), groups=2, fused_stats=True).layer1[0]
    names = {n for n, _ in block.named_children()}
    assert {"conv1", "bn1", "conv2", "bn2", "fconv3", "fdown"} <= names and "fconv1" not in names
