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
