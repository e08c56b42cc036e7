"""The port's NFNet against the JAX package's, from converted weights.

Size of tests/test_nfnet_parity.py: depths (1, 2), channels (64, 128), stem
(8, 8, 16, 32), group_size 32, 10 classes, batch 4 at 32 px. The JAX model's
initial weights are used with every ``skipinit_gain`` (zero at init, which
would switch every residual branch off) and every ECA kernel replaced by
random non-zero values from the seed. Logits in train mode (drop rates 0)
and eval mode: float32 within 1e-4 of the largest logit; bfloat16 (reported
against float32) within 5e-2. The JAX ScaledStdConv standardises in float32
even for float64 weights, so there is no float64 comparison to make.

Full width: ``eca_nfnet_l0`` has 24.14M parameters and the converter maps
every leaf of the JAX tree onto every key of the port's state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.models.nfnet import NFNet as JNFNet
from sota_imagenet_tpu.models.nfnet import eca_nfnet_l0 as jax_eca_nfnet_l0
from sota_imagenet_tpu_torch.models import NFNet, eca_nfnet_l0, eca_nfnet_l1
from sota_imagenet_tpu_torch.utils.misc import count_parameters
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

SMALL = dict(depths=(1, 2), channels=(64, 128), stem_chs=(8, 8, 16, 32), group_size=32, num_classes=10)


def nonzero_gains(params, rng):
    """``params`` as numpy, with skipinit gains and ECA kernels drawn from ``rng``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    leaves = []
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf)
        if name.endswith("skipinit_gain"):
            leaf = np.asarray(rng.uniform(0.5, 1.5), leaf.dtype)
        elif "ECA_0" in name:
            leaf = rng.standard_normal(leaf.shape).astype(leaf.dtype)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    jmodel = JNFNet(**SMALL)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    params = nonzero_gains(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)["params"], rng)
    model = NFNet(**SMALL)
    model.load_state_dict(flax_to_torch_model(model, params))
    return jmodel, params, model, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_float32_logits_match_jax(small, train):
    jmodel, params, model, x = small
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), train=train, rngs={"dropout": jax.random.PRNGKey(1)}))
    model.train(train)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 1e-2 and np.std(want) > 1e-3  # the branches are live, not all-shortcut


def test_bfloat16_logits_are_float32_and_near(small):
    jmodel, params, model, x = small
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), train=False))
    got = model.eval()(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32  # the head runs in bf16, the logits are returned as f32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=5e-2 * np.abs(want).max())


def test_skipinit_gain_starts_at_zero_and_classifier_is_normal_001():
    model = NFNet(**SMALL)
    model.reset_parameters(torch.Generator().manual_seed(0))
    gains = [p for n, p in model.named_parameters() if n.endswith("skipinit_gain")]
    assert len(gains) == 3 and all(g.dim() == 0 and float(g) == 0.0 for g in gains)
    assert abs(float(model.fc.weight.std()) - 0.01) < 2e-3 and float(model.fc.bias.abs().max()) == 0.0
    # signal propagation: beta = 1/expected_std; a stage's first block resets expected_std after taking its beta
    betas = [b.beta for b in model.blocks]
    np.testing.assert_allclose(betas, [1.0, 1.0 / (1.0 + 0.2**2) ** 0.5, 1.0 / (1.0 + 0.2**2) ** 0.5])
    assert [b.conv2.groups for b in model.blocks] == [1, 1, 1] and model.blocks[1].stride == 2


def test_stochastic_depth_rates_follow_the_block_index():
    model = NFNet(**SMALL, drop_rate=0.2, drop_path_rate=0.3)
    np.testing.assert_allclose([b.drop_path.keep_prob for b in model.blocks], [1.0, 0.85, 0.7])
    assert model.dropout.rate == 0.2


def test_full_width_l0_has_24_14m_parameters_and_every_leaf_maps():
    model = eca_nfnet_l0(drop_rate=0.2, drop_path_rate=0.15)
    assert round(count_parameters(model) / 1e6, 2) == 24.14
    assert [b.conv2.groups for b in model.blocks] == [1, 2, 2, 6, 6, 6, 6, 6, 6, 6, 6, 6]
    shapes = jax.eval_shape(
        lambda k: jax_eca_nfnet_l0().init(k, jnp.zeros((1, 64, 64, 3)), train=False), jax.random.PRNGKey(0)
    )["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_torch_model(model, params)  # raises on a leaf left over or a key not produced
    own = model.state_dict()
    assert set(sd) == set(own) and len(sd) == len(jax.tree_util.tree_leaves(params))
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in own)
    # a leaf the walk does not read, or a key it cannot fill, is an error
    with pytest.raises(KeyError, match="unmapped"):
        flax_to_torch_model(model, {**params, "extra": {"kernel": np.zeros(1)}})
    with pytest.raises(KeyError):
        flax_to_torch_model(model, {k: v for k, v in params.items() if k != "final_conv"})


def test_l1_is_deeper():
    assert len(eca_nfnet_l1().blocks) == 24
