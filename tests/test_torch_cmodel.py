"""The port's CModel against the JAX package's: the cases of
tests/test_cmodel.py that the ported module table covers (dict and list
forms, tags and integer back-references, ``extra_kwargs``, ``repeat``),
``configs/tiny_synthetic.yaml``, and a ConvActBlock + BlurPool +
scaled_conv1x1 stack with grouped, squeeze-excited and BatchNorm layers.

Each config is built in both packages; the JAX model's tree (every leaf
drawn anew from a numpy seed) is carried over by ``flax_to_torch_model``,
which walks both models in layer order; float32 outputs in eval mode within
1e-5 of the largest output. A module name of the JAX table that is not
ported raises NotImplementedError naming the module; ConvActBlock takes
the activated norms as its pre-norm, as the JAX block does."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.models import cmodel as TCM
from sota_imagenet_tpu_torch.models.cmodel import CModel, _parse_entry, _update_dict, build_structures
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_synthetic.yaml")

CONFIGS = {
    "plain_dict": """
- {module: conv3x3, args: [3, 16]}
- {module: SiLU}
- {module: conv3x3, args: [16, 32], kwargs: {stride: 2}}
- {module: FastGlobalAvgPool2d, kwargs: {flatten: True}}
- {module: Linear, args: [32, 10]}
""",
    "yolo_list": """
- [-1, 1, ConvActBlock, [3, 16], {stride: 2}]
- [-1, 2, ConvActBlock, [16, 16]]
- [-1, 1, Identity]
- [-1, 1, scaled_conv1x1, [16, 64]]
- [-1, 1, 'torch.nn.SiLU']
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "torch.nn.Dropout", [0.2]]
- [-1, 1, "nn.Linear", [64, 10]]
""",
    "tagged_skip": """
- {module: conv3x3, args: [3, 8], tag: enc}
- {module: conv3x3, args: [8, 8]}
- {module: conv3x3, args: [8, 8]}
- {module: Concat, inputs: [_prev_, enc]}
- {module: conv1x1, args: [16, 8]}
""",
    "integer_back_references": """
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, "nn.MaxPool2d", [2]]
- [-1, 1, conv3x3, [8, 8]]
- [[-1, 1], 1, Concat]
- [[-1, -2], 1, Concat, [], {axis: -1}]
- [-1, 1, "nn.AvgPool2d", [2, 2]]
- [-1, 1, Flatten]
""",
    "conv_act_stack": """
- [-1, 1, ConvActBlock, [3, 8], {stride: 2, conv_kwargs: {gain_init: 1.0, gamma: 1.7}}]
- [-1, 2, ConvActBlock, [8, 8], {sse: true}]
- [-1, 1, "pt.modules.BlurPool", 8]
- [-1, 1, ConvActBlock, [8, 16], {groups_width: 4, activation: "'swish_hard'"}]
- [-1, 1, ConvBnAct, [16, 16]]
- [-1, 1, "nn.BatchNorm2d", [16]]
- [-1, 1, SpaceToDepth]
- [-1, 1, ChannelShuffle, [4]]
- [-1, 1, scaled_conv1x1, [64, 32], {gamma: 2.0}]
- [-1, 1, 'torch.nn.SiLU']
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [32, 10]]
""",
}
EXTRA = {"yolo_list": {"ConvActBlock": {"activation": "'swish_hard'"}}}
OUT_SHAPES = {
    "plain_dict": (2, 10), "yolo_list": (2, 10), "tagged_skip": (2, 32, 32, 8),
    "integer_back_references": (2, 8 * 8 * 24), "conv_act_stack": (2, 10), "tiny_synthetic": (2, 1000),
}


def _randomized(tree, rng):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            v = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            v = rng.standard_normal(leaf.shape) * 0.5 + (1.0 if name in ("gain", "scale") else 0.0)
        leaves.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _models(name):
    if name == "tiny_synthetic":
        return JC.instantiate(JC.load(TINY, strict_env=False).model), TC.instantiate(TC.load(TINY, strict_env=False).model)
    cfg = yaml.safe_load(CONFIGS[name])
    return JCModel(layer_config=cfg, extra_kwargs=EXTRA.get(name)), CModel(layer_config=cfg, extra_kwargs=EXTRA.get(name))


@pytest.mark.parametrize("name", [*sorted(CONFIGS), "tiny_synthetic"])
def test_cmodel_output_matches_jax(name):
    rng = np.random.default_rng(0)
    jmodel, model = _models(name)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x), train=False)
    variables = _randomized(dict(variables), rng)
    model.load_state_dict(flax_to_torch_model(model, variables["params"], variables.get("batch_stats")))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    got = model.eval()(torch.from_numpy(x))
    if got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape == OUT_SHAPES[name]
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1.0))


def test_repeat_builds_the_module_that_many_times_in_layer_order():
    model = CModel(layer_config=yaml.safe_load(CONFIGS["yolo_list"]))
    assert [len(mods) for mods in model.layers] == [1, 2, 1, 1, 1, 1, 1, 1]
    assert model.layers[1][0] is not model.layers[1][1]
    assert "layers.1.1.conv.weight" in model.state_dict() and "layers.7.0.weight" in model.state_dict()


def test_update_dict():
    """Reference test_update_dict (model.py:1126-1144)."""
    assert _update_dict({"a": 10, "b": 20}, {"a": 12, "c": 30}) == {"a": 12, "b": 20, "c": 30}
    assert _update_dict({"foo": {"a": 10, "b": 20}}, {"foo": {"a": 12, "c": 30}}) == {"foo": {"a": 12, "b": 20, "c": 30}}
    assert _update_dict({"bar": 1}, {"foo": {"a": 12, "c": 30}}) == {"bar": 1, "foo": {"a": 12, "c": 30}}


def test_extra_kwargs_merge():
    """extra_kwargs defaults merged per class; layer kwargs win (reference model.py:1359-1376)."""
    cfg = [
        {"module": "ConvActBlock", "args": [3, 16], "kwargs": {"activation": "relu"}},
        {"module": "pt.blocks.ConvActBlock", "args": [16, 16]},
    ]
    extra = {"ConvActBlock": {"activation": "'swish_hard'", "conv_kwargs": {"gamma": 2.0}}}
    structures = build_structures(cfg, extra)
    assert structures[0].kwargs["activation"] == "relu"  # layer wins
    assert structures[0].kwargs["conv_kwargs"]["gamma"] == 2.0  # extra merged in
    assert structures[1].kwargs["activation"] == "'swish_hard'"  # matched by the last dotted component
    model = CModel(layer_config=cfg, extra_kwargs=extra)
    assert model.layers[1][0].conv.scale == pytest.approx(2.0 * (9 * 16) ** -0.5)
    assert tuple(model(torch.zeros(1, 32, 32, 3)).shape) == (1, 16, 32, 32)


def test_parse_entry_forms_match_jax():
    from sota_imagenet_tpu.models.cmodel import _parse_entry as jax_parse_entry

    for entry in (
        {"module": "conv3x3", "args": 3, "tag": "t"},
        {"module": "Concat", "inputs": ["_prev_", "t"]},
        [-1, 2, "ConvActBlock", [16, 16]],
        [[-1, 3], 1, "Concat"],
        [-1, 1, "pt.modules.BlurPool", 8, {"filt_size": 3}],
    ):
        assert vars(_parse_entry(entry)) == vars(jax_parse_entry(entry))
    with pytest.raises(ValueError):
        _parse_entry("conv3x3")


def test_module_table_covers_the_jax_table():
    from sota_imagenet_tpu.models.cmodel import _MODULES as JAX_MODULES

    assert set(TCM._MODULES) == set(JAX_MODULES)


@pytest.mark.parametrize("name", ["Yolo5_C3", "VGGBlock", "src.model.ConvMixerBlock", "src.model.FusedRepVGGBlock"])
def test_unported_module_raises_naming_it(name):
    """These names raised NotImplementedError naming ROADMAP item 10 until the
    rest of the CModel table was ported; now each builds and runs, by its
    dotted path too, and no name of the table raises."""
    args = {"Yolo5_C3": [8], "VGGBlock": [8, 8], "ConvMixerBlock": [8, 7], "FusedRepVGGBlock": [8, 8]}
    model = CModel(layer_config=[[-1, 1, "conv3x3", [3, 8]], [-1, 1, name, args[name.rsplit(".", 1)[-1]]]])
    assert model(torch.zeros(2, 8, 8, 3)).shape == (2, 8, 8, 8)
    assert type(model.layers[1][0]).__name__ == name.rsplit(".", 1)[-1]


def test_unknown_module_and_tag_raise_key_error():
    with pytest.raises(KeyError, match="unknown module"):
        CModel(layer_config=[[-1, 1, "NoSuchModule", [3, 8]]])
    with pytest.raises(KeyError, match="not found"):
        CModel(layer_config=[{"module": "conv3x3", "args": [3, 8], "inputs": ["missing"]}])


@pytest.mark.parametrize("option", [{"pre_norm": "agn"}, {"pre_norm": "abn"}])
def test_conv_act_block_options_not_ported_raise(option):
    """The activated norms as ConvActBlock's pre-norm, which raised before the
    activated-BN family was ported, now build and match the JAX block (float32,
    train mode, tests/test_torch_nondeep.py's tolerances)."""
    from sota_imagenet_tpu.models import blocks as JB
    from sota_imagenet_tpu_torch.models import blocks as TB
    from tests.test_torch_nondeep import compare

    compare(JB.ConvActBlock(in_chs=16, out_chs=16, **option), TB.ConvActBlock(16, 16, **option), train=True)
