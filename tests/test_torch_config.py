"""The port's config loader composes every YAML under configs/ to the same
tree as the JAX package's (as plain dicts), and raises the same error type
where the JAX loader raises."""

import glob
import os

import pytest

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu_torch import config as TC

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
ALL_YAML = sorted(glob.glob(os.path.join(CONFIG_DIR, "**", "*.yaml"), recursive=True))


def _load(mod, path, **kw):
    try:
        return "ok", mod.to_dict(mod.load(path, strict_env=False, **kw))
    except Exception as e:  # compared by type below
        return "error", type(e).__name__


def test_every_config_is_collected():
    assert len(ALL_YAML) > 200  # configs/, configs/exp/, configs/old_exp/**


@pytest.mark.parametrize("path", ALL_YAML, ids=[os.path.relpath(p, CONFIG_DIR) for p in ALL_YAML])
def test_config_composes_like_jax(path):
    assert _load(TC, path) == _load(JC, path)


def test_overrides_and_stages_like_jax():
    path = os.path.join(CONFIG_DIR, "exp", "1.r50_baseline.yaml")
    ov = [
        "loader.batch_size=64",
        "+model.width=2",
        "run.stages=[{start: 0, end: 1, lr: [0.001, 1.0]}, {start: 1, end: 3, lr: [1.0, 0], lr_mode: cos}]",
    ]
    t, j = TC.load(path, overrides=ov, strict_env=False), JC.load(path, overrides=ov, strict_env=False)
    assert TC.to_dict(t) == JC.to_dict(j)
    assert [vars(s) for s in TC.parse_stages(t.run.stages)] == [vars(s) for s in JC.parse_stages(j.run.stages)]
    with pytest.raises(KeyError):
        TC.load(path, overrides=["loader.no_such_key=1"], strict_env=False)


def test_registry_knows_the_slice_and_names_the_roadmap_for_the_rest():
    from sota_imagenet_tpu_torch import registry
    from sota_imagenet_tpu_torch.optim import build_optimizer

    for name in ("resnet18", "resnet34", "resnet50", "resnet101", "pytorch_tools.models.resnet50", "cross_entropy",
                 "CrossEntropyLoss"):
        assert callable(registry.resolve(name))
    with pytest.raises(KeyError, match="ROADMAP"):
        registry.resolve("bresnet50")
    with pytest.raises(KeyError, match="ROADMAP"):  # never imports the JAX package to find a name
        registry.resolve("sota_imagenet_tpu.models.bresnet50")
    with pytest.raises(KeyError, match="ROADMAP"):
        build_optimizer({"_target_": "adamw"}, [])
    assert build_optimizer({"_target_": "fused_sgd", "momentum": 0.9}, []).defaults["momentum"] == 0.9
