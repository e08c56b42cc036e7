"""The port's config loader composes every YAML under configs/ to the same
tree as the JAX package's (as plain dicts), and raises the same error type
where the JAX loader raises. Every ``configs/exp`` file either builds its
model and optimizer in the port or raises NotImplementedError naming a
ROADMAP item, never another exception; every active ``configs/old_exp``
file builds and runs an eval forward; every name of the JAX registry
resolves."""

import glob
import os
import re

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
    for name in ("vgg16_bn", "timm.models.vgg16_bn", "adacos", "fixmatch", "kld", "a-focal"):
        assert callable(registry.resolve(name))
    # every name of the JAX registry resolves now (test_registry_resolves_every_jax_name); an unknown one raises
    # KeyError as the JAX registry does, and a dotted path resolves by its last part, never by an import
    assert callable(registry.resolve("darknet53"))
    assert registry.resolve("sota_imagenet_tpu.models.darknet53") is registry.resolve("darknet53")
    with pytest.raises(KeyError, match="unknown target"):
        registry.resolve("no_such_model")
    with pytest.raises(KeyError, match="unknown target"):  # never imports the JAX package to find a name
        registry.resolve("sota_imagenet_tpu.models.no_such_model")
    with pytest.raises(KeyError, match="unknown optimizer"):  # an unknown optimizer, as the JAX factory
        build_optimizer({"_target_": "no_such_optimizer"}, [])
    for name in ("eca_nfnet_l0", "timm.models.eca_nfnet_l1", "CModel", "src.model.CModel", "CutmixMixup",
                 "pt_clb.Cutmix", "pytorch_tools.fit_wrapper.callbacks.Mixup", "Callback"):
        assert callable(registry.resolve(name))
    assert build_optimizer({"_target_": "fused_sgd", "momentum": 0.9}, []).defaults["momentum"] == 0.9


def test_registry_resolves_every_jax_name():
    """Every name and alias of the JAX package's registry resolves in the port."""
    from sota_imagenet_tpu import registry as jax_registry
    from sota_imagenet_tpu_torch import registry

    names = jax_registry.names() + sorted(jax_registry._ALIASES)
    assert len(names) > 100
    missing = []
    for name in names:
        try:
            assert callable(registry.resolve(name))
        except KeyError:
            missing.append(name)
    assert not missing


EXP_YAML = sorted(glob.glob(os.path.join(CONFIG_DIR, "exp", "*.yaml")))
# configs/exp files whose model and optimizer build in the port (ROADMAP.md records the count)
N_EXP_CONFIGS_THAT_BUILD = 108


def _build_model_and_optimizer(path):
    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    cfg = TC.load(path, strict_env=False)
    model = cli.build_model(cfg)
    mask = filter_from_weight_decay(model.named_parameters(), cfg.filter_from_wd) if cfg.filter_from_wd is not None else None
    build_optimizer(dict(cfg.optim), model.named_parameters(), wd_mask=mask)
    TC.instantiate(cfg.criterion)
    for clb in cfg.run.extra_callbacks or []:
        TC.instantiate(clb)
    return cfg, model


@pytest.fixture(scope="module")
def exp_outcomes():
    out = {}
    for path in EXP_YAML:
        try:
            _build_model_and_optimizer(path)
            out[path] = None
        except Exception as e:  # held to NotImplementedError below
            out[path] = e
    return out


@pytest.mark.parametrize("path", EXP_YAML, ids=[os.path.basename(p) for p in EXP_YAML])
def test_exp_config_builds_or_names_a_roadmap_item(path, exp_outcomes):
    err = exp_outcomes[path]
    if err is not None:
        assert isinstance(err, NotImplementedError), repr(err)
        assert re.search(r"ROADMAP\.md Queue 1.* item \d+", str(err)), str(err)


def test_count_of_exp_configs_that_build(exp_outcomes):
    built = sorted(os.path.basename(p) for p, e in exp_outcomes.items() if e is None)
    assert len(EXP_YAML) == 108
    assert "15.eca_nfnet_l0.yaml" in built and "1.r50_baseline.yaml" in built
    assert len(built) == N_EXP_CONFIGS_THAT_BUILD, built


def _is_commented(path: str) -> bool:
    """An abandoned experiment, kept fully commented (tests/test_old_exp_configs.py:30-36)."""
    with open(path) as f:
        return all(not ln.strip() or ln.strip().startswith("#") for ln in f)


OLD_EXP_YAML = [p for p in sorted(glob.glob(os.path.join(CONFIG_DIR, "old_exp", "*", "*.yaml")))
                if not _is_commented(p)]
# active configs/old_exp files that build in the port and run an eval forward (ROADMAP.md records the count)
N_OLD_EXP_CONFIGS_THAT_BUILD = 127


def _build_and_run(path):
    """As tests/test_old_exp_configs.py does for the JAX package: the model, optimizer, criterion and
    callbacks build, and one eval forward at 32 px gives finite logits of the merged label space's width."""
    import torch

    cfg, model = _build_model_and_optimizer(path)
    divisor = max(int(cfg.loader.get("classes_divisor", 1) or 1), 1)
    with torch.no_grad():
        out = model.eval()(torch.zeros(1, 32, 32, 3))
    n_cls = -(-int(cfg.loader.num_classes) // divisor)
    assert out.shape == (1, n_cls) and torch.isfinite(out).all(), (tuple(out.shape), n_cls)


@pytest.fixture(scope="module")
def old_exp_outcomes():
    out = {}
    for path in OLD_EXP_YAML:
        try:
            _build_and_run(path)
            out[path] = None
        except Exception as e:  # reported per file below
            out[path] = e
    return out


@pytest.mark.parametrize("path", OLD_EXP_YAML, ids=[os.path.relpath(p, os.path.join(CONFIG_DIR, "old_exp"))
                                                    for p in OLD_EXP_YAML])
def test_old_exp_config_builds_and_runs(path, old_exp_outcomes):
    assert old_exp_outcomes[path] is None, repr(old_exp_outcomes[path])


def test_count_of_old_exp_configs_that_build(old_exp_outcomes):
    built = [p for p, e in old_exp_outcomes.items() if e is None]
    assert len(OLD_EXP_YAML) == 127
    assert len(built) == N_OLD_EXP_CONFIGS_THAT_BUILD
