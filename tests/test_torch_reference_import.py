"""Reference checkpoints into the port (``utils/torch_import.py``) against the
JAX package's import (``sota_imagenet_tpu/utils/torch_import.py``).

For resnet50, bresnet50 and eca_nfnet_l0, a random ``state_dict`` in the
reference's layout (torchvision names; pytorch-tools' BResNet names with ECA
as ``se_module.conv`` and the antialiased downsample [BlurPool, conv, bn];
timm's NFNet names with (O, 1, 1, 1) gains and ``attn_last``), keys
prefixed ``module.`` as DDP saves them, made from a seed:

* the JAX ``convert_*`` followed by the port's ``flax_to_torch_model`` equals
  the port's ``import_state_dict``, tensor for tensor, at full size, and
  ``load_torch_checkpoint`` reads the same from a saved ``model.chpn``;
* on the same weights, the loaded port model's eval logits equal the JAX
  model's (the layouts cut to one block a stage, so the JAX forward stays
  small; float32, within 1e-4 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sota_imagenet_tpu.models.nfnet import NFNet as JNFNet
from sota_imagenet_tpu.models.resnet import Bottleneck as JBottleneck
from sota_imagenet_tpu.models.resnet import ResNet as JResNet
from sota_imagenet_tpu.utils import torch_import as JTI
from sota_imagenet_tpu_torch.models.nfnet import NFNet, eca_nfnet_l0
from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet, bresnet50
from sota_imagenet_tpu_torch.utils import torch_import as TI
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

FULL = {"resnet50": (3, 4, 6, 3), "bresnet50": (3, 4, 6, 3), "eca_nfnet_l0": (1, 2, 6, 3)}
CUT = (1, 1, 1, 1)


BRESNET = dict(stem_type="space2depth", antialias=True, attn_type="eca", norm_act="leaky_relu", drop_rate=0.2,
               drop_connect_rate=0.2)  # bresnet50's options (resnet.py:346-359 of both packages)


def _port(family, stages):
    if family == "resnet50":
        return ResNet(block=Bottleneck, layers=stages, num_classes=10)
    if family == "bresnet50":
        return bresnet50(layers=stages, num_classes=10)
    return NFNet(depths=stages, num_classes=10) if stages != FULL[family] else eca_nfnet_l0(num_classes=10)


def _jax(family, stages):
    if family == "resnet50":
        return JResNet(block=JBottleneck, layers=stages, num_classes=10)
    if family == "bresnet50":
        return JResNet(block=JBottleneck, layers=stages, num_classes=10, **BRESNET)
    return JNFNet(depths=stages, num_classes=10)


def _reference_name(family: str, key: str, shape) -> list:
    """The port's state_dict key -> the reference checkpoint's (name, shape) entries."""
    if family == "eca_nfnet_l0":
        if key.startswith("stem_conv"):
            key = f"stem.conv{int(key[9]) + 1}" + key[10:]
        elif key.startswith("stage"):
            s, rest = key[5:].split("_block", 1)
            b, rest = rest.split(".", 1)
            rest = {"downsample.weight": "downsample.conv.weight", "downsample.gain": "downsample.conv.gain",
                    "downsample.bias": "downsample.conv.bias", "attn.weight": "attn_last.conv.weight"}.get(rest, rest)
            key = f"stages.{s}.{b}.{rest}"
        elif key.startswith("fc."):
            key = "head." + key
        if key.endswith(".gain") and len(shape) == 1:
            shape = (shape[0], 1, 1, 1)
        return [(key, shape)]
    if family == "bresnet50":
        if key.endswith(".attn.weight"):
            return [(key.replace(".attn.weight", ".se_module.conv.weight"), shape)]
        if ".downsample." in key and not key.startswith("layer1."):  # strided: [BlurPool, conv, bn]
            head, tail = key.split(".downsample.")
            i, rest = tail.split(".", 1)
            out = [(f"{head}.downsample.{int(i) + 1}.{rest}", shape)]
            if tail == "0.weight":
                out.append((f"{head}.downsample.0.filt", (shape[1], 1, 3, 3)))  # a fixed buffer, not read
            return out
    return [(key, shape)]


def _reference_state_dict(family, stages, seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in _port(family, stages).state_dict().items():
        for name, shape in _reference_name(family, key, tuple(t.shape)):
            v = np.asarray(rng.standard_normal(shape) * 0.05, np.float32)
            if name.endswith("running_var"):
                v = np.abs(v) + 0.5
            sd["module." + name] = torch.from_numpy(v)
    return sd


def _convert_jax(family, sd, stages):
    npsd = {k: v.numpy() for k, v in sd.items()}
    if family == "resnet50":
        return JTI.convert_resnet_state_dict(npsd, layers=stages)
    if family == "bresnet50":
        return JTI.convert_bresnet_state_dict(npsd, layers=stages)
    return JTI.convert_nfnet_state_dict(npsd, depths=stages)


@pytest.mark.parametrize("family", list(FULL))
def test_import_equals_the_jax_conversion_then_flax_to_torch(family, tmp_path):
    stages = FULL[family]
    sd = _reference_state_dict(family, stages)
    model = _port(family, stages)
    want = flax_to_torch_model(model, *_convert_jax(family, sd, stages))
    got = TI.import_state_dict(model, sd)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    path = tmp_path / "model.chpn"
    torch.save({"state_dict": sd}, path)
    loaded = TI.load_torch_checkpoint(str(path), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]) and torch.equal(loaded[k], want[k]), k


@pytest.mark.parametrize("family", list(FULL))
def test_loaded_model_logits_equal_the_jax_models(family):
    sd = _reference_state_dict(family, CUT, seed=1)
    model = _port(family, CUT)
    model.load_state_dict(TI.import_state_dict(model, sd))
    model.eval()
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params, stats = _convert_jax(family, sd, CUT)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want = np.asarray(_jax(family, CUT).apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
