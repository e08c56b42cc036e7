"""Load a checkpoint trained by the reference into the port's models (port
of ``sota_imagenet_tpu/utils/torch_import.py``).

The reference saves ``model.chpn``, a torch ``state_dict`` in
torchvision/pytorch-tools naming (``conv1``/``bn1``/``layer{L}.{B}.conv{i}``
/``downsample``/``fc``; timm's for ECA-NFNet), keys prefixed ``module.``
when it trained under DDP. The three converters below read such a dict (as
numpy arrays) into the JAX package's ``{params, batch_stats}`` trees, with
the conventions of the JAX module: conv weights OIHW -> HWIO, Linear
(out, in) -> (in, out), BatchNorm weight/bias -> scale/bias and its running
statistics -> mean/var, ECA's conv1d (1, 1, k) -> (k, 1, 1). The port's
weights plan (``utils/weights.flax_to_torch_model``) then takes those trees
to the model's own names, as it takes the JAX package's, so no map is kept
twice; it raises where a weight of the checkpoint or of the model is left
over.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from sota_imagenet_tpu_torch.models import nfnet, resnet
from sota_imagenet_tpu_torch.models.attention import ECA
from sota_imagenet_tpu_torch.models.layers import BlurPool
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model


def _set(tree: Dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _strip_ddp(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """numpy values, the DDP ``module.`` prefix taken off (only that prefix)."""
    return {(k[7:] if k.startswith("module.") else k): np.asarray(v) for k, v in state_dict.items()}


def convert_resnet_state_dict(
    state_dict: Mapping[str, Any], layers=(3, 4, 6, 3), bottleneck: bool = True
) -> Tuple[Dict, Dict]:
    """torchvision-style ResNet state_dict (numpy values) -> (params, batch_stats) (torch_import.py:29-65)."""
    sd = _strip_ddp(state_dict)
    params: Dict = {}
    stats: Dict = {}

    def conv(src: str, dst: str):
        _set(params, dst + "/kernel", np.transpose(sd[src + ".weight"], (2, 3, 1, 0)))

    def bn(src: str, dst: str):
        _set(params, dst + "/scale", sd[src + ".weight"])
        _set(params, dst + "/bias", sd[src + ".bias"])
        _set(stats, dst + "/mean", sd[src + ".running_mean"])
        _set(stats, dst + "/var", sd[src + ".running_var"])

    conv("conv1", "stem_conv/Conv_0")
    bn("bn1", "stem_bn/BatchNorm_0/BatchNorm_0")
    n_convs = 3 if bottleneck else 2
    for li, depth in enumerate(layers, start=1):
        for b in range(depth):
            t, f = f"layer{li}.{b}", f"layer{li}_{b}"
            for ci in range(1, n_convs + 1):
                conv(f"{t}.conv{ci}", f"{f}/Conv_{ci - 1}/Conv_0")
                if ci < n_convs:
                    bn(f"{t}.bn{ci}", f"{f}/_NormAct_{ci - 1}/BatchNorm_0/BatchNorm_0")
                else:
                    bn(f"{t}.bn{ci}", f"{f}/BatchNorm_0/BatchNorm_0")
            if f"{t}.downsample.0.weight" in sd:
                conv(f"{t}.downsample.0", f"{f}/down_conv/Conv_0")
                bn(f"{t}.downsample.1", f"{f}/down_bn/BatchNorm_0")
    _set(params, "fc/kernel", sd["fc.weight"].T)
    _set(params, "fc/bias", sd["fc.bias"])
    return params, stats


def convert_nfnet_state_dict(state_dict: Mapping[str, Any], depths=(1, 2, 6, 3)) -> Tuple[Dict, Dict]:
    """timm NFNet-layout state_dict (numpy values) -> (params, {}) (torch_import.py:68-107):
    stem.conv1..4, stages.S.B.{conv1,conv2,conv2b,conv3,downsample.conv,attn or
    attn_last.conv,skipinit_gain}, final_conv, head.fc; every conv a
    ScaledStdConv2d (weight, bias, gain (O,1,1,1)). No BatchNorm buffers."""
    sd = _strip_ddp(state_dict)
    params: Dict = {}

    def ws_conv(src: str, dst: str):
        _set(params, dst + "/kernel", np.transpose(sd[src + ".weight"], (2, 3, 1, 0)))
        _set(params, dst + "/gain", sd[src + ".gain"].reshape(-1))
        if src + ".bias" in sd:
            _set(params, dst + "/bias", sd[src + ".bias"])

    for i in range(4):
        ws_conv(f"stem.conv{i + 1}", f"stem_conv{i}")
    for s, depth in enumerate(depths):
        for b in range(depth):
            t, f = f"stages.{s}.{b}", f"stage{s}_block{b}"
            for cname in ("conv1", "conv2", "conv2b", "conv3"):
                ws_conv(f"{t}.{cname}", f"{f}/{cname}")
            if f"{t}.downsample.conv.weight" in sd:
                ws_conv(f"{t}.downsample.conv", f"{f}/downsample")
            for attn_key in ("attn_last", "attn"):  # timm names it attn_last for NFNets
                k = f"{t}.{attn_key}.conv.weight"
                if k in sd:
                    _set(params, f"{f}/ECA_0/kernel", np.transpose(sd[k], (2, 1, 0)))
                    break
            if f"{t}.skipinit_gain" in sd:
                _set(params, f"{f}/skipinit_gain", np.asarray(sd[f"{t}.skipinit_gain"]).reshape(()))
    ws_conv("final_conv", "final_conv")
    _set(params, "fc/kernel", sd["head.fc.weight"].T)
    _set(params, "fc/bias", sd["head.fc.bias"])
    return params, {}


def convert_bresnet_state_dict(state_dict: Mapping[str, Any], layers=(3, 4, 6, 3)) -> Tuple[Dict, Dict]:
    """pytorch-tools BResNet-layout state_dict (numpy) -> (params, batch_stats)
    (torch_import.py:110-155): the torchvision names, ECA as
    ``se_module.conv`` (a (1, 1, k) conv1d), and the antialiased downsample
    [BlurPool (a fixed buffer, skipped), conv, bn] or the plain [conv, bn]."""
    sd = _strip_ddp(state_dict)
    params: Dict = {}
    stats: Dict = {}

    def conv(src: str, dst: str):
        _set(params, dst + "/kernel", np.transpose(sd[src + ".weight"], (2, 3, 1, 0)))

    def bn(src: str, dst: str):
        _set(params, dst + "/scale", sd[src + ".weight"])
        _set(params, dst + "/bias", sd[src + ".bias"])
        _set(stats, dst + "/mean", sd[src + ".running_mean"])
        _set(stats, dst + "/var", sd[src + ".running_var"])

    conv("conv1", "stem_conv/Conv_0")
    bn("bn1", "stem_bn/BatchNorm_0/BatchNorm_0")
    for li, depth in enumerate(layers, start=1):
        for b in range(depth):
            t, f = f"layer{li}.{b}", f"layer{li}_{b}"
            for ci in (1, 2, 3):
                conv(f"{t}.conv{ci}", f"{f}/Conv_{ci - 1}/Conv_0")
                if ci < 3:
                    bn(f"{t}.bn{ci}", f"{f}/_NormAct_{ci - 1}/BatchNorm_0/BatchNorm_0")
                else:
                    bn(f"{t}.bn{ci}", f"{f}/BatchNorm_0/BatchNorm_0")
            if f"{t}.se_module.conv.weight" in sd:
                _set(params, f"{f}/ECA_0/kernel", np.transpose(sd[f"{t}.se_module.conv.weight"], (2, 1, 0)))
            for di in (0, 1):  # [blurpool, conv, bn] (antialias) or [conv, bn]
                if f"{t}.downsample.{di}.weight" in sd and sd[f"{t}.downsample.{di}.weight"].ndim == 4:
                    conv(f"{t}.downsample.{di}", f"{f}/down_conv/Conv_0")
                    bn(f"{t}.downsample.{di + 1}", f"{f}/down_bn/BatchNorm_0")
                    break
    _set(params, "fc/kernel", sd["fc.weight"].T)
    _set(params, "fc/bias", sd["fc.bias"])
    return params, stats


def _family(model: torch.nn.Module) -> str:
    """``nfnet``; ``bresnet`` for a ResNet with the space2depth stem, ECA or
    BlurPool (the BResNet layout's names); else ``resnet``."""
    if isinstance(model, nfnet.NFNet):
        return "nfnet"
    if not isinstance(model, resnet.ResNet):
        raise TypeError(f"a reference checkpoint loads into a ResNet, BResNet or NFNet, not {type(model).__name__}")
    extras = any(isinstance(m, (ECA, BlurPool)) for m in model.modules())
    return "bresnet" if extras or model.stem_type == "space2depth" else "resnet"


def _stages(model: torch.nn.Module, prefix: str) -> Tuple[int, ...]:
    """Blocks per stage, read off the module names (``layer{L}`` children, or NFNet's ``stage{s}_block{b}``)."""
    if prefix == "layer":
        return tuple(len(getattr(model, f"layer{i}")) for i in range(1, 5))
    counts: Dict[int, int] = {}
    for name, _ in model.named_children():
        if name.startswith("stage") and "_block" in name:
            s = int(name[5 : name.index("_block")])
            counts[s] = counts.get(s, 0) + 1
    return tuple(counts[s] for s in sorted(counts))


def import_state_dict(model: torch.nn.Module, state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` (tensors or numpy) -> ``model``'s state_dict,
    for the port's ResNet, BResNet or ECA-NFNet (``_family``), their depths
    read off the model."""
    family = _family(model)
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in state_dict.items()}
    if family == "nfnet":
        params, stats = convert_nfnet_state_dict(sd, depths=_stages(model, "stage"))
    elif family == "bresnet":
        params, stats = convert_bresnet_state_dict(sd, layers=_stages(model, "layer"))
    else:
        bottleneck = isinstance(model.layer1[0], resnet.Bottleneck)
        params, stats = convert_resnet_state_dict(sd, layers=_stages(model, "layer"), bottleneck=bottleneck)
    return flax_to_torch_model(model, params, stats)


def load_torch_checkpoint(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Read a reference ``model.chpn`` / torch ``.pth`` file (the dict may sit
    under ``state_dict``, reference train.py:101) and load it into ``model``;
    returns the state_dict loaded."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k: v for k, v in sd.items() if hasattr(v, "detach")}
    out = import_state_dict(model, sd)
    model.load_state_dict(out)
    return out
