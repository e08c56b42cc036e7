"""Carry JAX-package weights into the port's models.

``flax_to_torch`` is the inverse of ``sota_imagenet_tpu/utils/torch_import.py``
``convert_resnet_state_dict`` (torch_import.py:29-65): it maps the JAX
package's ``{params, batch_stats}`` trees (numpy leaves) onto the port's
torchvision-layout ``state_dict`` — conv kernels HWIO → OIHW, Dense kernel
(in, out) → weight (out, in), BN scale/bias/mean/var →
weight/bias/running_mean/running_var. With it, tests run both packages from
the same weights.

A bottleneck built with ``fused_stats`` is recognised by its ``fconv3``:
its ``fconv1``/``fconv3``/``fdown`` (``Conv1x1BNStats``: kernel, scale, bias;
batch_stats mean, var) map to the port's modules of the same names, and its
remaining 3x3 conv (and the 1x1 conv1 when ``groups > 1``) sit at flax's
auto names ``Conv_i``/``_NormAct_i``, numbered from 0.

``flax_to_torch_model`` does the same for the port's NFNet and CModel (and
any module built from the layers they use). It walks the torch module and
reads, for each kind of module, the leaves its JAX counterpart creates.
NFNet names its children (``stem_conv{i}``, ``stage{s}_block{b}/conv1``...;
the inverse of ``torch_import.convert_nfnet_state_dict``); where the JAX
module names nothing, flax names each child by its class and the order of
construction (``ScaledStdConv_0``, ``ConvActBlock_2``), and a ``repeat``
builds the module that many times, so the walk counts classes in layer
order.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from sota_imagenet_tpu_torch.models import attention, blocks, cmodel, layers, nfnet, norms


def _get(tree: Mapping, path: str, used: set) -> np.ndarray:
    node: Any = tree
    path = path.strip("/")  # a module converted on its own has the empty path
    for p in path.split("/"):
        node = node[p]
    used.add(path)
    return np.asarray(node)


def _leaf_paths(tree: Mapping, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out |= _leaf_paths(v, p)
        else:
            out.add(p)
    return out


def flax_to_torch(
    params: Mapping, batch_stats: Mapping, layers: Sequence[int] = (3, 4, 6, 3), bottleneck: bool = True
) -> Dict[str, torch.Tensor]:
    """JAX ResNet ``params``/``batch_stats`` (numpy) -> port ``state_dict``.

    Raises if a leaf of either tree is left unmapped, so a layout change on
    either side cannot pass silently."""
    used_p: set = set()
    used_s: set = set()
    sd: Dict[str, torch.Tensor] = {}

    def conv(src: str, dst: str):
        sd[dst + ".weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(_get(params, src + "/kernel", used_p), (3, 2, 0, 1))))

    def bn(src: str, dst: str):
        sd[dst + ".weight"] = torch.from_numpy(_get(params, src + "/scale", used_p).copy())
        sd[dst + ".bias"] = torch.from_numpy(_get(params, src + "/bias", used_p).copy())
        sd[dst + ".running_mean"] = torch.from_numpy(_get(batch_stats, src + "/mean", used_s).copy())
        sd[dst + ".running_var"] = torch.from_numpy(_get(batch_stats, src + "/var", used_s).copy())

    def fused(src: str, dst: str):  # Conv1x1BNStats: kernel, scale, bias / mean, var one level down
        conv(src, dst)
        for leaf in ("scale", "bias"):
            sd[f"{dst}.{leaf}"] = torch.from_numpy(_get(params, f"{src}/{leaf}", used_p).copy())
        sd[dst + ".running_mean"] = torch.from_numpy(_get(batch_stats, src + "/mean", used_s).copy())
        sd[dst + ".running_var"] = torch.from_numpy(_get(batch_stats, src + "/var", used_s).copy())

    conv("stem_conv/Conv_0", "conv1")
    bn("stem_bn/BatchNorm_0/BatchNorm_0", "bn1")
    n_convs = 3 if bottleneck else 2
    for li, depth in enumerate(layers, start=1):
        for b in range(depth):
            f = f"layer{li}_{b}"
            t = f"layer{li}.{b}"
            if "fconv3" in params[f]:
                # fused_stats layout: fconv1 (groups == 1 only), fconv3 and fdown are
                # Conv1x1BNStats; the plain convs left keep flax's auto names in order
                plain = [2] if "fconv1" in params[f] else [1, 2]
                for i, ci in enumerate(plain):
                    conv(f"{f}/Conv_{i}/Conv_0", f"{t}.conv{ci}")
                    bn(f"{f}/_NormAct_{i}/BatchNorm_0/BatchNorm_0", f"{t}.bn{ci}")
                for name in ("fconv1", "fconv3", "fdown"):
                    if name in params[f]:
                        fused(f"{f}/{name}", f"{t}.{name}")
                continue
            for ci in range(1, n_convs + 1):
                conv(f"{f}/Conv_{ci - 1}/Conv_0", f"{t}.conv{ci}")
                if ci < n_convs:
                    bn(f"{f}/_NormAct_{ci - 1}/BatchNorm_0/BatchNorm_0", f"{t}.bn{ci}")
                else:
                    bn(f"{f}/BatchNorm_0/BatchNorm_0", f"{t}.bn{ci}")
            if "down_conv" in params[f]:
                conv(f"{f}/down_conv/Conv_0", f"{t}.downsample.0")
                bn(f"{f}/down_bn/BatchNorm_0", f"{t}.downsample.1")
    sd["fc.weight"] = torch.from_numpy(np.ascontiguousarray(_get(params, "fc/kernel", used_p).T))
    sd["fc.bias"] = torch.from_numpy(_get(params, "fc/bias", used_p).copy())
    left = (_leaf_paths(params) - used_p) | (_leaf_paths(batch_stats) - used_s)
    if left:
        raise KeyError(f"flax_to_torch left leaves unmapped: {sorted(left)[:10]}")
    return sd


def _oihw(kernel: np.ndarray) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW (grouped convs included: I is in/groups in both)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def flax_to_torch_model(model: torch.nn.Module, params: Mapping, batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` (numpy) of the JAX counterpart of
    ``model`` -> ``model``'s ``state_dict``. Raises if a leaf of either tree
    is left unmapped or a key of the state_dict is not produced."""
    batch_stats = batch_stats or {}
    used_p: set = set()
    used_s: set = set()
    sd: Dict[str, torch.Tensor] = {}

    def dense(src: str, dst: str, bias: bool):
        sd[dst + "weight"] = torch.from_numpy(np.ascontiguousarray(_get(params, src + "/kernel", used_p).T))
        if bias:
            sd[dst + "bias"] = _tensor(_get(params, src + "/bias", used_p))

    def walk(m: torch.nn.Module, src: str, dst: str):
        """``src``: the flax path of ``m``; ``dst``: its state_dict prefix (ends with a dot, or empty)."""
        if isinstance(m, layers.ScaledStdConv):
            sd[dst + "weight"] = _oihw(_get(params, src + "/kernel", used_p))
            for leaf in ("gain", "bias"):
                if getattr(m, leaf) is not None:
                    sd[dst + leaf] = _tensor(_get(params, f"{src}/{leaf}", used_p))
        elif isinstance(m, layers.Conv):
            sd[dst + "weight"] = _oihw(_get(params, src + "/Conv_0/kernel", used_p))
            if m.bias is not None:
                sd[dst + "bias"] = _tensor(_get(params, src + "/Conv_0/bias", used_p))
        elif isinstance(m, layers.Linear):
            dense(src + "/Dense_0", dst, m.bias is not None)
        elif isinstance(m, norms.BatchNorm):
            for leaf, name in (("scale", "weight"), ("bias", "bias")):
                sd[dst + name] = _tensor(_get(params, f"{src}/BatchNorm_0/{leaf}", used_p))
            for leaf in ("mean", "var"):
                sd[f"{dst}running_{leaf}"] = _tensor(_get(batch_stats, f"{src}/BatchNorm_0/{leaf}", used_s))
        elif isinstance(m, attention.ECA):
            sd[dst + "weight"] = _tensor(np.transpose(_get(params, src + "/kernel", used_p), (2, 1, 0)))
        elif isinstance(m, attention.SE):
            dense(src + "/Dense_0", dst + "fc1.", True)
            dense(src + "/Dense_1", dst + "fc2.", True)
        elif isinstance(m, attention.SEVar3):
            walk(m.conv, f"{src}/{type(m.conv).__name__}_0", dst + "conv.")
        elif isinstance(m, blocks.ConvActBlock):
            walk(m.conv, src + "/ScaledStdConv_0", dst + "conv.")
            if m.sse is not None:
                walk(m.sse, src + "/SEVar3_0", dst + "sse.")
        elif isinstance(m, blocks.ConvBnAct):
            walk(m.conv, src + "/Conv_0", dst + "conv.")
            walk(m.bn, src + "/BatchNorm_0", dst + "bn.")
        elif isinstance(m, nfnet.NFBlock):
            for name in ("conv1", "conv2", "conv2b", "conv3", "downsample"):
                if getattr(m, name) is not None:
                    walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            if m.attn is not None:
                walk(m.attn, f"{src}/{type(m.attn).__name__}_0", dst + "attn.")
            if m.skipinit_gain is not None:
                sd[dst + "skipinit_gain"] = _tensor(_get(params, src + "/skipinit_gain", used_p)).reshape(())
        elif isinstance(m, nfnet.NFNet):
            for name, child in m.named_children():
                if name == "fc":
                    dense("fc", "fc.", True)
                else:
                    walk(child, name, name + ".")
        elif isinstance(m, cmodel.CModel):
            seen: Dict[str, int] = {}
            for idx, mods in enumerate(m.layers):
                for r, mod in enumerate(mods):
                    cls = type(mod).__name__
                    seen[cls] = seen.get(cls, 0) + 1
                    walk(mod, f"{cls}_{seen[cls] - 1}", f"layers.{idx}.{r}.")
        elif m.state_dict():
            # a module with state that this walk does not know would be skipped silently
            raise KeyError(f"flax_to_torch_model does not know {type(m).__name__} at {src!r}")

    walk(model, "", "")
    left = (_leaf_paths(params) - used_p) | (_leaf_paths(batch_stats) - used_s)
    if left:
        raise KeyError(f"flax_to_torch_model left leaves unmapped: {sorted(left)[:10]}")
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"flax_to_torch_model produced no value for: {sorted(missing)[:10]}")
    return sd
