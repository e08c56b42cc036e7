"""Carry JAX-package ResNet weights into the port's ResNet.

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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch


def _get(tree: Mapping, path: str, used: set) -> np.ndarray:
    node: Any = tree
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
