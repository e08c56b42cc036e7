"""Carry JAX-package weights into the port's models.

``flax_to_torch`` is the inverse of ``sota_imagenet_tpu/utils/torch_import.py``
``convert_resnet_state_dict`` (torch_import.py:29-65): it maps the JAX
package's ``{params, batch_stats}`` trees (numpy leaves) onto the port's
torchvision-layout ``state_dict`` — conv kernels HWIO → OIHW, Dense kernel
(in, out) → weight (out, in), BN scale/bias/mean/var →
weight/bias/running_mean/running_var. With it, tests run both packages from
the same weights.

``flax_to_torch_model`` does the same for any model of the port (ResNet with
every option, ``fused_stats`` included, NFNet, CModel, BNet, the legacy
architectures of ``models/extras.py``, and any module built
from the layers, norms and blocks they use, a ``ParametrizedModel``'s
spectral state too), running statistics included (VarEMA's ``std_ema``/``mean_ema``, FRN's
``running_var``/``single_running_var``). It walks the torch module and
reads, for each kind of module, the leaves its JAX counterpart creates.
NFNet names its children (``stem_conv{i}``, ``stage{s}_block{b}/conv1``...;
the inverse of ``torch_import.convert_nfnet_state_dict``); where the JAX
module names nothing, flax names each child by its class and the order of
construction (``ScaledStdConv_0``, ``ConvActBlock_2``), and a ``repeat``
builds the module that many times, so the walk counts classes in layer
order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sota_imagenet_tpu_torch.losses import angular
from sota_imagenet_tpu_torch.models import (
    attention, blocks, bnet, cmodel, extras, layers, nfnet, norms, parametrize, resnet,
)


def _get(tree: Mapping, path: str, used: set) -> np.ndarray:
    """The leaf at the '/'-joined ``path``. A key may itself hold '/': the JAX
    spectral state is keyed by the kernels' flax paths, so each step takes
    the shortest run of parts that is a key of the node."""
    node: Any = tree
    path = path.strip("/")  # a module converted on its own has the empty path
    parts, i = path.split("/"), 0
    while i < len(parts):
        j = next((j for j in range(i + 1, len(parts) + 1) if "/".join(parts[i:j]) in node), i + 1)
        node, i = node["/".join(parts[i:j])], j
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
    """JAX ResNet ``params``/``batch_stats`` (numpy) -> port ``state_dict``,
    for a ResNet of the default options and ``layers`` (``fused_stats``, and
    grouped fused blocks, read off the trees): ``flax_to_torch_model`` on
    that layout, built on the meta device. Raises if a leaf of either tree
    is left unmapped, so a layout change on either side cannot pass
    silently."""
    kw = {}
    if bottleneck and "fconv3" in params["layer1_0"]:
        # a fused block without fconv1 has groups > 1; only the module names matter here
        kw = {"fused_stats": True, "groups": 1 if "fconv1" in params["layer1_0"] else 2}
    with torch.device("meta"):
        model = resnet.ResNet(block=resnet.Bottleneck if bottleneck else resnet.BasicBlock, layers=tuple(layers), **kw)
    return flax_to_torch_model(model, params, batch_stats)


def _oihw(kernel: np.ndarray) -> torch.Tensor:
    """flax HWIO conv kernel -> torch OIHW (grouped convs included: I is in/groups in both)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _dense(kernel: np.ndarray) -> torch.Tensor:
    """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
    return torch.from_numpy(np.ascontiguousarray(kernel.T))


def _eca(kernel: np.ndarray) -> torch.Tensor:
    """flax ECA kernel (k, 1, 1) (WIO) -> torch conv1d weight (1, 1, k)."""
    return _tensor(np.transpose(kernel, (2, 1, 0)))


def _scalar(a: np.ndarray) -> torch.Tensor:
    return _tensor(a).reshape(())


def _fan_in_vector(shape) -> Callable[[np.ndarray], torch.Tensor]:
    """A vector over an HWIO kernel's fan-in, ordered (h, w, i) as the JAX
    package flattens it, -> the same vector ordered (i, h, w), as the port
    flattens an OIHW weight (``shape``)."""
    _, i, kh, kw = shape
    return lambda a: torch.from_numpy(np.array(np.reshape(a, (kh, kw, i)).transpose(2, 0, 1).reshape(-1)))


# models whose children each carry the name of their flax counterpart (a Linear child is flax's own Dense)
_NAMED_CHILDREN = (nfnet.NFNet, bnet.BNet, extras.Darknet53, extras.DenseNet121, extras._MBConv,
                   extras.EfficientNetB0, extras.TResNetM)

# one entry of a plan: state_dict key -> (JAX collection, flax path, converter)
Plan = Dict[str, Tuple[str, str, Callable[[np.ndarray], torch.Tensor]]]


def _plan(model: torch.nn.Module) -> Plan:
    """Where each entry of ``model``'s state_dict lives in the trees of its JAX
    counterpart, and how it is converted: the walk that ``flax_to_torch_model``
    and ``kernel_parameters`` share."""
    plan: Plan = {}

    def param(dst: str, src: str, fn=_tensor):
        plan[dst] = ("params", src.strip("/"), fn)

    def stat(dst: str, src: str, fn=_tensor):
        plan[dst] = ("batch_stats", src.strip("/"), fn)

    def dense(src: str, dst: str, bias: bool):
        param(dst + "weight", src + "/kernel", _dense)
        if bias:
            param(dst + "bias", src + "/bias")

    def child(m: torch.nn.Module, src: str, dst: str):
        """A submodule that flax names by its class and order (only one of each class here)."""
        if m is not None:
            walk(m, f"{src}/{type(m).__name__}_0", dst)

    def numbered(m: torch.nn.Module, src: str, dst: str, names: Sequence[str]):
        """Children that flax names by class and order: each of ``names`` that ``m`` has, counted within its class."""
        seen: Dict[str, int] = {}
        for name in names:
            mod = getattr(m, name, None)
            if mod is not None:
                cls = type(mod).__name__
                walk(mod, f"{src}/{cls}_{seen.setdefault(cls, 0)}", f"{dst}{name}.")
                seen[cls] += 1

    def norm_act(m: torch.nn.Module, src: str, dst: str):
        """A norm inside the JAX ResNet's ``_NormAct`` at ``src`` (its activation is the block's)."""
        walk(m, f"{src}/{type(m).__name__}_0", dst)

    def walk(m: torch.nn.Module, src: str, dst: str):
        """``src``: the flax path of ``m``; ``dst``: its state_dict prefix (ends with a dot, or empty)."""
        if isinstance(m, parametrize.ParametrizedModel):
            walk(m.model, src, dst)
            shapes = {n: p.shape for n, p in m.model.named_parameters()}
            key = parametrize.SPECTRAL_STATE_KEY
            for name in m.stateful_names():  # the spectral state, keyed by the kernel's flax path
                kernel = plan[dst + name][1]
                stat(f"{dst}{key}.{name}.u", f"{key}/{kernel}/u")
                stat(f"{dst}{key}.{name}.v", f"{key}/{kernel}/v", _fan_in_vector(shapes[name]))
        elif isinstance(m, resnet.ResNet):
            if m.stem_type == "deep":
                for i in range(len(m.conv1)):
                    walk(m.conv1[i], f"stem_conv{i}", f"{dst}conv1.{i}.")
                    norm_act(m.bn1[i], f"stem_bn{i}", f"{dst}bn1.{i}.")
            else:
                walk(m.conv1, "stem_conv", dst + "conv1.")
                norm_act(m.bn1, "stem_bn", dst + "bn1.")
            for stage in range(m.num_stages):
                for b, block in enumerate(getattr(m, f"layer{stage + 1}")):
                    walk(block, f"layer{stage + 1}_{b}", f"{dst}layer{stage + 1}.{b}.")
            dense("fc", dst + "fc.", True)
        elif isinstance(m, (resnet.BasicBlock, resnet.Bottleneck)):
            # flax numbers the plain convs and the _NormActs apart, in the order the JAX block builds them;
            # with fused_stats, fconv1 takes conv1's place and fconv3 conv3's
            bottleneck, k = isinstance(m, resnet.Bottleneck), 0
            for i in (1, 2) if bottleneck else (1,):
                if hasattr(m, f"conv{i}"):
                    walk(getattr(m, f"conv{i}"), f"{src}/Conv_{k}", f"{dst}conv{i}.")
                    norm_act(getattr(m, f"bn{i}"), f"{src}/_NormAct_{k}", f"{dst}bn{i}.")
                    k += 1
            last = 3 if bottleneck else 2
            if hasattr(m, f"conv{last}"):
                walk(getattr(m, f"conv{last}"), f"{src}/Conv_{k}", f"{dst}conv{last}.")
                child(getattr(m, f"bn{last}"), src, f"{dst}bn{last}.")
            for name in ("fconv1", "fconv3", "fdown"):
                if getattr(m, name, None) is not None:
                    walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            child(m.attn, src, dst + "attn.")
            if m.downsample is not None:
                walk(m.downsample[0], f"{src}/down_conv", dst + "downsample.0.")
                walk(m.downsample[1], f"{src}/down_bn", dst + "downsample.1.")
        elif isinstance(m, _NAMED_CHILDREN):
            for name, sub in m.named_children():
                if isinstance(sub, layers.Linear):  # flax's own Dense, named
                    dense(f"{src}/{name}", f"{dst}{name}.", sub.bias is not None)
                else:
                    walk(sub, f"{src}/{name}", f"{dst}{name}.")
        elif isinstance(m, bnet.BNetBlock):
            # the pre-activation norms are unnamed (flax numbers them by class); conv{i}, norm{i} and gamma are named
            numbered(m, src, dst, [f"pre{i}" for i in range(m.n_convs)])
            for i in range(m.n_convs):
                for name in (f"conv{i}", f"norm{i}"):
                    if hasattr(m, name):
                        walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            if m.gamma is not None:
                param(dst + "gamma", src + "/gamma")
            child(m.attn, src, dst + "attn.")
        elif isinstance(m, bnet._NormActLayer):
            child(m.norm, src, dst + "norm.")
        elif isinstance(m, extras._DarkResidual):
            numbered(m, src, dst, ("cba1", "cba2"))
        elif isinstance(m, resnet.Conv1x1BNStats):
            param(dst + "weight", src + "/kernel", _oihw)
            for leaf in ("scale", "bias"):
                param(dst + leaf, f"{src}/{leaf}")
            for leaf in ("mean", "var"):
                stat(f"{dst}running_{leaf}", f"{src}/{leaf}")
        elif isinstance(m, (blocks.PreBasicBlock, blocks.PreInvertedResidual)):
            numbered(m, src, dst, ("norm1", "norm2", "norm3"))
            numbered(m, src, dst, ("conv1", "conv2", "conv3"))
        elif isinstance(m, norms.EstimatedABN):
            for leaf, name in (("scale", "weight"), ("bias", "bias")):
                param(dst + name, f"{src}/{leaf}")
            for leaf in ("mean", "var"):
                stat(f"{dst}running_{leaf}", f"{src}/{leaf}")
        elif isinstance(m, layers.ScaledStdConv):
            param(dst + "weight", src + "/kernel", _oihw)
            for leaf in ("gain", "bias"):
                if getattr(m, leaf) is not None:
                    param(dst + leaf, f"{src}/{leaf}")
        elif isinstance(m, layers.Conv):
            param(dst + "weight", src + "/Conv_0/kernel", _oihw)
            if m.bias is not None:
                param(dst + "bias", src + "/Conv_0/bias")
        elif isinstance(m, layers.Linear):
            dense(src + "/Dense_0", dst, m.bias is not None)
        elif isinstance(m, norms.BatchNorm):
            for leaf, name in (("scale", "weight"), ("bias", "bias")):
                if getattr(m, name) is not None:
                    param(dst + name, f"{src}/BatchNorm_0/{leaf}")
            for leaf in ("mean", "var"):
                stat(f"{dst}running_{leaf}", f"{src}/BatchNorm_0/{leaf}")
        elif isinstance(m, norms.GroupNorm):  # the JAX module wraps flax's nn.GroupNorm
            param(dst + "weight", src + "/GroupNorm_0/scale")
            param(dst + "bias", src + "/GroupNorm_0/bias")
        elif isinstance(m, (norms.FRNv1, norms.FRNv2)):
            for leaf in ("weight", "bias"):
                if getattr(m, leaf) is not None:
                    param(dst + leaf, f"{src}/{leaf}")
            for leaf in ("running_var", "single_running_var"):
                if hasattr(m, leaf):
                    stat(dst + leaf, f"{src}/{leaf}")
        elif isinstance(m, norms.VarEMA):
            stat(dst + "std_ema", src + "/std_ema")
            stat(dst + "mean_ema", src + "/mean_ema")
        elif isinstance(m, norms.ScaleNorm):
            if m.scale is not None:
                param(dst + "scale", src + "/scale")
        elif isinstance(m, norms.Affine):
            if m.value is not None:
                param(dst + "value", src + "/value", _scalar)
        elif isinstance(m, norms.Gain):
            param(dst + "gain", src + "/gain")
        elif isinstance(m, attention.ECA):
            param(dst + "weight", src + "/kernel", _eca)
        elif isinstance(m, attention.SE):
            dense(src + "/Dense_0", dst + "fc1.", True)
            dense(src + "/Dense_1", dst + "fc2.", True)
        elif isinstance(m, attention.SEVar3):
            child(m.conv, src, dst + "conv.")
        elif isinstance(m, attention.SEVar3Mod):
            child(m.se, src, dst + "se.")
        elif isinstance(m, (attention.XCA, attention.UFO)):
            for leaf in ("temperature", "temperature2"):
                if getattr(m, leaf) is not None:
                    param(dst + leaf, f"{src}/{leaf}")
            if getattr(m, "prenorm", None) is not None:  # UFO's flax LayerNorm: its scale only
                param(dst + "prenorm.weight", src + "/prenorm/scale")
            for name in ("qkv", "proj"):
                if getattr(m, name) is not None:
                    walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
        elif isinstance(m, attention.FCA):
            if m.eca is not None:
                param(dst + "eca.weight", src + "/kernel", _eca)
            else:
                dense(src + "/Dense_0", dst + "fc1.", True)
                dense(src + "/Dense_1", dst + "fc2.", True)
        elif isinstance(m, layers.GEMPool):  # GEMPoolChannel too
            param(dst + "p", src + "/p")
        elif isinstance(m, blocks.NonDeepBlock):
            child(m.norm, src, dst + "norm.")
            for name in ("c1", "c3"):
                if getattr(m, name) is not None:
                    walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            child(m.attn, src, dst + "attn.")
        elif isinstance(m, blocks.ConvActBlock):
            child(m.pre_norm, src, dst + "pre_norm.")
            walk(m.conv, src + "/ScaledStdConv_0", dst + "conv.")
            if m.attn is not None:
                walk(m.attn, src + "/XCA_0", dst + "attn.")
            if m.sse is not None:
                walk(m.sse, src + "/SEVar3_0", dst + "sse.")
        elif isinstance(m, (blocks.ConvBnAct, extras._CBA)):
            walk(m.conv, src + "/Conv_0", dst + "conv.")
            walk(m.bn, src + "/BatchNorm_0", dst + "bn.")
        elif isinstance(m, (blocks.VGGBlock, blocks.ConvMixBlock)):
            child(m.pre_norm, src, dst + "pre_norm.")
            walk(m.conv, src + "/ScaledStdConv_0", dst + "conv.")
        elif isinstance(m, blocks.ConvResidual):
            walk(m.conv, f"{src}/{type(m.conv).__name__}_0", dst + "conv.")
        elif isinstance(m, blocks.ConvMixerBlock):
            numbered(m, src, dst, ("conv1", "bn1", "conv2", "bn2"))
        elif isinstance(m, blocks.Residual):
            if isinstance(m.fn, torch.nn.Module):
                walk(m.fn, src + "/fn", dst + "fn.")
        elif isinstance(m, blocks.Yolo5_C3):  # the JAX block names its children
            for name in ("cv1_2_bn", "cv1_2_conv", "cv3_bn", "cv3_conv"):
                walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            for i, block in enumerate(m.m):
                walk(block, f"{src}/m{i}", f"{dst}m.{i}.")
        elif isinstance(m, blocks.FusedRepVGGBlock):
            for name in ("conv3", "bn3", "conv1", "bn1", "bn_id"):
                if getattr(m, name) is not None:
                    walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
        elif isinstance(m, (angular.SphereLinearLayer, angular.SphereMLPLayer)):
            # the class weights keep flax's (embedding, classes) layout
            param(dst + "weight", src + "/weight")
            if isinstance(m, angular.SphereMLPLayer):  # flax's own Dense and BatchNorm, named
                dense(src + "/fc1", dst + "fc1.", False)
                dense(src + "/fc2", dst + "fc2.", True)
                param(dst + "bn.weight", src + "/bn/scale")
                param(dst + "bn.bias", src + "/bn/bias")
                stat(dst + "bn.running_mean", src + "/bn/mean")
                stat(dst + "bn.running_var", src + "/bn/var")
        elif isinstance(m, blocks.NormFreeBlock):  # its convs are ScaledStdConv_0 and _1
            child(m.pre_norm, src, dst + "pre_norm.")
            walk(m.conv1, src + "/ScaledStdConv_0", dst + "conv1.")
            walk(m.conv2, src + "/ScaledStdConv_1", dst + "conv2.")
            child(m.attn, src, dst + "attn.")
        elif isinstance(m, blocks.NormFreeBlockTimm):
            child(m.pre_norm, src, dst + "pre_norm.")
            for name in ("conv1", "conv2", "conv2b", "conv3"):
                walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            child(m.attn, src, dst + "attn.")
        elif isinstance(m, blocks.EMABlock):
            child(m.ema, src, dst + "ema.")
            walk(m.conv, src + "/ScaledStdConv_0", dst + "conv.")
        elif isinstance(m, nfnet.NFBlock):
            for name in ("conv1", "conv2", "conv2b", "conv3", "downsample"):
                if getattr(m, name) is not None:
                    walk(getattr(m, name), f"{src}/{name}", f"{dst}{name}.")
            child(m.attn, src, dst + "attn.")
            if m.skipinit_gain is not None:
                param(dst + "skipinit_gain", src + "/skipinit_gain", _scalar)
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
    return plan


def flax_to_torch_model(model: torch.nn.Module, params: Mapping, batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` (numpy) of the JAX counterpart of
    ``model`` -> ``model``'s ``state_dict``. Raises if a leaf of either tree
    is left unmapped or a key of the state_dict is not produced."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    used = {"params": set(), "batch_stats": set()}
    sd = {dst: fn(_get(trees[coll], src, used[coll])) for dst, (coll, src, fn) in _plan(model).items()}
    left = set().union(*(_leaf_paths(trees[c]) - used[c] for c in trees))
    if left:
        raise KeyError(f"flax_to_torch_model left leaves unmapped: {sorted(left)[:10]}")
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"flax_to_torch_model produced no value for: {sorted(missing)[:10]}")
    return sd


# the axis of the port's tensor that the last axis of its flax counterpart becomes, by converter
_LAST_AXIS = {_oihw: 0, _dense: 0, _eca: 0, _tensor: -1, _scalar: -1}


def unit_dims(model: torch.nn.Module) -> Dict[str, int]:
    """For each parameter of ``model``, by name: the dim of its tensor that
    holds the last axis of its JAX counterpart (a conv's or a Dense
    kernel's output axis is dim 0 here, ECA's (k, 1, 1) kernel's size-1 axis
    too; a leaf carried as is keeps its last dim). The JAX
    ``_unitwise_norm`` (optim/zoo.py:41-49) takes one norm per index of that
    axis, so these are the units of AGC; a 0-d or 1-d parameter is one
    unit."""
    plan = _plan(model)
    return {n: _LAST_AXIS[plan[n][2]] for n, _ in model.named_parameters()}


# the rank of the flax leaf, by converter (a leaf carried as is keeps the port's rank; ``_scalar``'s are 0-d in both)
_FLAX_RANK = {_oihw: 4, _dense: 2, _eca: 3}
# the port's tensor -> its flax counterpart's layout, by converter (the inverse of each)
_TO_FLAX = {
    _oihw: lambda t: t.permute(2, 3, 1, 0),
    _dense: lambda t: t.T,
    _eca: lambda t: t.permute(2, 1, 0),
    _tensor: lambda t: t,
    _scalar: lambda t: t,
}


def flax_ranks(model: torch.nn.Module) -> Dict[str, int]:
    """For each parameter of ``model``, by name: the rank of its JAX leaf.
    The JAX optimizers and SAM treat a leaf with more than one axis as a
    matrix of units (AdamP's and SGDP's projection, ``sam_original``'s
    weighting: ``p.ndim > 1`` on the flax leaf); the plan's converters keep
    the rank, and this reads it off the plan, not off the port's tensor."""
    plan = _plan(model)
    return {n: _FLAX_RANK.get(plan[n][2], p.dim()) for n, p in model.named_parameters()}


def flax_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model``'s parameters as the JAX package's params tree holds them:
    flax path -> the parameter viewed in the flax layout (HWIO conv
    kernels, (in, out) Dense kernels; views, not copies), in the JAX
    tree's leaf order (keys sorted at every level). The TensorBoard sinks
    read the weights through it, so their tags, subsamples and histograms
    are the JAX package's."""
    plan = _plan(model)
    leaves = {plan[n][1]: _TO_FLAX[plan[n][2]](p) for n, p in model.named_parameters()}
    return {k: leaves[k] for k in sorted(leaves, key=lambda k: k.split("/"))}


def kernel_parameters(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """The parameters of ``model`` that are ``kernel`` leaves in its JAX
    counterpart (conv, Dense and ECA kernels), by name, in the model's order:
    the set the JAX auxiliary losses, orthogonal init and weight norm select
    by flax path. The port names every parameter ``weight``, so the names
    cannot tell a kernel from a norm's scale; the walk can."""
    plan = _plan(model)
    return {n: p for n, p in model.named_parameters() if n in plan and plan[n][1].rsplit("/", 1)[-1] == "kernel"}


def conv_kernels(model: torch.nn.Module, ungrouped: bool = False) -> Dict[str, torch.nn.Parameter]:
    """The parameters of ``model`` that the JAX forward parametrizations
    transform (parametrize.py:23-36 of the JAX package), by name, in the
    model's order: 4-d leaves whose flax path holds ``kernel`` (the convs'
    kernels, ScaledStdConv's and Conv1x1BNStats' included; not ECA's, the
    Dense heads' or a norm's). ``ungrouped`` leaves out the depthwise ones,
    whose HWIO kernel has in/groups == 1 (OIHW ``weight.shape[1]`` here)."""
    plan = _plan(model)
    return {
        n: p for n, p in model.named_parameters()
        if n in plan and p.dim() == 4 and "kernel" in plan[n][1].lower() and (not ungrouped or p.shape[1] > 1)
    }


def apply_sigmoid_trick(model: torch.nn.Module, num_classes: Optional[int] = None) -> List[str]:
    """Set the classifier bias of ``model`` to -log(C - 1), so each class's
    initial sigmoid probability is about 1/C (the RetinaNet prior,
    arXiv:1708.02002 section 4.1; the legacy ``sigmoid_trick: true``), as the
    JAX ``apply_sigmoid_trick`` (utils/misc.py:163) finds it: every 1-d
    parameter whose flax path ends in ``fc/bias``, else the last 1-d
    ``bias`` of width ``num_classes`` in the model's order (a CModel's
    ``nn.Linear`` head). In place; returns the names it set."""
    plan = _plan(model)
    whole = getattr(model, "_tp", {})  # a head-TP shard: the width is the whole head's (parallel/tp.py)
    width = lambda n, p: whole.get(n, (0, p.shape[0]))[1]  # noqa: E731
    named = [(n, p) for n, p in model.named_parameters() if p.dim() == 1]
    hits = [n for n, _ in named if plan[n][1].split("/")[-2:] == ["fc", "bias"]]
    if not hits and num_classes is not None:
        hits = [n for n, p in named if plan[n][1].split("/")[-1] == "bias" and width(n, p) == num_classes][-1:]
    if not hits:
        raise ValueError("sigmoid_trick: no fc/bias leaf found in params (classifier must be "
                         "named 'fc' with a bias, or pass num_classes for the fallback)")
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n in hits:
            params[n].fill_(-float(np.log(max(width(n, params[n]) - 1, 1))))
    return hits
