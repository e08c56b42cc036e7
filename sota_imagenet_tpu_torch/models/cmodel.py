"""CModel: build a model graph from a YAML layer list (port of
``sota_imagenet_tpu/models/cmodel.py``:39-302; reference model.py:1098-1226).

Module names resolve through an explicit table, never ``eval()``. Both layer
syntaxes are accepted: the dict form ``{module, args, kwargs, repeat,
inputs, tag}`` and the yolo-style list form ``[inputs, repeat, module,
args?, kwargs?]`` used by the experiment configs. Names like
``pt.modules.BlurPool``, ``torch.nn.SiLU``, ``nn.Linear`` resolve by their
last dotted component; quoted value strings (``"'swish_hard'"``) are
unquoted; known torch class paths in kwarg values map to the port's names.

Non-linear topologies come from ``tag`` + ``inputs``: a layer may consume
any earlier output by tag or by index; multi-input layers (``Concat``)
receive them positionally.

The modules are built once, in ``__init__``: ``layers`` is an
``nn.ModuleList`` in layer order, each entry the ``nn.ModuleList`` of that
layer's ``repeat`` modules. Every name of the JAX table is ported.
"""

from __future__ import annotations

import collections.abc
import copy
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from sota_imagenet_tpu_torch.models import attention as A
from sota_imagenet_tpu_torch.models import blocks as B
from sota_imagenet_tpu_torch.models import layers as L
from sota_imagenet_tpu_torch.models import norms as N


@dataclass
class ModuleStructure:
    """One layer entry (reference model.py:1098-1107)."""

    module: str
    args: List[Any] = field(default_factory=list)
    kwargs: Dict[str, Any] = field(default_factory=dict)
    repeat: int = 1
    inputs: List[Any] = field(default_factory=lambda: ["_prev_"])
    tag: Optional[str] = None


def _update_dict(to_dict: Dict, from_dict: Dict) -> Dict:
    """dict.update that recurses into nested dicts (reference model.py:1115-1123)."""
    for k, v in from_dict.items():
        if hasattr(v, "keys") and k in to_dict and hasattr(to_dict[k], "keys"):
            _update_dict(to_dict[k], v)
        else:
            to_dict[k] = v
    return to_dict


# --------------------------------------------------------------------------- #
# Module name table (reference-config compatible)
# --------------------------------------------------------------------------- #


def _act(name):
    return lambda *a, **kw: L.Activation(act=name)


def _dropout(p=0.5, **kw):
    kw.pop("inplace", None)
    return L.Dropout(rate=p)


def _norm_ctor(cls):
    """A norm from its config args: the channel count first, where one is given
    (the JAX table reads it from the input, cmodel.py:87-94)."""
    return lambda *args, **kw: cls(*args[:1], **kw)


def _conv_residual(*a, **kw):
    """ConvResidual takes an optional leading conv-constructor name in the
    reference (``[ConvResidual, [conv3x3, 48, 64]]``, model.py:1038-1053;
    config 68): a name that does not start with "scaled" gives a plain Conv
    with bias, "1x1" in it a 1x1 kernel (cmodel.py:74-84 of the JAX package)."""
    if a and isinstance(a[0], str):
        name, i, o = a[0], a[1], a[2]
        kw.setdefault("scaled", name.startswith("scaled"))
        kw.setdefault("kernel_size", 1 if "1x1" in name else 3)
        return B.ConvResidual(i, o, **kw)
    return B.ConvResidual(a[0], a[1], **kw)


def _sphere(name: str) -> Callable[..., nn.Module]:
    """A sphere head of losses/angular.py, imported when a model first names it
    (the losses package imports the models' layers)."""

    def make(emb, nc, **kw):
        from sota_imagenet_tpu_torch.losses import angular

        if name == "SphereLinearLayer":
            return angular.SphereLinearLayer(emb, nc)
        return angular.SphereMLPLayer(emb, nc, **kw)

    return make


_MODULES: Dict[str, Callable[..., nn.Module]] = {
    # blocks
    "ConvActBlock": lambda i, o, **kw: B.ConvActBlock(i, o, **kw),
    "ConvBnAct": lambda i, o, **kw: B.ConvBnAct(i, o, **kw),
    "NormFreeBlock": lambda i, o, m=None, **kw: B.NormFreeBlock(i, o, mid_chs=m, **kw),
    "NormFreeBlockTimm": lambda i, o, m=None, **kw: B.NormFreeBlockTimm(i, o, mid_chs=m, **kw),
    "NonDeepBlock": lambda i, o, **kw: B.NonDeepBlock(i, o, **kw),
    "EMABlock": lambda i, o, **kw: B.EMABlock(i, o, **kw),
    "PreInvertedResidual": lambda i, o, m=None, **kw: B.PreInvertedResidual(i, o, mid_chs=m, **kw),
    "PreBasicBlock": lambda i, o, m=None, **kw: B.PreBasicBlock(i, o, mid_chs=m, **kw),
    "VGGBlock": lambda i, o, **kw: B.VGGBlock(i, o, **kw),
    "ConvMixBlock": lambda i, o, **kw: B.ConvMixBlock(i, o, **kw),
    "Yolo5_C3": lambda i, **kw: B.Yolo5_C3(i, **kw),
    "ConvMixerBlock": lambda dim, k=9, **kw: B.ConvMixerBlock(dim, kernel_size=k, **kw),
    "FusedRepVGGBlock": lambda i, o, **kw: B.FusedRepVGGBlock(i, o, **kw),
    "ConvResidual": _conv_residual,
    "Residual": lambda fn=None, **kw: B.Residual(fn),
    # convs
    "scaled_conv3x3": L.scaled_conv3x3,
    "scaled_conv1x1": L.scaled_conv1x1,
    "conv3x3": L.conv3x3,
    "conv1x1": L.conv1x1,
    "ScaledStdConv2d": lambda i, o, **kw: L.ScaledStdConv(i, o, **kw),
    # attention
    "XCA_mod": lambda dim, **kw: A.XCA(dim, **kw),
    "UFO_mod": lambda dim, **kw: A.UFO(dim, **kw),
    "SEVar3_Mod": lambda i, o, **kw: A.SEVar3Mod(i, o, **kw),
    # norms
    "BatchNorm2d": lambda c, **kw: N.BatchNorm(c, **kw),
    "ABN": lambda c, **kw: N.ABN(c, **kw),
    "VarEMA": _norm_ctor(N.VarEMA),
    "FRNv1": _norm_ctor(N.FRNv1),
    "FRNv2": _norm_ctor(N.FRNv2),
    # reference config 64 names a removed "FRN(v3)" class: the JAX table maps it to FRNv2
    "FRN": _norm_ctor(N.FRNv2),
    "MeanEMA": _norm_ctor(N.MeanEMA),
    "ScaleNorm": _norm_ctor(N.ScaleNorm),
    "Affine": lambda v=1.0, **kw: N.Affine(value=v, **kw),
    "Gain": lambda size, **kw: N.Gain(size),
    # torch's GroupNorm(num_groups, num_channels): reference configs give both
    "GroupNorm": lambda num_groups, num_channels, **kw: N.GroupNorm(num_channels, num_groups=num_groups, **kw),
    # layers
    "BlurPool": lambda chs=None, **kw: L.BlurPool(channels=chs, **kw),
    "SpaceToDepth": lambda bs=2, **kw: L.SpaceToDepth(block_size=bs),
    "ChannelShuffle": lambda g=1, **kw: L.ChannelShuffle(groups=g),
    "FastGlobalAvgPool2d": lambda *a, **kw: L.FastGlobalAvgPool(**kw),
    "GEM_pool": lambda *a, **kw: L.GEMPool(**kw),
    # the JAX module reads the channels from its input; here they are the first argument
    "GEM_pool_channel": lambda c=0, **kw: L.GEMPoolChannel(num_channels=c, **kw),
    "MaxPool2d": lambda w=3, s=None, p=0, **kw: L.MaxPool(window=w, stride=s if s is not None else w, padding=p),
    "AvgPool2d": lambda w=2, s=None, p=0, **kw: L.AvgPool(window=w, stride=s if s is not None else w, padding=p),
    "Conv2d": lambda i, o, k=3, stride=1, padding=0, bias=True, groups=1, **kw: L.Conv(
        i, o, kernel_size=k, stride=stride, padding=padding, use_bias=bias, groups=groups
    ),
    "Linear": L.linear,
    "Dropout": _dropout,
    "Identity": lambda *a, **kw: nn.Identity(),
    "Concat": lambda *a, **kw: L.Concat(**kw),
    "Flatten": lambda *a, **kw: L.Flatten(),
    # sphere heads (reference angular_losses.py:202-245) as final layers
    "SphereLinearLayer": _sphere("SphereLinearLayer"),
    "SphereMLPLayer": _sphere("SphereMLPLayer"),
    # torch activation class names seen in configs
    "SiLU": _act("silu"),
    "ReLU": _act("relu"),
    "GELU": _act("gelu"),
    "Hardswish": _act("swish_hard"),
    "LeakyReLU": _act("leaky_relu"),
    "Mish": _act("mish"),
    "Sigmoid": _act("sigmoid"),
}

# strings appearing as kwarg *values* in reference configs -> the port's names
_VALUE_ALIASES = {
    "nn.BatchNorm2d": "bn",
    "torch.nn.BatchNorm2d": "bn",
    "nn.Identity": "identity",
    "nn.GroupNorm": "gn",
}


def resolve_module(name: str) -> Callable[..., nn.Module]:
    key = name.strip()
    if key in _MODULES:
        return _MODULES[key]
    tail = key.rsplit(".", 1)[-1]
    if tail in _MODULES:
        return _MODULES[tail]
    raise KeyError(f"CModel: unknown module {name!r}; known: {sorted(_MODULES)}")


def _norm_value(v: Any) -> Any:
    """Unquote "'string'" literals and map known torch paths."""
    if isinstance(v, str):
        s = v.strip()
        if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
            return s[1:-1]
        if s in _VALUE_ALIASES:
            return _VALUE_ALIASES[s]
        return s
    if isinstance(v, dict):
        return {k: _norm_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_norm_value(x) for x in v]
    return v


def _thaw(obj):
    """Recursively convert Mappings (config nodes) to plain dicts and tuples to lists."""
    if isinstance(obj, collections.abc.Mapping):
        return {k: _thaw(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_thaw(v) for v in obj]
    return obj


def _parse_entry(entry: Union[Dict, List]) -> ModuleStructure:
    if isinstance(entry, collections.abc.Mapping):
        d = _thaw(entry)
        d.setdefault("args", [])
        if not isinstance(d["args"], (list, tuple)):
            d["args"] = [d["args"]]
        d["args"] = list(d["args"])
        return ModuleStructure(**d)
    if isinstance(entry, (list, tuple)):
        # yolo-style: [inputs, repeat, module, args?, kwargs?]
        inputs, repeat, module = entry[0], entry[1], entry[2]
        args = list(entry[3]) if len(entry) > 3 and isinstance(entry[3], (list, tuple)) else (
            [entry[3]] if len(entry) > 3 else []
        )
        kwargs = _thaw(entry[4]) if len(entry) > 4 else {}
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        inputs = ["_prev_" if i == -1 else i for i in inputs]
        return ModuleStructure(module=module, args=args, kwargs=kwargs, repeat=repeat, inputs=inputs)
    raise ValueError(f"bad CModel layer entry: {entry!r}")


def _repeat(ctor: Callable[..., nn.Module], args: list, kwargs: dict, n: int) -> List[nn.Module]:
    """The ``n`` modules of a layer. A JAX module reads its input width off its
    input, and the port's are built before any input: where a repeat widens
    (adacos_sphere's ``[-1, 2, ConvActBlock, [32, 64]]``), the copies after
    the first are built for the width the first one outputs (``input_chs``)."""
    if n <= 0:
        return []
    first = ctor(*args, **kwargs)
    widens = isinstance(first, B.ConvActBlock) and first.in_chs != first.out_chs
    extra = {"input_chs": first.out_chs} if widens else {}
    return [first] + [ctor(*args, **kwargs, **extra) for _ in range(n - 1)]


def build_structures(layer_config: Sequence[Any], extra_kwargs: Optional[Dict[str, Dict]]) -> List[ModuleStructure]:
    structures = [_parse_entry(e) for e in layer_config]
    if extra_kwargs:
        for extra_name, extra_kw in _thaw(extra_kwargs).items():
            tail = extra_name.rsplit(".", 1)[-1]
            for layer in structures:
                lt = str(layer.module).rsplit(".", 1)[-1]
                if str(layer.module) == extra_name or lt == tail:
                    # layer kwargs win over extra_kwargs (reference model.py:1178)
                    layer.kwargs = _update_dict(copy.deepcopy(extra_kw), layer.kwargs)
    return structures


class CModel(nn.Module):
    """Config-defined model (reference CModel, model.py:1147-1226). ``forward``
    takes NHWC images, as the port's other models; inside, tensors are NCHW
    views in channels_last memory. The output keeps the activation dtype."""

    def __init__(self, layer_config: Sequence[Any] = (), extra_kwargs: Optional[Dict[str, Dict]] = None, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.structures = build_structures(layer_config, extra_kwargs)
        tag_to_idx = {s.tag: i for i, s in enumerate(self.structures) if s.tag is not None}

        def resolve_input(inp, layer_idx: int) -> int:
            """-1/_prev_ = previous output; other ints are yolo-style layer
            references (negative = relative, >=0 = absolute); strings = tags."""
            if inp == "_prev_":
                return -1
            if isinstance(inp, int):
                return layer_idx + inp if inp < 0 else inp
            if inp not in tag_to_idx:
                raise KeyError(f"CModel: input tag {inp!r} not found")
            return tag_to_idx[inp]

        self.resolved = [[resolve_input(i, idx) for i in s.inputs] for idx, s in enumerate(self.structures)]
        self.saved_needed = {j for idxs in self.resolved for j in idxs if j != -1}
        self.layers = nn.ModuleList()
        for s in self.structures:
            ctor = resolve_module(str(s.module))
            args = [_norm_value(a) for a in s.args]
            kwargs = {k: _norm_value(v) for k, v in s.kwargs.items()}
            self.layers.append(nn.ModuleList(_repeat(ctor, args, kwargs, int(s.repeat))))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-initialize every parameter from ``generator`` (module order)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
        saved: List[Any] = []
        for idx, mods in enumerate(self.layers):
            inps = [x if j == -1 else saved[j] for j in self.resolved[idx]]
            for mod in mods:
                x = mod(*inps)
                inps = [x]
            saved.append(x if idx in self.saved_needed else None)
        return x


def vgg16_bn(num_classes: int = 1000, **kwargs) -> CModel:
    """VGG16-BN as the JAX package builds it (models/__init__.py:77-102): the
    13 3x3 ConvBnAct (ReLU) of torchvision's layout with a 2x2 max-pool after
    each stage, then a global average pool and the 512-4096-4096 MLP head with
    dropout 0.5, as a CModel."""
    kwargs.pop("pretrained", None)
    cfg: List[Dict[str, Any]] = []
    in_chs = 3
    for stage_chs, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
        for _ in range(n):
            cfg.append({"module": "ConvBnAct", "args": [in_chs, stage_chs], "kwargs": {"activation": "relu"}})
            in_chs = stage_chs
        cfg.append({"module": "MaxPool2d", "args": [2, 2]})
    cfg += [
        {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
        {"module": "Linear", "args": [512, 4096]},
        {"module": "ReLU"},
        {"module": "Dropout", "args": [0.5]},
        {"module": "Linear", "args": [4096, 4096]},
        {"module": "ReLU"},
        {"module": "Dropout", "args": [0.5]},
        {"module": "Linear", "args": [4096, num_classes]},
    ]
    return CModel(layer_config=cfg, **kwargs)
