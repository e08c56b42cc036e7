"""BNet, bonlime's configurable experimental CNN family (port of
``sota_imagenet_tpu/models/bnet.py``: ``_PLANS`` :58, ``BNetBlock`` :90,
``_NormActLayer`` :208, ``BNet`` :218-440, ``_csp_stage`` :442 and the
factories :463-583).

The JAX module reconstructs the legacy ``arch: BNet`` constructor (which lived in
the external pytorch-tools package) from the configs' own comments; this
port follows it option for option. ``forward`` takes NHWC images (B, H, W, 3),
viewed as NCHW channels_last inside, and returns float32 logits.

Names: each submodule the JAX module names carries that name here
(``stem_conv``, ``stage{s}_block{i}``, ``conv{i}``, ``norm{i}``, ``gamma``,
``head_fc``, ``fc``...). The JAX block's pre-activation norms are unnamed,
so flax numbers them by class (``ABN_0``, ``ABN_1``); here they are
``pre{i}``, and ``utils/weights.py`` maps one onto the other.

Dtype policy (as the JAX package): parameters float32; convs and norms in
the activation dtype; the Dense heads and the classifier in the dtype of
their input (``dt or x.dtype``), so a bf16 trunk keeps a bf16 head; the
logits are float32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from sota_imagenet_tpu_torch.models.attention import get_attn
from sota_imagenet_tpu_torch.models.blocks import partial_residual
from sota_imagenet_tpu_torch.models.layers import (
    BlurPool, Conv, DropPath, Dropout, Linear, SpaceToDepth, activation_from_name, max_pool,
)
from sota_imagenet_tpu_torch.models.norms import BatchNorm, norm_from_name

# conv plans: (kind, width_key, stride_here, depthwise); kind "dw" takes the block's dw_kernel_size
_PLANS = {
    "XX": (("k3", "mid", True, False), ("k3", "out", False, False)),
    "Btl": (("k1", "mid", False, False), ("k3", "mid", True, False), ("k1", "out", False, False)),
    "IR": (("k1", "mid", False, False), ("dw", "mid", True, True), ("k1", "out", False, False)),
    "Custom_2": (("k1", "mid", False, False), ("k1", "out", False, False), ("dw", "out", True, True)),
    "Sep2": (("dw", "in", True, True), ("k1", "mid", False, False), ("dw", "mid", False, True),
             ("k1", "out", False, False)),
    "Sep3": (
        ("dw", "in", True, True),
        ("k1", "mid", False, False),
        ("dw", "mid", False, True),
        ("k1", "mid", False, False),
        ("dw", "mid", False, True),
        ("k1", "out", False, False),
    ),
    "Dark": (("k1", "mid", False, False), ("k3", "out", True, False)),
}


def _plan(block_fn: str):
    pre = block_fn.startswith("Pre_")
    key = block_fn[4:] if pre else block_fn
    if key not in _PLANS:
        raise KeyError(f"unknown block_fn {block_fn!r}; known: {sorted(_PLANS)} (+ Pre_ variants)")
    return pre, _PLANS[key]


def _norm_act(norm_layer: str, chs: int, activation: str, dtype) -> nn.Module:
    """An activated norm of ``norm_layer`` (abn, agn, estimated_abn...) for ``chs`` channels."""
    kw = {"dtype": dtype} if dtype is not None else {}
    return norm_from_name(norm_layer)(chs, activation=activation, **kw)


def _bn_1d(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over (B, C) features, as the JAX head applies it to a (B, 1, 1, C) view."""
    return bn(x[:, :, None, None])[:, :, 0, 0]


class BNetBlock(nn.Module):
    """One BNet block (JAX bnet.py:90-205). ``Pre_`` variants are
    pre-activation (an activated norm before every conv, ``pre{i}``); plain
    ones post-activation (conv -> activated norm, the last conv -> a plain
    BatchNorm, with ``init_zero`` one without scale times a zero-initialised
    ``gamma``; the activation after the residual when ``final_act``).

    The mid width is round(base * bottle_ratio), at least 8, with base the
    output width (the wider side with ``force_expansion``). Depthwise convs
    group over their input width; a 1x1 is never grouped; a 3x3 takes
    ``groups`` or input width // ``groups_width``. With ``antialias`` a
    stride-2 conv runs at stride 1 and a BlurPool follows it. The residual
    is taken at stride 1 only: the identity when the widths match, a
    partial one (``out[:, :in_chs] += x``) with ``force_residual`` when the
    block widens."""

    def __init__(
        self,
        block_fn: str = "XX",
        in_chs: int = 64,
        out_chs: int = 64,
        stride: int = 1,
        bottle_ratio: float = 1.0,
        force_residual: bool = False,
        force_expansion: bool = False,
        dw_kernel_size: int = 3,
        groups: int = 1,
        groups_width: Optional[int] = None,
        norm_layer: str = "abn",
        norm_act: str = "leaky_relu",
        final_act: bool = False,
        antialias: bool = False,
        keep_prob: float = 1.0,
        attn_type: Optional[str] = None,
        attn_kwargs: Optional[Dict[str, Any]] = None,
        init_zero: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.pre, plan = _plan(block_fn)
        self.n_convs, self.stride, self.in_chs, self.out_chs = len(plan), stride, in_chs, out_chs
        self.force_residual, self.final_act = force_residual, final_act
        self.act = activation_from_name(norm_act)
        base = max(in_chs, out_chs) if force_expansion else out_chs
        widths = {"in": in_chs, "out": out_chs, "mid": max(int(round(base * bottle_ratio)), 8)}
        cur = in_chs
        self.blur = [False] * self.n_convs
        for i, (kind, wkey, takes_stride, depthwise) in enumerate(plan):
            chs = widths[wkey]
            st = stride if takes_stride else 1
            k = dw_kernel_size if kind == "dw" else (3 if kind == "k3" else 1)
            if depthwise:
                g = cur
            elif k == 1:
                g = 1
            elif groups_width:
                g = max(cur // groups_width, 1)
            else:
                g = groups
            if self.pre:
                self.add_module(f"pre{i}", _norm_act(norm_layer, cur, norm_act, dtype))
            self.blur[i] = antialias and st == 2
            self.add_module(f"conv{i}", Conv(cur, chs, k, 1 if self.blur[i] else st, k // 2, groups=g, use_bias=False,
                                             dtype=dtype))
            if self.blur[i]:
                self.add_module(f"blur{i}", BlurPool())
            if not self.pre:
                if i < self.n_convs - 1:
                    norm = _norm_act(norm_layer, chs, norm_act, dtype)
                else:
                    norm = BatchNorm(chs, dtype=dtype, use_scale=not init_zero)
                self.add_module(f"norm{i}", norm)
            cur = chs
        self.gamma = nn.Parameter(torch.zeros(cur)) if (init_zero and not self.pre) else None
        self.attn = get_attn(attn_type)(cur, **(attn_kwargs or {})) if attn_type else None
        self.drop_path = DropPath(keep_prob)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        del generator
        if self.gamma is not None:
            nn.init.zeros_(self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for i in range(self.n_convs):
            if self.pre:
                out = getattr(self, f"pre{i}")(out)
            out = getattr(self, f"conv{i}")(out)
            if self.blur[i]:
                out = getattr(self, f"blur{i}")(out)
            if not self.pre:
                out = getattr(self, f"norm{i}")(out)
        if self.gamma is not None:
            out = out * self.gamma.to(out.dtype).view(1, -1, 1, 1)
        if self.attn is not None:
            out = self.attn(out)
        out = self.drop_path(out)
        if self.stride == 1 and (self.in_chs == self.out_chs or (self.force_residual and self.in_chs < self.out_chs)):
            out = partial_residual(out, x)
        if not self.pre and self.final_act:
            out = self.act(out)
        return out


class _NormActLayer(nn.Module):
    """An activated norm of ``norm_layer`` (JAX bnet.py:208: the norm is its unnamed child)."""

    def __init__(self, chs: int, norm_layer: str = "abn", activation: str = "leaky_relu", dtype=None):
        super().__init__()
        self.norm = _norm_act(norm_layer, chs, activation, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class BNet(nn.Module):
    """Config-driven BNet (the legacy ``arch: BNet`` + ``model_params``; JAX
    bnet.py:218-440): a stem (default 7x7/2 + max-pool, s2d/space2depth,
    deep, genet, dark), stages of BNetBlocks (``dim_reduction`` "stride &
    expand", "expand -> stride" or "s2d"; ``filter_steps``; CSP stages;
    drop-connect rising linearly over the blocks), and a head (default,
    default_nonorm, mobilenetv3(_norm), mlp_2/3, mlp_bn_fc(_bn), pool_fc),
    then dropout, optional l2 normalisation and the classifier (a Dense,
    or the sphere heads ``sphere_fc`` / ``sphere_mlp``)."""

    def __init__(
        self,
        layers: Sequence[int] = (1, 2, 6, 5),
        channels: Sequence[int] = (128, 192, 640, 640),
        stage_fns: Sequence[str] = ("simpl",) * 4,
        block_fns: Sequence[str] = ("XX", "XX", "Btl", "IR"),
        stage_args: Sequence[Dict[str, Any]] = (),
        stem_type: str = "default",
        stem_width: int = 32,
        head_type: str = "default",
        head_width: Any = 2560,
        head_norm_act: Optional[str] = None,
        mobilenetv3_head: Optional[bool] = None,
        norm_act: str = "leaky_relu",
        norm_layer: str = "abn",
        attn_type: Optional[str] = None,
        temperature: Optional[float] = None,
        reduction: Optional[int] = None,
        groups: int = 1,
        groups_width: Optional[int] = None,
        no_groups_with_stride: bool = False,
        expand_before_head: bool = True,
        antialias: bool = False,
        init_zero: bool = False,
        drop_rate: float = 0.0,
        drop_connect_rate: float = 0.0,
        normalize: bool = False,
        sphere_fc: bool = False,
        sphere_mlp: bool = False,
        first_stage_stride: int = 1,
        csp_stages: Sequence[bool] = (),
        csp_block_ratio: float = 0.5,
        x2_transition: bool = True,
        num_classes: int = 1000,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        del stage_fns  # "simpl" throughout: the stage function is the block loop below
        n_stages = len(layers)
        assert len(channels) == n_stages, "layers/channels length mismatch"
        stage_args = list(stage_args) + [{}] * (n_stages - len(stage_args))
        block_fns = list(block_fns) + [block_fns[-1]] * (n_stages - len(block_fns))
        csp = list(csp_stages) + [False] * (n_stages - len(csp_stages))
        self.dtype, self.normalize = dtype, normalize
        na = dict(norm_layer=norm_layer, dtype=dtype)

        # --- stem ---
        self.stem_type = st = stem_type
        if st in ("s2d", "space2depth"):
            self.stem_s2d = SpaceToDepth(4)
            self.stem_conv = Conv(48, stem_width, 3, 1, 1, use_bias=False, dtype=dtype)
            self.stem_norm = _NormActLayer(stem_width, activation=norm_act, **na)
            chs = stem_width
        elif st == "deep":
            chs = 3
            for i, c in enumerate((stem_width, stem_width, stem_width * 2)):
                self.add_module(f"stem_conv{i}", Conv(chs, c, 3, 2 if i == 0 else 1, 1, use_bias=False, dtype=dtype))
                self.add_module(f"stem_norm{i}", _NormActLayer(c, activation=norm_act, **na))
                chs = c
        elif st == "genet":
            self.stem_conv = Conv(3, stem_width, 3, 2, 1, use_bias=False, dtype=dtype)
            self.stem_norm = _NormActLayer(stem_width, activation=norm_act, **na)
            chs = stem_width
        elif st == "dark":
            self.stem_conv0 = Conv(3, stem_width, 3, 1, 1, use_bias=False, dtype=dtype)
            self.stem_norm0 = _NormActLayer(stem_width, activation=norm_act, **na)
            self.stem_conv1 = Conv(stem_width, stem_width * 2, 3, 2, 1, use_bias=False, dtype=dtype)
            self.stem_norm1 = _NormActLayer(stem_width * 2, activation=norm_act, **na)
            chs = stem_width * 2
        else:  # "default": ResNet 7x7/2 + max-pool
            self.stem_conv = Conv(3, stem_width, 7, 2, 3, use_bias=False, dtype=dtype)
            self.stem_norm = _NormActLayer(stem_width, activation=norm_act, **na)
            chs = stem_width

        # --- stages ---
        attn_kwargs: Dict[str, Any] = {}
        name = (attn_type or "").lower()
        if temperature is not None and name.startswith("fca"):
            attn_kwargs["temperature"] = temperature
        if reduction is not None and name.startswith("se"):
            attn_kwargs["reduction"] = reduction
        total_blocks, block_idx = sum(layers), 0
        self.stages: List[Dict[str, Any]] = []
        for s in range(n_stages):
            n_blocks, stage_chs = int(layers[s]), int(channels[s])
            args = dict(stage_args[s])
            dim_reduction = args.pop("dim_reduction", "stride & expand")
            filter_steps = args.pop("filter_steps", None)
            stage_stride = first_stage_stride if s == 0 else 2

            def block(i, in_chs, out_chs, stride, s=s, args=args, start=block_idx):
                no_groups = stride == 2 and no_groups_with_stride
                keep = 1.0 - drop_connect_rate * (start + i) / max(total_blocks - 1, 1)
                blk = BNetBlock(
                    block_fn=block_fns[s], in_chs=in_chs, out_chs=out_chs, stride=stride,
                    dw_kernel_size=args.get("dw_str2_kernel_size", 3) if stride == 2 else 3,
                    groups=1 if no_groups else groups,
                    groups_width=None if no_groups else args.get("groups_width", groups_width),
                    norm_layer=norm_layer, norm_act=norm_act, antialias=antialias,
                    keep_prob=keep if drop_connect_rate > 0 else 1.0, attn_type=attn_type, attn_kwargs=attn_kwargs,
                    init_zero=init_zero, dtype=dtype,
                    **{k: args[k] for k in ("bottle_ratio", "force_residual", "force_expansion", "final_act")
                       if k in args},
                )
                self.add_module(f"stage{s}_block{i}", blk)
                return out_chs

            # per-block output widths: filter_steps ramps them within the stage (from the width before an s2d)
            if filter_steps:
                outs = [min(stage_chs, chs + filter_steps * (i + 1)) for i in range(n_blocks)]
                outs[-1] = stage_chs
            else:
                outs = [stage_chs] * n_blocks
            strides, s2d = [1] * n_blocks, False
            if dim_reduction == "s2d":
                if stage_stride == 2:
                    self.add_module(f"stage{s}_s2d", SpaceToDepth(2))  # channels x4, /2
                    s2d, chs = True, chs * 4
            elif dim_reduction == "expand -> stride" and n_blocks > 1:
                strides[1] = stage_stride
            else:  # "stride & expand"
                strides[0] = stage_stride
            meta = {"s2d": s2d, "n": n_blocks, "csp": bool(csp[s]) and n_blocks > 1, "x2": x2_transition}
            chs = block(0, chs, outs[0], strides[0])
            if meta["csp"]:
                # the first block reduces, then the first c_blk channels run through the others and the rest bypass
                c_blk = meta["c_blk"] = max(int(stage_chs * csp_block_ratio), 8)
                block(1, min(c_blk, chs), c_blk, 1)
                for i in range(2, n_blocks):
                    block(i, c_blk, c_blk, 1)
                chs = c_blk + max(chs - c_blk, 0)
                if x2_transition:
                    self.add_module(f"stage{s}_csp_t1", Conv(c_blk, c_blk, 1, 1, 0, use_bias=False, dtype=dtype))
                    self.add_module(f"stage{s}_csp_t1n", _NormActLayer(c_blk, activation=norm_act, **na))
                self.add_module(f"stage{s}_csp_t2", Conv(chs, stage_chs, 1, 1, 0, use_bias=False, dtype=dtype))
                self.add_module(f"stage{s}_csp_t2n", _NormActLayer(stage_chs, activation=norm_act, **na))
                chs = stage_chs
            else:
                for i in range(1, n_blocks):
                    chs = block(i, chs, outs[i], strides[i])
            self.stages.append(meta)
            block_idx += n_blocks

        # --- head ---
        head_act = norm_act if head_norm_act is None else head_norm_act
        ht = head_type
        if mobilenetv3_head is not None:
            ht = "mobilenetv3" if mobilenetv3_head else ht
        if not expand_before_head:
            ht = "pool_fc"
        self.head_type = ht
        self.head_act = activation_from_name(head_act) if head_act and head_act != "none" else (lambda t: t)
        if ht == "default":
            self.head_conv = Conv(chs, head_width, 1, 1, 0, use_bias=False, dtype=dtype)
            self.head_norm = _NormActLayer(head_width, activation=head_act if head_act != "none" else "identity",
                                           **na)
            chs = head_width
        elif ht == "default_nonorm":
            self.head_conv = Conv(chs, head_width, 1, 1, 0, use_bias=True, dtype=dtype)
            chs = head_width
        elif ht in ("mobilenetv3", "mobilenetv3_norm"):
            self.head_fc = Linear(chs, head_width, std=None, dtype=dtype, follow_input=True)
            self.head_norm = BatchNorm(head_width, dtype=dtype) if ht == "mobilenetv3_norm" else None
            chs = head_width
        elif ht in ("mlp_2", "mlp_3"):
            n = 2 if ht == "mlp_2" else 3
            widths = list(head_width) if isinstance(head_width, (list, tuple)) else [head_width] * n
            self.n_head_fc = n
            for i in range(n):
                w = widths[min(i, len(widths) - 1)]
                self.add_module(f"head_fc{i}", Linear(chs, w, std=None, dtype=dtype, follow_input=True))
                chs = w
        elif ht in ("mlp_bn_fc", "mlp_bn_fc_bn"):
            self.head_bn0 = BatchNorm(chs, dtype=dtype)
            self.head_fc = Linear(chs, head_width, std=None, dtype=dtype, follow_input=True)
            self.head_bn1 = BatchNorm(head_width, dtype=dtype) if ht == "mlp_bn_fc_bn" else None
            chs = head_width
        elif ht != "pool_fc":
            raise KeyError(f"unknown head_type {ht!r}")

        self.dropout = Dropout(drop_rate)
        if sphere_mlp or sphere_fc:
            from sota_imagenet_tpu_torch.losses.angular import SphereLinearLayer, SphereMLPLayer

            self.fc = SphereMLPLayer(chs, num_classes) if sphere_mlp else SphereLinearLayer(chs, num_classes)
        else:
            self.fc = Linear(chs, num_classes, std=0.01, dtype=dtype, follow_input=True)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Re-initialize every parameter from ``generator`` (module order)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC images -> (B, num_classes) float32 logits."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
        st = self.stem_type
        if st in ("s2d", "space2depth"):
            x = self.stem_norm(self.stem_conv(self.stem_s2d(x)))
        elif st == "deep":
            for i in range(3):
                x = getattr(self, f"stem_norm{i}")(getattr(self, f"stem_conv{i}")(x))
            x = max_pool(x, 3, 2, 1)
        elif st == "dark":
            x = self.stem_norm0(self.stem_conv0(x))
            x = self.stem_norm1(self.stem_conv1(x))
        else:
            x = self.stem_norm(self.stem_conv(x))
            if st != "genet":
                x = max_pool(x, 3, 2, 1)
        for s, meta in enumerate(self.stages):
            if meta["s2d"]:
                x = getattr(self, f"stage{s}_s2d")(x)
            x = getattr(self, f"stage{s}_block0")(x)
            if meta["csp"]:
                c = meta["c_blk"]
                blk, bypass = x[:, :c], x[:, c:]
                for i in range(1, meta["n"]):
                    blk = getattr(self, f"stage{s}_block{i}")(blk)
                if meta["x2"]:
                    blk = getattr(self, f"stage{s}_csp_t1n")(getattr(self, f"stage{s}_csp_t1")(blk))
                x = torch.cat([blk, bypass], dim=1)
                x = getattr(self, f"stage{s}_csp_t2n")(getattr(self, f"stage{s}_csp_t2")(x))
            else:
                for i in range(1, meta["n"]):
                    x = getattr(self, f"stage{s}_block{i}")(x)
        x = self._head(x)
        x = self.dropout(x)
        if self.normalize:
            n = torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True).clamp(min=1e-12)
            x = x / n.to(x.dtype)
        return self.fc(x).float()

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        ht, act = self.head_type, self.head_act
        if ht == "default":
            return self.head_norm(self.head_conv(x)).mean(dim=(2, 3))
        if ht == "default_nonorm":
            return act(self.head_conv(x)).mean(dim=(2, 3))
        x = x.mean(dim=(2, 3))
        if ht in ("mobilenetv3", "mobilenetv3_norm"):
            x = self.head_fc(x)
            if self.head_norm is not None:
                x = _bn_1d(self.head_norm, x)
            return act(x)
        if ht in ("mlp_2", "mlp_3"):
            for i in range(self.n_head_fc):
                x = act(getattr(self, f"head_fc{i}")(x))
            return x
        if ht in ("mlp_bn_fc", "mlp_bn_fc_bn"):
            x = self.head_fc(_bn_1d(self.head_bn0, x))
            if self.head_bn1 is not None:
                x = _bn_1d(self.head_bn1, x)
            return act(x)
        return x  # pool_fc


def _merge(defaults: Dict[str, Any], kwargs: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(defaults)
    kwargs.pop("pretrained", None)
    out.update(kwargs)
    for k in ("layers", "channels", "stage_fns", "block_fns", "csp_stages"):
        if out.get(k) is not None:
            out[k] = tuple(out[k])
    if out.get("stage_args"):
        out["stage_args"] = tuple(dict(a) for a in out["stage_args"])
    return out


def bnet(**kwargs) -> BNet:
    """``arch: BNet``: fully config-driven (the legacy model_params pass through)."""
    kwargs.setdefault("stage_fns", ("simpl",) * len(kwargs.get("layers", (1, 2, 6, 5))))
    return BNet(**_merge({}, kwargs))


_SIMPL_R34 = dict(
    layers=(3, 4, 6, 3),
    channels=(64, 128, 256, 512),
    block_fns=("XX",) * 4,
    stage_args=tuple({"dim_reduction": "stride & expand", "bottle_ratio": 1, "final_act": True} for _ in range(4)),
    stem_type="default",
    stem_width=64,
    head_type="pool_fc",
    head_width=512,
    norm_act="relu",
)


def simpl_resnet34(**kwargs) -> BNet:
    """Simplified ResNet-34 on the BNet block DSL (legacy ``arch: simpl_resnet34``)."""
    return BNet(**_merge(_SIMPL_R34, kwargs))


def simpl_resnet50(**kwargs) -> BNet:
    d = dict(_SIMPL_R34)
    d.update(
        channels=(256, 512, 1024, 2048),
        block_fns=("Btl",) * 4,
        stage_args=tuple(
            {"dim_reduction": "stride & expand", "bottle_ratio": 0.25, "final_act": True} for _ in range(4)
        ),
        head_width=2048,
    )
    return BNet(**_merge(d, kwargs))


def simpl_preactresnet34(**kwargs) -> BNet:
    """Pre-activation variant (legacy ``arch: simpl_preactresnet34``)."""
    d = dict(_SIMPL_R34)
    d.update(
        block_fns=("Pre_XX",) * 4,
        stage_args=tuple({"dim_reduction": "stride & expand", "bottle_ratio": 1, "force_residual": True}
                         for _ in range(4)),
    )
    return BNet(**_merge(d, kwargs))


def csp_simpl_resnet34(**kwargs) -> BNet:
    """CSP wrapping of simpl_resnet34 (``no_first_csp`` keeps stage 0 plain)."""
    no_first = kwargs.pop("no_first_csp", False)
    d = dict(_SIMPL_R34)
    d["csp_stages"] = (not no_first, True, True, True)
    return BNet(**_merge(d, kwargs))


_DARK = dict(
    layers=(1, 2, 8, 8, 4),
    channels=(64, 128, 256, 512, 1024),
    stage_fns=("simpl",) * 5,
    block_fns=("Dark",) * 5,
    stage_args=tuple({"bottle_ratio": 0.5, "final_act": True} for _ in range(5)),
    stem_type="dark",
    stem_width=32,
    head_type="pool_fc",
    head_width=1024,
)


def simpl_dark(**kwargs) -> BNet:
    """Darknet-53-shaped BNet (legacy ``arch: simpl_dark``)."""
    return BNet(**_merge(_DARK, kwargs))


def csp_simpl_dark(**kwargs) -> BNet:
    no_first = kwargs.pop("no_first_csp", False)
    d = dict(_DARK)
    d["csp_stages"] = (not no_first, True, True, True, True)
    return BNet(**_merge(d, kwargs))


def genet_normal(**kwargs) -> BNet:
    """GENet-normal (arXiv:2006.14090; legacy ``arch: GENet_normal``): XX,
    XX, Btl(0.25), IR(3), head 2560, a /2 stem and every stage strided."""
    d = dict(
        layers=(1, 2, 6, 5),
        channels=(128, 192, 640, 640),
        block_fns=("XX", "XX", "Btl", "IR"),
        stage_args=(
            {"dim_reduction": "stride & expand", "bottle_ratio": 1, "final_act": True},
            {"dim_reduction": "stride & expand", "bottle_ratio": 1, "final_act": True},
            {"bottle_ratio": 0.25, "final_act": True},
            {"bottle_ratio": 3, "final_act": True},
        ),
        stem_type="genet",
        stem_width=32,
        head_type="default",
        head_width=2560,
        norm_act="relu",
        first_stage_stride=2,
    )
    return BNet(**_merge(d, kwargs))
