"""Inference export: a trained model as an artifact that serves without the
model code (port of ``sota_imagenet_tpu/utils/export.py``; the reference is
training-only and has no serving story).

Artifact layout (``export_inference``'s output dir), as the JAX package's:
    model.pt2    ``torch.export.save`` of the ExportedProgram
                 ``serve(params, images_u8_nhwc) -> logits_f32``
    params.npz   the weights, in the JAX package's npz format: arrays
                 ``a{i}``, a JSON path table ``__paths__``, ``__quant__`` for
                 int8 kernels and ``__views__`` for bfloat16 stored as uint16
    meta.json    input spec, dtype, quantization, platforms

The program takes the weights as an explicit dict, as the JAX program takes
``variables``, so they live in ``params.npz`` only: an int8 artifact is ~4x
smaller, and the weights served are the ones stored. The dict is the
model's ``state_dict`` (parameters, running statistics, a spectral norm's
``u``/``v``). The forward parametrizations of a ``ParametrizedModel`` (weight
standardisation, spectral norm) run inside the program on the stored raw
kernels, as in training. The program takes PREPROCESSED images (NHWC
uint8, already resized and center-cropped like the val pipeline) and bakes
in the reference normalization (mean 0.5*255, std 0.2*255,
dali_dataloader.py:27-29), so a server needs only decode and resize.
"""

from __future__ import annotations

import copy
import itertools
import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sota_imagenet_tpu_torch.constants import DATA_MEAN, DATA_STD
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel
from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.misc import resolve_device
from sota_imagenet_tpu_torch.utils.weights import kernel_parameters, unit_dims

# where a program traced by torch.export runs: its graph holds ATen operators only
PLATFORMS = ("cpu", "cuda")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _served_layout(t: torch.Tensor) -> torch.Tensor:
    """4-d floating tensors in channels_last memory, as the trainer holds
    them (steps.init_state): the served convs then take the trainer's NHWC
    kernels."""
    if t.dim() == 4 and t.is_floating_point():
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


def quantizable(model: nn.Module) -> Dict[str, int]:
    """The state_dict names that int8 quantizes, each with its channel dim:
    the parameters that are float ``kernel`` leaves of rank >= 2 in the JAX
    counterpart (conv, Dense and ECA kernels), and the dim that holds the
    flax kernel's last (output) axis. The port names every parameter
    ``weight``, so the set and the axis come from the weights plan, never
    from the torch name or shape."""
    dims = unit_dims(model)
    return {n: dims[n] for n, p in kernel_parameters(model).items() if p.is_floating_point()}


def _quantize_int8(a: np.ndarray, channel_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 (JAX ``_save_tree``): scale =
    amax/127 (1 where amax is 0), rint, clipped to +-127; float32 math."""
    axes = tuple(d for d in range(a.ndim) if d != channel_dim % a.ndim)
    amax = np.max(np.abs(a), axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    return np.clip(np.rint(a / scale), -127, 127).astype(np.int8), scale


def save_params(path: str, state: Mapping[str, torch.Tensor], quantize: Optional[str] = None,
                channel_dims: Optional[Mapping[str, int]] = None) -> None:
    """``state`` ({name: tensor}) as an npz in the JAX package's format. Each
    name is one path of the table (a list of one key: the port's names hold
    dots, the spectral state's too). With ``quantize='int8'`` the leaves in
    ``channel_dims`` are stored as int8 ``a{i}`` plus a float32 scale
    ``a{i}_s`` and their dtype in ``__quant__``; everything else (biases,
    norm affines, running statistics, the spectral state) stays as it is.
    bfloat16 leaves are stored through a uint16 view, named in
    ``__views__``. Raises if int8 was asked for and nothing qualified."""
    channel_dims = channel_dims or {}
    paths, arrays, qdtypes, vdtypes = [], {}, {}, {}
    for i, (name, t) in enumerate(state.items()):
        paths.append([name])
        t = t.detach().cpu()
        if quantize == "int8" and name in channel_dims and t.is_floating_point() and t.dim() >= 2:
            arrays[f"a{i}"], arrays[f"a{i}_s"] = _quantize_int8(t.float().numpy(), channel_dims[name])
            qdtypes[str(i)] = _dtype_name(t.dtype)
        elif t.dtype == torch.bfloat16:
            arrays[f"a{i}"] = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            vdtypes[str(i)] = "bfloat16"
        else:
            arrays[f"a{i}"] = t.contiguous().numpy()
    if quantize == "int8" and not qdtypes:
        raise ValueError("quantize='int8' requested but no float 'kernel' leaf (ndim>=2) was found to quantize")
    np.savez(path, __paths__=json.dumps(paths), __quant__=json.dumps(qdtypes), __views__=json.dumps(vdtypes), **arrays)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} from ``save_params``' npz, in the saved order; int8
    leaves dequantized once, here: float32(q) * scale, cast to the stored
    dtype (the JAX ``_load_tree``)."""
    z = np.load(path, allow_pickle=False)
    paths = json.loads(str(z["__paths__"]))
    qdtypes = json.loads(str(z["__quant__"])) if "__quant__" in z else {}
    vdtypes = json.loads(str(z["__views__"])) if "__views__" in z else {}
    out = {}
    for i, parts in enumerate(paths):
        a = z[f"a{i}"]
        if str(i) in qdtypes:
            t = torch.from_numpy(a.astype(np.float32) * z[f"a{i}_s"]).to(getattr(torch, qdtypes[str(i)]))
        elif str(i) in vdtypes:
            t = torch.from_numpy(a.view(np.int16)).view(getattr(torch, vdtypes[str(i)]))
        else:
            t = torch.from_numpy(a)
        out[".".join(parts)] = t
    return out


def resolve_final_image_size(cfg) -> int:
    """The size the FINAL training stage runs (and therefore validates) at:
    loader.image_size overridden by each stage's extra_args in order
    (DataManager semantics; val follows train, dali_dataloader.py:228)."""
    size = cfg.loader.image_size
    for stage in cfg.run.stages or []:
        extra = dict(stage.get("extra_args") or {}) if hasattr(stage, "get") else dict(getattr(stage, "extra_args", None) or {})
        if "image_size" in extra:
            size = int(extra["image_size"])
    return int(size)


class ServeModule(nn.Module):
    """``forward(params, images_u8) -> logits_f32`` over ``model`` in eval.
    ``model`` is held outside the module tree, so an export lifts none of
    its weights into the program: every weight comes in through ``params``.
    A ``ParametrizedModel`` is applied through ``functional_state``, which
    turns the raw kernels of ``params`` into the effective ones inside the
    graph."""

    def __init__(self, model: nn.Module, input_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.__dict__["_served"] = model.eval()
        self.input_dtype = input_dtype

    def forward(self, params: Dict[str, torch.Tensor], images_u8: torch.Tensor) -> torch.Tensor:
        x = (images_u8.to(torch.float32) - DATA_MEAN) / DATA_STD
        model = self._served
        if isinstance(model, ParametrizedModel):
            params, model = model.functional_state(params), model.model
        logits = torch.func.functional_call(model, params, (x.to(self.input_dtype),))
        return logits.to(torch.float32)


def make_serve_fn(model: nn.Module, input_dtype: torch.dtype = torch.bfloat16) -> ServeModule:
    """fn(params, images_u8) -> fp32 logits, with val normalization baked in."""
    return ServeModule(model, input_dtype)


def export_inference(
    model: nn.Module,
    out_dir: str,
    *,
    image_size: int,
    batch_size: Optional[int] = None,
    input_dtype: torch.dtype = torch.bfloat16,
    quantize: Optional[str] = None,  # 'int8': per-output-channel kernel quantization (save_params)
) -> str:
    """Trace ``model``'s serve function with ``torch.export`` and write the
    artifact, with the model's state_dict as its weights.
    ``batch_size=None`` exports a symbolic batch dimension (min 1): one
    artifact serves any batch size. The trace runs on the CPU wherever the
    model lives (a copy of it, if it is on the card): the graph of ATen
    operators is the same, and ``load_exported`` moves it to the device it
    serves on, while a trace on the card takes guards from CUDA's
    convolution backend choice (2 <= batch <= 65535 for a depthwise conv)
    that a batch of 1 breaks."""
    if quantize not in (None, "int8"):  # validate BEFORE tracing/writing anything
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    state = {k: _served_layout(v.detach().cpu()) for k, v in model.state_dict().items()}
    if any(t.device.type != "cpu" for t in (*model.parameters(), *model.buffers())):
        model = copy.deepcopy(model).cpu()
    serve = make_serve_fn(model, input_dtype)
    images = torch.zeros((batch_size or 2, image_size, image_size, 3), dtype=torch.uint8)
    dims = None
    if batch_size is None:
        dims = {"params": {k: None for k in state}, "images_u8": {0: torch.export.Dim("b", min=1)}}
    with torch.no_grad():
        program = torch.export.export(serve, (state, images), dynamic_shapes=dims, strict=False)
    if getattr(program, "example_inputs", None) is not None:
        program.example_inputs = None  # the saved program would carry the weights as its example inputs
    channel_dims = quantizable(model) if quantize else None
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, "model.pt2"))
    save_params(os.path.join(out_dir, "params.npz"), state, quantize=quantize, channel_dims=channel_dims)
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(
            {
                "image_size": image_size,
                "batch_size": batch_size,
                "input_dtype": _dtype_name(input_dtype),
                "quantize": quantize,
                "platforms": list(PLATFORMS),
                "traced_on": "cpu",
                "in_tree": "fn(params, images_u8_nhwc) -> logits_f32",
            },
            f,
            indent=2,
        )
    return out_dir


def custom_ops(program) -> list:
    """The operators of an ExportedProgram's graph outside ATen and prims
    (a kernel of this port's own would be one): empty for a portable one."""
    names = set()
    for node in program.graph.nodes:
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload):
            if node.target.namespace not in ("aten", "prims"):
                names.add(str(node.target))
    return sorted(names)


def load_exported(out_dir: str, device=None) -> Tuple[Callable[[torch.Tensor], torch.Tensor], dict]:
    """Returns (serve(images_u8) -> logits, meta). No model code needed.
    Runs on the card unless ``device`` says otherwise (raising without a
    GPU); a program traced on another device is moved to this one
    (``move_to_device_pass``). The weights are read, dequantized and put on
    the device once, here. ``serve`` takes a uint8 NHWC tensor or array.
    Each call is a span ``serve.request`` (``utils/trace.py``; its unit the
    request's number) holding ``serve.h2d``, the images' copy to the device,
    and ``serve.program``, the program's call."""
    device = resolve_device(device)
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    program = torch.export.load(os.path.join(out_dir, "model.pt2"))
    if meta.get("traced_on") != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    module = program.module()
    params = {k: _served_layout(v.to(device)) for k, v in load_params(os.path.join(out_dir, "params.npz")).items()}

    requests = itertools.count()

    def serve(images_u8) -> torch.Tensor:
        with torch.no_grad(), trace.span("serve.request", next(requests)):
            with trace.span("serve.h2d"):
                images = torch.as_tensor(images_u8).to(device)
            with trace.span("serve.program"):
                return module(params, images)

    return serve, meta
