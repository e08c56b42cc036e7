"""Train-step and eval throughput across model families on the card (port
of ``scripts/bench_models.py``).

Beside the ResNet-50 trainers of ``chip_smoke.py``, the other reference
model families (SURVEY.md section 2.2: BResNet-50, eca_nfnet_l0, vgg16_bn
and the 37.7M CModel VGG of ``configs/exp/62.vgg-cmodel.yaml``). The train
leg runs the port's whole train step (forward, label-smoothed loss,
backward, the optimizer's update) on synthetic data already on the device,
bf16 activations, channels_last weights (``steps.init_state``), at the JAX
script's batches (128; the VGGs 64) and 224 px. The ``--eval`` leg runs the
eval forward and its argmax at the reference val batch, 250. Each leg
times ``--iters`` calls (20 train, 30 eval) after 3 warm-up calls, between
two device synchronisations, and prints one JSON line per model with the
card's name and power limit (``nvidia-smi``), where the JAX script printed
its rate per TPU chip.

Usage: python -m sota_imagenet_tpu_torch.tools.bench_models [--eval] [name ...] [--device cpu]
       [--batch N] [--size S] [--iters N]     (default: every family, on the card)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict, Tuple

import torch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")
SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
EVAL_BATCH = 250  # the reference val batch


def _r50():
    from sota_imagenet_tpu_torch.models import resnet50

    return resnet50(), SGD, 128


def _bresnet():
    from sota_imagenet_tpu_torch.models import bresnet50

    return bresnet50(), SGD, 128


def _nfnet():
    from sota_imagenet_tpu_torch.models import eca_nfnet_l0

    return eca_nfnet_l0(), {"_target_": "adamw", "weight_decay": 0.02}, 128


def _vgg():
    from sota_imagenet_tpu_torch.models import vgg16_bn

    return vgg16_bn(), SGD, 64


def _vgg_cmodel():
    """The reference's 37.7M CModel VGG (62.vgg-cmodel.yaml, 75.458% top-1)."""
    from sota_imagenet_tpu_torch import config as C

    cfg = C.load(os.path.join(CONFIGS, "exp", "62.vgg-cmodel.yaml"), strict_env=False)
    return C.instantiate(cfg.model), {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}, 64


# name -> () -> (model, optimizer config, train batch)
FAMILIES: Dict[str, Callable[[], Tuple[torch.nn.Module, dict, int]]] = {
    "resnet50": _r50,
    "bresnet50": _bresnet,
    "eca_nfnet_l0": _nfnet,
    "vgg16_bn": _vgg,
    "vgg_cmodel": _vgg_cmodel,
}


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn: Callable[[], object], iters: int, device: torch.device, warmup: int = 3) -> float:
    """Seconds of ``iters`` calls of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return time.perf_counter() - t0


def bench_train(name: str, model, optim_cfg: dict, batch: int, size: int, device: torch.device, iters: int = 20,
                gpu: str = "") -> dict:
    """The port's train step (SGD or AdamW, label smoothing 0.1, bf16, a
    cosine schedule) on one synthetic batch on the device."""
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps as steps_lib
    from sota_imagenet_tpu_torch.train.schedule import make_lr_schedule

    schedule = make_lr_schedule([dict(ep=(0, 90), lr=(1.0, 0.0), mode="cos")], steps_per_epoch=100)
    state = steps_lib.init_state(model, lambda m: build_optimizer(dict(optim_cfg), m.named_parameters()),
                                 device=device, seed=0)
    step = steps_lib.build_train_step(CrossEntropyLoss(smoothing=0.1), schedule, input_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((batch, size, size, 3), generator=gen, device=device, dtype=torch.bfloat16)
    labels = torch.nn.functional.one_hot(torch.arange(batch, device=device) % 1000, 1000).to(torch.float32)
    batch_ = {"image": images, "label": labels}
    seconds = _timed(lambda: step(state, batch_), iters, device)
    out = {"model": name, "mode": "train", "img_per_sec": batch * iters / seconds, "ms_per_step": seconds / iters * 1e3,
           "batch": batch, "size": size, "iters": iters, "device": device.type, "gpu": gpu}
    print(json.dumps(out), flush=True)
    return out


def bench_eval(name: str, model, batch: int, size: int, device: torch.device, iters: int = 30, gpu: str = "") -> dict:
    """The eval forward and its argmax (what a server returns) at ``batch``, bf16."""
    if hasattr(model, "reset_parameters"):
        model.reset_parameters(torch.Generator().manual_seed(0))  # the weights init_state draws
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((batch, size, size, 3), generator=gen, device=device, dtype=torch.bfloat16)

    def forward():
        with torch.no_grad():
            return model(images).argmax(-1)

    seconds = _timed(forward, iters, device)
    out = {"model": name, "mode": "eval", "img_per_sec": batch * iters / seconds, "ms_per_batch": seconds / iters * 1e3,
           "batch": batch, "size": size, "iters": iters, "device": device.type, "gpu": gpu}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> list:
    from sota_imagenet_tpu_torch.utils.misc import resolve_device

    ap = argparse.ArgumentParser(description="per-family train and eval img/s of the port")
    ap.add_argument("names", nargs="*", help=f"families (default: all of {', '.join(FAMILIES)})")
    ap.add_argument("--eval", action="store_true", help="the eval forward at batch 250, not the train step")
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--batch", type=int, default=None, help="override each family's batch")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--iters", type=int, default=None, help="timed calls (default 20 train, 30 eval)")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(FAMILIES)
    if unknown:
        ap.error(f"unknown families {sorted(unknown)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    gpu = gpu_line() if device.type == "cuda" else "cpu"
    results = []
    for name in args.names or list(FAMILIES):
        model, optim_cfg, train_batch = FAMILIES[name]()
        if args.eval:
            results.append(bench_eval(name, model, args.batch or EVAL_BATCH, args.size, device, args.iters or 30, gpu))
        else:
            results.append(bench_train(name, model, optim_cfg, args.batch or train_batch, args.size, device,
                                       args.iters or 20, gpu))
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return results


if __name__ == "__main__":
    main()
