#!/usr/bin/env python3
"""On-card smoke drive of the PyTorch/CUDA port (``sota_imagenet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. build   — compile every CUDA kernel of the port from ``csrc/`` with nvcc;
             print the build seconds, ptxas' resource lines, and the card's
             name and power limit.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's shape and a ragged one, with its stages off
             and on (tolerance: bit-exact), and time kernel and plain version
             with CUDA events (median of 10 runs of 20 back-to-back launches
             after warm-up) beside the kernel's bound.
3. model   — one f32 train step of full-width ResNet-50 (64 px, batch 8) on
             the card against the same step on the CPU, from the same seeded
             weights (tolerances in model_phase).
4. trainer A — ``cli.main`` on configs/exp/1.r50_baseline.yaml (ResNet-50 at
             full width, batch 256 at 224 px, bf16, synthetic data, debug
             mode: 10 train steps and 20 val steps). Checks: finite loss, one
             augment-kernel launch per train step, parameters and batches on
             cuda, model_last.ckpt written. Prints ms/step (median of steps
             4-10, CUDA events), img/s and peak device memory.
5. trainer B — the same on configs/exp/3.r50_hard-aug_rand-interp.yaml with
             loader.re_prob=0.3: the kernel's colour, gray and erase stages
             and the blur run inside the trainer.
6. profile — trainer A once more with torch.profiler over steps 4-7: device
             time per step by layer and the top kernels, and the device's
             busy share (a separate run, so trainer A's times stay clean).

The line before the last is the card's name and power limit; before it, one
JSON line ``{"kernels": [...]}``. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "nvidia-smi unavailable"


def median_ms(fn, reps: int, per_rep: int, warmup: int = 5) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` runs of
    ``per_rep`` back-to-back calls, each run between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) / per_rep


def build_phase() -> dict:
    from sota_imagenet_tpu_torch.ops import cuda_build, fused_aug

    t0 = time.perf_counter()
    fused_aug.library()
    seconds = time.perf_counter() - t0
    print(f"[build] fused_aug library ready in {seconds:.2f} s")
    log = cuda_build.library_path("fused_aug", ("fused_aug.cu",)).with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                print(f"[build]   {line.strip()}")
    return {"build_s": seconds}


def kernel_phase() -> dict:
    """fused_aug against its plain version on the card; returns its JSON entry."""
    import torch

    from sota_imagenet_tpu_torch.ops.fused_aug import draw_augment_scalars, fused_augment, fused_augment_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for b, h, w in ((256, 224, 224), (3, 37, 53)):
        imgs = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
        for stages in ("off", "on"):
            probs = (0.4, 0.2, 0.3) if stages == "on" else (0.0, 0.0, 0.0)
            kw = dict(color_twist_prob=probs[0], gray_prob=probs[1], re_prob=probs[2], re_count=3)
            scalars = draw_augment_scalars(gen, b, device="cuda", **kw)
            out = fused_augment(imgs, scalars, out_dtype=torch.bfloat16, **kw)
            ref = fused_augment_reference(imgs, scalars, out_dtype=torch.bfloat16, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            n_bytes = imgs.numel() * (1 + 2) + scalars.numel() * 4  # u8 in, bf16 out, scalars
            case = {
                "shape": [b, h, w, 3],
                "stages": stages,
                "max_abs_err": diff,
                "ms": median_ms(lambda: fused_augment(imgs, scalars, out_dtype=torch.bfloat16, **kw), 10, 20),
                "plain_ms": median_ms(
                    lambda: fused_augment_reference(imgs, scalars, out_dtype=torch.bfloat16, **kw), 5, 4
                ),
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            }
            print(f"[kernels] fused_aug {case}")
            if diff != 0.0:
                raise AssertionError(f"fused_aug disagrees with its plain version at {case['shape']} {stages}: {diff}")
            cases.append(case)
    main = cases[0]  # B=256, 224x224, stages off: what r50_baseline runs
    return {
        "name": "fused_aug",
        "route": "cuda",
        "source": "sota_imagenet_tpu_torch/csrc/fused_aug.cu",
        "replaces": "sota_imagenet_tpu/ops/pallas_aug.py:161",
        "launches": None,  # set from the main path's run (trainer A)
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "max_abs_diff": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this function
        "cases": cases,
    }


TRAINER_OVERRIDES = (
    "loader.backend=synthetic",
    "val_loader.backend=synthetic",
    "debug=true",  # 10 train steps, 20 val steps
    "run.stages=[{start: 0, end: 1, lr: [0.001, 1.0]}]",
)


def _probe_callback(profile_window=None):
    """A host callback that records a CUDA event after each train step is
    queued (no host sync: read once at epoch end), and where the run's
    parameters and batches live. With ``profile_window=(a, b)`` it also runs
    torch.profiler from the end of step a to the end of step b (0-based),
    synchronising at both ends; that perturbs those steps' times."""
    import torch

    from sota_imagenet_tpu_torch.train.callbacks import Callback

    class Probe(Callback):
        prof = None

        def on_epoch_begin(self, epoch):
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record()
            self.metric_devices = set()

        def on_batch_end(self, step, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            self.metric_devices.add(metrics["loss"].device.type)
            if profile_window and step == profile_window[0]:
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.start()
                self.prof_t0 = time.perf_counter()
            elif profile_window and step == profile_window[1]:
                torch.cuda.synchronize()
                self.prof_wall_ms = (time.perf_counter() - self.prof_t0) * 1e3
                self.prof.stop()

        def on_epoch_end(self, epoch, train_metrics, val_metrics):
            torch.cuda.synchronize()
            self.step_ms = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
            self.param_devices = {p.device.type for p in self.runner.state.model.parameters()}
            self.train_metrics = dict(train_metrics)
            self.batch_size = self.runner.batch_size

    return Probe()


def model_phase() -> dict:
    """One f32 train step of full-width ResNet-50 on the card against the same
    step on the CPU (the path the tests hold against the JAX package): same
    seeded weights, one batch of 8 images at 64 px, lr 0.1, TF32 off.

    Tolerances: loss rtol 1e-4; grad_norm rtol 1e-2 and the updated params
    and BN buffers within relative L2 3e-2, because a float32 rounding that
    moves a pre-activation across a ReLU kink moves the gradient
    (tests/test_torch_train_step.py), and this randomly initialised net's
    step is large (grad_norm ~700 at lr 0.1). On an H100 the card was
    1.1e-6 (loss), 6.4e-4 (grad_norm) and 3.4e-3 (state) off the CPU."""
    import torch

    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models import resnet50
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    optim = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
    runs = []  # (loss, grad_norm, flat state) on the CPU, then on the card
    for dev in ("cpu", "cuda"):
        state = steps.init_state(
            resnet50(), lambda m: build_optimizer(optim, m.named_parameters()), device=dev, seed=0
        )
        step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda i: 0.1, input_dtype=torch.float32)
        state, m = step(state, {"image": images.to(dev), "label": labels.to(dev)})
        flat = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        runs.append((float(m["loss"]), float(m["grad_norm"]), flat))
    (loss_c, gn_c, sd_c), (loss_g, gn_g, sd_g) = runs
    result = {
        "phase": "model",
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "grad_norm_rel": abs(gn_g - gn_c) / abs(gn_c),
        "state_rel_l2": float((sd_g - sd_c).norm() / sd_c.norm()),
        "loss": [loss_c, loss_g],
        "grad_norm": [gn_c, gn_g],
    }
    print(f"[model] {json.dumps(result)}")
    if not (result["loss_rel"] < 1e-4 and result["grad_norm_rel"] < 1e-2 and result["state_rel_l2"] < 3e-2):
        raise AssertionError(f"ResNet-50 train step on the card disagrees with the CPU: {result}")
    return result


def trainer_phase(name: str, config: str, extra: tuple, gpu: str, profile_window=None) -> dict:
    """cli.main on ``config`` (full-width ResNet-50, bs 256 @ 224, bf16)."""
    import glob

    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.ops.fused_aug import fused_augment

    probe = _probe_callback(profile_window)
    with tempfile.TemporaryDirectory() as logdir:
        overrides = [*TRAINER_OVERRIDES, *extra, f"log.dir={logdir}"]
        torch.cuda.reset_peak_memory_stats()
        fused_augment.launches = 0  # counts from here are the main path's
        t0 = time.perf_counter()
        val = cli.main(["-c", config, *overrides], callbacks=[probe])
        wall = time.perf_counter() - t0
        launches = fused_augment.launches
        ckpts = glob.glob(os.path.join(logdir, "*", "*", "model_last.ckpt"))
    steps = len(probe.step_ms)
    loss = probe.train_metrics.get("loss", float("nan"))
    steady = probe.step_ms[3:10]  # steps 4-10
    ms_step = statistics.median(steady) if steady else float("nan")
    result = {
        "phase": name,
        "config": config,
        "train_steps": steps,
        "kernel_launches": launches,
        "train_loss": loss,
        "val": val,
        "ms_per_step_median_4_10": ms_step,
        "step_ms": probe.step_ms,
        "img_per_s": probe.batch_size / ms_step * 1e3,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "wall_s": wall,
        "gpu": gpu,
    }
    if probe.prof is not None:
        result["profile"] = _device_time_breakdown(probe.prof, probe.prof_wall_ms, profile_window)
    print(f"[{name}] {json.dumps(result)}")
    if not math.isfinite(loss) or not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"{name}: non-finite loss (train {loss}, val {val})")
    if steps != 10 or launches != steps:
        raise AssertionError(f"{name}: {launches} fused_aug launches for {steps} train steps (want one per step, 10 steps)")
    if probe.param_devices != {"cuda"} or probe.metric_devices != {"cuda"}:
        raise AssertionError(f"{name}: params on {probe.param_devices}, batches/metrics on {probe.metric_devices}")
    if not ckpts:
        raise AssertionError(f"{name}: model_last.ckpt was not written")
    return result


# kernel-name fragments -> the layer a device kernel belongs to (first match wins)
KERNEL_GROUPS = (
    ("fused_aug", ("fused_aug",)),
    ("memcpy", ("memcpy", "memset")),
    ("conv/matmul", ("conv", "gemm", "sm90", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "cudnn")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_")),
    ("optimizer/EMA", ("multi_tensor", "foreach")),
)


def _device_time_breakdown(prof, wall_ms: float, window) -> dict:
    """Device time of the profiled steps by layer and by kernel, beside the
    window's wall time (busy share = device time / wall)."""
    from torch.autograd import DeviceType

    rows = sorted(
        ((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    groups: dict = {}
    for ms, _, key in rows:
        low = key.lower()
        group = next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    device_ms = sum(ms for ms, _, _ in rows)
    steps = window[1] - window[0]
    return {
        "steps": steps,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if wall_ms > 0 else None,
        "by_group_ms_per_step": {g: ms / steps for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms_per_step": ms / steps, "calls": n, "name": key[:120]} for ms, n, key in rows[:15]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this drive runs only on the card", file=sys.stderr)
        return 1
    try:
        import sota_imagenet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})", file=sys.stderr)
        return 1

    gpu = gpu_line()
    print(f"[env] {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} | {gpu}")
    build_phase()
    kernel = kernel_phase()
    model_phase()
    trainer_a = trainer_phase("trainer_a", "configs/exp/1.r50_baseline.yaml", (), gpu)
    trainer_b = trainer_phase("trainer_b", "configs/exp/3.r50_hard-aug_rand-interp.yaml", ("loader.re_prob=0.3",), gpu)
    trainer_phase("profile", "configs/exp/1.r50_baseline.yaml", (), gpu, profile_window=(2, 6))
    kernel["gpu"] = gpu
    kernel["launches"] = trainer_a["kernel_launches"]  # on the main path: trainer A's run (r50_baseline)
    kernel["launches_hard_aug"] = trainer_b["kernel_launches"]
    print(json.dumps({"kernels": [kernel]}))
    print(gpu)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
