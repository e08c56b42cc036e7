#!/usr/bin/env python3
"""On-card smoke drive of the PyTorch/CUDA port (``sota_imagenet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels   # a subset, for iterating

Phases (each runs even if an earlier one failed, except that nothing runs
without a build; any failure exits non-zero and prints no result):

1. build   — compile every CUDA library of the port from ``csrc/`` with nvcc,
             one nvcc per source, all started together; print the build
             seconds and ptxas' resource lines of each.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's shapes and a ragged one, and time kernel,
             plain version and (where one PyTorch call computes the same
             function) that library call with CUDA events (median of runs
             of back-to-back launches after warm-up) beside the kernel's
             bound. fused_aug: bit-exact, stages off and on. conv1x1_stats:
             the 15 shapes resnet50(fused_stats=True) launches at batch 256,
             224 px, a ragged one, the stride-2 NHWC wrapper and the
             backward (tolerances in conv_stats_phase). moments: three
             ResNet-50 activation shapes and a ragged one (moments_phase).
3. model   — one f32 train step of full-width ResNet-50 (64 px, batch 8) on
             the card against the same step on the CPU, from the same seeded
             weights, unfused and with fused_stats (tolerances in
             model_phase).
4. trainer A — ``cli.main`` on configs/exp/1.r50_baseline.yaml (ResNet-50 at
             full width, batch 256 at 224 px, bf16, synthetic data, debug
             mode: 10 train steps and 20 val steps). Checks: finite loss, the
             launches of every kernel (one augment launch per train step),
             parameters and batches on cuda, model_last.ckpt written. Prints
             ms/step (median of steps 4-10, CUDA events), img/s and peak
             device memory.
5. trainer B — the same on configs/exp/3.r50_hard-aug_rand-interp.yaml with
             loader.re_prob=0.3: the kernel's colour, gray and erase stages
             and the blur run inside the trainer.
6. trainer C — trainer A with model={_target_: resnet50, fused_stats: true}:
             every 1x1 conv + BatchNorm of a train step goes through the
             conv1x1_stats kernel, 36 launches per step.
7. profile — trainers A and C once more with torch.profiler over steps 4-7:
             device time per step by layer and the top kernels, and the
             device's busy share (separate runs, so the trainers' times stay
             clean).

Every kernel counter is set to 0 just before each trainer's ``cli.main`` and
read just after. The line before the last is the card's name and power
limit; before it, one JSON line ``{"kernels": [...]}``. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak


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


LIBRARIES = (  # (module under sota_imagenet_tpu_torch.ops and its library's name, sources)
    ("fused_aug", ("fused_aug.cu",)),
    ("conv_stats", ("conv_stats.cu",)),
    ("moments", ("moments.cu",)),
)


def build_phase() -> dict:
    """Build every library at once (one nvcc each) and print ptxas' lines."""
    import importlib

    from sota_imagenet_tpu_torch.ops import cuda_build

    def build(module):
        t0 = time.perf_counter()
        importlib.import_module(f"sota_imagenet_tpu_torch.ops.{module}").library()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        names = [name for name, _ in LIBRARIES]
        seconds = dict(zip(names, pool.map(build, names)))
    total = time.perf_counter() - t0
    print(f"[build] {len(LIBRARIES)} libraries ready in {total:.2f} s: {json.dumps(seconds)}")
    for name, sources in LIBRARIES:
        log = cuda_build.library_path(name, sources).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "ptxas info" in line and ("registers" in line or "Compiling" in line):
                    print(f"[build]   {name}: {line.strip()}")
    return {"build_s": total, "per_library_s": seconds}


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


# (M, K, N, launches per train step) of resnet50(fused_stats=True) at batch
# 256, 224 px: fconv1 and fconv3 of all 16 bottlenecks, fdown of 4
R50_CONV1X1 = (
    (802816, 64, 64, 1), (802816, 64, 256, 4), (802816, 256, 64, 2), (802816, 256, 128, 1),
    (200704, 128, 512, 4), (200704, 256, 512, 1), (200704, 512, 128, 3), (200704, 512, 256, 1),
    (50176, 256, 1024, 6), (50176, 512, 1024, 1), (50176, 1024, 256, 5), (50176, 1024, 512, 1),
    (12544, 512, 2048, 3), (12544, 1024, 2048, 1), (12544, 2048, 512, 2),
)
SUM_RTOL = 1e-5


def flip_fraction(k: int) -> float:
    """Most elements of y that may differ from the plain version's: 1e-3, and
    K * 2^-20 past K = 1024. The tensor cores' f32 sums drift from the plain
    version's in proportion to K (an H100 showed 4.3e-5 at K = 64 and
    1.02e-3 at K = 2048), so more sums land across a bf16 boundary."""
    return max(1e-3, k * 2.0**-20)


def _check_y(x, w, y, y_ref) -> dict:
    """y against the plain version's y_ref. The two f32 sums are taken in
    other orders, so where they straddle a bf16 rounding boundary y may
    differ by one bf16 ulp (of the larger of the two), plus the f32
    summation-order bound 2K * 2^-24 * (|x| @ |w|^T) where y is near 0; at
    most flip_fraction(K) of the elements may differ at all."""
    import torch

    yk, yr = y.float(), y_ref.float()
    diff = (yk - yr).abs()
    n_diff = int((diff > 0).sum())
    _, exp = torch.frexp(torch.maximum(yk.abs(), yr.abs()))
    ulp = torch.ldexp(torch.ones_like(yk), exp - 8)
    del yk, yr
    slack = (x.float().abs() @ w.float().abs().t()).mul_(2.0 * x.shape[1] * 2.0**-24)
    over = int((diff > ulp + slack).sum())
    out = {
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
        "n_diff": n_diff,
        "frac_diff": n_diff / max(diff.numel(), 1),
    }
    if over or out["frac_diff"] > flip_fraction(x.shape[1]):
        raise AssertionError(f"conv1x1_stats y disagrees with its plain version: {over} elements past the bound, {out}")
    return out


def _check_sums(y, s1, s2) -> dict:
    """Sums against float64 sums of the kernel's own y (this isolates the
    epilogue): within SUM_RTOL of sum|y| (immune to cancellation) and of
    sum y^2."""
    y64 = y.double()
    e1 = float(((s1.double() - y64.sum(0)).abs() / y64.abs().sum(0).clamp_min(1e-30)).max())
    sq = (y64 * y64).sum(0)
    e2 = float(((s2.double() - sq).abs() / sq.clamp_min(1e-30)).max())
    if not (e1 <= SUM_RTOL and e2 <= SUM_RTOL):
        raise AssertionError(f"conv1x1_stats sums off the float64 sums of its own y: {e1}, {e2}")
    return {"sum_rel_err": e1, "sumsq_rel_err": e2}


def conv_stats_phase() -> dict:
    """conv1x1_stats against its plain version on the card at the 15 r50
    shapes, a ragged shape and the stride-2 NHWC wrapper; its autograd
    backward against the plain version's autograd (rtol 1e-2 of the largest
    gradient: gy_tot is rounded to bf16 before the products, the plain
    version's f32 gradient only at the cast of x); times summed over the 36
    launches of a train step."""
    import torch

    from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats, conv1x1_stats_nhwc, conv1x1_stats_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for m, k, n, count in (*R50_CONV1X1, (1000, 40, 72, 0)):
        # post-ReLU-like activations and fan-out-scaled weights, as in the net
        x = torch.rand((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device="cuda") * math.sqrt(2.0 / n)).to(torch.bfloat16)
        y, s1, s2 = conv1x1_stats(x, w)
        y_ref, _, _ = conv1x1_stats_reference(x, w)
        torch.cuda.synchronize()
        case = {"shape": [m, k, n], "launches_per_step": count}
        case.update(_check_y(x, w, y, y_ref))
        case.update(_check_sums(y, s1, s2))
        del y, s1, s2, y_ref
        n_bytes = 2 * (m * k + k * n + m * n) + 2 * 4 * n
        case["bound_ms"] = max(2 * m * k * n / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        case["bound_by"] = "operations" if 2 * m * k * n / BF16_FLOPS > n_bytes / HBM_BYTES_PER_S else "bytes"
        case["ms"] = median_ms(lambda: conv1x1_stats(x, w), 10, 10)
        case["plain_ms"] = median_ms(lambda: conv1x1_stats_reference(x, w), 3, 2, warmup=1)
        wt = w.t()
        case["library_ms"] = median_ms(lambda: torch.matmul(x, wt), 10, 10)  # the product alone
        print(f"[kernels] conv1x1_stats {json.dumps(case)}")
        cases.append(case)
        del x, w, wt
    # stride-2 NHWC wrapper at stage 2's fdown: (256, 256, 56, 56) -> (256, 512, 28, 28)
    x4 = torch.rand((256, 256, 56, 56), generator=gen, device="cuda").to(torch.bfloat16)
    x4 = x4.contiguous(memory_format=torch.channels_last)
    w4 = torch.randn((512, 256, 1, 1), generator=gen, device="cuda") * math.sqrt(2.0 / 512)
    y4, s1, s2 = conv1x1_stats_nhwc(x4, w4, stride=2)
    x2d = x4[:, :, ::2, ::2].permute(0, 2, 3, 1).reshape(-1, 256)
    y2d_ref, _, _ = conv1x1_stats_reference(x2d, w4.view(512, 256))
    torch.cuda.synchronize()
    if tuple(y4.shape) != (256, 512, 28, 28) or not y4.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"conv1x1_stats_nhwc gave {tuple(y4.shape)} {y4.stride()}, want channels_last 256x512x28x28")
    y2d = y4.permute(0, 2, 3, 1).reshape(-1, 512)
    strided = {"shape": [256, 256, 56, 56], "stride": 2}
    strided.update(_check_y(x2d, w4.view(512, 256).to(torch.bfloat16), y2d, y2d_ref))
    strided.update(_check_sums(y2d, s1, s2))
    print(f"[kernels] conv1x1_stats_nhwc {json.dumps(strided)}")
    del x4, w4, y4, x2d, y2d, y2d_ref
    # backward: the autograd.Function (kernel forward) against autograd through the plain version
    grads = []
    for m, k, n in ((50176, 256, 1024), (1000, 40, 72)):
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.1
        got = []
        for fn in (conv1x1_stats, conv1x1_stats_reference):
            xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            y, s1, s2 = fn(xl, wl)
            mean = s1 / m
            var = s2 / m - mean**2  # the loss of tests/test_pallas_conv_stats.py::test_grads_match_unfused
            (y.float().mul(0.01).sum() + mean.mul(0.5).sum() + var.mul(0.25).sum()).backward()
            got.append((xl.grad, wl.grad))
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*got)]
        grads.append({"shape": [m, k, n], "dx_rel_err": errs[0], "dw_rel_err": errs[1]})
        print(f"[kernels] conv1x1_stats backward {json.dumps(grads[-1])}")
        if max(errs) > 1e-2:
            raise AssertionError(f"conv1x1_stats backward disagrees with the plain version's autograd: {grads[-1]}")
    main = [c for c in cases if c["launches_per_step"]]

    def per_step(key, cases=main):
        return sum(c[key] * c["launches_per_step"] for c in cases)

    by_bytes = per_step("bound_ms", [c for c in main if c["bound_by"] == "bytes"])

    return {
        "name": "conv1x1_stats",
        "route": "cuda",
        "source": "sota_imagenet_tpu_torch/csrc/conv_stats.cu",
        "replaces": "sota_imagenet_tpu/ops/pallas_conv_stats.py:107",
        "launches": None,  # set from the main path's run (trainer C)
        "max_abs_err": max(c["max_abs_err"] for c in (*cases, strided)),
        "ms": per_step("ms"),  # the 36 launches of one train step
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        # what decides most of the per-step bound
        "bound_by": "bytes" if by_bytes * 2 >= per_step("bound_ms") else "operations",
        "library_ms": per_step("library_ms"),  # torch.matmul of the same operands: the product alone
        "times_are": "sums over the 36 launches of one train step at batch 256, 224 px",
        "cases": cases,
        "strided": strided,
        "backward": grads,
    }


MOMENTS_SHAPES = (((256, 112, 112, 64), "bfloat16"), ((256, 56, 56, 256), "bfloat16"), ((256, 7, 7, 2048), "bfloat16"),
                  ((3, 9, 5, 128), "bfloat16"), ((3, 9, 5, 128), "float32"))


def moments_phase() -> dict:
    """moments against float64 moments of the same input on the card: mean
    within rtol 1e-5 plus an atol of 1e-5 of the channel's root mean square,
    var within rtol 1e-5 plus an atol of 1e-5 of the channel's mean square
    (var = E[x^2] - mean^2 cancels down to that scale)."""
    import torch

    from sota_imagenet_tpu_torch.ops.moments import moments, moments_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for shape, dtype in MOMENTS_SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(getattr(torch, dtype))
        mean, var = moments(x)
        x64 = x.double().reshape(-1, shape[-1])
        mean64 = x64.mean(0)
        sq64 = (x64 * x64).mean(0)
        var64 = (x64 - mean64).square().mean(0)
        del x64
        torch.cuda.synchronize()
        e_mean = float(((mean.double() - mean64).abs() / (1e-5 * mean64.abs() + 1e-5 * sq64.sqrt())).max())
        e_var = float(((var.double() - var64).abs() / (1e-5 * var64 + 1e-5 * sq64)).max())
        dims = tuple(range(len(shape) - 1))
        n_bytes = x.numel() * x.element_size() + 2 * 4 * shape[-1]
        case = {
            "shape": list(shape),
            "dtype": dtype,
            "max_abs_err": max(float((mean.double() - mean64).abs().max()), float((var.double() - var64).abs().max())),
            "err_over_tol": max(e_mean, e_var),
            "ms": median_ms(lambda: moments(x), 10, 10),
            "plain_ms": median_ms(lambda: moments_reference(x), 5, 4),
            "library_ms": median_ms(lambda: torch.var_mean(x, dims, correction=0), 10, 10),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        }
        print(f"[kernels] moments {json.dumps(case)}")
        if case["err_over_tol"] > 1.0:
            raise AssertionError(f"moments disagrees with float64 moments at {shape} {dtype}: {case}")
        cases.append(case)
        del x
    main = cases[0]  # (256, 112, 112, 64) bf16: the largest activation of ResNet-50 at batch 256
    return {
        "name": "moments",
        "route": "cuda",
        "source": "sota_imagenet_tpu_torch/csrc/moments.cu",
        "replaces": "sota_imagenet_tpu/ops/pallas_norm.py:51",
        "launches": None,  # no path calls it, in either package
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],  # torch.var_mean(x, (0, 1, 2), correction=0)
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


def model_phase(fused_stats: bool = False, norm_act: str = "relu", check: bool = True) -> dict:
    """One f32 train step of full-width ResNet-50 on the card against the same
    step on the CPU (the path the tests hold against the JAX package): same
    seeded weights, one batch of 8 images at 64 px, lr 0.1, TF32 off.

    Tolerances: loss rtol 1e-4; grad_norm rtol 1e-2 and the updated params
    and BN buffers within relative L2 3e-2, because a float32 rounding that
    moves a pre-activation across a ReLU kink moves the gradient
    (tests/test_torch_train_step.py), and this randomly initialised net's
    step is large (grad_norm ~700 at lr 0.1). On an H100 the unfused card
    step was 1.1e-6 (loss), 6.4e-4 (grad_norm) and 3.4e-3 (state) off the
    CPU.

    With ``fused_stats`` the 1x1 convs take bf16 products in an f32 net on
    both sides (the kernel on the card, its plain version on the CPU); their
    f32 sums run in other orders, so a y near a bf16 rounding boundary may
    round the other way; so may an input of the bf16 cast that the card's and
    the CPU's 3x3 convs left 1e-6 apart. Each flip moves a product by up to
    2^-8, and train-mode BatchNorm carries it on. With ReLU such flips and the
    kink together moved this step's state by 20% on an H100 (NVIDIA H100 80GB
    HBM3, 700 W), so the checked fused step uses SiLU, as
    tests/test_torch_train_step.py does; there the card was 1.07e-3 (loss),
    1.86e-2 (grad_norm) and 4.9e-3 (state) off the CPU, so the fused
    tolerances are loss rtol 1e-2, grad_norm rtol 5e-2 and state 3e-2. The
    ReLU step is run and reported (``check=False``)."""
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
            resnet50(fused_stats=fused_stats, norm_act=norm_act),
            lambda m: build_optimizer(optim, m.named_parameters()),
            device=dev,
            seed=0,
        )
        step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda i: 0.1, input_dtype=torch.float32)
        state, m = step(state, {"image": images.to(dev), "label": labels.to(dev)})
        flat = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        runs.append((float(m["loss"]), float(m["grad_norm"]), flat))
    (loss_c, gn_c, sd_c), (loss_g, gn_g, sd_g) = runs
    result = {
        "phase": f"model_fused_{norm_act}" if fused_stats else "model",
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "grad_norm_rel": abs(gn_g - gn_c) / abs(gn_c),
        "state_rel_l2": float((sd_g - sd_c).norm() / sd_c.norm()),
        "loss": [loss_c, loss_g],
        "grad_norm": [gn_c, gn_g],
    }
    print(f"[{result['phase']}] {json.dumps(result)}")
    loss_rtol, gn_rtol = (1e-2, 5e-2) if fused_stats else (1e-4, 1e-2)
    within = result["loss_rel"] < loss_rtol and result["grad_norm_rel"] < gn_rtol and result["state_rel_l2"] < 3e-2
    if check and not within:
        raise AssertionError(f"ResNet-50 train step on the card disagrees with the CPU: {result}")
    return result


def kernel_counters() -> dict:
    """name -> the wrapper whose ``launches`` counts that kernel's launches."""
    from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats
    from sota_imagenet_tpu_torch.ops.fused_aug import fused_augment
    from sota_imagenet_tpu_torch.ops.moments import moments

    return {"fused_aug": fused_augment, "conv1x1_stats": conv1x1_stats, "moments": moments}


def trainer_phase(name: str, config: str, extra: tuple, gpu: str, per_step: dict, profile_window=None) -> dict:
    """cli.main on ``config`` (full-width ResNet-50, bs 256 @ 224, bf16);
    ``per_step`` is each kernel's expected launches per train step."""
    import glob

    import torch

    from sota_imagenet_tpu_torch import cli

    probe = _probe_callback(profile_window)
    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as logdir:
        overrides = [*TRAINER_OVERRIDES, *extra, f"log.dir={logdir}"]
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0  # counts from here are this path's
        t0 = time.perf_counter()
        val = cli.main(["-c", config, *overrides], callbacks=[probe])
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        ckpts = glob.glob(os.path.join(logdir, "*", "*", "model_last.ckpt"))
    steps = len(probe.step_ms)
    loss = probe.train_metrics.get("loss", float("nan"))
    steady = probe.step_ms[3:10]  # steps 4-10
    ms_step = statistics.median(steady) if steady else float("nan")
    result = {
        "phase": name,
        "config": config,
        "overrides": list(extra),
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
    want = {k: per_step.get(k, 0) * steps for k in counters}
    if steps != 10 or launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} in {steps} train steps, want {want} in 10 steps")
    if probe.param_devices != {"cuda"} or probe.metric_devices != {"cuda"}:
        raise AssertionError(f"{name}: params on {probe.param_devices}, batches/metrics on {probe.metric_devices}")
    if not ckpts:
        raise AssertionError(f"{name}: model_last.ckpt was not written")
    return result


# kernel-name fragments -> the layer a device kernel belongs to (first match wins)
KERNEL_GROUPS = (
    ("fused_aug", ("fused_aug",)),
    # before conv/matmul, whose fragment "conv" would claim conv1x1_stats_kernel
    ("conv1x1_stats", ("conv1x1_stats",)),
    ("moments", ("moments_kernel",)),
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


PHASES = ("build", "kernels", "model", "trainer_a", "trainer_b", "trainer_c", "profile")
FUSED = ("model={_target_: resnet50, fused_stats: true}",)
R50 = "configs/exp/1.r50_baseline.yaml"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES), help=f"comma-separated subset of {','.join(PHASES)}")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

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
    # plain versions and the model phase compare f32 products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed, results = [], {}

    def run(name, fn, *a, **kw):
        try:
            results[name] = fn(*a, **kw)
        except Exception:  # noqa: BLE001 - report every phase, fail at the end
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            failed.append(name)

    run("build", build_phase)
    if "build" in failed:
        return 1
    if "kernels" in phases:
        run("fused_aug", kernel_phase)
        run("conv1x1_stats", conv_stats_phase)
        run("moments", moments_phase)
    if "model" in phases:
        run("model", model_phase)
        run("model_fused_silu", model_phase, fused_stats=True, norm_act="silu")
        run("model_fused_relu", model_phase, fused_stats=True, check=False)
    aug_only = {"fused_aug": 1}
    if "trainer_a" in phases:
        run("trainer_a", trainer_phase, "trainer_a", R50, (), gpu, aug_only)
    if "trainer_b" in phases:
        hard = "configs/exp/3.r50_hard-aug_rand-interp.yaml"
        run("trainer_b", trainer_phase, "trainer_b", hard, ("loader.re_prob=0.3",), gpu, aug_only)
    if "trainer_c" in phases:
        run("trainer_c", trainer_phase, "trainer_c", R50, FUSED, gpu, {"fused_aug": 1, "conv1x1_stats": 36})
    if "profile" in phases:
        run("profile", trainer_phase, "profile", R50, (), gpu, aug_only, profile_window=(2, 6))
        run("profile_c", trainer_phase, "profile_c", R50, FUSED, gpu, {"fused_aug": 1, "conv1x1_stats": 36},
            profile_window=(2, 6))
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    if phases != list(PHASES):
        print(f"chip_smoke: ran only {phases}; a full run prints the result lines", file=sys.stderr)
        return 0
    kernels = [results["fused_aug"], results["conv1x1_stats"], results["moments"]]
    # launches on each kernel's own main path: fused_aug on r50_baseline (trainer A),
    # conv1x1_stats with fused_stats (trainer C); no path calls moments
    kernels[0]["launches"] = results["trainer_a"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_hard_aug"] = results["trainer_b"]["kernel_launches"]["fused_aug"]
    kernels[1]["launches"] = results["trainer_c"]["kernel_launches"]["conv1x1_stats"]
    kernels[2]["launches"] = max(r["kernel_launches"]["moments"] for k, r in results.items() if k.startswith("trainer"))
    for k in kernels:
        k["gpu"] = gpu
    print(json.dumps({"kernels": kernels}))
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
