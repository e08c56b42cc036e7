#!/usr/bin/env python3
"""On-card smoke drive of the PyTorch/CUDA port (``sota_imagenet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels   # a subset, for iterating

Phases (each runs even if an earlier one failed, except that nothing runs
without a build; any failure exits non-zero and prints no result). They run
in this order: build, kernels, trainer A, then learn in a process of its
own beside the phases that check values and time nothing (the model phases,
model_ddp, model_mesh, wheel, serve, resume, and the soak's processes from
the start), then the other trainers (U and V after P1), bench_models, the data
phases and A's profile.

1. build   — compile every CUDA library of the port from ``csrc/`` with nvcc,
             one nvcc per source, all started together; print the build
             seconds and ptxas' resource lines of each.
2. kernels — hold each kernel against its plain PyTorch version on the card
             at the main path's shapes and a ragged one, and time it beside
             its bound: ``kernel_ms`` is the kernel's own device time
             (torch.profiler, device_ms), ``wrapper_ms`` a call through the
             port's wrapper, back to back between CUDA events (median_ms),
             and ``host_us`` the host's cost of one call at a toy shape;
             the plain version and (where one PyTorch call computes the same
             function) that library call are timed too. fused_aug:
             bit-exact, stages off and on. conv1x1_stats: the 15 shapes
             resnet50(fused_stats=True) launches at batch 256, 224 px (all
             on the sm90 kernel, bit for bit the same over two calls),
             ragged ones, the stride-2 NHWC wrapper and the backward
             (tolerances in conv_stats_phase). moments: three ResNet-50
             activation shapes and a ragged one (moments_phase).
3. model   — one f32 train step of full-width ResNet-50 (64 px, batch 8) on
             the card against the same step on the CPU, from the same seeded
             weights, unfused and with fused_stats (tolerances in
             model_phase); and one f32 step of a full-width, depth-cut NFNet
             with AdamW, accumulation 2 and the gain mask (nfnet_model_phase);
             and one of the 24.nf_conv-act trunk with LAMB and the ortho loss
             (nf_lamb_model_phase); and one of a depth-cut 80_1 trunk (UFO,
             XCA, GEM) with SGD and AGC (nondeep_model_phase); and one of
             full-width bresnet50 with weight standardisation, SiLU checked
             and leaky_relu reported (bresnet_model_phase); and one of a
             depth-cut config-8 BNet trunk with Novograd under config 9's
             ForwardWeightNorm, and again under ForwardSpectralNorm, whose
             u and v must agree too (bnet_model_phase). These last three
             hold loss to rtol 1e-5, grad_norm to 1e-5 of the CPU's float64
             step, the gradients to 1e-4 and the update to 1e-3 (_within).
             Then three steps of a depth-cut full-width ResNet-50 for each
             optimizer of the zoo, the projected sets of AdamP and SGDP
             equal on both sides, and the parameter histogram on the card
             against numpy (zoo_model_phase); one SAM step of a depth-cut
             24.nf_conv-act trunk per kind, bn_from_perturbed both ways,
             and the weights equal to the saved ones plus the optimizer's
             update (sam_model_phase). Then one f32 step of a trunk of the
             CModel table's new blocks (VGGBlock, ConvMixBlock, ConvResidual,
             FusedRepVGGBlock, Yolo5_C3, ConvMixerBlock, SphereMLPLayer) and
             one of vgg16_bn's layer list (cmodel_tables_model_phase); f32
             steps with each new criterion, two with sigmoid_trick's bias,
             AdaCos three with its state (losses_model_phase). The CPU
             steps of the phases built on _card_vs_cpu_step(s) (bresnet,
             bnet, zoo, sam, these two and model_legacy) run PyTorch's own
             convs, not oneDNN's (cpu_reference); the card's, through
             model_mesh, cuDNN's heuristic picks, not its autotuner's
             (_deterministic_cudnn).
3b. model_legacy — one f32 step on the card against the CPU of each legacy
             architecture with its config's optimizer, SiLU activations,
             64 px, batch 8: exp48's BNet trunk at full width (one block a
             stage), exp57's with weight standardisation and AdamP (the
             projected sets equal), exp26's csp_simpl_dark, a depth-cut
             densenet121 and the whole tresnetm (legacy_model_phase;
             tolerances as the model phases').
3c. model_remat, model_skip, model_debug_nans — the last trainer options
             on the card (f32, cuDNN deterministic where bits are compared):
             one step of a depth-cut bresnet50 with drop-path, the spectral
             config-8 BNet trunk and the adacos_sphere trunk under run.remat
             'full' and 'convs' against the same step without it (loss,
             gradients, buffers, AdaCos's state within 1e-6; bit-identity
             reported; remat_model_phase); run.skip_nonfinite's four cases
             and its lr lag on the tiny CModel, each held to the same steps
             on the CPU (skip_model_phase); debug_nans raising on a poisoned
             batch, and a clean run equal with and without it
             (debug_nans_model_phase).
4. trainer A — ``cli.main`` on configs/exp/1.r50_baseline.yaml (ResNet-50 at
             full width, batch 256 at 224 px, bf16, synthetic data, debug
             mode: 10 train steps and 20 val steps). Checks: finite loss, the
             launches of every kernel (one augment launch per train step),
             parameters and batches on cuda, model_last.ckpt written. Prints
             ms/step (median of steps 4-10, CUDA events), img/s and peak
             device memory. Its steps are never profiled (23).
5. trainer B — the same on configs/exp/3.r50_hard-aug_rand-interp.yaml with
             loader.re_prob=0.3: the kernel's colour, gray and erase stages
             and the blur run inside the trainer.
6. trainer C — trainer A with model={_target_: resnet50, fused_stats: true}:
             every 1x1 conv + BatchNorm of a train step goes through the
             conv1x1_stats kernel, 36 launches per step, all on its sm90
             path.
6b. trainer S, trainer C-remat — trainer A with run.remat=convs, whose
             steps 2-3 the config's own Profiler callback traces (the device
             breakdown read from its trace file, which must name fused_aug
             and cuDNN's convolutions; ms/step over steps 5-10); trainer C
             with run.remat=full: 72 conv1x1_stats launches a step, the
             forward's 36 and their recompute. Each beside A's or C's
             ms/step and peak memory.
7. trainer D — ``cli.main`` on configs/exp/15.eca_nfnet_l0.yaml as the file
             says but for synthetic data, debug mode and one 1-epoch warmup
             stage: full-width eca_nfnet_l0 (24.14M parameters), batch 256 at
             224 px, bf16, accumulate_steps 2 (a loader batch of 512 as two
             microbatches of 256), EMA 0.9997, CutmixMixup, drop
             rates 0.2/0.15, AdamW with ``filter_from_wd: [gain]``, the
             augment kernel with all its stages live. Checks as trainer A,
             and: the EMA differs from the weights, every gain sits in the
             parameter group without weight decay.
8. trainer E — ``cli.main`` on configs/tiny_synthetic.yaml as it stands (a
             CModel, f32, 32 px, two debug epochs): the train loss falls.
9. data    — writes a JPEG ImageFolder from a seed into a temporary
             directory (10 classes; 2,560 train images, 600 val; ~500x375,
             375x500 and 400x400, every 128th 1440x1080 or 1080x1440; one PNG
             and one grayscale JPEG per split; the class's colour over
             low-frequency noise), then: which decoder runs (the native
             libjpeg core, or PIL where it cannot be built) and the host's
             cores; device_resample of one loader batch (256 canvases of 560
             px) on the card against the CPU, at most 1 step on at most 0.1%
             of the values, and its time; the CPU resample against
             decode_train's host resize within 1 step; host decode img/s on 1
             and 6 threads (data_phase).
10. trainer F — ``cli.main`` on configs/exp/2.r50_rand_interp.yaml (ResNet-50,
             bs 256 @ 224, bf16, random interpolation) from that tree, debug
             mode, two epochs (the second, which starts with an empty
             prefetch buffer, is reported): checks as trainer A, 20 augment
             launches, and the val pass scores all 600
             images once (the masked tail: the val batches' ``_weight`` sum
             to 600). Prints ms/step, img/s, input_wait_share, data_time_s,
             the decoder's counts, the val pass's wall and the H2D MB per
             batch.
10b. trainer T — ``records tfrecord`` writes that tree as the reference's
             128 + 16 TFRecord shards (timed), and trainer F's config trains
             from them through the tfrecord backend: two epochs, 20 augment
             launches, all 600 val images scored once; its epoch img/s beside
             F's.
11. trainer G — the same tree on r50_baseline with loader.device_resample=true
             and val_loader.rectangular=true: 560 px canvases resampled on the
             card, then the augment kernel; val in three aspect shapes,
             weighted by ``_weight``.
12. packed, trainer H — packed records of that tree and r50 through the
             device cache (r50_hbm_cache.yaml; packed_phase, trainer_phase
             with ``cache``).
12b. learn — the accuracy proof with its serving closure (learn_phase), in
             a process of its own (LearnProcess) started after the kernels
             phase: it trains beside the model phases and model_ddp, which
             check values, time nothing and give the card little work, and
             ends before trainer A.
13. trainer I — ``cli.main`` on configs/exp/41.nf_conv-act_lamb.yaml as the
             file says but for synthetic data, debug mode and one 1-epoch
             stage of its cosine: the norm-free CModel of 24.nf_conv-act at
             full width (ConvActBlocks, VarEMA monitors, NormFreeBlockTimm
             with ECA), batch 224 at 224 px, bf16, CutmixMixup, LAMB (wd 5e-3,
             the gain mask), OrthoInitClb and OrthoLossClb type 1, the augment
             kernel with all its stages live. Checks as trainer A, and: after
             OrthoInitClb (a probe whose on_begin runs after it) the rows of a
             NormFreeBlockTimm's grouped 3x3 conv2 kernel are orthonormal
             within 1e-5, no gain is weight-decayed, a VarEMA std_ema has
             moved from 1. The model phase holds one f32 step of the same
             trunk (LAMB, OrthoLoss) on the card against the CPU
             (nf_lamb_model_phase).
14. trainer J — ``cli.main`` on configs/exp/80_1.non-deeps_ufo-0.5_no-res.yaml
             as the file says but for synthetic data, debug mode and one
             1-epoch stage of its cosine: the non-deep CModel at full width
             (SpaceToDepth-4 stem, 14 NonDeepBlocks with BatchNorm and
             scaled convs, 4 of them with UFO channel attention, the
             384-2048-2048-1000 head; 24.81M parameters), batch 224 at 224 px,
             bf16, SGD with the gain mask, CutmixMixup prob 1, AGC 0.01, the
             augment kernel with all its stages live. Checks as trainer A,
             and: no gain is weight-decayed, and AGC's record of the last
             step (a probe turns it on after step 9; device tensors, read at
             the epoch's end) shows it ran on the card over every unit of the
             model, clipped at least one, and left none over its bound. It
             reports the forward MACs (forward_gmac). The model phase holds
             one f32 step of a depth-cut trunk at 80_1's widths (UFO, XCA
             with and without v_norm, GEM, AGC) on the card against the CPU
             (nondeep_model_phase).
15. trainer K — ``cli.main`` on configs/exp/bresnet50.yaml as the file says
             but for synthetic data, debug mode and one 1-epoch stage of its
             warmup: full-width BResNet-50 (25.58M parameters; space2depth
             stem, BlurPool, ECA, leaky_relu), batch 256 at 224 px, bf16,
             weight standardisation (gamma 1.72) over its 53 ungrouped
             convs, EMA 0.9999, cutmix prob 1, drop 0.2/0.2, SGD, the
             augment kernel's colour stage live. Checks as trainer A, and:
             the EMA differs from the weights; the state_dict keys are an
             unwrapped bresnet50's; for a 3x3 and a 1x1 conv the effective
             weight has per-output-channel mean 0 (1e-5) and std
             1.72/sqrt(fan_in) (1e-3 relative), the raw weight does not
             (bresnet_checks).
16. trainer L — ``cli.main`` on configs/exp/51.r50_adamp.yaml as the file
             says but for synthetic data, debug mode and one 1-epoch stage
             of its warmup: ResNet-50, batch 192 at 224 px, bf16, AdamP (wd
             1e-2), OrthoInitClb, EMA 0.9993, colour twist 0.3,
             GradDistributionTB every 50 steps and log.histogram's
             WeightDistributionTB, both into an in-memory writer
             (RecordingWriter) that the Runner takes as its tb_writer.
             Checks as trainer A, and: the EMA moved, one parameter
             histogram (step 0) of sum(ceil(numel / 10)) values over the
             161 parameters, 161 weight histograms; reports how many of
             the 54 matrices AdamP projected each step.
17. trainer M — ``cli.main`` on configs/exp/32.nf_conv-act_sam.yaml as the
             file says but for synthetic data, debug mode and one 1-epoch
             stage of its cosine: the 24.nf_conv-act CModel at full width,
             batch 224 at 224 px, bf16, unit-wise SAM (rho 0.01), BAdam in
             AdamW mode, CutmixMixup prob 1. Checks as trainer A, and: two
             training forwards a step (a forward hook), a VarEMA moved, no
             gain decayed.
18. trainer N — ``cli.main`` on configs/exp/adacos_sphere.yaml as the file
             says but for synthetic data, debug mode and one 1-epoch stage
             of its warmup: seven ConvActBlocks, the SphereLinearLayer head,
             AdaCos (max_s 20), batch 256 at 160 px, bf16, SGD. Checks as
             trainer A, and: AdaCos's state after each step (device copies,
             read at the epoch's end) finite, its scale moved from 20; the
             val pass left it as the last step did; an eval resumed from
             model_last.ckpt restores it and leaves it so (_resume_eval).
19. trainer O — ``cli.main`` on configs/exp/66.conv-mix_original.yaml as the
             file says but for synthetic data, debug mode and one 1-epoch
             stage of its warmup: ConvMixer-768/30 (patch 7, kernel 7),
             batch 48 at 224 px, bf16, SGD. Checks as trainer A, and: 30
             ConvMixerBlocks, 19-21M parameters; reports the forward GMAC.
19b. trainer Q — ``cli.main`` on configs/old_exp/exp85-114/exp48.GEnet_no_dim_red_ctmx.yaml
             as the file says but for synthetic data, debug mode and one
             1-epoch stage of its warmup: BNet (Pre_XX, Pre_XX, Pre_IR,
             Pre_IR with 9x9 strided depthwise convs; s2d stem; widths
             128/192/640/1024, head 2560), batch 256 at 224 px, bf16, SGD,
             EMA 0.9993, cutmix, colour twist 0.4. Checks as trainer A, and:
             the EMA moved, the JAX model's parameter count, 14 BNetBlocks,
             every parameter decayed; reports the forward GMAC.
19c. trainer R — the same on configs/old_exp/first_attempts/effnetb0_tf.yaml
             with one 1-epoch stage of its poly decay: EfficientNet-B0
             (swish, drop 0.2, drop-connect 0.2), batch 384 at 224 px, val
             at 256, RMSprop, EMA 0.9999, cutmix, colour twist 0.4; the
             JAX model's parameter count and 16 MBConv blocks.
20. model_ddp — first a probe (ddp_probe_phase): two ranks on the card
             under gloo try each collective on CUDA tensors, and two under
             NCCL must be refused (one device). Then two float64 steps of
             each leg (model_ddp_phase: the truncated Bottleneck ResNet of
             tools/dryrun_multichip.py at 64 px, global batch 16, TF32 off,
             cuDNN deterministic) on two gloo ranks sharing the card against
             one process on it: SGD + EMA + sync-BN + cutmix; bn_stats local
             and 4; accumulation 2 with unit-wise SAM; ZeRO-1 under AdamW,
             AdaiS and Lookahead(SGD) against the replicated run (bit for
             bit; AdaiS within DDP_TOL); a depth-cut adacos_sphere trunk with
             AdaCos's state; FixMatchLoss, whose pairs straddle the ranks;
             run.remat 'convs'; ZeRO-1 with skip_nonfinite and a poisoned
             batch on rank 0 only, which both ranks skip. Both ranks'
             weights bit for bit equal.
21. trainer P — configs/exp/1.r50_baseline.yaml at full width through
             cli.main as two gloo ranks on the card (mesh.data=2,
             mesh.zero1=true; 128 of the 256 rows each, bf16, synthetic,
             debug, A's stage): ms/step and img/s of the global batch, the
             gradient all-reduce, BN and ZeRO-1 collectives a step (calls,
             bytes, ms), the gradient-sized all-reduce alone, peak memory per
             rank. Checks: the ranks' parameters and buffers bit for bit
             equal after step 10, fused_aug 10 in 10 on each rank,
             model_last.ckpt written once, an eval resumed from it on two
             ranks reproduces the run's val metrics exactly.
22. trainer P1 — the same config as one rank under NCCL, from torchrun's
             environment (WORLD_SIZE=1, mesh.data=-1): its ms/step against
             trainer A's is the cost of the port's collectives at one rank.
22a. model_mesh — the mesh's spatial and model axes on two gloo ranks
             sharing the card against one process on it (mesh_model_phase):
             i_spatial_2, the model_ddp truncated ResNet at 64 px in float64
             with mesh.spatial=2 (two steps, within DDP_TOL), and with
             fused_stats in float32 (conv1x1_stats on each rank's band; one
             step, MESH_FUSED_TOL: bf16 products); j_tp_2, the adacos_sphere
             trunk with mesh.model=2 and its SphereLinearLayer class-sharded.
             Then wheel (wheel_phase): a wheel of this checkout built
             offline, installed with pip --target outside it, imported by a
             fresh interpreter that has no directory of the checkout on its
             path, which builds fused_aug from the wheel's csrc/ and holds
             one launch against its plain version; then the installed
             sota-train-torch console script trains tiny_synthetic for one
             debug epoch on the card and exits 0.
22a'. trainers U and V — r50_baseline at full width through cli.main as two
             gloo ranks on the card with trainer P's batch on one data rank
             (trainer_mesh_phase): U with mesh.spatial=2 (a 112-row band of
             every image on each rank), V with mesh.model=2 (500 of the
             head's 1000 classes on each). ms/step, the halo, spatial-sum,
             spatial_gather and class collectives a step (calls, bytes, ms),
             peak memory and head bytes per rank; both ranks' weights equal
             and fused_aug 10 in 10 on each.
22b. serve — the serving path (serve_phase): trainer A's r50_baseline
             checkpoint, exported by ``cli export`` on the CPU in bf16
             (symbolic batch), float32 and int8, served on the card against
             the live module (bf16 top-1 equal on 250 rows, batch 1 served;
             float32 |dlogit| <= 1e-4; int8 under 0.35x of float32's bytes
             and equal to a float artifact of its dequantized weights);
             bresnet50's weight standardisation and the spectral BNet trunk
             inside their programs (within 1e-4 of the wrapped live
             modules); no custom op in any program (fused_stats too); no
             kernel of the port launched.
22b'. resume — trainer A's model_last.ckpt (SGD, step 10) resumed through
             cli.main under AdamW for one debug epoch (resume_phase): the
             weights bit for bit the checkpoint's at the first step, a fresh
             AdamW and step 0 (the JAX restore's params-only fallback), 10
             fused_aug launches, a finite loss; the same file under SGD
             restores the step and every momentum buffer bit for bit. Then
             how long a save holds its caller with the background write
             beside a synchronous save of the same payload (model.ckpt,
             model_last.ckpt), and how long trainer A's CheckpointSaver held
             its epoch loop (saver_timing); reported, not checked.
22c. soak — tools/soak.py with debug=true: configs/tpu_soak.yaml killed
             with SIGKILL once its checkpoint holds epoch 1, resumed with
             run.auto_resume=true at that epoch to the end across the
             160 -> 224 px boundary. Its two processes run beside serve,
             whose exports trace on one host core and whose checks on the
             card are of values, not of times.
22d. bench_models — tools/bench_models.py, alone on the card: the
             eval leg of its five families (batch 250, bf16, 224 px) and
             r50's train leg; serve's r50 artifact timed at batch 250 beside
             the live module.
23. profile — trainers C, D, H, I, J, K, L, M, O, Q and R run torch.profiler
             over their steps 2 and 3 (PROFILE), and their ms/step is the
             median of steps 5-10, which the profiler does not touch; trainer
             A's steps stay unprofiled, and its profile is a run of its own
             (the phase ``profile``). Each reports device time per step by
             group and the top kernels, and the device's busy share. D's, I's, J's, K's,
             L's, M's, O's, Q's and R's device time is attributed to the port's layers by
             the op that launched each kernel (layer_breakdown; UFO, XCA,
             GEM, AGC, the parametrization, BlurPool, drop-path, SAM's
             perturbation and copies and the parameter histogram each a
             group of its own, the depthwise convs apart from the grouped
             ones, the optimizer's step by its own scope, each layer's top
             kernels); I's must show the auxiliary loss's forward and
             backward in every profiled step. Q's and R's shares of their
             device step by depthwise convs, BatchNorm/ABN, BNet's partial
             residual (a scope of its own) and fused_aug are printed apart
             (legacy_layer_shares).

Trainers S and C-remat must peak below A and C in ``max_memory_allocated``
(run.remat's memory gate, checked after the trainers), and model_remat
counts conv1x1_stats a step under each remat policy on the full-width
fused_stats ResNet-50 (36, 72, 72).

Every kernel counter is set to 0 just before each trainer's ``cli.main`` and
read just after. The line before the last is the card's name and power
limit; before it, one JSON line ``{"kernels": [...]}``. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak


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


def device_ms(fn, fragment=None, calls: int = 20) -> float:
    """Device time of the kernels that one call of ``fn`` launches, from
    torch.profiler: the self device time of the CUDA kernels whose name holds
    ``fragment`` (every kernel if None) over ``calls`` calls after a warm-up,
    divided by ``calls``. A profile must show one such kernel per call (with
    no fragment, at least one kernel per call); the profiler now and then
    loses kernel records, so a short profile is taken again, up to 5
    times."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(5):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [
            e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and (fragment is None or fragment in e.key)
        ]
        count = sum(e.count for e in events)
        if count == calls or (fragment is None and count > calls):
            return sum(e.self_device_time_total for e in events) / calls / 1e3
        print(f"[kernels] the profile shows {count} kernels named *{fragment}* in {calls} calls: again", flush=True)
    raise AssertionError(f"5 profiles short of kernels named *{fragment}* in {calls} calls")


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn``: the host clock over back-to-back
    calls, at a shape whose kernels take less than the call, so the device
    never holds the host back."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


MODULES = ("fused_aug", "conv_stats", "moments", "nf_fused")  # under sota_imagenet_tpu_torch.ops, one library each


def build_phase() -> dict:
    """Build every library at once (one nvcc each) and print ptxas' lines."""
    import importlib

    from sota_imagenet_tpu_torch.ops import cuda_build

    def build(module):
        t0 = time.perf_counter()
        importlib.import_module(f"sota_imagenet_tpu_torch.ops.{module}").library()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(MODULES)) as pool:
        seconds = dict(zip(MODULES, pool.map(build, MODULES)))
    total = time.perf_counter() - t0
    print(f"[build] {len(MODULES)} libraries ready in {total:.2f} s: {json.dumps(seconds)}")
    for name in MODULES:
        sources = importlib.import_module(f"sota_imagenet_tpu_torch.ops.{name}")._SOURCES
        log = cuda_build.library_path(name, sources).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if ("ptxas info" in line and ("registers" in line or "Compiling" in line)) or "spill" in line:
                    print(f"[build]   {name}: {line.strip()}")
    return {"build_s": total, "per_library_s": seconds}


def kernel_phase() -> dict:
    """fused_aug against its plain version on the card; returns its JSON entry."""
    import torch

    from sota_imagenet_tpu_torch.ops.fused_aug import draw_augment_scalars, fused_augment, fused_augment_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    # the shapes and types the trainers give it: (256, 224, 224) bf16 (r50_baseline with the stages
    # off, the folder trainers; exp48's colour twist 0.4 alone, trainer Q), (512, 224, 224) bf16 (the
    # NFNet recipe's loader batch, 2 x 256 under accumulate_steps 2, stages on), (64, 32, 32) f32 with
    # the stages off (tiny_synthetic, run.bf16 false: the kernel's float instantiation), (384, 224,
    # 224) bf16 with effnetb0_tf's colour twist 0.4 (trainer R); and a toy shape with odd sides
    stage_probs = {"off": (0.0, 0.0, 0.0), "on": (0.4, 0.2, 0.3), "color_twist_0.4": (0.4, 0.0, 0.0)}
    for b, h, w, out_dtype, stage_sets in (
        (256, 224, 224, torch.bfloat16, ("off", "on", "color_twist_0.4")),
        (3, 37, 53, torch.bfloat16, ("off", "on")),
        (64, 32, 32, torch.float32, ("off", "on")),
        (512, 224, 224, torch.bfloat16, ("off", "on")),
        (384, 224, 224, torch.bfloat16, ("off", "color_twist_0.4")),
    ):
        imgs = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
        for stages in stage_sets:
            probs = stage_probs[stages]
            kw = dict(color_twist_prob=probs[0], gray_prob=probs[1], re_prob=probs[2], re_count=3)
            scalars = draw_augment_scalars(gen, b, device="cuda", **kw)
            out = fused_augment(imgs, scalars, out_dtype=out_dtype, **kw)
            ref = fused_augment_reference(imgs, scalars, out_dtype=out_dtype, **kw)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            n_bytes = imgs.numel() * (1 + out.element_size()) + scalars.numel() * 4  # u8 in, out, scalars

            def call():
                return fused_augment(imgs, scalars, out_dtype=out_dtype, **kw)

            case = {
                "shape": [b, h, w, 3],
                "out_dtype": str(out_dtype).removeprefix("torch."),
                "stages": stages,
                "max_abs_err": diff,
                "kernel_ms": device_ms(call, "fused_aug"),
                "wrapper_ms": median_ms(call, 10, 20),
                "plain_ms": median_ms(
                    lambda: fused_augment_reference(imgs, scalars, out_dtype=out_dtype, **kw), 5, 4
                ),
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            }
            if b == 3:  # the toy shape: what a call costs the host
                case["host_us"] = host_us(call)
            print(f"[kernels] fused_aug {case}")
            if diff != 0.0:
                where = f"{case['shape']} {case['out_dtype']} stages {stages}"
                raise AssertionError(f"fused_aug disagrees with its plain version at {where}: {diff}")
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
        "ms": main["kernel_ms"],  # device time of the kernel alone
        "wrapper_ms": main["wrapper_ms"],
        "host_us_toy": next(c["host_us"] for c in cases if "host_us" in c),  # (3, 37, 53, 3), stages off
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this function
        "cases": cases,
    }


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
    shapes (each on the sm90 kernel, and the same bit for bit over two
    calls), ragged shapes on both kernels and the stride-2 NHWC wrapper; its
    autograd backward against the plain version's autograd (rtol 1e-2 of the
    largest gradient: gy_tot is rounded to bf16 before the products, the
    plain version's f32 gradient only at the cast of x); times summed over
    the 36 launches of a train step."""
    import torch

    from sota_imagenet_tpu_torch.ops.conv_stats import (
        R50_SHAPES,
        conv1x1_stats,
        conv1x1_stats_nhwc,
        conv1x1_stats_reference,
        plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_path0 = dict(conv1x1_stats.launches_by_path)
    cases = []
    # the r50 shapes, then ragged ones: M on sm90, K % 8 != 0 and N % 8 != 0 on mma_sync
    for m, k, n, count in (*R50_SHAPES, (1000, 40, 72, 0), (1000, 40, 75, 0), (1000, 45, 72, 0)):
        # post-ReLU-like activations and fan-out-scaled weights, as in the net
        x = torch.rand((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device="cuda") * math.sqrt(2.0 / n)).to(torch.bfloat16)
        before = dict(conv1x1_stats.launches_by_path)
        y, s1, s2 = conv1x1_stats(x, w)
        again = conv1x1_stats(x, w)
        y_ref, _, _ = conv1x1_stats_reference(x, w)
        torch.cuda.synchronize()
        p = plan(m, k, n, x.data_ptr(), w.data_ptr(), sms)
        took = [path for path, v in conv1x1_stats.launches_by_path.items() if v != before[path]]
        case = {"shape": [m, k, n], "launches_per_step": count, "path": p.path, "tile_n": p.tile_n, "grid": p.grid}
        case["deterministic"] = all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
        case.update(_check_y(x, w, y, y_ref))
        case.update(_check_sums(y, s1, s2))
        del y, s1, s2, y_ref, again
        if took != [p.path] or (count and p.path != "sm90") or not case["deterministic"]:
            raise AssertionError(f"conv1x1_stats at {case['shape']}: launched {took}, planned {p}, {case}")
        n_bytes = 2 * (m * k + k * n + m * n) + 2 * 4 * n
        case["bound_ms"] = max(2 * m * k * n / BF16_FLOPS, n_bytes / HBM_BYTES_PER_S) * 1e3
        case["bound_by"] = "operations" if 2 * m * k * n / BF16_FLOPS > n_bytes / HBM_BYTES_PER_S else "bytes"

        def call():
            return conv1x1_stats(x, w)

        case["kernel_ms"] = device_ms(call, "conv1x1_stats")
        case["wrapper_ms"] = median_ms(call, 10, 10)
        if m == 1000:
            case["host_us"] = host_us(call)
        case["plain_ms"] = median_ms(lambda: conv1x1_stats_reference(x, w), 3, 2, warmup=1)
        wt = w.t()
        case["library_ms"] = device_ms(lambda: torch.matmul(x, wt))  # the product alone
        case["bound_share"] = case["bound_ms"] / case["kernel_ms"]
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
    by_path = {k: v - by_path0[k] for k, v in conv1x1_stats.launches_by_path.items()}
    print(f"[kernels] conv1x1_stats launches by path in this phase: {json.dumps(by_path)}")

    return {
        "name": "conv1x1_stats",
        "route": "cuda",
        "source": "sota_imagenet_tpu_torch/csrc/conv_stats_sm90.cu",  # the main path's kernel
        "general_source": "sota_imagenet_tpu_torch/csrc/conv_stats.cu",  # mma_sync: K or N % 8, unaligned bases
        "replaces": "sota_imagenet_tpu/ops/pallas_conv_stats.py:107",
        "launches": None,  # set from the main path's run (trainer C)
        "launches_by_path": None,  # likewise
        "max_abs_err": max(c["max_abs_err"] for c in (*cases, strided)),
        "ms": per_step("kernel_ms"),  # device time of the 36 launches of one train step
        "wrapper_ms": per_step("wrapper_ms"),
        "host_us_toy": cases[-3]["host_us"],  # 1000 x 40 x 72 on sm90
        "deterministic": all(c["deterministic"] for c in cases),
        "kernels_phase_launches_by_path": by_path,
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

        def call():
            return moments(x)

        case = {
            "shape": list(shape),
            "dtype": dtype,
            "max_abs_err": max(float((mean.double() - mean64).abs().max()), float((var.double() - var64).abs().max())),
            "err_over_tol": max(e_mean, e_var),
            "kernel_ms": device_ms(call, "moments_kernel"),
            "wrapper_ms": median_ms(call, 10, 10),
            "plain_ms": median_ms(lambda: moments_reference(x), 5, 4),
            "library_ms": device_ms(lambda: torch.var_mean(x, dims, correction=0)),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        }
        if shape[0] == 3:
            case["host_us"] = host_us(call)
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
        "ms": main["kernel_ms"],  # device time of the kernel alone
        "wrapper_ms": main["wrapper_ms"],
        "host_us_toy": cases[3]["host_us"],  # (3, 9, 5, 128) bf16
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main["library_ms"],  # torch.var_mean(x, (0, 1, 2), correction=0), its kernels' device time
        "cases": cases,
    }


def _nf_sites(batch: int = 2) -> dict:
    """The nf_fused calls of one train forward of eca_nfnet_l0 at 224 px, by
    shape: {"act": {(C, H, W, has bias): calls}, "tail": {(C, H, W, ECA):
    calls}, "ws": [[(weight, scale, eps), ...] of each nf_ws call]}, the
    weights as initialised, recorded by spies on a small batch on the card,
    as the main path calls them."""
    import torch

    from sota_imagenet_tpu_torch.models import nfnet
    from sota_imagenet_tpu_torch.ops import nf_fused

    sites = {"act": {}, "tail": {}, "ws": []}
    real = nf_fused.nf_act, nf_fused.nf_tail, nf_fused.nf_ws

    def act(x, bias, scale):
        key = (*x.shape[1:], bias is not None)
        sites["act"][key] = sites["act"].get(key, 0) + 1
        return real[0](x, bias, scale)

    def tail(h, bias, shortcut, eca_weight, *a):
        key = (*h.shape[1:], eca_weight is not None)
        sites["tail"][key] = sites["tail"].get(key, 0) + 1
        return real[1](h, bias, shortcut, eca_weight, *a)

    def ws(convs, dtype):
        sites["ws"].append([(w.detach().clone(), scale, eps) for w, _, scale, eps in convs])
        return real[2](convs, dtype)

    model = nfnet.eca_nfnet_l0(drop_path_rate=0.15, dtype=torch.bfloat16)
    model = model.to(device="cuda", memory_format=torch.channels_last).train()
    nf_fused.nf_act, nf_fused.nf_tail, nf_fused.nf_ws = act, tail, ws
    try:
        model(torch.zeros((batch, 224, 224, 3), device="cuda")).sum().backward()
    finally:
        nf_fused.nf_act, nf_fused.nf_tail, nf_fused.nf_ws = real
    return sites


def _one_ulp_over(got, want32, mag, rel: float = 2.0**-20) -> float:
    """The largest |got - want32| over one bf16 ulp of ``want32`` plus ``rel``
    of ``mag`` (tests/test_torch_nf_fused_cuda.py's tolerance): at most 1
    where bf16 ``got`` is the float32 ``want32`` rounded once."""
    import torch

    want32 = want32.float()
    exp = torch.floor(torch.log2(want32.abs().clamp_min(2.0**-126)))
    ulp = torch.exp2(exp - 7) + rel * mag.float()
    return float(((got.float() - want32).abs() / ulp).max())


def _sum_over(got, want) -> float:
    """The largest |got - want| over 1e-4 of |want| plus 1e-4 of the largest |want| (float32 sums in
    another order; the card tests' tolerance): at most 1 where they agree."""
    want = want.to(got.dtype)
    return float(((got - want).abs() / (1e-4 * want.abs() + 1e-4 * float(want.abs().max()) + 1e-30)).max())


def nf_fused_phase() -> dict:
    """nf_fused's kernels on the card at every distinct shape one train step
    of eca_nfnet_l0 gives them (_nf_sites), batch 256: ``nf_act``,
    ``nf_tail`` and ``nf_ws``, forward and backward through their autograd
    Functions, against their plain versions (``nf_*_reference``): bf16
    outputs within one bf16 ulp of the plain float32 result rounded once,
    float32 sums within 1e-4 (tests/test_torch_nf_fused_cuda.py's
    tolerances); a dropped sample's output exactly its shortcut. Each
    kernel's device time (the profiler), its bound (bytes once at 3.35
    TB/s) and the plain version's time on the card, summed over a train step
    (two microbatches of 256)."""
    import torch

    from sota_imagenet_tpu_torch.ops import nf_fused

    batch, microbatches, scale = 256, 2, 1.7881293296813965
    sites = _nf_sites()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def nhwc(c, h, w, std=1.0):
        x = torch.randn((batch, h, w, c), generator=gen, device="cuda") * std
        return x.to(torch.bfloat16).permute(0, 3, 1, 2)

    cases, worst = [], {"ulps": 0.0, "sums": 0.0}

    def check(case, ulps, sums):
        case["ulps_over_tol"], case["sums_over_tol"] = ulps, sums
        worst["ulps"], worst["sums"] = max(worst["ulps"], ulps), max(worst["sums"], sums)
        print(f"[kernels] nf_fused {json.dumps(case)}", flush=True)
        if ulps > 1.0 or sums > 1.0:
            raise AssertionError(f"nf_fused disagrees with its plain version: {case}")
        cases.append(case)

    for (c, h, w, has_bias), calls in sorted(sites["act"].items()):
        x = nhwc(c, h, w, 2.0).requires_grad_()
        bias = torch.randn(c, generator=gen, device="cuda").requires_grad_() if has_bias else None
        dy = nhwc(c, h, w)
        y = nf_fused.nf_act(x, bias, scale)
        dx, db = torch.autograd.grad(y, [x] if bias is None else [x, bias], dy) + ((None,) if bias is None else ())
        xf = x.detach().float()
        b = None if bias is None else bias.detach()
        z_mag = xf.abs() + (0.0 if b is None else b.abs().view(1, -1, 1, 1))
        want_dx, want_db = nf_fused.nf_act_grad_reference(dy.float(), xf, b, scale)
        ulps = max(_one_ulp_over(y, nf_fused.nf_act_reference(xf, b, scale), scale * z_mag),
                   _one_ulp_over(dx, want_dx, dy.float().abs() * scale * (1.0 + z_mag)))
        sums = 0.0 if b is None else _sum_over(db, want_db)
        xd = x.detach().contiguous(memory_format=torch.channels_last)
        dyc = dy.contiguous(memory_format=torch.channels_last)
        n = batch * c * h * w
        case = {"kernel": "nf_act", "shape": [batch, c, h, w], "bias": has_bias, "calls_per_microbatch": calls,
                "fwd_ms": device_ms(lambda: nf_fused._act_kernel(xd, b, scale)),
                "bwd_ms": device_ms(lambda: nf_fused._act_grad_kernel(dyc, xd, b, scale)),
                "bound_fwd_ms": 4 * n / HBM_BYTES_PER_S * 1e3, "bound_bwd_ms": 6 * n / HBM_BYTES_PER_S * 1e3,
                "plain_ms": median_ms(lambda: (nf_fused.nf_act_reference(xd, b, scale),
                                               nf_fused.nf_act_grad_reference(dyc, xd, b, scale)), 3, 2, warmup=1)}
        check(case, ulps, sums)
        del x, y, dx, dy, xd, dyc, xf, z_mag, want_dx
    for (c, h, w, eca), calls in sorted(sites["tail"].items()):
        hh, sc, dy = nhwc(c, h, w).requires_grad_(), nhwc(c, h, w).requires_grad_(), nhwc(c, h, w)
        bias = (torch.randn(c, generator=gen, device="cuda") * 0.2).requires_grad_()
        taps = torch.randn((1, 1, 3), generator=gen, device="cuda").requires_grad_() if eca else None
        gain = torch.full((), 0.5, device="cuda", requires_grad=True)
        mask = torch.rand(batch, generator=gen, device="cuda") < 0.85
        mask[0], mask[-1] = True, False
        k = 0.2 * (2.0 if eca else 1.0) / 0.85
        leaves = [t for t in (hh, bias, sc, taps, gain) if t is not None]
        out = nf_fused.nf_tail(hh, bias, sc, taps, gain, mask, k)
        grads = dict(zip(("dh", "db", "dsc", "dw", "dgain") if eca else ("dh", "db", "dsc", "dgain"),
                         torch.autograd.grad(out, leaves, dy)))
        hf, scf = hh.detach().float(), sc.detach().float()
        tp = None if taps is None else taps.detach()
        want, want_m = nf_fused.nf_tail_reference(hf, bias.detach(), scf, tp, gain.detach(), mask, k)
        wdh, wdb, wdw, wdgain = nf_fused.nf_tail_grad_reference(dy.float(), hf, bias.detach(), want_m, tp,
                                                                gain.detach(), mask, k)
        if not (torch.equal(out[~mask], sc.detach()[~mask]) and torch.equal(grads["dsc"], dy)):
            raise AssertionError(f"nf_tail at {[batch, c, h, w]}: a dropped sample is not its shortcut, or the "
                                 "shortcut's gradient is not dy")
        kmax = k * 0.5
        mag = scf.abs() + kmax * (hf.abs() + bias.detach().abs().view(1, -1, 1, 1))
        ulps = max(_one_ulp_over(out[mask], want[mask], mag[mask]),
                   _one_ulp_over(grads["dh"][mask], wdh[mask], (dy.float().abs() * kmax + wdh.abs())[mask], 1e-4))
        sums = max(_sum_over(grads["db"], wdb), _sum_over(grads["dgain"], wdgain),
                   _sum_over(grads["dw"], wdw) if eca else 0.0)
        hd, scd = hh.detach(), sc.detach()
        b, g = bias.detach(), gain.detach().reshape(1)
        m = nf_fused._tail_kernel(hd, b, scd, tp, g, mask, k)[1]
        n = batch * c * h * w
        case = {"kernel": "nf_tail", "shape": [batch, c, h, w], "eca": eca, "calls_per_microbatch": calls,
                "fwd_ms": device_ms(lambda: nf_fused._tail_kernel(hd, b, scd, tp, g, mask, k)),
                "bwd_ms": device_ms(lambda: nf_fused._tail_grad_kernel(dy, hd, b, m, tp, g, mask, k)),
                "bound_fwd_ms": ((2 if eca else 0) + 6) * n / HBM_BYTES_PER_S * 1e3,
                "bound_bwd_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
                "plain_ms": median_ms(lambda: (nf_fused.nf_tail_reference(hd, b, scd, tp, g, mask, k),
                                               nf_fused.nf_tail_grad_reference(dy, hd, b, m, tp, g, mask, k)),
                                      3, 2, warmup=1)}
        check(case, ulps, sums)
        del hh, sc, dy, out, grads, hf, scf, want, wdh, mag, hd, scd
    for group in sites["ws"]:
        # the model's initial weights, random gains (tests/test_torch_nf_fused_cuda.py's data)
        shapes = [tuple(w.shape) for w, _, _ in group]
        wd, scs, epss = [w for w, _, _ in group], [sc for _, sc, _ in group], [eps for _, _, eps in group]
        ws = [w.clone().requires_grad_() for w in wd]
        gains = [(torch.rand(s[0], generator=gen, device="cuda") * 2.0 + 0.1).requires_grad_() for s in shapes]
        dys = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16) for s in shapes]
        ys = nf_fused.nf_ws(list(zip(ws, gains, scs, epss)), torch.bfloat16)
        got = torch.autograd.grad(ys, [t for pair in zip(ws, gains) for t in pair], dys)
        gd = [g.detach() for g in gains]
        ulps = sums = 0.0
        for j, (w, g, sc_, eps) in enumerate(zip(wd, gd, scs, epss)):
            var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
            a = torch.rsqrt(var + eps) * sc_ * g.view(-1, 1, 1, 1)
            ulps = max(ulps, _one_ulp_over(ys[j], nf_fused.nf_ws_reference(w, g, sc_, eps), (w.abs() + mean.abs()) * a))
            want_dw, want_dg = nf_fused.nf_ws_grad_reference(dys[j].float(), w, g, sc_, eps)
            sums = max(sums, _sum_over(got[2 * j], want_dw), _sum_over(got[2 * j + 1], want_dg))
        stats = nf_fused._ws_kernel(wd, gd, scs, epss)[1]
        n = sum(math.prod(s) for s in shapes)
        case = {"kernel": "nf_ws", "shapes": [list(s) for s in shapes], "calls_per_microbatch": 1,
                "fwd_ms": device_ms(lambda: nf_fused._ws_kernel(wd, gd, scs, epss)),
                "bwd_ms": device_ms(lambda: nf_fused._ws_grad_kernel(dys, wd, gd, stats, scs)),
                "bound_fwd_ms": 6 * n / HBM_BYTES_PER_S * 1e3, "bound_bwd_ms": 10 * n / HBM_BYTES_PER_S * 1e3,
                "plain_ms": median_ms(lambda: [(nf_fused.nf_ws_reference(w, g, s, e),
                                                nf_fused.nf_ws_grad_reference(d, w, g, s, e))
                                               for w, g, s, e, d in zip(wd, gd, scs, epss, dys)], 3, 2, warmup=1)}
        check(case, ulps, sums)

    def per_step(key, kernel=None):
        return microbatches * sum(c[key] * c["calls_per_microbatch"] for c in cases
                                  if kernel is None or c["kernel"] == kernel)

    by_kernel = {}
    for kernel in ("nf_act", "nf_tail", "nf_ws"):
        ms = per_step("fwd_ms", kernel) + per_step("bwd_ms", kernel)
        bound = per_step("bound_fwd_ms", kernel) + per_step("bound_bwd_ms", kernel)
        by_kernel[kernel] = {"ms": ms, "bound_ms": bound, "bound_share": bound / ms,
                             "plain_ms": per_step("plain_ms", kernel)}
    ms = per_step("fwd_ms") + per_step("bwd_ms")
    bound = per_step("bound_fwd_ms") + per_step("bound_bwd_ms")
    print(f"[kernels] nf_fused per train step of 2 x 256: {json.dumps(by_kernel)}", flush=True)
    return {
        "name": "nf_fused",
        "route": "cuda",
        "source": "sota_imagenet_tpu_torch/csrc/nf_fused.cu",
        "replaces": None,  # no TPU kernel: XLA fuses these chains itself
        "launches": None,  # set from the main path's run (trainer D)
        "ulps_over_tol": worst["ulps"],
        "sums_over_tol": worst["sums"],
        "ms": ms,  # device time of the kernels of one train step, forward and backward
        "bound_ms": bound,
        "bound_by": "bytes",
        "bound_share": bound / ms,
        "plain_ms": per_step("plain_ms"),
        "library_ms": None,  # no single PyTorch call computes these chains
        "by_kernel": by_kernel,
        "times_are": "sums over one train step of eca_nfnet_l0, two microbatches of 256 at 224 px",
        "cases": cases,
    }


# --------------------------------------------------------------------------- #
# The folder data path: a JPEG ImageFolder written from a seed
# --------------------------------------------------------------------------- #

FOLDER_CLASSES, FOLDER_TRAIN, FOLDER_VAL = 10, 2560, 600  # 10 full steps at batch 256; val 600 = 2 x 250 + a padded 100
FOLDER_SIZES = ((500, 375), (375, 500), (400, 400))  # (w, h) around ImageNet's, one per rect bucket
FOLDER_BIG = ((1440, 1080), (1080, 1440))  # crops past the 560 px canvas: decode_train_scaled's host resize


def _folder_image(split: int, i: int, seed: int):
    """(PIL image, file suffix) of image i of a split: the class's colour over
    low-frequency noise (a 6x8 random image scaled up), so the files stay
    small and the class can be learned from the colour. Train image 3 and val
    image 3 are PNGs, image 4 of each a grayscale JPEG; every 128th image is
    large."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng((seed, split, i))
    c = i % FOLDER_CLASSES
    w, h = FOLDER_BIG[(i // 128) % 2] if i % 128 == 127 else FOLDER_SIZES[i % 3]
    colour = np.array([(37 * c) % 256, (101 * c + 60) % 256, (173 * c + 120) % 256], np.float32)
    noise = rng.integers(-40, 41, (6, 8, 3)).astype(np.float32)
    small = np.clip(colour + noise, 0, 255).astype(np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if i == 4:
        img = img.convert("L")
    return img, (".png" if i == 3 else ".jpg")


def write_imagefolder(root: str, seed: int = 0) -> dict:
    """root/{train,val}/class_<c>/<i>.jpg with FOLDER_TRAIN and FOLDER_VAL
    images, written by a thread per core; returns counts and seconds."""
    t0 = time.perf_counter()

    def write(job):
        split, i = job
        img, suffix = _folder_image(split, i, seed)
        d = os.path.join(root, ("train", "val")[split], f"class_{i % FOLDER_CLASSES:02d}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{i:05d}{suffix}")
        img.save(path, quality=90) if suffix == ".jpg" else img.save(path)
        return os.path.getsize(path)

    jobs = [(0, i) for i in range(FOLDER_TRAIN)] + [(1, i) for i in range(FOLDER_VAL)]
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        sizes = list(pool.map(write, jobs))
    return {"train": FOLDER_TRAIN, "val": FOLDER_VAL, "classes": FOLDER_CLASSES, "mbytes": sum(sizes) / 1e6,
            "write_s": time.perf_counter() - t0}


def _decode_rate(fn, paths, workers: int) -> float:
    """Images per second of ``fn(path, generator)`` over ``paths`` on ``workers`` threads."""
    import numpy as np

    jobs = [(p, np.random.default_rng((0, 0, k))) for k, p in enumerate(paths)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        for _ in pool.map(lambda job: fn(*job), jobs):
            pass
    return len(paths) / (time.perf_counter() - t0)


def data_phase(tree: str, gpu: str) -> dict:
    """The host half of the folder path and the device resample.

    1. The decoder this process uses (the native libjpeg core, or PIL where
       the library cannot be built) and the host's cores.
    2. One batch of the device-resample loader (256 canvases of 560 px from
       the tree, random interpolation) resampled to 224 px on the card
       against the same call on the CPU: at most 1 uint8 step anywhere, on at
       most 0.1% of the values; and its time on the card (CUDA events);
       then what pinning that 240.8 MB batch costs the host, and its copy to
       the card.
    3. The CPU resample of decode_train_scaled's canvas against decode_train's
       host resize of the same file with the same generator, 72 files: within
       1 step where both decode the same pixels (tests/test_device_resample.py
       holds JAX so). PIL decodes a large source in draft mode at a reduced
       DCT scale for decode_train but at full size for the canvas, so the
       large files (FOLDER_BIG) are reported, not held, when PIL decodes.
    4. Host decode rates (img/s) of decode_train and decode_train_scaled at
       224 px, on 1 thread and on loader.workers (6) threads, and of one epoch
       of the train FolderLoader alone (batch 256, 6 workers), host resize
       and device-resample canvases: the host side's ceiling for trainers F
       and G."""
    import numpy as np
    import torch

    from sota_imagenet_tpu_torch.data import decode as D
    from sota_imagenet_tpu_torch.data import native
    from sota_imagenet_tpu_torch.data.pipeline import FolderLoader, scan_image_folder
    from sota_imagenet_tpu_torch.ops.resample import device_resample

    decoder = "native" if native.available() else "pil"
    train = os.path.join(tree, "train")
    loader = FolderLoader(train, is_train=True, batch_size=256, image_size=224, workers=6,
                          random_interpolation=True, device_resample=True)
    it = iter(loader)
    canvases, _, meta = next(it)
    it.close()
    x, m = torch.from_numpy(canvases), torch.from_numpy(meta)
    on_cpu = device_resample(x, m, out_size=224)
    xd, md = x.cuda(), m.cuda()
    on_card = device_resample(xd, md, out_size=224).cpu()
    diff = (on_card - on_cpu).abs()
    card_vs_cpu = {"max_abs_err": float(diff.max()), "frac_diff": float((diff > 0).float().mean())}
    resample_ms = median_ms(lambda: device_resample(xd, md, out_size=224), 5, 3)
    del xd, md
    # what the feed's producer and copy stream pay for one 240.8 MB batch of canvases
    pin_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        pinned = x.pin_memory()
        pin_s.append(time.perf_counter() - t0)
    h2d_ms = median_ms(lambda: pinned.to("cuda", non_blocking=True), 3, 2)
    copy = {"batch_mb": x.numel() / 1e6, "pin_ms": [t * 1e3 for t in pin_s], "h2d_ms": h2d_ms,
            "h2d_gb_per_s": x.numel() / h2d_ms / 1e6}
    del pinned

    files, _, _ = scan_image_folder(train)
    picks = [p for p in files if os.path.basename(p).startswith(("00003", "00004"))]  # the PNG and the gray JPEG
    picks += files[::40][:64] + [p for p in files if int(os.path.basename(p)[:5]) % 128 == 127][:6]
    held, n_held, big = 0, 0, []
    for k, path in enumerate(picks):
        host = D.decode_train(path, np.random.default_rng((7, k)), 224, random_interpolation=True)
        canvas, sh, sw, filt = D.decode_train_scaled(path, np.random.default_rng((7, k)), 224, random_interpolation=True)
        dev = device_resample(torch.from_numpy(canvas[None]), torch.tensor([[sh, sw, filt]]), out_size=224)[0]
        err = int(np.abs(dev.numpy().astype(int) - host.astype(int)).max())
        is_big = int(os.path.basename(path)[:5]) % 128 == 127
        if is_big and decoder == "pil":
            big.append(err)
        else:
            held, n_held = max(held, err), n_held + 1
    sample = files[::5]

    def loader_rate(device_resample: bool) -> float:
        """img/s of one epoch of the train FolderLoader alone (batch 256, 6 workers): the host side's ceiling."""
        ld = FolderLoader(train, is_train=True, batch_size=256, image_size=224, workers=6,
                          random_interpolation=True, device_resample=device_resample)
        t0 = time.perf_counter()
        n = sum(batch[0].shape[0] for batch in ld)
        return n / (time.perf_counter() - t0)

    rates = {
        "folder_loader_host_resize_6": loader_rate(False),
        "folder_loader_device_resample_6": loader_rate(True),
        "decode_train_1": _decode_rate(lambda p, g: D.decode_train(p, g, 224, random_interpolation=True), sample[:96], 1),
        "decode_train_6": _decode_rate(lambda p, g: D.decode_train(p, g, 224, random_interpolation=True), sample[:512], 6),
        "decode_train_scaled_1": _decode_rate(lambda p, g: D.decode_train_scaled(p, g, 224), sample[:96], 1),
        "decode_train_scaled_6": _decode_rate(lambda p, g: D.decode_train_scaled(p, g, 224), sample[:512], 6),
    }
    result = {
        "phase": "data",
        "decoder": decoder,
        "native_library": native.LIB_PATH if decoder == "native" else None,
        "cpu_count": os.cpu_count(),
        "resample_card_vs_cpu": card_vs_cpu,
        "resample_ms_b256_560_to_224": resample_ms,
        "canvas_batch_pin_and_copy": copy,
        "host_vs_device_resample_max_step": held,
        "host_vs_device_resample_files_held": n_held,
        "host_vs_device_resample_big_sources_pil": big,
        "decode_img_per_s": rates,
        "gpu": gpu,
    }
    print(f"[data] {json.dumps(result)}")
    if card_vs_cpu["max_abs_err"] > 1.0 or card_vs_cpu["frac_diff"] > 1e-3:
        raise AssertionError(f"device_resample on the card disagrees with the CPU: {card_vs_cpu}")
    if held > 1:
        raise AssertionError(f"the CPU resample is {held} steps off decode_train's host resize")
    return result


def pack_tree(tree: str, out: str) -> dict:
    """Packed records of the JPEG tree at 224 px, written by a process per
    core (spawned: this process holds CUDA); what it took."""
    from sota_imagenet_tpu_torch.data import native, records
    from sota_imagenet_tpu_torch.data.packed import create_packed_records

    workers = os.cpu_count() or 8
    t0 = time.perf_counter()
    create_packed_records(tree, out, image_size=224, workers=workers)
    seconds = time.perf_counter() - t0
    n = FOLDER_TRAIN + FOLDER_VAL
    return {"images": n, "seconds": seconds, "img_per_s": n / seconds, "workers": workers, "crc32c": records.CRC32C,
            "decoder": "native" if native.available() else "pil"}


def packed_phase(packed_root: str, packing: dict, gpu: str) -> dict:
    """The packed tier and the device cache, apart from a trainer.

    1. One epoch of the train PackedLoader alone (batch 256, 6 workers): img/s.
    2. The cache's fill of the train split from a PackedLoader, chunked (256
       MB) and monolithic: MB, seconds and MB/s (the loader's reading
       included); the two caches hold the same bytes.
    3. One batch of the cache (the identity in place of the augment) against
       the packed records it came from: the rows the cache drew, epoch 0's
       permutation from (0x5EED, 0, 0), are the records at those positions
       of the loader's epoch-0 order (seed 42), pixel for pixel, and their
       labels.
    4. The gather of one batch (torch.index_select of 256 rows) on the card,
       CUDA events, against its bound: 2 x 38.5 MB at 3.35 TB/s."""
    import numpy as np
    import torch

    from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
    from sota_imagenet_tpu_torch.data.packed import PackedLoader

    def loader(workers=6):
        return PackedLoader(packed_root, is_train=True, batch_size=256, image_size=224, workers=workers)

    t0 = time.perf_counter()
    n = sum(batch[0].shape[0] for batch in loader())
    loader_rate = n / (time.perf_counter() - t0)

    def identity(generator, images, labels):
        return {"image": images, "label": labels}

    fills, caches = {}, {}
    for mode, chunk_mb in (("chunked_256mb", 256), ("monolithic", 0)):
        feed = DeviceCacheFeed(loader(), identity, device="cuda", fill_chunk_mb=chunk_mb)
        feed.ensure_filled()
        fills[mode] = {"mb": feed.fill_mb, "s": feed.fill_s, "mb_per_s": feed.fill_mb / feed.fill_s}
        caches[mode] = feed
    chunked, mono = caches["chunked_256mb"], caches["monolithic"]
    n_per = chunked._n_per_shard
    same = (n_per == mono._n_per_shard and torch.equal(chunked.images[:n_per], mono.images[:n_per])
            and torch.equal(chunked.labels[:n_per], mono.labels[:n_per]))
    del mono, caches

    batch = next(iter(chunked))
    rows = np.random.default_rng((0x5EED, 0, 0)).permutation(n_per)[:256]
    ref = loader(workers=1)
    order = np.arange(len(ref.entries))
    np.random.default_rng(ref.seed + 0).shuffle(order)  # the stream the fill read: epoch 0's order
    want = [ref._load_one(ref.entries[order[r]]) for r in rows]
    images_equal = bool((batch["image"].cpu().numpy() == np.stack([w[0] for w in want])).all())
    labels_equal = batch["label"].cpu().tolist() == [w[1] for w in want]

    idx = torch.from_numpy(rows).cuda()
    gather_ms = median_ms(lambda: torch.index_select(chunked.images, 0, idx), 10, 20)
    gather_bytes = 2 * 256 * 224 * 224 * 3
    result = {
        "phase": "packed",
        "packing": packing,
        "loader_img_per_s_6_workers": loader_rate,
        "fill": fills,
        "caches_equal": same,
        "batch_equals_records": images_equal and labels_equal,
        "gather_ms_b256": gather_ms,
        "gather_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
        "cache_rows": n_per,
        "gpu": gpu,
    }
    print(f"[packed] {json.dumps(result)}")
    if not same:
        raise AssertionError("the chunked fill's cache differs from the monolithic fill's")
    if not (images_equal and labels_equal):
        raise AssertionError(f"a cache batch differs from its records: images {images_equal}, labels {labels_equal}")
    if n_per != FOLDER_TRAIN:
        raise AssertionError(f"the train cache holds {n_per} rows, want {FOLDER_TRAIN}")
    return result


def learn_phase(gpu: str) -> dict:
    """tools/accuracy_proof.main, 30 epochs on the hue corpus with
    configs/tpu_accuracy.yaml as it stands: best val Acc@1 >= 90, the
    script's own criterion; its serving closure (the EMA weights exported on
    the CPU, served on the card over the val folder) within 2.0 points of the
    final val Acc@1; and one augment launch per train step (2,000 images at
    batch 64 with drop-last: 31 steps an epoch), none in the closure."""
    from sota_imagenet_tpu_torch.tools import accuracy_proof

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0  # counts from here are this path's
    t0 = time.perf_counter()
    proof = accuracy_proof.main(["--epochs", str(LEARN_EPOCHS)])
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    result = {"phase": "learn", **proof, "wall_s": wall, "kernel_launches": launches, "gpu": gpu}
    print(f"[learn] {json.dumps(result)}")
    if not proof["ok"]:
        raise AssertionError(f"learn: best val Acc@1 {proof['best_acc1']} below 90 in {LEARN_EPOCHS} epochs, or the "
                             f"exported artifact's {proof['artifact_acc1']} more than 2.0 from the final "
                             f"{proof['final_acc1']}")
    steps = LEARN_EPOCHS * (accuracy_proof.N_CLASSES * accuracy_proof.TRAIN_PER_CLASS // 64)
    if launches != {"fused_aug": steps, "conv1x1_stats": 0, "moments": 0}:
        raise AssertionError(f"learn: kernel launches {launches}, want {steps} augment launches")
    return result


LEARN_EPOCHS = 30


@contextlib.contextmanager
def _count_h2d(counter: dict):
    """Count the bytes DeviceFeed copies to the card, per train and val
    batch, and the bytes the device cache copies after its fill (its index
    rows), per split."""
    from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
    from sota_imagenet_tpu_torch.data.pipeline import DeviceFeed

    original, original_cache = DeviceFeed._to_device, DeviceCacheFeed._to_device

    def counted(self, tensors, copy_stream):
        split = "train" if getattr(self.host, "is_train", False) else "val"
        counter[split + "_bytes"] = counter.get(split + "_bytes", 0) + sum(t.numel() * t.element_size() for t in tensors)
        counter[split + "_batches"] = counter.get(split + "_batches", 0) + 1
        return original(self, tensors, copy_stream)

    def counted_cache(self, array):
        key = "cache_" + ("train" if self.is_train else "val") + "_bytes"
        counter[key] = counter.get(key, 0) + array.nbytes
        return original_cache(self, array)

    DeviceFeed._to_device, DeviceCacheFeed._to_device = counted, counted_cache
    try:
        yield counter
    finally:
        DeviceFeed._to_device, DeviceCacheFeed._to_device = original, original_cache


TRAINER_OVERRIDES = (
    "loader.backend=synthetic",
    "val_loader.backend=synthetic",
    "debug=true",  # 10 train steps, 20 val steps
    "run.stages=[{start: 0, end: 1, lr: [0.001, 1.0]}]",
)


CACHE_OVERRIDES = (
    "debug=true",  # 10 train steps, 20 val steps an epoch
    "run.stages=[{start: 0, end: 2, lr: [0.001, 1.0]}]",
)


def folder_overrides(tree: str) -> tuple:
    """The JPEG ImageFolder at ``tree`` for train and val, debug mode, and two
    epochs: the feed's producer decodes ahead into up to five batches (its
    queue of 2, 3 copied to the card) while the first step waits on cuDNN's
    autotuning, so the first epoch's later steps run from that buffer. The
    second epoch starts with an empty buffer and shows the steady state,
    which the probe reports."""
    return (
        "loader.backend=folder",
        "val_loader.backend=folder",
        f"loader.root_data_dir={tree}",
        f"val_loader.root_data_dir={tree}",
        "debug=true",  # 10 train steps, 20 val steps an epoch
        "run.stages=[{start: 0, end: 2, lr: [0.001, 1.0]}]",
    )


class RecordingWriter:
    """The SummaryWriter methods the TensorBoard sinks call, kept in memory,
    so a trainer's sinks run on the card whether or not the tensorboard
    package is installed there."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append({"kind": "scalar", "tag": tag, "step": step})

    def add_histogram(self, tag, values, step):
        self.calls.append({"kind": "histogram", "tag": tag, "step": step})

    def add_histogram_raw(self, tag, min, max, num, sum, sum_squares, bucket_limits, bucket_counts, global_step):
        self.calls.append({"kind": "histogram_raw", "tag": tag, "step": global_step, "num": num, "min": min,
                           "max": max, "buckets": len(bucket_counts)})

    def close(self):
        pass


def _probe_callback(profile_window=None, record_shapes=False):
    """A host callback that records a CUDA event after each train step is
    queued (no host sync: read once at epoch end), and where the run's
    parameters and batches live. With ``profile_window=(a, b)`` it also runs
    torch.profiler from the end of step a to the end of step b (0-based),
    synchronising at both ends; that perturbs those steps' times."""
    import torch

    from sota_imagenet_tpu_torch.train.callbacks import Callback

    class Probe(Callback):
        prof = None
        ortho = None
        agc = None
        agc_stats = None
        writer = None  # set to a RecordingWriter, it becomes the Runner's tb_writer (the last callback's writer)
        train_forwards = 0

        def on_begin(self):
            self.projected = []  # AdamP's / SGDP's device booleans of each step, read at the epoch's end
            model = self.runner.state.model

            def count(module, args, out):
                if module.training:
                    self.train_forwards += 1

            if not getattr(model, "_probe_hooked", False):
                model.register_forward_hook(count)
                model._probe_hooked = True
            # the run's AGC transform, if the config names the callback: it records its last step (below)
            from sota_imagenet_tpu_torch.train.callbacks import AdaptiveGradientClipping

            self.agc = next((c.transform for c in self.runner.callbacks if isinstance(c, AdaptiveGradientClipping)), None)
            # after OrthoInitClb's on_begin (cli.main puts the config's callbacks first): the rows of one
            # NormFreeBlockTimm's grouped 3x3 conv2 kernel, as the step will first read them
            from sota_imagenet_tpu_torch.models.blocks import NormFreeBlockTimm

            block = next((m for m in self.runner.state.model.modules() if isinstance(m, NormFreeBlockTimm)), None)
            if block is not None:
                w = block.conv2.weight.detach().float()
                rows = w.reshape(w.shape[0], -1)
                err = (rows @ rows.T - torch.eye(rows.shape[0], device=rows.device)).abs().max()
                self.ortho = {"shape": list(w.shape), "groups": block.conv2.groups, "max_abs_gram_minus_eye": float(err)}

        def on_epoch_begin(self, epoch):
            self.events = [torch.cuda.Event(enable_timing=True)]
            self.events[0].record()
            self.loss_states = []  # a stateful criterion's state after each step (device copies)
            self.metric_devices = set()
            self.val_batches = []  # (_weight tensor or None, image shape) of each val batch
            for name in ("_eval_step", "_eval_step_ema"):  # built by now; wrapped once
                step = getattr(self.runner, name)
                if not getattr(step, "probed", False):

                    def probed(state, batch, step=step):
                        m = step(state, batch)
                        self.val_batches.append((m.get("_weight"), tuple(batch["image"].shape)))
                        return m

                    probed.probed = True
                    setattr(self.runner, name, probed)

        def on_batch_end(self, step, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            opt = getattr(self.runner.state.optimizer, "inner", self.runner.state.optimizer)
            if getattr(opt, "projected", None) is not None:
                self.projected.append(opt.projected)
            loss_state = self.runner.state.loss_state
            if loss_state is not None:
                self.loss_states.append({k: v.clone() for k, v in loss_state.items()})
            if self.agc is not None and step == 8:
                # AGC keeps device tensors about the next (last) step's clip: no host read inside any step
                self.agc.record = True
            self.metric_devices.add(metrics["loss"].device.type)
            # the train steps' peak once cuDNN's autotuning (steps 1-2) is done: an allocator counter, no sync
            if step == 1:
                self.warm_peak = torch.cuda.max_memory_allocated()  # steps 1-2, autotuning included
                torch.cuda.reset_peak_memory_stats()
            elif step > 1:
                self.steady_peak = torch.cuda.max_memory_allocated()
            if profile_window and step == profile_window[0]:
                torch.cuda.synchronize()
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                self.prof = torch.profiler.profile(activities=acts, record_shapes=record_shapes)
                self.prof.start()
                self.prof_t0 = time.perf_counter()
            elif profile_window and step == profile_window[1]:
                torch.cuda.synchronize()
                self.prof_wall_ms = (time.perf_counter() - self.prof_t0) * 1e3
                self.prof.stop()
            self.last_step_t = time.perf_counter()

        def on_epoch_end(self, epoch, train_metrics, val_metrics):
            torch.cuda.synchronize()
            self.epoch_times_s = [*getattr(self, "epoch_times_s", []), train_metrics["epoch_time_s"]]
            # the val pass's wall, from the last train step's dispatch: its decode, copies and
            # (rectangular val) cuDNN's autotuning of each new shape, not a steady-state time
            self.val_pass_s = [*getattr(self, "val_pass_s", []), time.perf_counter() - self.last_step_t]
            self.val_weights = [None if w is None else float(w) for w, _ in self.val_batches]
            self.val_shapes = sorted({shape for _, shape in self.val_batches})
            self.step_ms = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
            self.param_devices = {p.device.type for p in self.runner.state.model.parameters()}
            self.train_metrics = dict(train_metrics)
            self.train_metrics_by_epoch = [*getattr(self, "train_metrics_by_epoch", []), dict(train_metrics)]
            self.batch_size = self.runner.batch_size
            state = self.runner.state
            self.ema_differs = state.ema is not None and any(
                not torch.equal(a, b) for a, b in zip(state.ema.state_dict().values(), state.model.state_dict().values())
            )
            self.std_emas = [float(b) for n, b in state.model.named_buffers() if n.endswith("std_ema")]
            self.loss_state_per_step = [{k: float(v) for k, v in ls.items()} for ls in self.loss_states]
            # after the epoch's val pass, which reads the state and must leave it as the last step left it
            self.loss_state_after_val = None if state.loss_state is None else {
                k: float(v) for k, v in state.loss_state.items()}
            self.projected_per_step = [int(x) for x in torch.stack([p.sum() for p in self.projected]).tolist()] \
                if self.projected else []
            self.matrices = len(self.projected[0]) if self.projected else 0
            if self.agc is not None and self.agc.stats is not None:
                self.agc.record = False
                st = self.agc.stats
                self.agc_stats = {"device": st["max_ratio_after"].device.type, "units": int(st["units"]),
                                  "clipped": int(st["clipped"]), "max_ratio_after": float(st["max_ratio_after"])}
            names = {id(p): n for n, p in state.model.named_parameters()}
            self.weight_decay_of = {
                names[id(p)]: g["weight_decay"] for g in state.optimizer.param_groups for p in g["params"]
            }

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


def nfnet_model_phase() -> dict:
    """One f32 train step of a full-width, depth-cut NFNet (one block per
    stage, channels 256-512-1536-1536, ECA) on the card against the same step
    on the CPU: same seeded weights with every skipinit_gain set to 1 (zero at
    init, which would switch the branches off), one batch of 8 images at
    64 px, AdamW (wd 1e-3, eps 1e-6) with the gain mask, accumulate_steps 2,
    lr 0.01, TF32 off. SiLU is smooth, so the tolerances are loss rtol 1e-4,
    grad_norm rtol 1e-2, updated state within relative L2 1e-2. Adam's first
    step moves every weight by lr * g / (|g| + eps), so a gradient element
    within rounding of zero could move its weight by up to 2 * lr the other
    way; with eps 1e-6 few do: on an NVIDIA H100 80GB HBM3 (700 W) the card
    was 6.9e-8 (loss), 2.6e-4 (grad_norm) and 4.4e-6 (state) off the CPU."""
    import torch

    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models import NFNet
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    optim = {"_target_": "adamw", "weight_decay": 1e-3, "eps": 1e-6}
    runs = []  # (loss, grad_norm, flat state) on the CPU, then on the card
    for dev in ("cpu", "cuda"):
        model = NFNet(depths=(1, 1, 1, 1))
        mask = filter_from_weight_decay(model.named_parameters(), ["gain"])
        state = steps.init_state(
            model, lambda m: build_optimizer(optim, m.named_parameters(), wd_mask=mask), device=dev, seed=0
        )
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("skipinit_gain"):
                    p.fill_(1.0)
        step = steps.build_train_step(
            CrossEntropyLoss(smoothing=0.1), lambda i: 0.01, accumulate_steps=2, input_dtype=torch.float32
        )
        state, m = step(state, {"image": images.to(dev), "label": labels.to(dev)})
        flat = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        runs.append((float(m["loss"]), float(m["grad_norm"]), flat))
    (loss_c, gn_c, sd_c), (loss_g, gn_g, sd_g) = runs
    result = {
        "phase": "model_nfnet",
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "grad_norm_rel": abs(gn_g - gn_c) / abs(gn_c),
        "state_rel_l2": float((sd_g - sd_c).norm() / sd_c.norm()),
        "loss": [loss_c, loss_g],
        "grad_norm": [gn_c, gn_g],
    }
    print(f"[model_nfnet] {json.dumps(result)}")
    if not (result["loss_rel"] < 1e-4 and result["grad_norm_rel"] < 1e-2 and result["state_rel_l2"] < 1e-2):
        raise AssertionError(f"NFNet train step on the card disagrees with the CPU: {result}")
    return result


def nf_lamb_model_phase() -> dict:
    """One f32 train step of the 24.nf_conv-act trunk at full width (its YAML's
    layer list, 64 px, batch 8) on the card against the same step on the CPU,
    from the same seeded weights: LAMB through badam (wd 5e-3, eps 1e-6) with
    the gain mask, OrthoLossClb type 1 (min_filters 64, min_norm 0.1, weight
    1e-3) as the auxiliary loss, lr 0.003, TF32 off; drop-path and dropout
    off (their draws differ between the two generators). Tolerances as the
    NFNet case's: loss rtol 1e-4, grad_norm rtol 1e-2, and, since LAMB moves
    each parameter by lr = 0.003 of its norm (so the whole state moves by
    ~3e-3), the update (state after minus state before) within relative L2
    1e-2, and the VarEMA statistics within rtol 1e-4. swish_hard has kinks
    at -3 and 3: a float32 rounding that moves a pre-activation across one
    moves a few gradient elements, which these tolerances absorb. On an
    NVIDIA H100 80GB HBM3 (700 W) the card was 6.1e-8 (loss), 6.8e-7
    (grad_norm), 1.6e-5 (update) and 6.2e-8 (std_ema) off the CPU."""
    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models.layers import DropPath, Dropout
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.callbacks import OrthoLossClb
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    cfg = C.load(NF_LAMB, strict_env=False)
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    aux = OrthoLossClb(type=1, weight=1e-3, min_filters=64, min_norm=0.1).step_options()["aux_loss"]
    runs = []  # (loss, grad_norm, state before, state after, VarEMA std_emas) on the CPU, then on the card
    for dev in ("cpu", "cuda"):
        model = cli.build_model(cfg)
        for m in model.modules():
            if isinstance(m, DropPath):
                m.keep_prob = 1.0
            elif isinstance(m, Dropout):
                m.rate = 0.0
        mask = filter_from_weight_decay(model.named_parameters(), cfg.filter_from_wd)
        state = steps.init_state(
            model, lambda m: build_optimizer(dict(cfg.optim), m.named_parameters(), wd_mask=mask), device=dev, seed=0
        )
        before = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda i: 0.003, input_dtype=torch.float32,
                                      aux_loss=aux)
        state, m = step(state, {"image": images.to(dev), "label": labels.to(dev)})
        after = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        std_emas = torch.tensor([float(b) for n, b in state.model.named_buffers() if n.endswith("std_ema")])
        runs.append((float(m["loss"]), float(m["grad_norm"]), before, after, std_emas))
    (loss_c, gn_c, b_c, a_c, s_c), (loss_g, gn_g, b_g, a_g, s_g) = runs
    result = {
        "phase": "model_nf_lamb",
        "optimizer": type(state.optimizer).__name__,
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "grad_norm_rel": abs(gn_g - gn_c) / abs(gn_c),
        "init_equal": bool(torch.equal(b_c, b_g)),
        "update_rel_l2": float(((a_g - b_g) - (a_c - b_c)).norm() / (a_c - b_c).norm()),
        "state_rel_l2": float((a_g - a_c).norm() / a_c.norm()),
        "update_over_state": float((a_c - b_c).norm() / b_c.norm()),
        "std_ema_rel": float(((s_g - s_c).abs() / s_c.abs()).max()),
        "loss": [loss_c, loss_g],
        "grad_norm": [gn_c, gn_g],
    }
    print(f"[model_nf_lamb] {json.dumps(result)}")
    if not (result["init_equal"] and result["optimizer"] == "Lamb" and result["loss_rel"] < 1e-4
            and result["grad_norm_rel"] < 1e-2 and result["update_rel_l2"] < 1e-2 and result["std_ema_rel"] < 1e-4):
        raise AssertionError(f"NF/LAMB train step on the card disagrees with the CPU: {result}")
    return result


# 80_1's stem and widths cut in depth: one block per width, an 80_1 UFO block, one with 84's and one with 84_1's
# xca_kwargs, and 83's GEM head
NONDEEP_TRUNK = """
- [-1, 1, "pt.modules.SpaceToDepth", 4]
- [-1, 1, NonDeepBlock, [48, 128]]
- [-1, 1, NonDeepBlock, [128, 128]]
- [-1, 1, "nn.AvgPool2d", [2, 2]]
- [-1, 1, NonDeepBlock, [128, 256]]
- [-1, 1, NonDeepBlock, [256, 256]]
- [-1, 1, "nn.AvgPool2d", [2, 2]]
- [-1, 1, NonDeepBlock, [256, 384]]
- [-1, 1, NonDeepBlock, [384, 384], {ufo_kwargs: {residual: False, last_proj: True}}]
- [-1, 1, NonDeepBlock, [384, 384], {xca_kwargs: {residual: True, last_proj: True}}]
- [-1, 1, NonDeepBlock, [384, 384], {xca_kwargs: {residual: True, last_proj: True, v_norm: True}}]
- [-1, 1, GEM_pool]
- [-1, 1, "nn.Linear", [384, 2048]]
- [-1, 1, nn.Hardswish]
- [-1, 1, "nn.Linear", [2048, 2048]]
- [-1, 1, nn.Hardswish]
- [-1, 1, "nn.Linear", [2048, 1000]]
"""


def nondeep_model_phase() -> dict:
    """One f32 train step of a depth-cut 80_1 trunk at full width
    (NONDEEP_TRUNK: the SpaceToDepth-4 stem, BatchNorm and the scaled convs
    of 80_1's extra_kwargs, UFO, XCA with and without v_norm, GEM) on the
    card against the same step on the CPU, from the same seeded weights: one
    batch of 8 images at 64 px, SGD (momentum 0.9, wd 3e-5, the gain mask)
    with AGC 0.01 through AdaptiveGradientClipping, lr 0.1, TF32 off. The
    same step in float64 on the CPU is the scale of float32's own error
    (``cpu_f32_vs_f64``; UFO and XCA still take q, k, v in float32 there, as
    the JAX modules do).

    Tolerances: loss rtol 1e-5; the clipped gradients within relative L2
    1e-4 (float32 rounding, ~5e-6 between the CPU's float32 and float64
    steps: ``cpu_f32_vs_f64``); the step's reported grad_norm rtol 1e-4,
    because the CPU's float32 ``torch._foreach_norm`` of the large head
    kernels is less exact than the card's reduction: the CPU's grad_norm is
    the one off the float64 step (PERF.md section 6); the update (state after
    minus state before, BatchNorm's running statistics included, which it
    mostly is) within relative L2 1e-3. The two AGC records (units, units
    clipped) agree, but for one unit at its bound."""
    import torch
    import yaml

    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.callbacks import AdaptiveGradientClipping
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    cfg = C.load(NONDEEP, strict_env=False)
    extra = C.to_dict(cfg.model)["extra_kwargs"]
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    runs = {}  # (device, dtype) -> loss, grad_norm, clipped gradients, state before, state after, AGC record
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64)):
        model = CModel(layer_config=yaml.safe_load(NONDEEP_TRUNK), extra_kwargs=extra)
        mask = filter_from_weight_decay(model.named_parameters(), cfg.filter_from_wd)
        state = steps.init_state(
            model, lambda m: build_optimizer(dict(cfg.optim), m.named_parameters(), wd_mask=mask), device=dev, seed=0
        )
        model.to(dt)
        before = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        clip = AdaptiveGradientClipping(clip_factor=0.01)
        clip.transform.record = True
        step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda i: 0.1, input_dtype=dt,
                                      **clip.step_options())
        state, m = step(state, {"image": images.to(dev), "label": labels.to(dev)})
        grads = torch.cat([p.grad.detach().double().flatten().cpu() for p in state.model.parameters()])
        after = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        rec = {k: float(v) for k, v in clip.transform.stats.items()}
        rec["device"] = clip.transform.stats["max_ratio_after"].device.type
        runs[dev, dt] = (float(m["loss"]), float(m["grad_norm"]), grads, before, after, rec)
    (loss_c, gn_c, g_c, b_c, a_c, r_c) = runs["cpu", torch.float32]
    (loss_g, gn_g, g_g, b_g, a_g, r_g) = runs["cuda", torch.float32]
    (loss_d, gn_d, g_d, _, _, _) = runs["cpu", torch.float64]
    kinds = sorted({type(m).__name__ for m in state.model.modules()} & {"UFO", "XCA", "GEMPool", "SEVar3", "BatchNorm"})
    result = {
        "phase": "model_nondeep",
        "modules": kinds,
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "grad_norm_rel": abs(gn_g - gn_c) / abs(gn_c),
        "grad_rel_l2": float((g_g - g_c).norm() / g_c.norm()),
        "init_equal": bool(torch.equal(b_c, b_g)),
        "update_rel_l2": float(((a_g - b_g) - (a_c - b_c)).norm() / (a_c - b_c).norm()),
        "state_rel_l2": float((a_g - a_c).norm() / a_c.norm()),
        "update_over_state": float((a_c - b_c).norm() / b_c.norm()),
        "cpu_f32_vs_f64": {"loss_rel": abs(loss_c - loss_d) / abs(loss_d), "grad_norm_rel": abs(gn_c - gn_d) / abs(gn_d),
                           "grad_rel_l2": float((g_c - g_d).norm() / g_d.norm())},
        "agc": {"cpu": r_c, "cuda": r_g},
        "loss": [loss_c, loss_g, loss_d],
        "grad_norm": [gn_c, gn_g, gn_d],
    }
    print(f"[model_nondeep] {json.dumps(result)}")
    if not (result["init_equal"] and len(kinds) == 5 and result["loss_rel"] < 1e-5 and result["grad_norm_rel"] < 1e-4
            and result["grad_rel_l2"] < 1e-4 and result["update_rel_l2"] < 1e-3):
        raise AssertionError(f"non-deep train step on the card disagrees with the CPU: {result}")
    if r_g["device"] != "cuda" or r_g["units"] != r_c["units"] or abs(r_g["clipped"] - r_c["clipped"]) > 1 or not (
            0 < r_g["clipped"] < r_g["units"] and r_g["max_ratio_after"] <= 1.0 + 1e-5):
        raise AssertionError(f"non-deep train step: AGC on the card {r_g}, on the CPU {r_c}")
    return result


def _seeded_masks(seed: int = 0):
    """A stand-in for layers.draw_keep_mask drawing from a CPU generator
    seeded ``seed`` and moving the mask to the device: the card's and the
    CPU's runs drop the same samples (their own generators cannot agree)."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def draw(generator, keep_prob, shape, device):
        return (torch.rand(tuple(shape), generator=gen) < keep_prob).to(device)

    return draw


@contextlib.contextmanager
def cpu_reference(device: str):
    """Around a run on ``device``: on the CPU, PyTorch's own conv kernels in
    place of oneDNN's. On an H100's host, oneDNN's float32 convs left
    model_cmodel_tables' trunk's gradients 1.7e-3 off float64 (relative L2),
    PyTorch's own 4e-6, and the card's were 6.9e-6 from those (PERF.md
    section 6).
    Float64 runs do not use oneDNN."""
    import torch

    if device != "cpu":
        yield
    else:
        with torch.backends.mkldnn.flags(enabled=False):
            yield


def _card_vs_cpu_step(make_state, images, labels, step_kw: dict, criterion=None):
    """Run one train step from ``make_state(device, dtype)`` on the CPU in
    float32, on the card in float32 and on the CPU in float64: loss,
    grad_norm, the gradients, the state before and after, and the state
    itself, by (device, dtype). The criterion is label-smoothing CE unless
    one is given. The CPU runs on PyTorch's own conv kernels (cpu_reference)."""
    import torch

    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models import layers
    from sota_imagenet_tpu_torch.train import steps

    criterion = criterion or CrossEntropyLoss(smoothing=0.1)
    runs, draw = {}, layers.draw_keep_mask
    try:
        for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64)):
            layers.draw_keep_mask = _seeded_masks(0)
            with cpu_reference(dev):
                state = make_state(dev, dt)
            before = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
            step = steps.build_train_step(criterion, input_dtype=dt, **step_kw)
            with cpu_reference(dev):
                state, m = step(state, {"image": images.to(dev, dt), "label": labels.to(dev, dt)})
            grads = torch.cat([p.grad.detach().double().flatten().cpu() for p in state.model.parameters()])
            after = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
            runs[dev, dt] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "grads": grads,
                             "before": before, "after": after, "state": state}
    finally:
        layers.draw_keep_mask = draw
    return runs


def _step_agreement(name: str, runs, extra: dict = None) -> dict:
    """The card's float32 step against the CPU's, beside the CPU's float32
    step against its float64 one (the scale of float32's own error)."""
    import torch

    c, g = runs["cpu", torch.float32], runs["cuda", torch.float32]
    d = runs["cpu", torch.float64]
    result = {
        "phase": name,
        "loss_rel": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
        "grad_norm_rel": abs(g["grad_norm"] - c["grad_norm"]) / abs(c["grad_norm"]),
        "grad_norm_rel_f64": abs(g["grad_norm"] - d["grad_norm"]) / abs(d["grad_norm"]),
        "grad_rel_l2": float((g["grads"] - c["grads"]).norm() / c["grads"].norm()),
        "init_equal": bool(torch.equal(c["before"], g["before"])),
        "update_rel_l2": float(((g["after"] - g["before"]) - (c["after"] - c["before"])).norm()
                               / (c["after"] - c["before"]).norm()),
        "update_over_state": float((c["after"] - c["before"]).norm() / c["before"].norm()),
        "cpu_f32_vs_f64": {"loss_rel": abs(c["loss"] - d["loss"]) / abs(d["loss"]),
                           "grad_norm_rel": abs(c["grad_norm"] - d["grad_norm"]) / abs(d["grad_norm"]),
                           "grad_rel_l2": float((c["grads"] - d["grads"]).norm() / d["grads"].norm()),
                           "update_rel_l2": float(((c["after"] - c["before"]) - (d["after"] - d["before"])).norm()
                                                  / (d["after"] - d["before"]).norm())},
        "loss": [c["loss"], g["loss"], d["loss"]],
        "grad_norm": [c["grad_norm"], g["grad_norm"], d["grad_norm"]],
        **(extra or {}),
    }
    print(f"[{name}] {json.dumps(result)}")
    return result


def _within(result: dict) -> bool:
    """The model phases' tolerances: loss rtol 1e-5 against the CPU; grad_norm
    rtol 1e-5 against the CPU's float64 step, because the CPU's float32 norm
    of the gradients is the less exact side (4e-5 to 7e-5 off its own float64
    step on an H100 in these phases, the card 1.5e-7; PERF.md section 6);
    the gradients within relative L2 1e-4 and the update within 1e-3 of the
    CPU's."""
    return (result["init_equal"] and result["loss_rel"] < 1e-5 and result["grad_norm_rel_f64"] < 1e-5
            and result["grad_rel_l2"] < 1e-4 and result["update_rel_l2"] < 1e-3)


def bresnet_model_phase(norm_act: str = "silu", check: bool = True) -> dict:
    """One f32 train step of full-width bresnet50 with weight standardisation
    (gamma 1.72, as bresnet50.yaml) on the card against the same step on
    the CPU, from the same seeded weights and the same drop-path and dropout
    masks (drawn on the CPU, _seeded_masks): batch 8 at 64 px, SGD (momentum
    0.9, wd 3e-5), lr 0.2, TF32 off; beside the CPU's float64 step (the
    standardisation stays float32 there, as in the JAX package). Tolerances
    in _within.

    The checked step uses SiLU: with the recipe's leaky_relu, a float32
    rounding that moves a pre-activation across the kink moves the gradient
    (the CPU's own float32 step is 7e-3 off its float64 one in relative L2 of
    the gradients, with SiLU 1.7e-5), as model_phase explains for ReLU. The
    leaky_relu step is run and reported (``check=False``)."""
    import torch

    from sota_imagenet_tpu_torch.models import bresnet50
    from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, weight_standardization_fn
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps

    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    optim = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}

    def make_state(dev, dt):
        model = ParametrizedModel(bresnet50(norm_act=norm_act), weight_standardization_fn(1.72))
        state = steps.init_state(model, lambda m: build_optimizer(optim, m.named_parameters()), device=dev, seed=0)
        model.to(dt)
        return state

    runs = _card_vs_cpu_step(make_state, images, labels, {"lr_schedule": lambda i: 0.2})
    model = runs["cuda", torch.float32]["state"].model
    result = _step_agreement("model_bresnet" if check else f"model_bresnet_{norm_act}", runs, {
        "norm_act": norm_act,
        "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "standardised_kernels": len(model.selected[0]),
    })
    if check and not (_within(result) and result["standardised_kernels"] == 53):
        raise AssertionError(f"bresnet50 train step on the card disagrees with the CPU: {result}")
    return result


# config 8's layer list (8.bnet_no-dim-red_nov.yaml) at full width, each repeat cut to one block
BNET_TRUNK = """
- [-1, 1, "pt.modules.SpaceToDepth", 2]
- [-1, 1, conv3x3, [12, 32]]
- [-1, 1, "torch.nn.SiLU"]
- [-1, 1, "pt.modules.BlurPool", 32]
- [-1, 1, PreBasicBlock, [32, 128]]
- [-1, 1, "pt.modules.BlurPool", 128]
- [-1, 1, PreBasicBlock, [128, 192]]
- [-1, 1, PreBasicBlock, [192, 192]]
- [-1, 1, "pt.modules.BlurPool", 192]
- [-1, 1, PreInvertedResidual, [192, 640]]
- [-1, 1, PreInvertedResidual, [640, 640]]
- [-1, 1, "pt.modules.BlurPool", 640]
- [-1, 1, PreInvertedResidual, [640, 1024]]
- [-1, 1, PreInvertedResidual, [1024, 1024]]
- [-1, 1, "pt.modules.ABN", 1024, {activation: "'swish'"}]
- [-1, 1, conv1x1, [1024, 2560]]
- [-1, 1, "pt.modules.ABN", 2560, {activation: "'swish'"}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [2560, 1000]]
"""
BNET = "configs/exp/8.bnet_no-dim-red_nov.yaml"


def bnet_model_phase(spectral: bool = False) -> dict:
    """One f32 train step of a depth-cut config-8 trunk at full width
    (BNET_TRUNK: SpaceToDepth, BlurPool, PreBasicBlock, PreInvertedResidual,
    ABN with swish_hard, config 8's extra_kwargs) with config 8's Novograd
    (wd 2e-3, betas 0.9/0.99, ``init_zero``) at lr 0.05, on the card against
    the CPU from the same seeded weights, 8 images at 64 px, tolerances as
    bresnet_model_phase's. The parametrization is config 9's
    ForwardWeightNorm (gamma 1.4, use_std), or with ``spectral``
    ForwardSpectralNorm (one power iteration a training forward): then the
    card's u and v after the step must equal the CPU's within 1e-5 of each
    vector's largest element."""
    import torch
    import yaml

    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.models.parametrize import SPECTRAL_STATE_KEY, ParametrizedModel
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.callbacks import ForwardSpectralNorm, ForwardWeightNorm

    cfg = C.load(BNET, strict_env=False)
    extra = C.to_dict(cfg.model)["extra_kwargs"]
    clb = ForwardSpectralNorm() if spectral else ForwardWeightNorm(gamma=1.4, use_std=True)
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()

    def make_state(dev, dt):
        model = ParametrizedModel(CModel(layer_config=yaml.safe_load(BNET_TRUNK), extra_kwargs=extra),
                                  clb.step_options()["parametrization"])
        state = steps.init_state(model, lambda m: build_optimizer(dict(cfg.optim), m.named_parameters()), device=dev,
                                 seed=0)
        model.to(dt)
        return state

    runs = _card_vs_cpu_step(make_state, images, labels, {"lr_schedule": lambda i: 0.05})
    name = "model_bnet_spectral" if spectral else "model_bnet"
    g, c = runs["cuda", torch.float32]["state"], runs["cpu", torch.float32]["state"]
    kinds = sorted({type(m).__name__ for m in g.model.modules()} & {"PreBasicBlock", "PreInvertedResidual", "ABN",
                                                                    "BlurPool", "SpaceToDepth"})
    extra_result = {"modules": kinds, "optimizer": type(g.optimizer).__name__,
                    "parametrized_kernels": len(g.model.selected[0])}
    if spectral:
        sd_g, sd_c = g.model.state_dict(), c.model.state_dict()
        keys = [k for k in sd_c if k.startswith(SPECTRAL_STATE_KEY)]
        extra_result["spectral_vectors"] = len(keys)
        extra_result["spectral_max_rel"] = max(
            float((sd_g[k].cpu() - sd_c[k]).abs().max() / sd_c[k].abs().max()) for k in keys)
    result = _step_agreement(name, runs, extra_result)
    ok = _within(result) and len(kinds) == 5 and result["optimizer"] == "Novograd"
    if spectral:
        ok = ok and result["spectral_vectors"] == 2 * result["parametrized_kernels"] and result["spectral_max_rel"] < 1e-5
    if not ok:
        raise AssertionError(f"{name}: the BNet train step on the card disagrees with the CPU: {result}")
    return result


# each optimizer of model_zoo: (config node, lr): the configs' arguments, and a tenth of their peak lr (the
# optimizer without a config, RMSprop, 1e-4), so that three steps move a randomly initialised net by percents
ZOO_OPTIMIZERS = {
    "adamp_51": ({"_target_": "adamp", "weight_decay": 1e-2}, 1e-4),
    "adamp_13": ({"_target_": "adamp", "weight_decay": 3e-4, "eps": 1e-3}, 3e-3),
    "sgdp": ({"_target_": "sgdp", "momentum": 0.9, "weight_decay": 1e-4}, 0.01),
    "adai_55": ({"_target_": "adai", "betas": [0.1, 0.99], "weight_decay": 3e-5, "sgd_mom": True,
                 "stable_wd": True}, 0.01),
    "adais_50": ({"_target_": "adais", "betas": [0.1, 0.99], "weight_decay": 1e-3}, 0.01),
    "madgrad_54": ({"_target_": "madgrad"}, 2e-4),
    "adam_layerwise_49": ({"_target_": "adam_layerwise", "weight_decay": 2e-2, "betas": [0.9, 0.995]}, 2e-4),
    "rmsprop": ({"_target_": "rmsprop", "momentum": 0.9}, 1e-4),
    "lookahead_sgd_k2": ({"_target_": "sgd", "momentum": 0.9, "lookahead": True, "lookahead_k": 2}, 0.01),
}
ZOO_STEPS = 3


def _card_vs_cpu_steps(make_state, images, labels, n_steps: int, step_kw: dict, criterion=None):
    """``n_steps`` train steps from ``make_state(device, dtype)`` on the CPU in
    float32, on the card in float32 and on the CPU in float64, on the same
    batch: each step's loss and grad_norm, AdamP's or SGDP's projected set of
    each step, a stateful criterion's state after each step, the state
    before and after. The criterion is label-smoothing CE unless one is
    given. The CPU runs on PyTorch's own conv kernels (cpu_reference)."""
    import torch

    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.train import steps

    criterion = criterion or CrossEntropyLoss(smoothing=0.1)
    runs = {}
    for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32), ("cpu", torch.float64)):
        state = make_state(dev, dt)
        before = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        step = steps.build_train_step(criterion, input_dtype=dt, **step_kw)
        losses, norms, projected, loss_states = [], [], [], []
        for _ in range(n_steps):
            with cpu_reference(dev):
                state, m = step(state, {"image": images.to(dev, dt), "label": labels.to(dev, dt)})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if state.loss_state is not None:
                loss_states.append({k: float(v) for k, v in state.loss_state.items()})
            opt = getattr(state.optimizer, "inner", state.optimizer)
            if getattr(opt, "projected", None) is not None:
                projected.append(opt.projected.cpu().tolist())
        after = torch.cat([v.detach().double().flatten().cpu() for v in state.model.state_dict().values()])
        runs[dev, dt] = {"loss": losses, "grad_norm": norms, "projected": projected, "loss_state": loss_states,
                         "before": before, "after": after, "state": state}
    return runs


def zoo_model_phase() -> dict:
    """Three f32 train steps of a full-width, depth-cut ResNet-50 (one
    Bottleneck per stage, SiLU, 64 px, batch 8, TF32 off) on the card
    against the CPU, from the same seeded weights, for each optimizer of
    the zoo with its configs' arguments and peak lr (ZOO_OPTIMIZERS): AdamP
    (configs 51 and 13), SGDP, Adai (55), AdaiS (50), MADGRAD (54),
    AdamLayerwise (49), RMSprop with momentum, and Lookahead over SGD with
    k 2 (it syncs at the second step); beside the CPU's float64 steps.
    Tolerances as the model phases': each step's loss rtol 1e-5 against the
    CPU, the first step's grad_norm rtol 1e-5 against the CPU's float64 step
    (the later steps start from weights that float32 and float64 moved
    apart, and are reported), the update of the three steps (state after
    minus before) within relative L2 1e-3 of the CPU's. The
    parameters AdamP and SGDP project must be the same on both sides at
    every step. Then GradDistributionTB's histogram of a full-width
    ResNet-50's weights on the card against numpy on the CPU (zoo_histogram)."""
    import torch

    from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.utils.weights import flax_ranks, unit_dims

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32 on both sides
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    out, bad = {}, []
    for name, (optim, lr) in ZOO_OPTIMIZERS.items():

        def make_state(dev, dt, optim=optim):
            model = ResNet(block=Bottleneck, layers=(1, 1, 1, 1), norm_act="silu")
            layout = {"unit_dim": unit_dims(model), "flax_rank": flax_ranks(model)}
            state = steps.init_state(model, lambda m: build_optimizer(optim, m.named_parameters(), **layout),
                                     device=dev, seed=0)
            model.to(dt)
            return state

        runs = _card_vs_cpu_steps(make_state, images, labels, ZOO_STEPS, {"lr_schedule": lambda i, lr=lr: lr})
        c, g, d = runs["cpu", torch.float32], runs["cuda", torch.float32], runs["cpu", torch.float64]
        res = {
            "optimizer": type(g["state"].optimizer).__name__,
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(g["loss"], c["loss"])),
            "grad_norm_rel_f64": [abs(a - b) / abs(b) for a, b in zip(g["grad_norm"], d["grad_norm"])],
            "grad_norm_rel_cpu_f32_vs_f64": [abs(a - b) / abs(b) for a, b in zip(c["grad_norm"], d["grad_norm"])],
            "init_equal": bool(torch.equal(c["before"], g["before"])),
            "update_rel_l2": float(((g["after"] - g["before"]) - (c["after"] - c["before"])).norm()
                                   / (c["after"] - c["before"]).norm()),
            "update_over_state": float((c["after"] - c["before"]).norm() / c["before"].norm()),
            "loss": [c["loss"], g["loss"]],
        }
        if c["projected"]:
            res["projected_per_step"] = [sum(p) for p in g["projected"]]
            res["projected_of"] = len(g["projected"][0])
            res["projected_flips"] = [sum(a != b for a, b in zip(pc, pg)) for pc, pg in zip(c["projected"], g["projected"])]
        out[name] = res
        print(f"[model_zoo] {name} {json.dumps(res)}", flush=True)
        if not (res["init_equal"] and res["loss_rel"] < 1e-5 and res["grad_norm_rel_f64"][0] < 1e-5
                and res["update_rel_l2"] < 1e-3 and not any(res.get("projected_flips", []))):
            bad.append(name)
    out["histogram"] = zoo_histogram()
    result = {"phase": "model_zoo", "steps": ZOO_STEPS, "optimizers": out}
    print(f"[model_zoo] {json.dumps(result)}")
    if bad or not out["histogram"]["within"]:
        raise AssertionError(f"model_zoo: the card disagrees with the CPU for {bad}, histogram {out['histogram']}")
    return result


def zoo_histogram() -> dict:
    """GradDistributionTB's histogram (train.callbacks.log_histogram: every
    10th weight of each leaf in the flax layout, log10 |w| clipped to
    [-15, 5], 64 bins) of a full-width ResNet-50's seeded weights on the card,
    against numpy on the CPU from the same weights. The counts must agree
    but for values within one float32 ulp of a bin edge (the card's log10
    and numpy's may round such a value to either side); how many there are
    is reported."""
    import numpy as np
    import torch

    from sota_imagenet_tpu_torch.models import resnet50
    from sota_imagenet_tpu_torch.train.callbacks import LOG_EDGES, log_histogram
    from sota_imagenet_tpu_torch.utils.weights import flax_params

    model = resnet50()
    model.reset_parameters(torch.Generator().manual_seed(0))
    leaves = [v.detach().numpy() for v in flax_params(model).values()]
    model.cuda()
    got = log_histogram(list(flax_params(model).values()), 10, torch.from_numpy(LOG_EDGES).cuda())
    counts = got["counts"].cpu().numpy()
    vals = np.concatenate([np.abs(a.ravel()[::10]) for a in leaves]).astype(np.float32)
    logs = np.clip(np.log10(vals + np.float32(1e-30)), np.float32(-15.0), np.float32(5.0))
    want, _ = np.histogram(logs, bins=LOG_EDGES)
    ulp = np.spacing(np.abs(LOG_EDGES)).astype(np.float32)
    near = int(sum(((logs >= e - u) & (logs <= e + u)).sum() for e, u in zip(LOG_EDGES[1:-1], ulp[1:-1])))
    on_edge = int(np.isin(logs, LOG_EDGES[1:-1]).sum())  # log10(1) = 0 is an edge: the BN scales of 1
    moved = int(np.abs(counts - want).sum())
    result = {"values": int(vals.size), "counts_differ_by": moved, "values_within_one_ulp_of_an_edge": near,
              "of_which_on_an_edge": on_edge,
              "min": [float(got["min"]), float(logs.min())], "max": [float(got["max"]), float(logs.max())],
              "sum_rel": abs(float(got["sum"]) - float(logs.astype(np.float64).sum())) / abs(float(logs.sum()))}
    result["within"] = bool(moved <= 2 * near and int(counts.sum()) == vals.size and result["sum_rel"] < 1e-5)
    return result


# 24.nf_conv-act's layer list (its YAML) at full width, each repeat cut to one block
NF_SAM_TRUNK = """
- [-1, 1, ConvActBlock, [3, 16], {stride: 2, conv_kwargs: {gain_init: 1.0}}]
- [-1, 1, ConvActBlock, [16, 32], {conv_kwargs: {gain_init: 0.5}}]
- [-1, 1, ConvActBlock, [32, 64], {conv_kwargs: {gain_init: 0.5}}]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [64, 64], {stride: 2}]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [64, 64]]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [64, 128], {stride: 2}]
- [-1, 1, VarEMA]
- [-1, 1, ConvActBlock, [128, 128], {groups_width: 64}]
- [-1, 1, VarEMA]
- [-1, 1, "pt.modules.BlurPool", 128]
- [-1, 1, VarEMA]
- [-1, 1, NormFreeBlockTimm, [128, 768, 384]]
- [-1, 1, NormFreeBlockTimm, [768, 768, 384]]
- [-1, 1, VarEMA]
- [-1, 1, "pt.modules.BlurPool", 768]
- [-1, 1, VarEMA]
- [-1, 1, NormFreeBlockTimm, [768, 768, 384]]
- [-1, 1, scaled_conv1x1, [768, 2304], {gamma: '${init_gamma}'}]
- [-1, 1, 'torch.nn.SiLU']
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "torch.nn.Dropout", [0.2]]
- [-1, 1, "nn.Linear", [2304, 1000]]
"""
SAM = "configs/exp/32.nf_conv-act_sam.yaml"


def sam_model_phase() -> dict:
    """One f32 SAM train step of a depth-cut 24.nf_conv-act trunk at full
    width (NF_SAM_TRUNK with 32.nf_conv-act_sam's extra_kwargs: swish_hard,
    VarEMA monitors, NormFreeBlockTimm with ECA; drop-path and dropout off)
    on the card against the CPU, from the same seeded weights, for each kind
    (asam, asam_unitwise with rho 0.01 as config 32, sam_original with rho
    0.5, eta 0.01) with bn_from_perturbed true and false: 64 px, batch 8,
    32's optimizer (BAdam in AdamW mode, wd 5e-3, eps 1e-6, the gain mask),
    lr 0.005, TF32 off; beside the CPU's float64 step. Tolerances as
    model_nf_lamb's (loss rtol 1e-4, grad_norm rtol 1e-2, the update within
    relative L2 1e-2, the VarEMA statistics rtol 1e-4). And on the card, the
    weights after the step are the saved unperturbed weights plus the
    optimizer's update of the step's (perturbed-point) gradients: the same
    optimizer, built anew on a copy holding the saved weights and given
    those gradients, lands on the same weights bit for bit."""
    import torch
    import yaml

    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.models.layers import DropPath, Dropout
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32 on both sides
    torch.backends.cudnn.allow_tf32 = False

    cfg = C.load(SAM, strict_env=False)
    extra = C.to_dict(cfg.model)["extra_kwargs"]
    layers = yaml.safe_load(NF_SAM_TRUNK.replace("'${init_gamma}'", str(cfg.init_gamma)))
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (8, 64, 64, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (8,), generator=gen), 1000).float()
    kinds = {"asam": {"rho": 0.01}, "asam_unitwise": {"rho": 0.01}, "sam_original": {"rho": 0.5, "eta": 0.01}}
    out, bad = {}, []

    def optimizer(m, mask):
        return build_optimizer(dict(cfg.optim), m.named_parameters(), wd_mask=mask)

    def make_state(dev, dt):
        model = CModel(layer_config=layers, extra_kwargs=extra)
        for mod in model.modules():
            if isinstance(mod, DropPath):
                mod.keep_prob = 1.0
            elif isinstance(mod, Dropout):
                mod.rate = 0.0
        mask = filter_from_weight_decay(model.named_parameters(), cfg.filter_from_wd)
        state = steps.init_state(model, lambda m: optimizer(m, mask), device=dev, seed=0)
        model.to(dt)
        state.mask = mask
        return state

    for kind, kw in kinds.items():
        for bn in (True, False):
            sam = {"kind": kind, "bn_from_perturbed": bn, **kw}
            runs = _card_vs_cpu_steps(make_state, images, labels, 1, {"lr_schedule": lambda i: 0.005, "sam": sam})
            c, g, d = runs["cpu", torch.float32], runs["cuda", torch.float32], runs["cpu", torch.float64]
            std = lambda r: torch.tensor([float(b) for n, b in r["state"].model.named_buffers() if n.endswith("std_ema")])
            res = {
                "loss_rel": abs(g["loss"][0] - c["loss"][0]) / abs(c["loss"][0]),
                "grad_norm_rel": abs(g["grad_norm"][0] - c["grad_norm"][0]) / abs(c["grad_norm"][0]),
                "grad_norm_rel_f64": abs(g["grad_norm"][0] - d["grad_norm"][0]) / abs(d["grad_norm"][0]),
                "init_equal": bool(torch.equal(c["before"], g["before"])),
                "update_rel_l2": float(((g["after"] - g["before"]) - (c["after"] - c["before"])).norm()
                                       / (c["after"] - c["before"]).norm()),
                "std_ema_rel": float(((std(g) - std(c)).abs() / std(c).abs()).max()),
                "loss": [c["loss"][0], g["loss"][0], d["loss"][0]],
            }
            # the card's weights are the saved ones plus the optimizer's update of the step's gradients (each
            # parameter's .grad holds them after the step): put the saved weights back, step a new optimizer
            model = g["state"].model
            stepped = [p.detach().clone() for p in model.parameters()]
            sd = model.state_dict()
            saved = dict(zip(sd, g["before"].split([v.numel() for v in sd.values()])))
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(saved[n].view(p.shape).to(p.dtype))
            opt = optimizer(model, g["state"].mask)
            for group in opt.param_groups:
                group["lr"] = 0.005
            opt.step()
            res["weights_equal_saved_plus_update"] = all(torch.equal(p, q) for p, q in zip(model.parameters(), stepped))
            out[f"{kind}{'' if bn else '_bn_from_clean'}"] = res
            print(f"[model_sam] {kind} bn_from_perturbed={bn} {json.dumps(res)}", flush=True)
            if not (res["init_equal"] and res["loss_rel"] < 1e-4 and res["grad_norm_rel"] < 1e-2
                    and res["update_rel_l2"] < 1e-2 and res["std_ema_rel"] < 1e-4
                    and res["weights_equal_saved_plus_update"]):
                bad.append((kind, bn))
    result = {"phase": "model_sam", "runs": out}
    print(f"[model_sam] {json.dumps(result)}")
    if bad:
        raise AssertionError(f"model_sam: the SAM step on the card disagrees with the CPU for {bad}: {out}")
    return result


TABLES_TRUNK = """
- [-1, 1, conv3x3, [3, 32], {bias: true}]
- [-1, 2, VGGBlock, [32, 32], {pre_norm: "VarEMA(32)", activation: silu, conv_kwargs: {gamma: 1.7, gain_init: 1, n_heads: 1}}]
- [-1, 1, VGGBlock, [32, 64], {pre_norm: "VarEMA(32)", groups_width: 16, activation: silu, conv_kwargs: {gamma: 1.7}}]
- [-1, 1, ConvMixBlock, [64, 64], {partial_factor: 0.5, activation: silu, pre_norm: "VarEMA(64)", groups_width: 16}]
- [-1, 1, ConvResidual, [conv3x3, 64, 96]]
- [-1, 1, nn.BatchNorm2d, 96]
- [-1, 1, ConvResidual, [96, 96]]
- [-1, 1, FusedRepVGGBlock, [96, 96], {activation: silu}]
- [-1, 1, FusedRepVGGBlock, [96, 128], {stride: 2, activation: silu}]
- [-1, 1, Yolo5_C3, [128], {num_blocks: 2, block_kwargs: {se_kwargs: null}}]
- [-1, 1, ConvMixerBlock, [128, 7]]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, SphereMLPLayer, [128, 1000], {hidden_size: 512}]
"""


def _seeded_batch(size: int, batch: int = 8):
    """A seeded batch of normalized pixels and one-hot labels over 1000 classes."""
    import torch

    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (batch, size, size, 3), generator=gen).float().sub(127.5).mul(1 / 51.0)
    labels = torch.nn.functional.one_hot(torch.randint(0, 1000, (batch,), generator=gen), 1000).float()
    return images, labels


def cmodel_tables_model_phase() -> dict:
    """One f32 train step (SGD, TF32 off) on the card against the CPU of the
    CModel table's new blocks: a trunk at 64 px, batch 8, of config 61's
    VGGBlock (VarEMA pre-norm, groups_width), ConvMixBlock (factor 0.5),
    config 68's ConvResidual (``[conv3x3, i, o]``: a Conv with bias) and a
    scaled one, FusedRepVGGBlock (with and without its identity branch),
    Yolo5_C3 (two NonDeepBlocks, SE off through ``se_kwargs: null``), a
    ConvMixerBlock (k 7) and the SphereMLPLayer head (its flax BatchNorm);
    and vgg16_bn's layer list at full width (1000 classes, 64 px, its two
    dropouts at rate 0). Tolerances as the model phases' (_within), against
    the CPU's float32 step on PyTorch's own convs (cpu_reference); the
    activations are SiLU where the blocks take one and in vgg16_bn's place
    of ReLU (kinks: the Chaos note of ROADMAP.md), but Yolo5_C3's and the
    NonDeepBlocks' hard_silu, which they fix."""
    import torch
    import yaml

    from sota_imagenet_tpu_torch.models.cmodel import CModel, vgg16_bn
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels = _seeded_batch(64)
    optim = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
    # vgg16_bn's own layer list, with SiLU for its ReLUs and its dropouts at 0: at 0.5 (equal masks) the
    # card's float32 gradients came 6.4e-4 off the CPU's, whose own were 1e-5 off float64 (PERF.md section
    # 6); the dropout masks are held in model_bresnet
    vgg = [{**e, "module": "SiLU"} if e["module"] == "ReLU" else
           {**e, "kwargs": {"activation": "silu"}} if e["module"] == "ConvBnAct" else
           {**e, "args": [0.0]} if e["module"] == "Dropout" else e
           for e in (vars(st) for st in vgg16_bn().structures)]
    models = {"trunk": lambda: CModel(layer_config=yaml.safe_load(TABLES_TRUNK)),
              "vgg16_bn_silu": lambda: CModel(layer_config=vgg)}
    out, bad = {}, []
    for name, build in models.items():

        def make_state(dev, dt, build=build):
            model = build()
            state = steps.init_state(model, lambda m: build_optimizer(optim, m.named_parameters()), device=dev, seed=0)
            model.to(dt)
            return state

        runs = _card_vs_cpu_step(make_state, images, labels, {"lr_schedule": lambda i: 0.1})
        model = runs["cuda", torch.float32]["state"].model
        kinds = sorted({type(m).__name__ for m in model.modules()})
        res = _step_agreement(f"model_cmodel_tables {name}", runs, {
            "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6, "module_kinds": kinds})
        out[name] = res
        if not _within(res):
            bad.append(name)
    result = {"phase": "model_cmodel_tables", "models": out}
    print(f"[model_cmodel_tables] {json.dumps(result)}")
    if bad:
        raise AssertionError(f"model_cmodel_tables: the card disagrees with the CPU for {bad}")
    return result


# criterion config -> the model it takes: a depth-cut ResNet-50 for the logit losses (``trick``: with
# sigmoid_trick's classifier bias), adacos_sphere's trunk for the cosine ones; AdaCos runs three steps
LOSS_CRITERIA = {
    "focal": ({"_target_": "focal", "gamma": 2.0}, "r50"),
    "binary_focal_sigmoid_trick": ({"_target_": "binary_focal", "alpha": 0.25}, "r50_trick"),
    "binary_kl": ({"_target_": "kld", "smoothing": 0.01}, "r50"),
    "sigmoid_sigmoid_trick": ({"_target_": "sigmoid"}, "r50_trick"),
    "hard_negative": ({"_target_": "hard_negative", "hard_pct": 0.02,
                       "loss": {"_target_": "binary_kl", "reduction": "none"}}, "r50"),
    "fixmatch": ({"_target_": "fixmatch", "hard_weight": 0.01, "hard_pct": 0.01}, "r50"),
    "adacos": ({"_target_": "adacos", "margin": 0.0, "max_s": 20}, "sphere"),
    "arcface": ({"_target_": "arcface"}, "sphere"),
    "cosface": ({"_target_": "cosface"}, "sphere"),
    "arc_softmax_center": ({"_target_": "arc-softmax-center", "center_weight": 0.5}, "sphere"),
    "my_loss_1": ({"_target_": "my_loss_1"}, "sphere"),
}
ADACOS = "configs/exp/adacos_sphere.yaml"
ADACOS_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.001, 0.5]}]",)  # the recipe's warmup, cut to the one debug epoch


def losses_model_phase() -> dict:
    """f32 train steps (SGD, TF32 off, 64 px, batch 8) on the card against the
    CPU with each new criterion (LOSS_CRITERIA): the logit losses on a
    full-width, depth-cut ResNet-50 (one Bottleneck per stage, SiLU), two of
    them with sigmoid_trick's classifier bias (-log 999 on ``fc.bias``,
    checked before the step); the cosine losses on adacos_sphere's trunk at
    full width (its ConvActBlocks with SiLU, its SphereLinearLayer), AdaCos
    for three steps with its state (running B, median cosine, s) after each.
    Tolerances as the zoo's: each step's loss rtol 1e-5 against the CPU (its
    float32 steps on PyTorch's own convs, cpu_reference), the first step's
    grad_norm rtol 1e-5 against the CPU's float64 step, the update within
    relative L2 1e-3; AdaCos's state rtol 1e-5 after every step."""
    import torch
    import yaml

    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.utils.weights import apply_sigmoid_trick

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels = _seeded_batch(64)
    optim = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
    sphere_layers = C.to_dict(C.load(ADACOS, strict_env=False).model)["layer_config"]
    out, bad = {}, []
    for name, (crit_cfg, kind) in LOSS_CRITERIA.items():
        criterion = C.instantiate(crit_cfg)
        trick = {}

        def make_state(dev, dt, kind=kind, criterion=criterion, trick=trick):
            if kind == "sphere":
                model = CModel(layer_config=sphere_layers, extra_kwargs={"ConvActBlock": {"activation": "silu"}})
            else:
                model = ResNet(block=Bottleneck, layers=(1, 1, 1, 1), norm_act="silu")
            state = steps.init_state(model, lambda m: build_optimizer(optim, m.named_parameters()), device=dev,
                                     seed=0, criterion=criterion)
            if kind == "r50_trick":
                trick["names"] = apply_sigmoid_trick(model)
                trick["bias"] = sorted({float(v) for v in model.fc.bias.detach().cpu()})
            model.to(dt)
            return state

        n_steps = 3 if name == "adacos" else 1
        runs = _card_vs_cpu_steps(make_state, images, labels, n_steps, {"lr_schedule": lambda i: 0.1},
                                  criterion=criterion)
        c, g, d = runs["cpu", torch.float32], runs["cuda", torch.float32], runs["cpu", torch.float64]
        res = {
            "criterion": type(criterion).__name__,
            "model": kind,
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(g["loss"], c["loss"])),
            "grad_norm_rel_f64": [abs(a - b) / abs(b) for a, b in zip(g["grad_norm"], d["grad_norm"])],
            "init_equal": bool(torch.equal(c["before"], g["before"])),
            "update_rel_l2": float(((g["after"] - g["before"]) - (c["after"] - c["before"])).norm()
                                   / (c["after"] - c["before"]).norm()),
            "loss": [c["loss"], g["loss"]],
        }
        ok = (res["init_equal"] and res["loss_rel"] < 1e-5 and res["grad_norm_rel_f64"][0] < 1e-5
              and res["update_rel_l2"] < 1e-3)
        if g["loss_state"]:
            res["loss_state"] = g["loss_state"]
            res["loss_state_rel"] = max(abs(gs[k] - cs[k]) / abs(cs[k])
                                        for gs, cs in zip(g["loss_state"], c["loss_state"]) for k in cs)
            prev_s = [s["prev_s"] for s in g["loss_state"]]
            ok = ok and res["loss_state_rel"] < 1e-5 and all(math.isfinite(v) for v in prev_s) and prev_s[0] != 20.0
        if kind == "r50_trick":
            res["sigmoid_trick"] = dict(trick)
            ok = ok and trick["names"] == ["fc.bias"] and trick["bias"] == [float(torch.tensor(-math.log(999.0)))]
        out[name] = res
        print(f"[model_losses] {name} {json.dumps(res)}", flush=True)
        if not ok:
            bad.append(name)
    result = {"phase": "model_losses", "criteria": out}
    print(f"[model_losses] {json.dumps(result)}")
    if bad:
        raise AssertionError(f"model_losses: the card disagrees with the CPU for {bad}")
    return result


def _silu_activations(model):
    """Every module activation (an ``act`` attribute: the blocks', ABN's, the
    stems') made SiLU: a float32 rounding that moves a pre-activation across
    a ReLU's or leaky_relu's kink moves the gradient (bresnet_model_phase)."""
    import torch
    import torch.nn.functional as F

    for m in model.modules():
        if callable(getattr(m, "act", None)) and not isinstance(m.act, torch.nn.Module):
            m.act = F.silu
    return model


def _legacy_model(path: str, **cut):
    """The ``model:`` block of the old_exp config at ``path`` with ``cut`` over it, 1000 classes."""
    from sota_imagenet_tpu_torch import config as C

    return C.instantiate({**C.to_dict(C.load(path, strict_env=False).model), "num_classes": 1000, **cut})


def legacy_model_phase() -> dict:
    """One f32 train step (TF32 off, 64 px, batch 8) on the card against the
    CPU of each legacy architecture, from the same seeded weights, each with
    its config's optimizer and SiLU for its activations (_silu_activations;
    BNet through ``norm_act``): exp48's trunk at full width, one block per
    stage (s2d stem, Pre_XX/Pre_IR with 9x9 strided depthwise convs, partial
    residuals; SGD); exp57's, with weight standardisation (gamma 1.72)
    through ParametrizedModel and AdamP, whose projected sets on the card
    and on the CPU must be equal; exp26's csp_simpl_dark (s2d stem, CSP
    ratio 0.75, no x2 transition) with two blocks a stage; densenet121 with
    two layers a block; and tresnetm whole (it has no depth field).
    Tolerances as the model phases' (_within)."""
    import torch

    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, weight_standardization_fn
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.utils.weights import flax_ranks, unit_dims

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels = _seeded_batch(64)
    one_block = {"layers": [1, 1, 1, 1], "norm_act": "silu"}
    cases = {  # name -> (config, model, lr, WS gamma)
        "exp48_trunk": (EXP48, lambda: _legacy_model(EXP48, **one_block), 0.2, None),
        "exp57_trunk_ws_adamp": (EXP57, lambda: _legacy_model(EXP57, **one_block), 0.002, 1.72),
        "csp_simpl_dark": (EXP26, lambda: _legacy_model(EXP26, layers=[1, 2, 2, 2, 2], norm_act="silu"), 0.1, None),
        "densenet121": (DENSENET, lambda: _silu_activations(_legacy_model(DENSENET, blocks=[2, 2, 2, 2])), 0.1, None),
        "tresnetm": (TRESNET, lambda: _silu_activations(_legacy_model(TRESNET)), 0.1, None),
    }
    out, bad = {}, []
    for name, (config, build, lr, gamma) in cases.items():
        optim = dict(C.load(config, strict_env=False).optim)

        def make_state(dev, dt, build=build, gamma=gamma, optim=optim):
            model = build()
            if gamma is not None:
                model = ParametrizedModel(model, weight_standardization_fn(gamma))
            units = {"unit_dim": unit_dims(model), "flax_rank": flax_ranks(model)}
            state = steps.init_state(model, lambda m: build_optimizer(optim, m.named_parameters(), **units),
                                     device=dev, seed=0)
            model.to(dt)
            return state

        runs = _card_vs_cpu_step(make_state, images, labels, {"lr_schedule": lambda i, lr=lr: lr})
        model = runs["cuda", torch.float32]["state"].model
        extra = {"config": config, "optimizer": optim["_target_"],
                 "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6,
                 "module_kinds": sorted({type(m).__name__ for m in model.modules()} & {
                     "BNetBlock", "_NormActLayer", "_CBA", "BasicBlock", "Bottleneck", "SE", "BlurPool", "BatchNorm",
                     "ABN", "SpaceToDepth", "ParametrizedModel"})}
        ok = True
        if gamma is not None:
            card, cpu = (runs[dev, torch.float32]["state"].optimizer.projected.cpu() for dev in ("cuda", "cpu"))
            extra.update({"standardised_kernels": len(model.selected[0]), "projected": int(card.sum()),
                          "projected_cpu": int(cpu.sum()), "projected_sets_equal": bool(torch.equal(card, cpu))})
            ok = extra["projected_sets_equal"] and extra["projected"] >= extra["standardised_kernels"] > 0
        res = _step_agreement(f"model_legacy {name}", runs, extra)
        out[name] = res
        if not (ok and _within(res)):
            bad.append(name)
    result = {"phase": "model_legacy", "models": out}
    print(f"[model_legacy] {json.dumps(result)}")
    if bad:
        raise AssertionError(f"model_legacy: the card disagrees with the CPU for {bad}")
    return result


def legacy_layer_shares(name: str, result: dict) -> dict:
    """A profiled legacy trainer's device time by the port's layer groups (the
    depthwise convs, BatchNorm/ABN, BNet's partial residual, fused_aug...),
    each as ms a step and as a share of its profiled device step; printed."""
    prof = result["profile"]
    device_step = prof["device_ms"] / prof["steps"]
    by_layer = prof["by_layer_ms_per_step"]
    shares = {g: {"ms_per_step": by_layer.get(g, 0.0), "share_of_step": by_layer.get(g, 0.0) / device_step}
              for g in ("depthwise convs", "dense convs", "grouped convs", "BatchNorm", "partial residual",
                        "fused_aug", "elementwise/activations", "SGD", "RMSprop", "EMA", "copies")}
    print(f"[{name}] {json.dumps({'device_ms_per_step': device_step, 'layers': shares})}")
    return shares


def forward_gmac(config: str, image_size: int = 224) -> dict:
    """The model of ``config``'s forward MACs per image at ``image_size``,
    counted by torch.utils.flop_counter on the meta device (no memory, no
    compute), in all and by the CModel submodule kind (c1, c3, attn) where
    there is one."""
    import collections

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as C

    cfg = C.load(config, strict_env=False)
    with torch.device("meta"):
        model = cli.build_model(cfg)
        x = torch.empty(1, image_size, image_size, 3)
    counter = FlopCounterMode(display=False, depth=None)
    with counter:
        model.train()(x)
    by_kind = collections.Counter()
    for name, ops in counter.get_flop_counts().items():
        parts = name.split(".")  # CModel.layers.<i>.<r>.<kind>
        if len(parts) == 5 and parts[0] == "CModel":
            by_kind[parts[4]] += sum(ops.values()) / 2e9
    return {"gmac_per_image": counter.get_total_flops() / 2e9, "by_kind_gmac": dict(by_kind)}


def tiny_phase(gpu: str) -> dict:
    """cli.main on configs/tiny_synthetic.yaml as it stands (a CModel of three
    ConvActBlocks, f32, 32 px, batch 64, two debug epochs of 10 steps) on the
    card: the train loss falls, one augment launch per step."""
    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.train.callbacks import Callback

    class Record(Callback):
        def on_begin(self):
            self.losses = []

        def on_epoch_end(self, epoch, train_metrics, val_metrics):
            self.losses.append(train_metrics["loss"])
            self.param_devices = {p.device.type for p in self.runner.state.model.parameters()}

    rec = Record()
    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as logdir:
        for fn in counters.values():
            fn.launches = 0  # counts from here are this path's
        t0 = time.perf_counter()
        val = cli.main(["-c", "configs/tiny_synthetic.yaml", f"log.dir={logdir}"], callbacks=[rec])
        wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    result = {"phase": "trainer_e", "train_loss_by_epoch": rec.losses, "val": val, "kernel_launches": launches,
              "wall_s": wall, "gpu": gpu}
    print(f"[trainer_e] {json.dumps(result)}")
    if len(rec.losses) != 2 or not all(math.isfinite(v) for v in (*rec.losses, *val.values())):
        raise AssertionError(f"trainer_e: losses {rec.losses}, val {val}")
    if not rec.losses[1] < rec.losses[0]:
        raise AssertionError(f"trainer_e: the train loss did not fall: {rec.losses}")
    if launches != {"fused_aug": 20, "conv1x1_stats": 0, "moments": 0} or rec.param_devices != {"cuda"}:
        raise AssertionError(f"trainer_e: kernel launches {launches}, params on {rec.param_devices}")
    return result


BRESNET = "configs/exp/bresnet50.yaml"
BRESNET_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0, 0.2]}]",)  # the recipe's warmup, cut to the one debug epoch
BRESNET_GAMMA = 1.72  # the recipe's init_gamma (configs/base.yaml)


def bresnet_checks(model) -> dict:
    """Trainer K's model after its run: its parameter count, its state_dict
    keys against an unwrapped bresnet50's, and for one 3x3 and one 1x1 conv
    the effective (standardised) weight's per-output-channel mean (0) and
    std (gamma / sqrt(fan_in)) beside the raw weight's."""
    import torch

    from sota_imagenet_tpu_torch.models import bresnet50

    with torch.device("meta"):
        unwrapped = list(bresnet50().state_dict())
    eff = model.effective_parameters()
    raw = dict(model.named_parameters())
    checks = {}
    for name in ("layer1.0.conv2.weight", "layer3.0.conv1.weight"):  # a 3x3 and a 1x1
        out = {}
        for kind, w in (("effective", eff[name]), ("raw", raw[name])):
            rows = w.detach().double().reshape(w.shape[0], -1)
            want_std = BRESNET_GAMMA / rows.shape[1] ** 0.5
            out[f"{kind}_mean_max"] = float(rows.mean(dim=1).abs().max())
            out[f"{kind}_std_rel_err"] = float(((rows.std(dim=1, correction=0) - want_std).abs() / want_std).max())
        checks[f"{name} {tuple(raw[name].shape)}"] = out
    return {
        "parameters_m": sum(p.numel() for p in model.parameters()) / 1e6,
        "state_dict_keys_unwrapped": list(model.state_dict()) == unwrapped,
        "standardised_kernels": len(model.selected[0]),
        "weight_standardisation": checks,
    }


def nf_structural_launches(model, backward: bool = True) -> int:
    """nf_fused's launches in one forward (and with ``backward`` its backward)
    of the NFNet in ``model`` on the kernels' path: each SiLU site 1 forward
    and 1 backward, plus the bias's column sum where it has one (all but the
    pre-activations); each block tail 2 forward with ECA (pool, apply), 1
    without, and 4 backward (sums, gate, apply, column sum); the weight
    standardisation 1 forward and 1 backward for each block's convs and once
    for the stem's and the final conv's together."""
    from sota_imagenet_tpu_torch.models.nfnet import NFNet

    net = next(m for m in model.modules() if isinstance(m, NFNet))
    sites = len(net.stem) - 1 + 1  # the stem's SiLU sites and the final conv's
    fwd, bwd = sites + 1, 2 * sites + 1
    for blk in net.blocks:
        fwd += 1 + 3 + (2 if blk.attn is not None else 1) + 1
        bwd += 1 + 3 * 2 + 4 + 1
    return fwd + bwd if backward else fwd


def kernel_counters() -> dict:
    """name -> the wrapper whose ``launches`` counts that kernel's launches."""
    from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats
    from sota_imagenet_tpu_torch.ops.fused_aug import fused_augment
    from sota_imagenet_tpu_torch.ops.moments import moments

    return {"fused_aug": fused_augment, "conv1x1_stats": conv1x1_stats, "moments": moments}


def _resume_eval(config: str, overrides: list, ckpt: str, val: dict) -> dict:
    """``run.evaluate=true`` from ``ckpt`` through cli.main: the criterion's
    state in the checkpoint, as the eval finds it (after the restore) and as
    it leaves it, and the eval's metrics beside the run's final val ones."""
    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.train.callbacks import Callback

    def host(state):
        return {k: float(v) for k, v in state.items()}

    class StateProbe(Callback):
        def on_begin(self):
            self.at_begin = host(self.runner.state.loss_state)

        def on_end(self):
            self.at_end = host(self.runner.state.loss_state)

    probe = StateProbe()
    again = cli.main(["-c", config, *overrides, "run.evaluate=true", f"run.resume={ckpt}"], callbacks=[probe])
    saved = host(torch.load(ckpt, map_location="cpu", weights_only=True)["state"]["loss_state"])
    return {"saved": saved, "restored": probe.at_begin, "after_eval": probe.at_end, "val": again,
            "val_equal": again == val, "val_max_abs_diff": max(abs(again[k] - val[k]) for k in val)}


def tfrecord_overrides(root: str) -> tuple:
    """The TFRecords under ``root`` (``records tfrecord``'s layout) for train
    and val, debug mode and two epochs, as folder_overrides."""
    return ("loader.backend=tfrecord", "val_loader.backend=tfrecord", *folder_overrides(root)[2:])


def write_records(tree: str, out: str) -> dict:
    """``records tfrecord`` on the ImageFolder at ``tree``: the reference's
    128 train and 16 val shards of JPEG records with their indexes, written
    by 8 processes; its seconds and bytes."""
    import glob

    from sota_imagenet_tpu_torch import cli

    t0 = time.perf_counter()
    cli.records_main(["tfrecord", tree, "--out", out, "--workers", "8"])
    seconds = time.perf_counter() - t0
    files = glob.glob(os.path.join(out, "*_records", "*"))
    return {"seconds": seconds, "shards": len(files), "mbytes": sum(os.path.getsize(f) for f in files) / 1e6,
            "img_per_s": (FOLDER_TRAIN + FOLDER_VAL) / seconds}


def _trace_breakdown(path: str, steps: int) -> dict:
    """Device time a step by KERNEL_GROUPS from a Chrome trace file (the
    Profiler callback's): its kernel, copy and fill events."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            name = e.get("name", "")
            ms, n = rows.get(name, (0.0, 0))
            rows[name] = (ms + e.get("dur", 0.0) / 1e3, n + 1)
    groups: dict = {}
    for name, (ms, _) in rows.items():
        low = name.lower()
        group = next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])
    convs = [n for n in rows if any(f in n.lower() for f in ("conv", "fprop", "dgrad", "wgrad", "cudnn"))]
    return {
        "trace": os.path.basename(path), "steps": steps, "device_ms": sum(ms for ms, _ in rows.values()),
        "launches_per_step": sum(n for _, n in rows.values()) / steps,
        "by_group_ms_per_step": {g: ms / steps for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms_per_step": ms / steps, "calls": n, "name": k[:120]} for k, (ms, n) in top[:12]],
        "fused_aug_kernels": sorted(n for n in rows if "fused_aug" in n.lower()),
        "conv_kernels": len(convs), "conv_kernel_example": convs[0][:120] if convs else None,
    }


def trainer_phase(
    name: str, config: str, extra: tuple, gpu: str, per_step: dict, profile_window=None, recipe: str = None,
    tree: str = None, val_shapes: int = 1, cache: bool = False, keep_ckpt: str = None, profiler_clb=None,
    tfrecord: bool = False,
) -> dict:
    """cli.main on ``config`` (a full-width model, bs 256 @ 224, bf16);
    ``per_step`` is each kernel's expected launches per train step. With
    ``recipe`` "nfnet" the run must also end with an EMA that differs from
    the weights and every gain outside the weight decay; with "nf_lamb",
    every gain outside the weight decay, the rows of a NormFreeBlockTimm's
    conv2 kernel orthonormal within 1e-5 after OrthoInitClb, and a VarEMA
    std_ema moved from 1; with "nondeep" (80_1), every gain outside the
    weight decay, 14 NonDeepBlocks of which 4 hold a UFO, and AGC's record
    of the last step (on the card, every unit of the model, at least one
    clipped, none over its bound after the clip); it also reports the
    model's forward MACs (forward_gmac); with "bnet" or "effnet" (the
    legacy recipes, LEGACY), an EMA that moved, every parameter decayed, the
    JAX model's parameter count, its blocks and its optimizer, and the
    forward MACs. With any recipe, a profile is
    attributed to the port's layers (layer_breakdown); nf_lamb's must find
    the auxiliary loss's forward and backward in every profiled step. With ``tree`` it reads
    that JPEG ImageFolder (train and val) instead of synthetic data, for two
    epochs (folder_overrides), and reports the second: every
    val image must be scored once (the sum of the masked val batches'
    ``_weight``), and it reports the decoder's counts, ``input_wait_share``,
    ``data_time_s``, the val pass's wall and the bytes copied to the card
    per train batch; the val batches must come in ``val_shapes`` shapes.
    With ``cache`` the tree is a packed one, read through IMAGENET_DIR by a
    config that caches it on the card (cache_overrides), and the run also
    reports the cache's fill (the first epoch's ``cache_fill_s`` and
    ``cache_mb``) and the bytes it copies to the card per train step.
    With ``tfrecord`` the tree holds ``records tfrecord``'s shards, read
    through the tfrecord backend (tfrecord_overrides). With
    ``profiler_clb=(a, b)`` the config's own ``Profiler`` callback
    (``run.extra_callbacks``) traces the end of step a to the end of step b
    into the run's log dir, and the device breakdown is read from its trace
    file (_trace_breakdown), which must name the fused_aug kernel and
    cuDNN's convolutions."""
    import glob

    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.data import decode
    from sota_imagenet_tpu_torch.ops import nf_fused
    from sota_imagenet_tpu_torch.tools.accuracy_proof import imagenet_dir

    probe = _probe_callback(profile_window, record_shapes=recipe is not None)
    if recipe in ("adamp", "sam"):
        probe.writer = RecordingWriter()
    counters = kernel_counters()
    scopes = _layer_scopes() if (recipe and profile_window) else contextlib.nullcontext()
    data = (TRAINER_OVERRIDES if tree is None else CACHE_OVERRIDES if cache else tfrecord_overrides(tree) if tfrecord
            else folder_overrides(tree))
    env = imagenet_dir(tree) if cache else contextlib.nullcontext()
    with tempfile.TemporaryDirectory() as logdir, scopes, _count_h2d({}) as h2d, env:
        overrides = [*data, *extra, f"log.dir={logdir}"]
        if profiler_clb:
            profile_dir = os.path.join(logdir, "profile")
            overrides.append(f"run.extra_callbacks=[{{_target_: Profiler, log_dir: {profile_dir}, "
                             f"start_step: {profiler_clb[0]}, num_steps: {profiler_clb[1] - profiler_clb[0]}}}]")
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0  # counts from here are this path's
        by_path = counters["conv1x1_stats"].launches_by_path
        for path in by_path:
            by_path[path] = 0
        for counter in (nf_fused.launches, nf_fused.fused, nf_fused.fallbacks):
            counter.clear()  # counts from here are this path's
        decoded0 = dict(decode.decoded)
        t0 = time.perf_counter()
        val = cli.main(["-c", config, *overrides], callbacks=[probe])
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        nf = {"launches": sum(nf_fused.launches.values()), "by_kernel": dict(nf_fused.launches),
              "fused_blocks": nf_fused.fused["NFBlock"], "fallbacks": dict(nf_fused.fallbacks)}
        by_path = dict(by_path)
        ckpts = glob.glob(os.path.join(logdir, "*", "*", "model_last.ckpt"))
        if keep_ckpt and ckpts:
            shutil.copyfile(ckpts[0], keep_ckpt)
        resumed = _resume_eval(config, overrides, ckpts[0], val) if recipe == "adacos" and ckpts else None
        traces = glob.glob(os.path.join(logdir, "profile", "*.pt.trace.json")) if profiler_clb else []
        clb_profile = _trace_breakdown(traces[0], profiler_clb[1] - profiler_clb[0]) if len(traces) == 1 else None
    steps = len(probe.step_ms)
    loss = probe.train_metrics.get("loss", float("nan"))
    # steps 4-10 (1-based) of the last epoch, less those the profiler ran in and the one after it stopped
    # (its sync, then the profiler's own stop, leave the card idle inside that step's time); a run of two
    # epochs (``tree``) is profiled in its first
    epochs = 1 if tree is None else 2
    window = profile_window or profiler_clb
    skip = range(window[0] + 1, window[1] + 2) if window and epochs == 1 else ()
    steady = [i for i in range(3, min(len(probe.step_ms), 10)) if i not in skip]
    ms_step = statistics.median(probe.step_ms[i] for i in steady) if steady else float("nan")
    result = {
        "phase": name,
        "config": config,
        "overrides": list(extra),
        "train_steps": steps,
        "kernel_launches": launches,
        "conv1x1_stats_launches_by_path": by_path,
        "nf_fused": nf,
        "train_loss": loss,
        "val": val,
        "ms_per_step_median": ms_step,
        "steady_steps": [i + 1 for i in steady],
        "step_ms": probe.step_ms,
        "img_per_s": probe.batch_size / ms_step * 1e3,
        "input_wait_share": probe.train_metrics.get("input_wait_share"),
        "data_time_s": probe.train_metrics.get("data_time_s"),
        "epoch_time_s": probe.train_metrics.get("epoch_time_s"),
        "max_memory_allocated_gib": max(getattr(probe, "warm_peak", 0), torch.cuda.max_memory_allocated()) / 2**30,
        "max_memory_allocated_steady_gib": getattr(probe, "steady_peak", math.nan) / 2**30,
        "wall_s": wall,
        "gpu": gpu,
    }
    if tree is not None:
        result.update({
            "decoded": {k: decode.decoded[k] - decoded0[k] for k in decoded0},
            "h2d_mb_per_train_batch": h2d.get("train_bytes", 0) / max(h2d.get("train_batches", 1), 1) / 1e6,
            "h2d_mb_per_val_batch": h2d.get("val_bytes", 0) / max(h2d.get("val_batches", 1), 1) / 1e6,
            "val_weights": probe.val_weights,
            "val_shapes": probe.val_shapes,
            "val_pass_s": probe.val_pass_s,  # by epoch: G's first autotunes cuDNN for its three val shapes
            # each epoch's 10 steps: the first epoch's first step waits on the prefetch, and 10 steps
            # are too few for a steady state (the feed holds up to 5 decoded batches)
            "epoch_times_s": probe.epoch_times_s,
            "epoch_img_per_s": [steps * probe.batch_size / t for t in probe.epoch_times_s],
        })
    if cache:
        first = probe.train_metrics_by_epoch[0]
        result.update({
            "cache_fill_s": first.get("cache_fill_s"),
            "cache_mb": first.get("cache_mb"),
            "input_wait_share_by_epoch": [m.get("input_wait_share") for m in probe.train_metrics_by_epoch],
            # the index rows, copied once an epoch: the steady state's only H2D traffic
            "h2d_mb_per_train_step": h2d.get("cache_train_bytes", 0) / (2 * steps) / 1e6,
            "h2d_mb_val_per_epoch": h2d.get("cache_val_bytes", 0) / 2 / 1e6,
        })
    if profiler_clb:
        result["profile_callback"] = clb_profile
        result["profile_traces"] = len(traces)
    if probe.prof is not None:
        result["profile"] = _device_time_breakdown(probe.prof, probe.prof_wall_ms, profile_window)
        if recipe:
            by_layer, aux_steps, kernels_by_layer = layer_breakdown(probe.prof, profile_window)
            result["profile"]["by_layer_ms_per_step"] = by_layer
            result["profile"]["aux_loss_steps"] = aux_steps
            result["profile"]["top_kernels_by_layer"] = kernels_by_layer
    if recipe:
        decay = probe.weight_decay_of
        result["ema_differs_from_weights"] = probe.ema_differs
        result["weight_decay_groups"] = {
            "decayed": sum(1 for v in decay.values() if v > 0),
            "not_decayed": sum(1 for v in decay.values() if v == 0),
            "gains_decayed": sorted(k for k, v in decay.items() if "gain" in k and v > 0),
        }
    if recipe == "nfnet":
        # the main path's nf_fused launches: each microbatch a train forward and backward (the blocks'
        # fused calls over the blocks a forward), each val batch a forward
        from sota_imagenet_tpu_torch.models.nfnet import NFNet

        model = probe.runner.state.model
        microbatches = nf["fused_blocks"] // len(next(m for m in model.modules() if isinstance(m, NFNet)).blocks)
        nf["microbatches"], nf["val_forwards"] = microbatches, len(probe.val_batches)
        nf["want"] = (microbatches * nf_structural_launches(model)
                      + len(probe.val_batches) * nf_structural_launches(model, backward=False))
        nf["launches_per_step"] = (nf["launches"] - len(probe.val_batches) * nf_structural_launches(
            model, backward=False)) / max(steps * epochs, 1)
    if recipe == "nf_lamb":
        result["ortho_init"] = probe.ortho
        result["std_ema"] = probe.std_emas
        result["parameters_m"] = sum(p.numel() for p in probe.runner.state.model.parameters()) / 1e6
    if recipe == "bresnet":
        result.update(bresnet_checks(probe.runner.state.model))
    if recipe in ("adamp", "sam"):
        model = probe.runner.state.model
        calls = probe.writer.calls
        result["parameters"] = len(list(model.parameters()))
        result["parameters_m"] = sum(p.numel() for p in model.parameters()) / 1e6
        result["tb_calls"] = {k: sum(1 for c in calls if c["kind"] == k) for k in ("scalar", "histogram", "histogram_raw")}
        result["param_log_histograms"] = [c for c in calls if c["kind"] == "histogram_raw"]
        result["param_log_histogram_num_expected"] = sum(-(-p.numel() // 10) for p in model.parameters())
        result["optimizer"] = type(probe.runner.state.optimizer).__name__
    if recipe == "adamp":
        # the parameters whose step AdamP projected, each step (device booleans read at the epoch's end)
        result["adamp_projected_per_step"] = probe.projected_per_step
        result["adamp_matrix_parameters"] = probe.matrices
    if recipe == "sam":
        result["train_forwards"] = probe.train_forwards
        result["std_ema"] = probe.std_emas
    if recipe == "adacos":
        result["loss_state_per_step"] = probe.loss_state_per_step
        result["loss_state_after_val"] = probe.loss_state_after_val
        result["resume_eval"] = resumed
        result["parameters_m"] = sum(p.numel() for p in probe.runner.state.model.parameters()) / 1e6
    if recipe in LEGACY:
        model = probe.runner.state.model
        kind = LEGACY[recipe][1]
        result["parameters"] = sum(p.numel() for p in model.parameters())
        result["blocks"] = sum(1 for m in model.modules() if type(m).__name__ == kind)
        result["forward"] = forward_gmac(config)
        # fwd + bwd = 3x the forward's MACs, 2 FLOP each, over the batch
        result["tflop_per_step"] = 6 * result["forward"]["gmac_per_image"] * probe.batch_size / 1e3
        result["optimizer"] = type(getattr(probe.runner.state.optimizer, "inner", probe.runner.state.optimizer)).__name__
    if recipe == "convmixer":
        model = probe.runner.state.model
        result["parameters_m"] = sum(p.numel() for p in model.parameters()) / 1e6
        result["blocks"] = sum(1 for m in model.modules() if type(m).__name__ == "ConvMixerBlock")
        result["forward"] = forward_gmac(config)
        # fwd + bwd = 3x the forward's MACs, 2 FLOP each, over the batch
        result["tflop_per_step"] = 6 * result["forward"]["gmac_per_image"] * probe.batch_size / 1e3
    if recipe == "nondeep":
        from sota_imagenet_tpu_torch.utils.weights import unit_dims

        model = probe.runner.state.model
        dims = unit_dims(model)
        result["agc"] = probe.agc_stats
        result["agc_units_expected"] = sum(
            1 if p.dim() <= 1 or p.shape[dims[n]] == 1 else p.shape[dims[n]] for n, p in model.named_parameters()
        )
        result["parameters_m"] = sum(p.numel() for p in model.parameters()) / 1e6
        result["blocks"] = {k: sum(1 for m in model.modules() if type(m).__name__ == k) for k in ("NonDeepBlock", "UFO")}
        result["forward"] = forward_gmac(config)
        # fwd + bwd = 3x the forward's MACs, 2 FLOP each, over the batch
        result["tflop_per_step"] = 6 * result["forward"]["gmac_per_image"] * probe.batch_size / 1e3
    print(f"[{name}] {json.dumps(result)}")
    if not math.isfinite(loss) or not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"{name}: non-finite loss (train {loss}, val {val})")
    want = {k: per_step.get(k, 0) * steps * epochs for k in counters}
    if steps != 10 or launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} in {epochs} x {steps} train steps, want {want}")
    if recipe == "nfnet" and (nf["fallbacks"] or not nf["microbatches"] or nf["microbatches"] % (steps * epochs)
                              or nf["launches"] != nf["want"]):
        raise AssertionError(f"{name}: nf_fused {nf}: want no fallbacks, a whole number of microbatches a step "
                             "and the structural count of launches")
    if recipe != "nfnet" and nf["launches"]:
        raise AssertionError(f"{name}: nf_fused launched on a path that has no NFNet: {nf}")
    if by_path != {"sm90": want["conv1x1_stats"], "mma_sync": 0}:
        raise AssertionError(f"{name}: conv1x1_stats launches by path {by_path}, want all {want['conv1x1_stats']} on sm90")
    if probe.param_devices != {"cuda"} or probe.metric_devices != {"cuda"}:
        raise AssertionError(f"{name}: params on {probe.param_devices}, batches/metrics on {probe.metric_devices}")
    if not ckpts:
        raise AssertionError(f"{name}: model_last.ckpt was not written")
    if profiler_clb and (clb_profile is None or not clb_profile["fused_aug_kernels"] or not clb_profile["conv_kernels"]):
        raise AssertionError(f"{name}: the Profiler callback's traces {len(traces)}, breakdown {clb_profile}")
    if cache and (result["cache_mb"] != FOLDER_TRAIN * 224 * 224 * 3 / 1e6 or sum(result["decoded"].values())):
        raise AssertionError(f"{name}: cache of {result['cache_mb']} MB, images decoded {result['decoded']}")
    if tree is not None and (None in probe.val_weights or sum(probe.val_weights) != FOLDER_VAL):
        raise AssertionError(f"{name}: val batches weighed {probe.val_weights}, want masks summing to {FOLDER_VAL}")
    if tree is not None and len(probe.val_shapes) != val_shapes:
        raise AssertionError(f"{name}: val batches of shapes {probe.val_shapes}, want {val_shapes} shapes")
    if recipe:
        groups = result["weight_decay_groups"]
        if recipe in ("nfnet", "bresnet", "adamp", *LEGACY) and not probe.ema_differs:
            raise AssertionError(f"{name}: the EMA equals the weights after {steps} steps")
        gains = any("gain" in k for k in probe.weight_decay_of)
        if recipe in ("nfnet", "nf_lamb", "nondeep", "sam") and (
                groups["gains_decayed"] or not groups["decayed"] or not gains):
            raise AssertionError(f"{name}: weight decay groups {groups}")
        # resnet50, bresnet50, BNet and EfficientNet have no gain; the legacy recipes decay every parameter
        if recipe in ("bresnet", "adamp", *LEGACY) and (not groups["decayed"] or gains):
            raise AssertionError(f"{name}: weight decay groups {groups}")
        if recipe in LEGACY and groups["not_decayed"]:
            raise AssertionError(f"{name}: weight decay groups {groups}")
    if recipe == "adamp":
        hists = result["param_log_histograms"]
        if result["optimizer"] != "AdamP" or result["parameters"] != 161 or len(result["adamp_projected_per_step"]) != steps:
            raise AssertionError(f"{name}: optimizer {result['optimizer']}, {result['parameters']} parameters, "
                                 f"projections {result['adamp_projected_per_step']}")
        if [h["step"] for h in hists] != [0] or hists[0]["num"] != result["param_log_histogram_num_expected"]:
            raise AssertionError(f"{name}: GradDistributionTB's histograms {hists}, want one at step 0 of "
                                 f"{result['param_log_histogram_num_expected']} values")
        if result["tb_calls"]["histogram"] != 161:  # log.histogram's WeightDistributionTB, at the epoch's start
            raise AssertionError(f"{name}: TensorBoard calls {result['tb_calls']}")
    if recipe == "sam":
        if result["train_forwards"] != 2 * steps:
            raise AssertionError(f"{name}: {result['train_forwards']} training forwards in {steps} steps, want two a step")
        if not any(abs(v - 1.0) > 1e-3 for v in probe.std_emas):
            raise AssertionError(f"{name}: no VarEMA std_ema moved from 1: {probe.std_emas}")
    if recipe == "bresnet":
        ws = result["weight_standardisation"]
        if not (result["state_dict_keys_unwrapped"] and result["standardised_kernels"] == 53 and all(
                c["effective_mean_max"] < 1e-5 and c["effective_std_rel_err"] < 1e-3
                and (c["raw_mean_max"] > 1e-5 or c["raw_std_rel_err"] > 1e-3) for c in ws.values())):
            raise AssertionError(f"{name}: weight standardisation of the run's model: {result}")
    if recipe == "adacos":
        states, r = result["loss_state_per_step"], resumed
        prev_s = [st["prev_s"] for st in states]
        if len(states) != steps or not all(math.isfinite(v) for st in states for v in st.values()) or len(
                set(prev_s)) < 2 or prev_s[0] == 20.0:
            raise AssertionError(f"{name}: AdaCos's state after each step {states}")
        if result["loss_state_after_val"] != states[-1]:
            raise AssertionError(f"{name}: the val pass moved the state: {states[-1]} -> {result['loss_state_after_val']}")
        if r is None or not (r["saved"] == states[-1] == r["restored"] == r["after_eval"]):
            raise AssertionError(f"{name}: the state saved, restored and after the resumed eval: {r}, last {states[-1]}")
    if recipe in LEGACY:
        params, kind, blocks, optimizer = LEGACY[recipe]
        if (result["parameters"], result["blocks"], result["optimizer"]) != (params, blocks, optimizer):
            raise AssertionError(f"{name}: {result['parameters']} parameters, {result['blocks']} {kind}s, "
                                 f"{result['optimizer']}; want {params}, {blocks}, {optimizer}")
    if recipe == "convmixer":
        if result["blocks"] != 30 or not 19.0 < result["parameters_m"] < 21.0:
            raise AssertionError(f"{name}: {result['blocks']} ConvMixerBlocks, {result['parameters_m']}M parameters")
    if recipe == "nondeep":
        agc = result["agc"]
        if agc is None or agc["device"] != "cuda" or agc["units"] != result["agc_units_expected"] or not (
                0 < agc["clipped"] <= agc["units"] and agc["max_ratio_after"] <= 1.0 + 1e-4):
            raise AssertionError(f"{name}: AGC's record of the last step {agc}, {result['agc_units_expected']} units")
        if result["blocks"] != {"NonDeepBlock": 14, "UFO": 4}:
            raise AssertionError(f"{name}: the model holds {result['blocks']}")
    if recipe == "nf_lamb":
        ortho = probe.ortho
        if ortho is None or ortho["shape"] != [384, 64, 3, 3] or ortho["max_abs_gram_minus_eye"] > 1e-5:
            raise AssertionError(f"{name}: a NormFreeBlockTimm conv2 kernel after OrthoInitClb: {ortho}")
        if not any(abs(v - 1.0) > 1e-3 for v in probe.std_emas):
            raise AssertionError(f"{name}: no VarEMA std_ema moved from 1: {probe.std_emas}")
        if profile_window and result["profile"]["aux_loss_steps"] != {
            "forward": profile_window[1] - profile_window[0], "backward": profile_window[1] - profile_window[0]
        }:
            raise AssertionError(f"{name}: the auxiliary loss in the profiled steps: {result['profile']['aux_loss_steps']}")
    return result


# --------------------------------------------------------------------------- #
# The last trainer options: remat, the non-finite skip, debug_nans
# --------------------------------------------------------------------------- #

REMAT_POLICIES = (False, "full", "convs")
REMAT_TOL = 1e-6  # relative L2 of each remat run's step against the same step without it, on the card
# the tiny CModel of the skip and debug_nans phases (JAX tests/test_train.py's), at 16 px
TINY_LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]
SKIP_FLAT = [{"start": 0, "end": 2, "lr": [0.1, 0.1]}]
SKIP_MOVING = [{"start": 0, "end": 2, "lr": [0.2, 0.01]}]  # linear over 8 steps: a new lr every step


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms: two runs of one step give the same bits."""
    import torch

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def _remat_case(name, make_state, images, labels, criterion, lr: float) -> dict:
    """One f32 step on the card under each policy from the same seeded state:
    the loss, the gradients, the buffers after it and the criterion's state,
    each policy against no remat (relative L2, and whether bit-identical)."""
    import torch

    from sota_imagenet_tpu_torch.train import steps

    flat = lambda ts: torch.cat([t.detach().double().flatten().cpu() for t in ts]) if ts else None
    counter = kernel_counters()["conv1x1_stats"]
    runs, conv1x1 = {}, {}
    for remat in REMAT_POLICIES:
        state = make_state()
        step = steps.build_train_step(criterion, lambda i: lr, remat=remat, input_dtype=torch.float32)
        counter.launches = 0
        state, m = step(state, {"image": images.cuda(), "label": labels.cuda()})
        conv1x1[str(remat)] = counter.launches
        runs[remat] = {
            "loss": flat([m["loss"]]), "grads": flat([p.grad for p in state.model.parameters()]),
            "buffers": flat(list(state.model.buffers())),
            "loss_state": flat(list(state.loss_state.values())) if state.loss_state else None,
        }
    base, out = runs[False], {}
    for remat in REMAT_POLICIES[1:]:
        r = runs[remat]
        keys = [k for k in base if base[k] is not None]
        out[remat] = {"rel": {k: float((r[k] - base[k]).norm() / base[k].norm()) for k in keys},
                      "bit_identical": {k: bool(torch.equal(r[k], base[k])) for k in keys}}
    return {"case": name, "buffers": int(base["buffers"].numel()), "conv1x1_stats_launches": conv1x1, **out}


def remat_model_phase() -> dict:
    """``run.remat`` on the card (f32, 64 px, batch 8, cuDNN deterministic):
    a depth-cut full-width bresnet50 with drop-path 0.2 and dropout 0.2 (the
    masks come from the bound generator, which the recompute must replay),
    the config-8 BNet trunk under ForwardSpectralNorm (u/v advance once),
    the adacos_sphere trunk with AdaCos's state, and the full-width
    ``fused_stats`` ResNet-50, whose conv1x1_stats launches each policy
    counts (36 a step without remat, 72 under each: every fused conv runs
    again in its block's recompute). Under 'full' and 'convs',
    loss, gradients, buffers and the criterion's state within REMAT_TOL of
    the step without remat; whether they are bit-identical is reported."""
    import copy

    import torch
    import yaml

    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.config import instantiate
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel
    from sota_imagenet_tpu_torch.models.resnet import bresnet50, resnet50
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.callbacks import ForwardSpectralNorm

    images, labels = _seeded_batch(64)
    sgd = lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}, m.named_parameters())

    def state_of(model, optimizer=sgd, criterion=None):
        return lambda: steps.init_state(model(), optimizer, device="cuda", seed=0, criterion=criterion)

    bnet = C.load(BNET, strict_env=False)
    extra = C.to_dict(bnet.model)["extra_kwargs"]
    spectral = ForwardSpectralNorm().step_options()["parametrization"]
    adacos_model = {"_target_": "CModel", "layer_config": yaml.safe_load(ADACOS_TRUNK),
                    "extra_kwargs": {"ConvActBlock": {"activation": "swish_hard"}}}
    adacos = instantiate({"_target_": "adacos", "margin": 0.0, "max_s": 20})
    cases = [
        ("bresnet_drop_path", state_of(lambda: bresnet50(layers=(1, 1, 1, 1), drop_connect_rate=0.2)),
         CrossEntropyLoss(smoothing=0.1), 0.1),
        ("bnet_spectral", state_of(
            lambda: ParametrizedModel(CModel(layer_config=yaml.safe_load(BNET_TRUNK), extra_kwargs=extra), spectral),
            lambda m: build_optimizer(dict(bnet.optim), m.named_parameters())), CrossEntropyLoss(smoothing=0.1), 0.05),
        ("adacos_trunk", state_of(lambda: instantiate(copy.deepcopy(adacos_model)), criterion=adacos), adacos, 0.1),
        ("r50_fused_stats", state_of(lambda: resnet50(fused_stats=True)), CrossEntropyLoss(smoothing=0.1), 0.1),
    ]
    with _deterministic_cudnn():
        rows = [_remat_case(name, make, images, labels, crit, lr) for name, make, crit, lr in cases]
    result = {"phase": "model_remat", "cases": rows, "tolerance": REMAT_TOL}
    print(f"[model_remat] {json.dumps(result)}")
    bad = [(r["case"], p, k, v) for r in rows for p in REMAT_POLICIES[1:] for k, v in r[p]["rel"].items()
           if not v <= REMAT_TOL]
    if bad:
        raise AssertionError(f"model_remat: a remat step differs from the plain one: {bad}")
    fused = next(r for r in rows if r["case"] == "r50_fused_stats")["conv1x1_stats_launches"]
    if fused != {"False": 36, "full": REMAT_FULL_CONV1X1_PER_STEP, "convs": REMAT_FULL_CONV1X1_PER_STEP}:
        raise AssertionError(f"model_remat: conv1x1_stats launches per policy {fused}")
    return result


def _tiny_runner(device: str, make_optimizer, stages, debug_nans: bool = False):
    import copy

    import torch

    from sota_imagenet_tpu_torch.config import parse_stages
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.train.loop import Runner
    from sota_imagenet_tpu_torch.train.schedule import phases_from_stages

    runner = Runner(CModel(layer_config=copy.deepcopy(TINY_LAYERS)), CrossEntropyLoss(smoothing=0.1), make_optimizer,
                    lr_phases=phases_from_stages(parse_stages(stages)), input_dtype=torch.float32, device=device,
                    debug_nans=debug_nans)
    runner.init_state(seed=0)
    runner._build_steps(steps_per_epoch=4, base_epoch=0)
    return runner


def _tiny_batch(step: int, poison: bool, device: str) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(step)
    img = rng.normal(size=(8, 16, 16, 3)).astype(np.float32)
    if poison:
        img[0, 0, 0, 0] = np.inf  # BatchNorm turns it into NaN: the loss, every gradient
    return {"image": torch.from_numpy(img).to(device),
            "label": torch.from_numpy(np.eye(10, dtype=np.float32)[np.arange(8) % 10]).to(device)}


def _skip_run(device: str, skip_n: int, pattern, stages) -> list:
    """The tiny CModel's steps over ``pattern`` (True: a poisoned batch) under
    ``run.skip_nonfinite=skip_n``: after each, the weights, the counters and
    the loss."""
    import torch

    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.optim.skip_nonfinite import ApplyIfFinite

    def make_optimizer(m):
        opt = build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters())
        return ApplyIfFinite(opt, skip_n) if skip_n else opt

    runner = _tiny_runner(device, make_optimizer, stages)
    init = torch.cat([p.detach().double().flatten().cpu() for p in runner.state.model.parameters()])
    out = []
    for i, poison in enumerate(pattern):
        runner.state, m = runner._train_step(runner.state, _tiny_batch(i, poison, device))
        opt = runner.state.optimizer
        out.append({"params": torch.cat([p.detach().double().flatten().cpu() for p in runner.state.model.parameters()]),
                    "counters": opt.counters() if skip_n else None, "loss": float(m["loss"]), "lr": m["lr"]})
    return [{"init": init}, *out]


def skip_model_phase() -> dict:
    """``run.skip_nonfinite`` on the card, each case held to the same steps on
    the CPU (float32, TF32 off): a poisoned step skipped then recovery (N=3),
    NaN weights without the guard, the guard giving up after N=2, the
    schema's default, and the lr lag (a schedule that moves every step: a
    skip, then three clean steps at the schedule of the applied count)."""
    import torch

    from sota_imagenet_tpu_torch.config import RunnerConfig

    cases = {"skipped_then_recovers": (3, [True, False], SKIP_FLAT), "without_guard": (0, [True], SKIP_FLAT),
             "gives_up": (2, [True] * 4, SKIP_FLAT), "lr_lag": (3, [True, False, False, False], SKIP_MOVING)}
    rows, failures = {}, []
    for name, (n, pattern, stages) in cases.items():
        card, cpu = _skip_run("cuda", n, pattern, stages), _skip_run("cpu", n, pattern, stages)
        finite = [bool(torch.isfinite(s["params"]).all()) for s in card[1:]]
        rel = [float((a["params"] - b["params"]).norm() / b["params"].norm()) if f else None
               for a, b, f in zip(card[1:], cpu[1:], finite)]
        rows[name] = {"counters": [s["counters"] for s in card[1:]], "finite_params": finite, "rel_to_cpu": rel,
                      "losses": [s["loss"] for s in card[1:]], "lr": [s["lr"] for s in card[1:]],
                      "counters_equal_cpu": [a["counters"] for a in card[1:]] == [b["counters"] for b in cpu[1:]],
                      "finite_equal_cpu": finite == [bool(torch.isfinite(s["params"]).all()) for s in cpu[1:]]}
        r = rows[name]
        if not (r["counters_equal_cpu"] and r["finite_equal_cpu"] and all(v is None or v < 1e-5 for v in rel)):
            failures.append(f"{name}: the card against the CPU {r}")
    r = rows["skipped_then_recovers"]
    init = _skip_run("cuda", 3, [], SKIP_FLAT)[0]["init"]
    rows["skipped_step_left_the_weights"] = bool(torch.equal(
        _skip_run("cuda", 3, [True], SKIP_FLAT)[1]["params"], init))
    if not (rows["skipped_step_left_the_weights"] and r["finite_params"] == [True, True]
            and r["counters"][1]["total_notfinite"] == 1 and r["counters"][1]["notfinite_count"] == 0):
        failures.append(f"skipped_then_recovers: {r}")
    if rows["without_guard"]["finite_params"] != [False]:
        failures.append(f"without_guard: {rows['without_guard']}")
    if rows["gives_up"]["finite_params"] != [True, True, False, False]:
        failures.append(f"gives_up: {rows['gives_up']}")
    if rows["lr_lag"]["counters"][-1]["update_count"] != 3:
        failures.append(f"lr_lag: {rows['lr_lag']}")
    rows["schema_default"] = RunnerConfig().skip_nonfinite
    result = {"phase": "model_skip", "cases": rows}
    print(f"[model_skip] {json.dumps(result)}")
    if failures or rows["schema_default"] != 0:
        raise AssertionError("model_skip: " + "; ".join(failures))
    return result


def debug_nans_model_phase() -> dict:
    """``debug_nans`` on the card: a poisoned batch raises FloatingPointError
    naming the BatchNorm where its inf becomes NaN; three clean steps with it
    on equal three without it bit for bit (cuDNN deterministic)."""
    import torch

    from sota_imagenet_tpu_torch.optim import build_optimizer

    sgd = lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters())
    runner = _tiny_runner("cuda", sgd, SKIP_FLAT, debug_nans=True)
    try:
        runner._train_step(runner.state, _tiny_batch(0, True, "cuda"))
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    states = []
    with _deterministic_cudnn():
        for debug in (False, True):
            r = _tiny_runner("cuda", sgd, SKIP_FLAT, debug_nans=debug)
            for i in range(3):
                r.state, _ = r._train_step(r.state, _tiny_batch(i, False, "cuda"))
            states.append(r.state.model.state_dict())
    equal = all(torch.equal(v, states[1][k]) for k, v in states[0].items())
    result = {"phase": "model_debug_nans", "raised": raised, "clean_run_bit_equal": equal}
    print(f"[model_debug_nans] {json.dumps(result)}")
    if not (raised and "BatchNorm" in raised and equal):
        raise AssertionError(f"model_debug_nans: {result}")
    return result


# --------------------------------------------------------------------------- #
# Data parallelism on the one card: two gloo ranks over CUDA tensors, one NCCL rank
# --------------------------------------------------------------------------- #

PROBE_DTYPES = ("float32", "float64", "bfloat16", "uint8", "int64")


def _probe_rank() -> dict:
    """On one rank of a two-rank group on the card: each collective on CUDA
    tensors, "ok" with the right values or the first line of its error."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    rank, out = dist.get_rank(), {"backend": dist.get_backend()}

    def attempt(name, fn):
        try:
            good = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if good else "wrong values"
        except Exception as e:  # noqa: BLE001 - the probe records what the backend refuses
            out[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:240]}"

    def all_reduce(dt):
        t = torch.full((4096,), rank + 1, dtype=getattr(torch, dt), device="cuda")
        dist.all_reduce(t)
        return bool((t.double() == 3).all())

    for dt in PROBE_DTYPES:
        attempt(f"all_reduce_{dt}", lambda dt=dt: all_reduce(dt))

    def broadcast():
        t = torch.full((4096,), float(rank), device="cuda")
        dist.broadcast(t, 1)
        return bool((t == 1).all())

    def all_gather():
        parts = [torch.empty(8, device="cuda") for _ in range(2)]
        dist.all_gather(parts, torch.full((8,), float(rank), device="cuda"))
        return bool((parts[1] == 1).all())

    def reduce_scatter():
        t = torch.empty(8, device="cuda")
        dist.reduce_scatter(t, [torch.full((8,), float(rank + 1), device="cuda") for _ in range(2)])
        return bool((t == 3).all())

    def objects():
        box = [{"rank": rank}]
        dist.broadcast_object_list(box, 0)
        return box[0] == {"rank": 0}

    for name, fn in (("broadcast", broadcast), ("all_gather", all_gather), ("reduce_scatter", reduce_scatter),
                     ("broadcast_object_list", objects), ("barrier", lambda: dist.barrier() or True)):
        attempt(name, fn)
    return out


def ddp_probe_phase(gpu: str) -> dict:
    """Which collectives gloo takes on CUDA tensors in this PyTorch, and that
    NCCL refuses two ranks on the one card (the ground of parallel/mesh.py's
    design: all_reduce and broadcast only, gloo when ranks share a card)."""
    from sota_imagenet_tpu_torch.tools.ranks import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gloo = run_ranks(_probe_rank, 2, tmp_dir=tmp, timeout=180)
        gloo_s = time.perf_counter() - t0
        try:
            nccl = run_ranks(_probe_rank, 2, tmp_dir=tmp, timeout=120, backend="nccl")
        except RuntimeError as e:  # the group itself may fail to form: that is the refusal too
            nccl = [{"error": str(e)[-600:]}]
    result = {"phase": "ddp_probe", "gloo_cuda": gloo[0], "nccl_two_ranks_one_card": nccl[0], "gloo_wall_s": gloo_s,
              "gpu": gpu}
    print(f"[ddp_probe] {json.dumps(result)}")
    needed = ("all_reduce_float32", "all_reduce_float64", "all_reduce_uint8", "broadcast")
    if any(gloo[0][k] != "ok" for k in needed):
        raise AssertionError(f"ddp_probe: gloo refuses a collective the port needs on CUDA tensors: {gloo[0]}")
    if all(v == "ok" for k, v in nccl[0].items() if k != "backend"):
        raise AssertionError(f"ddp_probe: NCCL took two ranks on one card: {nccl[0]}")
    return result


ADACOS_TRUNK = """
- [-1, 1, ConvActBlock, [3, 32], {stride: 2}]
- [-1, 1, ConvActBlock, [32, 64], {stride: 2}]
- [-1, 1, ConvActBlock, [64, 128], {stride: 2}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, SphereLinearLayer, [128, 1000]]
"""
FIXMATCH_TRUNK = """
- [-1, 1, conv3x3, [3, 16], {stride: 2}]
- [-1, 1, BatchNorm2d, 16]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [16, 100]]
"""
DDP_STEPS = 2  # 3 before model_mesh and trainers U and V joined: room for them in the 1,200 s
# two ranks against one process on the card, relative L2 of the state's change (float64): the BN statistics
# are summed in another order over ranks; AdaCos's head rounds its cosines to float32 and AdaiS keeps float32
# second moments whose mean the shards sum in two parts (1.1e-8 on the CPU, tests/test_torch_ddp_step.py)
DDP_TOL = {"state": 1e-10, "float32_parts": 1e-7}


def _ddp_legs() -> dict:
    """The model_ddp legs: specs of tools/ranks.train_steps on the card, float64, global batch 16 at 64 px."""
    import copy

    import numpy as np
    import torch
    import yaml

    from sota_imagenet_tpu_torch.config import instantiate
    from sota_imagenet_tpu_torch.tools.dryrun_multichip import spec

    base = {**spec(2, 1, per_rank=8, steps=DDP_STEPS), "device": "cuda", "zero1": False, "accumulate_steps": 1,
            "sam": None, "ema_decay": 0.0, "mixup": None}
    sgd = base["optim"]
    adacos_model = {"_target_": "CModel", "layer_config": yaml.safe_load(ADACOS_TRUNK),
                    "extra_kwargs": {"ConvActBlock": {"activation": "swish_hard"}}}
    m = instantiate(copy.deepcopy(adacos_model))
    m.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    adacos_batches = [(rng.uniform(-2.0, 2.0, (16, 64, 64, 3)), np.eye(1000)[rng.integers(0, 1000, 16)])
                      for _ in range(DDP_STEPS)]
    legs = {
        "a_sgd_ema_cutmix": {**base, "ema_decay": 0.999, "mixup": spec(2, 1, per_rank=8, steps=DDP_STEPS)["mixup"]},
        "b_bn_local": {**base, "bn_stats": 2},
        "b_bn_4": {**base, "bn_stats": 4},
        "c_accumulate_2_asam_unitwise": {**base, "accumulate_steps": 2,
                                         "sam": {"kind": "asam_unitwise", "rho": 0.05, "eta": 0.01,
                                                 "bn_from_perturbed": True}},
        "e_adacos": {**base, "model": adacos_model, "init": {k: v.numpy().copy() for k, v in m.state_dict().items()},
                     "criterion": {"_target_": "adacos", "margin": 0.0, "max_s": 20}, "batches": adacos_batches},
    }
    # FixMatch pairs global row i with row i + 8, on the other rank; a CModel, whose logits stay float64
    # (the ResNet's head returns float32 ones, and the criterion's sums would then round in float32)
    fixmatch_model = {"_target_": "CModel", "layer_config": yaml.safe_load(FIXMATCH_TRUNK)}
    m = instantiate(copy.deepcopy(fixmatch_model))
    m.reset_parameters(torch.Generator().manual_seed(0))
    legs["f_fixmatch"] = {**base, "model": fixmatch_model, "init": {k: v.numpy().copy() for k, v in m.state_dict().items()},
                          "criterion": {"_target_": "FixMatchLoss", "hard_weight": 0.5, "hard_pct": 0.2}}
    # remat 'convs': every BatchNorm's all-reduce runs again in the recompute
    legs["g_remat_convs"] = {**base, "remat": "convs"}
    # ZeRO-1 with the skip: the next-to-last step's batch holds an inf in row 0, which only rank 0 loads; the averaged
    # gradient is NaN on both ranks, so both skip that update
    poisoned = [(im.copy(), lb) for im, lb in base["batches"]]
    poisoned[DDP_STEPS - 2][0][0, 0, 0, 0] = np.inf  # the step before the last: the last one finite again
    legs["h_zero1_skip"] = {**base, "zero1": True, "skip_nonfinite": 2, "batches": poisoned}
    for name, optim, lr in (("adamw", {"_target_": "adamw", "weight_decay": 1e-2}, 1e-3),
                            ("adais", {"_target_": "adais", "weight_decay": 1e-4}, base["lr"]),
                            ("lookahead_sgd", {**sgd, "lookahead": True, "lookahead_k": 2}, base["lr"])):
        legs[f"d_zero1_{name}"] = {**base, "optim": optim, "lr": lr, "zero1": True}
        legs[f"d_replicated_{name}"] = {**base, "optim": optim, "lr": lr}
    return legs


def _max_rel(pairs) -> float:
    """The largest relative difference of (got, want) pairs; a pair non-finite on both sides alike counts 0."""
    out = 0.0
    for a, b in pairs:
        if not (math.isfinite(a) and math.isfinite(b)):
            if not (math.isnan(a) and math.isnan(b)) and a != b:
                return math.inf
            continue
        out = max(out, abs(a - b) / abs(b))
    return out


def _rel_delta(got: dict, want: dict, init: dict) -> float:
    keys = [k for k in init if init[k].dtype.kind == "f"]
    err = sum(float(((got[k] - want[k]) ** 2).sum()) for k in keys)
    ref = sum(float(((want[k] - init[k]) ** 2).sum()) for k in keys)
    return (err / max(ref, 1e-300)) ** 0.5


def model_ddp_phase(gpu: str) -> dict:
    """DDP_STEPS float64 steps on the card of each leg, on two gloo ranks sharing
    it against one process on it with the same global batch of 16 (TF32
    off): (a) SGD, EMA, sync-BN, cutmix with pre-drawn values; (b)
    bn_stats=local and bn_stats=4; (c) accumulate_steps=2 with unit-wise
    SAM; (d) ZeRO-1 under AdamW, AdaiS and Lookahead(SGD), each against the
    replicated two-rank run (bit for bit, AdaiS within DDP_TOL); (e) a
    depth-cut adacos_sphere trunk with AdaCos's state; (f) FixMatchLoss,
    whose pairs sit on the other rank; (g) run.remat 'convs', the
    recompute's BatchNorm all-reduces counted; (h) ZeRO-1 with
    skip_nonfinite 2 and an inf in rank 0's rows of step 2: both ranks skip
    that update. Loss, grad_norm, the weights, BN buffers and EMA, and the
    criterion's state."""
    import numpy as np

    from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_legs, train_steps

    legs = _ddp_legs()
    names = list(legs)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(train_legs, 2, ([legs[n] for n in names],), tmp_dir=tmp, timeout=600)
    ranks_s = time.perf_counter() - t0
    out, failures = {}, []
    for i, name in enumerate(names):
        r0, r1 = ranks[0][i], ranks[1][i]
        init = legs[name]["init"]
        if name == "h_zero1_skip":  # the poisoned batch leaves NaN running statistics: the weights are compared
            init = {k: v for k, v in init.items() if "running" not in k}
        row = {"ranks_bit_equal": all(np.array_equal(r0["model"][k], r1["model"][k], equal_nan=True)
                                      for k in r0["model"]),
               "loss": [m["loss"] for m in r0["metrics"]], "grad_norm": [m["grad_norm"] for m in r0["metrics"]],
               "collectives_per_step": {k: v / DDP_STEPS for k, v in r0["collectives"].items()}}
        if not row["ranks_bit_equal"]:
            failures.append(f"{name}: the ranks' weights differ")
        if "_replicated_" not in name:
            one = train_steps(legs[name])  # one process on the card, no group
            tol = DDP_TOL["float32_parts"] if name in ("e_adacos", "d_zero1_adais") else DDP_TOL["state"]
            row["vs_one_process"] = {
                "state_rel_l2": _rel_delta(r0["model"], one["model"], init),
                "ema_rel_l2": _rel_delta(r0["ema"], one["ema"], init) if one["ema"] is not None else None,
                "loss_rel": _max_rel((a["loss"], b["loss"]) for a, b in zip(r0["metrics"], one["metrics"])),
                "grad_norm_rel": _max_rel((a["grad_norm"], b["grad_norm"]) for a, b in zip(r0["metrics"], one["metrics"])),
                "loss_state": None if one["loss_state"] is None else {
                    k: [float(r0["loss_state"][k]), float(v)] for k, v in one["loss_state"].items()},
                "tolerance": tol,
            }
            v = row["vs_one_process"]
            if not (v["state_rel_l2"] < tol and (v["ema_rel_l2"] is None or v["ema_rel_l2"] < tol)
                    and v["loss_rel"] <= 2**-23 and v["grad_norm_rel"] < max(tol, 1e-10)):
                failures.append(f"{name}: two ranks against one process {v}")
            if one["loss_state"] is not None and not all(
                    abs(a - b) <= 1e-6 * abs(b) for a, b in row["vs_one_process"]["loss_state"].values()):
                failures.append(f"{name}: AdaCos's state {v['loss_state']}")
        if name == "h_zero1_skip":
            row["skip_counters"] = [r0["skip"], r1["skip"]]
            if not r0["skip"] == r1["skip"] == {"notfinite_count": 0, "last_finite": True, "total_notfinite": 1,
                                                "update_count": DDP_STEPS - 1}:
                failures.append(f"{name}: the ranks' skip counters {row['skip_counters']}")
        if name == "g_remat_convs":  # the recompute's BatchNorm all-reduces, beside leg a's (no remat)
            row["bn_collectives_per_step_without_remat"] = ranks[0][names.index("a_sgd_ema_cutmix")][
                "collectives"].get("bn", 0) / DDP_STEPS
        if name.startswith("d_zero1_"):
            rep = ranks[0][names.index(name.replace("zero1", "replicated"))]
            diff = max(float(np.abs(r0["model"][k] - rep["model"][k]).max()) for k in r0["model"])
            row["zero1_vs_replicated"] = {"max_abs_diff": diff, "state_rel_l2": _rel_delta(r0["model"], rep["model"], init)}
            limit = 0.0 if name != "d_zero1_adais" else None
            if (limit is not None and diff != limit) or (
                    limit is None and row["zero1_vs_replicated"]["state_rel_l2"] >= DDP_TOL["float32_parts"]):
                failures.append(f"{name}: ZeRO-1 against the replicated run {row['zero1_vs_replicated']}")
        out[name] = row
    result = {"phase": "model_ddp", "legs": out, "two_rank_wall_s": ranks_s, "gpu": gpu}
    print(f"[model_ddp] {json.dumps(result)}")
    if failures:
        raise AssertionError("model_ddp: " + "; ".join(failures))
    return result


WHEEL_CHECK = r"""
import json, sys, torch
import sota_imagenet_tpu_torch
from sota_imagenet_tpu_torch.ops import cuda_build
from sota_imagenet_tpu_torch.ops.fused_aug import draw_augment_scalars, fused_augment, fused_augment_reference
gen = torch.Generator(device="cuda").manual_seed(0)
imgs = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8, device="cuda", generator=gen)
kw = dict(color_twist_prob=0.4, gray_prob=0.2, re_prob=0.3, re_count=3)
scalars = draw_augment_scalars(gen, 8, device="cuda", **kw)
before = fused_augment.launches
out = fused_augment(imgs, scalars, out_dtype=torch.bfloat16, **kw)
ref = fused_augment_reference(imgs, scalars, out_dtype=torch.bfloat16, **kw)
from sota_imagenet_tpu_torch.ops import nf_fused
x = torch.randn((4, 8, 8, 64), device="cuda", generator=gen).to(torch.bfloat16).permute(0, 3, 1, 2)
b = torch.randn(64, device="cuda", generator=gen)
nf_before = sum(nf_fused.launches.values())
y = nf_fused.nf_act(x, b, 1.7881293296813965)
y_ref = nf_fused.nf_act_reference(x.float(), b, 1.7881293296813965)
torch.cuda.synchronize()
print(json.dumps({"package": sota_imagenet_tpu_torch.__file__, "build_dir": str(cuda_build.build_dir()),
                  "library": str(cuda_build.library_path("fused_aug", ["fused_aug.cu"])),
                  "launches": fused_augment.launches - before,
                  "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                  "nf_library": str(cuda_build.library_path("nf_fused", ["nf_fused.cu"])),
                  "nf_launches": sum(nf_fused.launches.values()) - nf_before,
                  "nf_max_rel_err": ((y.float() - y_ref).abs() / y_ref.abs().clamp_min(1e-3)).max().item(),
                  "sys_path": sys.path}))
"""


def wheel_phase(gpu: str) -> dict:
    """The port installed from a wheel of this checkout, outside it: ``pip
    wheel`` of a copy of the tree (offline: no index, no build isolation, no
    dependencies), ``pip install --no-deps --target`` into a temporary
    directory, then a fresh interpreter that has that directory on its path
    and no directory of the checkout imports the port, builds fused_aug from
    the wheel's own csrc/ and launches it on the card against its plain
    version (bit for bit), and nf_fused's ``nf_act`` likewise (within one
    bf16 ulp, 2**-7 of the value); then the installed ``sota-train-torch`` console
    script trains tiny_synthetic for one debug epoch on the card and must
    exit 0 with its model_last.ckpt written."""
    import glob
    import shutil
    import subprocess
    import zipfile

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PIP_NO_INDEX": "1", "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tree, wheels, site, work = (os.path.join(tmp, d) for d in ("tree", "wheels", "site", "work"))
        os.makedirs(tree)
        os.makedirs(work)
        for name in ("pyproject.toml", "MANIFEST.in", "README.md", "LICENSE"):
            shutil.copy2(os.path.join(repo, name), tree)
        ignore = shutil.ignore_patterns("__pycache__", "_build", "*.pyc", "*.so")
        for pkg in ("sota_imagenet_tpu", "sota_imagenet_tpu_torch"):
            shutil.copytree(os.path.join(repo, pkg), os.path.join(tree, pkg), ignore=ignore)
        pip = [sys.executable, "-m", "pip", "--disable-pip-version-check", "-q"]
        subprocess.run([*pip, "wheel", ".", "--no-deps", "--no-build-isolation", "--no-index", "-w", wheels],
                       cwd=tree, env=env, check=True, capture_output=True, text=True, timeout=300)
        (whl,) = [os.path.join(wheels, f) for f in os.listdir(wheels) if f.endswith(".whl")]
        cu = sorted(n for n in zipfile.ZipFile(whl).namelist() if n.endswith(".cu"))
        subprocess.run([*pip, "install", "--no-deps", "--no-index", "--target", site, whl], env=env, check=True,
                       capture_output=True, text=True, timeout=300)
        proc = subprocess.run([sys.executable, "-c", WHEEL_CHECK], cwd=work, env={**env, "PYTHONPATH": site},
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"wheel: the installed port failed:\n{proc.stdout}\n{proc.stderr}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        # the installed console script trains tiny_synthetic for one debug epoch on the card
        logs, t1 = os.path.join(work, "logs"), time.perf_counter()
        script = subprocess.run([os.path.join(site, "bin", "sota-train-torch"), "-c", os.path.join(repo, "configs",
                                 "tiny_synthetic.yaml"), "log.tensorboard=false", f"log.dir={logs}",
                                 "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]"], cwd=work,
                                env={**env, "PYTHONPATH": site}, capture_output=True, text=True, timeout=600)
        script_result = {"rc": script.returncode, "seconds": time.perf_counter() - t1,
                         "on_the_card": "| device: cuda" in script.stdout + script.stderr,
                         "model_last": len(glob.glob(os.path.join(logs, "*", "*", "model_last.ckpt")))}
        if script.returncode != 0:
            print(f"[wheel] sota-train-torch:\n{script.stdout[-3000:]}\n{script.stderr[-3000:]}", flush=True)
        site = os.path.realpath(site)
    result = {"phase": "wheel", "cu_files": cu, "package": got["package"], "build_dir": got["build_dir"],
              "launches": got["launches"], "max_abs_err": got["max_abs_err"], "nf_launches": got["nf_launches"],
              "nf_max_rel_err": got["nf_max_rel_err"],
              "outside_checkout": not got["package"].startswith(repo) and not any(
                  p and os.path.abspath(p).startswith(repo) for p in got["sys_path"]),
              "sota_train_torch": script_result, "seconds": time.perf_counter() - t0, "gpu": gpu}
    print(f"[wheel] {json.dumps(result)}")
    if len(cu) != 5 or result["launches"] != 1 or result["max_abs_err"] != 0.0 or not result["outside_checkout"]:
        raise AssertionError(f"wheel: {result}")
    if result["nf_launches"] != 1 or result["nf_max_rel_err"] > 2.0**-7:
        raise AssertionError(f"wheel: nf_fused from the wheel: {result}")
    if not result["build_dir"].startswith(site):
        raise AssertionError(f"wheel: built into {result['build_dir']}, not beside the installed package")
    if script_result["rc"] != 0 or not script_result["on_the_card"] or script_result["model_last"] != 1:
        raise AssertionError(f"wheel: the installed sota-train-torch: {script_result}")
    return result


def truncated_fused_resnet():
    """trainer P's truncated ResNet (two one-block stages, 100 classes) with ``fused_stats``: every 1x1 conv
    and its BatchNorm through conv1x1_stats, a strided ``fdown`` among them."""
    from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet

    return ResNet(block=Bottleneck, layers=(1, 1), num_classes=100, fused_stats=True)


# the fused legs' products are bf16: one rank's band and one process's image round a few products apart once their
# inputs differ by float32's noise (the BatchNorm sums' order), so they agree to bf16's grain, not float64's
MESH_FUSED_TOL = {"loss": 1e-3, "state": 1e-2}


def mesh_model_phase(gpu: str) -> dict:
    """The mesh's two new axes on two gloo ranks sharing the card, each leg
    against one process on the card with the same global batch:
    i_spatial_2, trainer P's truncated ResNet at 64 px in float64 (SGD, EMA,
    cutmix with pre-drawn values, sync-BN) with mesh.spatial=2 (DDP_STEPS steps,
    within DDP_TOL), and the same with ``fused_stats`` in float32 (1 step;
    conv1x1_stats on each rank's band, its sums over both); j_tp_2, the
    depth-cut adacos_sphere trunk with mesh.model=2 and its SphereLinearLayer
    class-sharded (AdaCos's state, float32 cosines: DDP_TOL's float32
    parts). Loss, grad_norm, the weights, BN buffers and EMA, and the ranks
    bit for bit."""
    import copy

    import numpy as np
    import torch

    from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_legs, train_steps

    legs = _ddp_legs()
    base = {**legs["a_sgd_ema_cutmix"], "zero1": False}
    fused = truncated_fused_resnet()
    fused.reset_parameters(torch.Generator().manual_seed(0))
    mesh_legs = {
        "i_spatial_2": {**base, "spatial": 2},
        "i_spatial_2_fused_stats": {**base, "spatial": 2, "model": truncated_fused_resnet, "dtype": "float32",
                                    "init": {k: v.numpy().copy() for k, v in fused.state_dict().items()},
                                    "batches": base["batches"][:1], "mixup": None, "ema_decay": 0.0},
        "j_tp_2": {**copy.deepcopy(legs["e_adacos"]), "model_axis": 2, "tp_params": ["SphereLinearLayer"]},
    }
    names = list(mesh_legs)
    counters = kernel_counters()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(train_legs, 2, ([mesh_legs[n] for n in names],), tmp_dir=tmp, timeout=600)
    ranks_s = time.perf_counter() - t0
    out, failures = {}, []
    for i, name in enumerate(names):
        r0, r1 = ranks[0][i], ranks[1][i]
        spec = {**mesh_legs[name], "spatial": 1, "model_axis": 1}
        counters["conv1x1_stats"].launches = 0
        one = train_steps(spec)
        init = spec["init"]
        row = {"ranks_bit_equal": all(np.array_equal(r0["model"][k], r1["model"][k]) for k in r0["model"]),
               "loss": [m["loss"] for m in r0["metrics"]], "loss_one_process": [m["loss"] for m in one["metrics"]],
               "state_rel_l2": _rel_delta(r0["model"], one["model"], init),
               "loss_rel": _max_rel((a["loss"], b["loss"]) for a, b in zip(r0["metrics"], one["metrics"])),
               "grad_norm_rel": _max_rel((a["grad_norm"], b["grad_norm"]) for a, b in zip(r0["metrics"], one["metrics"])),
               "collectives_per_step": {k: v / len(r0["metrics"]) for k, v in r0["collectives"].items()},
               "shards": r0["shards"], "conv1x1_stats_launches_one_process": counters["conv1x1_stats"].launches}
        if name == "i_spatial_2_fused_stats":
            ok = row["loss_rel"] < MESH_FUSED_TOL["loss"] and row["state_rel_l2"] < MESH_FUSED_TOL["state"]
            ok = ok and row["conv1x1_stats_launches_one_process"] > 0
        else:
            tol = DDP_TOL["float32_parts"] if name == "j_tp_2" else DDP_TOL["state"]
            row["tolerance"] = tol
            ok = row["state_rel_l2"] < tol and row["loss_rel"] <= 2**-23 and row["grad_norm_rel"] < max(tol, 1e-10)
            if name == "j_tp_2":
                row["loss_state"] = {k: [float(r0["loss_state"][k]), float(v)] for k, v in one["loss_state"].items()}
                ok = ok and all(abs(a - b) <= 1e-6 * abs(b) for a, b in row["loss_state"].values())
                ok = ok and r0["shards"] == {"layers.4.0.weight": [1, 1000]} and r0["collectives"].get("tp_gather")
            else:
                ok = ok and r0["collectives"].get("halo")
        if not (ok and row["ranks_bit_equal"]):
            failures.append(f"{name}: {row}")
        out[name] = row
    result = {"phase": "model_mesh", "legs": out, "two_rank_wall_s": ranks_s, "gpu": gpu}
    print(f"[model_mesh] {json.dumps(result)}")
    if failures:
        raise AssertionError("model_mesh: " + "; ".join(failures))
    return result


def _digest(model) -> str:
    """A hash of every parameter and buffer's bytes, in the state_dict's order
    (a head-TP shard gathered whole: every rank of a run must call it)."""
    import hashlib

    import torch

    from sota_imagenet_tpu_torch.parallel import tp

    h = hashlib.sha256()
    for v in tp.full_state_dict(model).values():
        h.update(v.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _all_reduce_ms(numel: int, reps: int = 5) -> float:
    """The median ms of one sum all-reduce of ``numel`` float32 on the card, the gradient's size."""
    import torch

    from sota_imagenet_tpu_torch.parallel import mesh as par

    buf = torch.ones(numel, device="cuda")
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        par.all_reduce_(buf, "timing")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def ddp_trainer_rank(config: str, overrides: list, log_dir: str, timed: bool, resume_eval: bool) -> dict:
    """One rank of a data-parallel trainer on the card: cli.main with every
    kernel counter at 0 just before it, the collectives counted (and timed
    with ``timed``), then the gradient-sized all-reduce alone and, with
    ``resume_eval``, a run.evaluate=true resume of the run's model_last.ckpt."""
    import glob

    import torch
    import torch.distributed as dist

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.parallel import mesh as par
    from sota_imagenet_tpu_torch.parallel import tp

    probe = _probe_callback()
    counters = kernel_counters()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0  # counts from here are this path's
    par.STATS.reset()
    par.STATS.timed = timed
    t0 = time.perf_counter()
    val = cli.main(["-c", config, *overrides, f"log.dir={log_dir}"], callbacks=[probe])
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    stats = par.STATS.as_dict()
    par.STATS.timed = False
    model = probe.runner.state.model
    out = {
        "rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(), "val": val,
        "launches": launches, "step_ms": probe.step_ms, "batch_size": probe.batch_size,
        "train_loss": probe.train_metrics.get("loss"), "collectives": stats, "wall_s": wall,
        "max_memory_allocated_gib": max(getattr(probe, "warm_peak", 0), torch.cuda.max_memory_allocated()) / 2**30,
        "max_memory_allocated_steady_gib": getattr(probe, "steady_peak", math.nan) / 2**30,
        "digest": _digest(model), "parameters": sum(p.numel() for p in model.parameters()),
        "head_bytes": {n: p.numel() * p.element_size() for n, p in model.named_parameters() if n in tp.sharded(model)},
        "optimizer": type(probe.runner.state.optimizer).__name__,
        "param_devices": sorted(probe.param_devices),
    }
    out["grad_all_reduce_alone_ms"] = _all_reduce_ms(out["parameters"])
    ckpts = sorted(glob.glob(os.path.join(log_dir, "*", "*", "model_last.ckpt")))
    out["model_last_ckpts"] = len(ckpts)
    if resume_eval and ckpts:
        out["resume_val"] = cli.main(["-c", config, *overrides, f"log.dir={log_dir}", "run.evaluate=true",
                                      f"run.resume={ckpts[0]}"])
    return out


P_OVERRIDES = ("mesh.data=2", "mesh.zero1=true")
P1_OVERRIDES = ("mesh.data=-1", "mesh.zero1=true", "val_loader.batch_size=64")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ddp_summary(ranks: list, data_ranks: int = None) -> dict:
    """The trainer's figures from its ranks' results (rank 0's clock); ``data_ranks``: the ranks that
    split the batch (all of them without spatial or model ranks)."""
    r0 = ranks[0]
    steps = len(r0["step_ms"])
    ms = statistics.median(r0["step_ms"][3:10])
    global_batch = r0["batch_size"] * (data_ranks or r0["world"])
    col = r0["collectives"]

    def per_step(kinds):
        calls = sum(col.get(k, {}).get("calls", 0) for k in kinds)
        secs = [col.get(k, {}).get("seconds") for k in kinds if k in col]
        return {"calls": calls / steps, "bytes": sum(col.get(k, {}).get("bytes", 0) for k in kinds) / steps,
                "ms": (sum(secs) * 1e3 / steps) if secs and None not in secs else None}

    return {
        "backend": r0["backend"], "world": r0["world"], "global_batch": global_batch, "train_steps": steps,
        "ms_per_step_median": ms, "steady_steps": list(range(4, 11)), "img_per_s": global_batch / ms * 1e3,
        "step_ms": r0["step_ms"],
        "grad_all_reduce": per_step(("grad",)), "bn_collectives": per_step(("bn", "bn_backward")),
        "zero1_param_broadcasts": per_step(("params",)),
        "grad_all_reduce_alone_ms": [r["grad_all_reduce_alone_ms"] for r in ranks],
        "max_memory_allocated_gib_per_rank": [r["max_memory_allocated_gib"] for r in ranks],
        "max_memory_allocated_steady_gib_per_rank": [r["max_memory_allocated_steady_gib"] for r in ranks],
        "launches_per_rank": [r["launches"] for r in ranks], "parameters": r0["parameters"],
        "optimizer": r0["optimizer"], "train_loss": r0["train_loss"], "val": r0["val"],
        "wall_s": max(r["wall_s"] for r in ranks),
    }


def trainer_p_phase(gpu: str) -> dict:
    """r50_baseline at full width through cli.main as two ranks sharing the
    card (gloo over CUDA tensors; NCCL refuses them), mesh.data=2,
    mesh.zero1=true: global batch 256 at 224 px, 128 a rank, bf16, synthetic,
    debug, trainer A's stage. The collectives are timed, each between two
    synchronisations (gloo stages them through the host and waits for them
    anyway). Checks: every rank's parameters and BN buffers equal bit for bit
    after step 10, fused_aug launched 10 times in 10 steps on each rank (no
    conv1x1_stats or moments), model_last.ckpt written once, and a
    run.evaluate=true resume on two ranks reproduces the run's val metrics
    exactly."""
    from sota_imagenet_tpu_torch.tools.ranks import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "logs")
        ranks = run_ranks(ddp_trainer_rank, 2, (R50, [*TRAINER_OVERRIDES, *P_OVERRIDES], log_dir, True, True),
                          tmp_dir=tmp, timeout=900)
    result = {"phase": "trainer_p", "config": R50, "overrides": list(P_OVERRIDES), **_ddp_summary(ranks),
              "digests_equal": len({r["digest"] for r in ranks}) == 1,
              "model_last_ckpts": ranks[0]["model_last_ckpts"],
              "resume_val_equal": all(r.get("resume_val") == r["val"] for r in ranks), "gpu": gpu}
    print(f"[trainer_p] {json.dumps(result)}")
    want = {"fused_aug": 10, "conv1x1_stats": 0, "moments": 0}
    if result["train_steps"] != 10 or any(r["launches"] != want for r in ranks):
        raise AssertionError(f"trainer_p: launches per rank {result['launches_per_rank']}, want {want} each")
    if not result["digests_equal"] or result["model_last_ckpts"] != 1 or not result["resume_val_equal"]:
        raise AssertionError(f"trainer_p: replicas equal {result['digests_equal']}, model_last.ckpt "
                             f"{result['model_last_ckpts']}, resumed eval {[r.get('resume_val') for r in ranks]} "
                             f"against {ranks[0]['val']}")
    if result["backend"] != "gloo" or result["optimizer"] != "Zero1" or ranks[0]["param_devices"] != ["cuda"]:
        raise AssertionError(f"trainer_p: backend {result['backend']}, optimizer {result['optimizer']}")
    if not math.isfinite(result["train_loss"]) or not all(math.isfinite(v) for v in result["val"].values()):
        raise AssertionError(f"trainer_p: non-finite loss {result['train_loss']}, val {result['val']}")
    return result


# a val batch of 64 (the config's is 250): the trainers' 20 val steps are a check, and the run's seconds are short
MESH_TRAINERS = {"trainer_u": ("mesh.spatial=2", "val_loader.batch_size=64"),
                 "trainer_v": ("mesh.model=2", "val_loader.batch_size=64")}


def mesh_trainer_ranks(names: list, log_dir: str) -> list:
    """ddp_trainer_rank for each of the mesh trainers ``names``, one after the other on this rank (one spawn)."""
    return [ddp_trainer_rank(R50, [*TRAINER_OVERRIDES, *MESH_TRAINERS[n]], os.path.join(log_dir, n), True, False)
            for n in names]


def mesh_trainers_phase(names: list, gpu: str) -> dict:
    """Trainers U and V (trainer_mesh_result) from one spawn of two ranks."""
    from sota_imagenet_tpu_torch.tools.ranks import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(mesh_trainer_ranks, 2, (names, os.path.join(tmp, "logs")), tmp_dir=tmp, timeout=1200)
    out, failures = {}, []
    for i, name in enumerate(names):
        try:
            out[name] = trainer_mesh_result(name, [r[i] for r in ranks], gpu)
        except AssertionError as e:
            failures.append(str(e))
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def trainer_mesh_result(name: str, ranks: list, gpu: str) -> dict:
    """r50_baseline at full width through cli.main as two gloo ranks sharing
    the card, trainer P's batch (256 at 224 px, bf16, synthetic, debug, 10
    steps) on one data rank: U with mesh.spatial=2 (each rank a 112-row band
    of every image, the deepest map 7 rows split 3 and 4), V with
    mesh.model=2 (each rank 500 of the head's 1000 classes). The collectives
    are timed, each between two synchronisations. Checks: fused_aug 10
    launches on each rank (the same rows, the same draws), no conv1x1_stats
    or moments; the ranks' weights equal bit for bit (V's head gathered
    whole); finite losses; U's halos and V's class gathers counted."""
    overrides = MESH_TRAINERS[name]
    summary = _ddp_summary(ranks, data_ranks=1)
    col, steps = ranks[0]["collectives"], summary["train_steps"]

    def per_step(kinds):
        secs = [col[k]["seconds"] for k in kinds if k in col]
        return {"calls": sum(col.get(k, {}).get("calls", 0) for k in kinds) / steps,
                "bytes": sum(col.get(k, {}).get("bytes", 0) for k in kinds) / steps,
                "ms": sum(secs) * 1e3 / steps if secs else 0.0}

    result = {"phase": name, "config": R50, "overrides": list(overrides), **summary,
              "halo": per_step(("halo", "halo_backward")),
              "spatial_gather": per_step(("spatial_gather", "spatial_gather_backward")),
              "spatial_sums": per_step(("spatial_sum", "spatial_sum_backward")),
              "class_gathers": per_step(("tp_gather", "tp_input_backward", "tp_reduce")),
              "collective_ms_per_step": sum(v["seconds"] or 0.0 for v in col.values()) * 1e3 / steps,
              "head_bytes_per_rank": [sum(r["head_bytes"].values()) for r in ranks],
              "digests_equal": len({r["digest"] for r in ranks}) == 1, "gpu": gpu}
    print(f"[{name}] {json.dumps(result)}")
    want = {"fused_aug": 10, "conv1x1_stats": 0, "moments": 0}
    if result["train_steps"] != 10 or any(r["launches"] != want for r in ranks):
        raise AssertionError(f"{name}: launches per rank {result['launches_per_rank']}, want {want} each")
    if not result["digests_equal"]:
        raise AssertionError(f"{name}: the ranks' weights differ")
    if not math.isfinite(result["train_loss"]) or not all(math.isfinite(v) for v in result["val"].values()):
        raise AssertionError(f"{name}: non-finite loss {result['train_loss']}, val {result['val']}")
    if name == "trainer_u" and not result["halo"]["calls"]:
        raise AssertionError("trainer_u: no halo exchanged")
    if name == "trainer_v" and (not result["class_gathers"]["calls"] or result["head_bytes_per_rank"] != [500 * 2049 * 4] * 2):
        raise AssertionError(f"trainer_v: class gathers {result['class_gathers']}, head bytes {result['head_bytes_per_rank']}")
    return result


def trainer_p1_phase(gpu: str) -> dict:
    """The same config as one rank under NCCL, from torchrun's environment
    (RANK=0, WORLD_SIZE=1, mesh.data=-1, mesh.zero1=true): the NCCL init and
    every collective of the path run on the card, untimed (each would
    synchronise), so its ms/step against trainer A's is their cost at one
    rank."""
    from sota_imagenet_tpu_torch.tools.ranks import run_ranks

    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "logs")
        ranks = run_ranks(ddp_trainer_rank, 1, (R50, [*TRAINER_OVERRIDES, *P1_OVERRIDES], log_dir, False, False),
                          tmp_dir=tmp, timeout=600, backend=None, env=env)
    result = {"phase": "trainer_p1", "config": R50, "overrides": list(P1_OVERRIDES), **_ddp_summary(ranks),
              "model_last_ckpts": ranks[0]["model_last_ckpts"], "gpu": gpu}
    print(f"[trainer_p1] {json.dumps(result)}")
    want = {"fused_aug": 10, "conv1x1_stats": 0, "moments": 0}
    if result["backend"] != "nccl" or ranks[0]["launches"] != want or result["model_last_ckpts"] != 1:
        raise AssertionError(f"trainer_p1: backend {result['backend']}, launches {ranks[0]['launches']}")
    if not math.isfinite(result["train_loss"]):
        raise AssertionError(f"trainer_p1: non-finite loss {result['train_loss']}")
    return result


# kernel-name fragments -> the layer a device kernel belongs to (first match wins)
KERNEL_GROUPS = (
    ("fused_aug", ("fused_aug",)),
    # before conv/matmul, whose fragment "conv" would claim conv1x1_stats_kernel
    ("conv1x1_stats", ("conv1x1_stats",)),
    ("moments", ("moments_kernel",)),
    # the device cache's torch.index_select: vectorized_gather_kernel for the image rows, the
    # scatter/gather kernel for the labels (not gatherTopK: that is the Acc@5 metric's top-k)
    ("gather", ("vectorized_gather", "scatter_gather", "indexselect", "index_select")),
    ("memcpy", ("memcpy", "memset")),
    ("conv/matmul", ("conv", "gemm", "sm90", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "cudnn")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_")),
    ("optimizer/EMA", ("multi_tensor", "foreach")),
)


def _device_time_breakdown(prof, wall_ms: float, window) -> dict:
    """Device time of the profiled steps by layer and by kernel, beside the
    window's wall time (busy share = device time / wall), and the device
    operations (kernels, copies, fills) a step."""
    from torch.autograd import DeviceType

    averages = prof.key_averages()
    # the profiler mirrors each record_function scope (the optimizer's own, the layer scopes) as a
    # device event spanning its kernels and the gaps between them: not device work
    scopes = {e.key for e in averages if e.device_type == DeviceType.CPU and e.is_user_annotation}
    rows = sorted(
        (
            (e.self_device_time_total / 1e3, e.count, e.key)
            for e in averages
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.key not in scopes
        ),
        reverse=True,
    )
    groups: dict = {}
    members: dict = {}  # group -> its kernels, largest first
    for ms, n, key in rows:
        low = key.lower()
        group = next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")
        groups[group] = groups.get(group, 0.0) + ms
        members.setdefault(group, []).append({"ms_per_step": ms / (window[1] - window[0]), "calls": n, "name": key[:100]})
    device_ms = sum(ms for ms, _, _ in rows)
    steps = window[1] - window[0]
    return {
        "steps": steps,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms if wall_ms > 0 else None,
        # kernels, copies and fills the device ran: the launches a step
        "launches_per_step": sum(n for _, n, _ in rows) / steps,
        "by_group_ms_per_step": {g: ms / steps for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"ms_per_step": ms / steps, "calls": n, "name": key[:120]} for ms, n, key in rows[:15]],
        "top_kernels_by_group": {g: m[:3] for g, m in members.items() if g != "other"},
        # where the host's time goes: a host that runs ahead of the card blocks in the launch that finds
        # CUDA's queue full, or in a call that waits for the card
        "top_host_ops": [
            {"ms_per_step": e.self_cpu_time_total / 1e3 / steps, "calls": e.count, "name": e.key[:80]}
            for e in sorted((e for e in averages if e.device_type == DeviceType.CPU and not e.is_user_annotation),
                            key=lambda e: -e.self_cpu_time_total)[:8]
        ],
    }


@contextlib.contextmanager
def _layer_scopes():
    """For a profiled run: wrap the weight standardisation (ScaledStdConv's,
    and a ParametrizedModel's effective weights), the ECA gate, VarEMA, the
    auxiliary losses, cutmix_mixup, UFO, XCA, the GEM pools, AGC, BlurPool,
    drop-path, SAM's perturbation and its copies of the weights and buffers,
    GradDistributionTB's histogram and BNet's partial residual in torch.profiler.record_function
    scopes (SCOPE_LAYERS), so
    layer_breakdown can tell their kernels from the other ones (UFO's and
    XCA's 1x1 convs count as theirs). The originals are
    put back on exit. A scope opens only while the profiler records: the
    trainer's other steps, which it times, pay one check a call."""
    import functools

    import torch

    from sota_imagenet_tpu_torch.models import bnet
    from sota_imagenet_tpu_torch.models.attention import ECA, UFO, XCA
    from sota_imagenet_tpu_torch.models.layers import BlurPool, DropPath, GEMPool, ScaledStdConv
    from sota_imagenet_tpu_torch.models.norms import VarEMA
    from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel
    from sota_imagenet_tpu_torch.optim.factory import AGC
    from sota_imagenet_tpu_torch.train import callbacks, steps

    def scoped(label, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not torch.autograd._profiler_enabled():
                return fn(*a, **kw)
            with torch.profiler.record_function(label):
                return fn(*a, **kw)

        return wrapper

    targets = (
        (ScaledStdConv, "standardized_weight", "ws"), (ECA, "forward", "eca"), (VarEMA, "forward", "varema"),
        (callbacks.OrthoLossClb, "_type1", "aux"), (callbacks.OrthoLossClb, "_type2", "aux"),
        (callbacks.NormLossClb, "_loss", "aux"), (callbacks, "cutmix_mixup", "mixup"),
        (UFO, "forward", "ufo"), (XCA, "forward", "xca"), (GEMPool, "forward", "gem"), (AGC, "__call__", "agc"),
        (ParametrizedModel, "effective_parameters", "param"), (BlurPool, "forward", "blur"),
        (DropPath, "forward", "droppath"), (steps.SamPerturbation, "__call__", "sam_perturb"),
        (steps, "_restore", "sam_restore"), (callbacks, "log_histogram", "histogram"),
        (bnet, "partial_residual", "partial_res"),
    )
    originals = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]
    try:
        for owner, attr, label in targets:
            setattr(owner, attr, scoped(label, getattr(owner, attr)))
        yield
    finally:
        for owner, attr, fn in originals:
            setattr(owner, attr, fn)


SCOPE_LAYERS = {"ws": "weight standardisation", "eca": "ECA", "varema": "VarEMA", "aux": "aux loss", "mixup": "mixup",
                "ufo": "UFO", "xca": "XCA", "gem": "GEM", "agc": "AGC", "param": "parametrization (WS)",
                "blur": "BlurPool", "droppath": "drop-path", "sam_perturb": "SAM perturb",
                "sam_restore": "SAM save/restore", "histogram": "param histogram", "partial_res": "partial residual"}
CONV_OPS = {"aten::cudnn_convolution": (0, 1), "aten::convolution": (0, 1), "aten::_convolution": (0, 1),
            "aten::conv2d": (0, 1), "aten::convolution_backward": (1, 2)}  # op -> positions of (input, weight)


def layer_breakdown(prof, window):
    """Device ms per step by layer of the port, for a run profiled under
    _layer_scopes with record_shapes. Each kernel belongs to the CPU op that
    launched it (torch.profiler links them). A kernel's layer is, in this
    order: the record_function scope around its op (SCOPE_LAYERS, and the
    optimizer's own ``Optimizer.step#<name>.step`` scope, named by the
    optimizer); for a backward op, the scope of the forward op with the same
    autograd sequence number (the auxiliary loss's backward is its own
    layer); grouped or dense convs, by the op's input and weight shapes
    (groups = C_in / weight's dim 1); ``_foreach`` ops outside the optimizer:
    the EMA; batch-norm ops, forward and backward: BatchNorm; memcpy and
    memset: copies; anything else launched by an op: elementwise and
    activations (the activations, the residual and drop-path
    arithmetic, the loss, dtype casts, gradient accumulation). fused_aug is
    launched by no op: it is read from the kernel records by name, and what
    is left of the device time is ``unattributed``. Also returns in how many
    distinct ``aux`` scopes the auxiliary loss's forward and its backward
    launched kernels."""
    from torch.autograd import DeviceType

    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def scope_of(e):
        """(layer, the scope's event id) of the innermost scope around ``e``."""
        for a in ancestors(e):
            if a.name in SCOPE_LAYERS:
                return SCOPE_LAYERS[a.name], a.id
            if a.name.startswith("Optimizer.step"):
                return a.name.split("#")[-1].split(".")[0], a.id  # "Optimizer.step#Lamb.step" -> Lamb
        return None, None

    forward_scope = {}  # autograd sequence number -> (layer, scope id) of the forward op
    for e in cpu:
        if e.sequence_nr >= 0 and not any(a.name.startswith("autograd::engine::evaluate_function") for a in ancestors(e)):
            layer, sid = scope_of(e)
            if layer is not None:
                forward_scope[e.sequence_nr] = (layer, sid)

    aux = {"forward": set(), "backward": set()}

    def layer_of(e):
        layer, sid = scope_of(e)
        if layer is not None:
            if layer == "aux loss":
                aux["forward"].add(sid)
            return layer
        for a in ancestors(e):
            if a.name.startswith("autograd::engine::evaluate_function") and a.sequence_nr in forward_scope:
                layer, sid = forward_scope[a.sequence_nr]
                if layer == "aux loss":
                    aux["backward"].add(sid)
                    return "aux loss backward"
                return layer
        for a in ancestors(e):
            if a.name in CONV_OPS and a.input_shapes:
                i, w = (a.input_shapes[k] for k in CONV_OPS[a.name])
                if len(w) == 4 and len(i) == 4 and w[1] > 0:
                    if w[1] == 1 and i[1] > 1:
                        return "depthwise convs"
                    return "grouped convs" if i[1] // w[1] > 1 else "dense convs"
        if any("_foreach" in a.name for a in ancestors(e)):
            return "EMA"
        if any("batch_norm" in a.name for a in ancestors(e)):
            return "BatchNorm"
        return "elementwise/activations"

    layers: dict = {}
    kernels: dict = {}  # layer -> kernel name -> ms
    for e in cpu:
        for k in e.kernels:
            low = k.name.lower()
            if "fused_aug" in low:
                continue
            layer = "copies" if ("memcpy" in low or "memset" in low) else layer_of(e)
            layers[layer] = layers.get(layer, 0.0) + k.duration / 1e3
            by_name = kernels.setdefault(layer, {})
            by_name[k.name] = by_name.get(k.name, 0.0) + k.duration / 1e3
    scopes = {e.name for e in cpu if e.is_user_annotation}  # mirrored on the device as spans, not work
    device = [
        e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation and e.name not in scopes
    ]
    layers["fused_aug"] = sum(e.time_range.elapsed_us() for e in device if "fused_aug" in e.name) / 1e3
    total = sum(e.time_range.elapsed_us() for e in device) / 1e3
    layers["unattributed"] = total - sum(layers.values())
    steps = window[1] - window[0]
    by_layer = {k: v / steps for k, v in sorted(layers.items(), key=lambda kv: -kv[1])}
    top = {layer: [{"ms_per_step": ms / steps, "name": n[:120]} for n, ms in sorted(v.items(), key=lambda kv: -kv[1])[:4]]
           for layer, v in kernels.items()}
    return by_layer, {k: len(v) for k, v in aux.items()}, top


SERVE_SIZE = 224
SERVE_BATCH = 250  # the reference val batch
F32 = ("run.bf16=false",)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def _serve_images():
    """SERVE_BATCH seeded uint8 NHWC images on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (SERVE_BATCH, SERVE_SIZE, SERVE_SIZE, 3), np.uint8)).cuda()


def _live_logits(model, images_u8, dtype):
    """The eval forward of ``model`` on uint8 NHWC images, normalized as the
    val pipeline and the artifact do, float32 logits."""
    import torch

    from sota_imagenet_tpu_torch.constants import DATA_MEAN, DATA_STD

    with torch.no_grad():
        return model.eval()(((images_u8.float() - DATA_MEAN) / DATA_STD).to(dtype)).float()


def _export_and_compare(name: str, model, size: int, dtype, images, work: str) -> dict:
    """``model`` (on the card) exported (the trace runs on a copy on the
    CPU), loaded back on the card and served on ``images``, against the live
    module's eval forward."""
    import torch

    from sota_imagenet_tpu_torch.utils import export as E

    out = os.path.join(work, name)
    t0 = time.perf_counter()
    E.export_inference(model, out, image_size=size, input_dtype=dtype)
    export_s = time.perf_counter() - t0
    serve, meta = E.load_exported(out)
    got, want = serve(images), _live_logits(model, images, dtype)
    program = torch.export.load(os.path.join(out, "model.pt2"))
    return {"export_s": export_s, "traced_on": meta["traced_on"], "max_abs_diff": float((got - want).abs().max()),
            "bit_equal": bool(torch.equal(got, want)), "custom_ops": E.custom_ops(program), "bytes": _dir_bytes(out)}


def serve_phase(gpu: str, work: str, ckpt: str) -> dict:
    """The serving path at full width: trainer A's r50_baseline
    model_last.ckpt (``ckpt``, its BatchNorm statistics trained over 10
    steps); ``cli export`` traces it on the CPU (as the JAX accuracy proof exports), in bf16 with a symbolic batch,
    in float32, and in float32 with int8 kernels; the artifacts are loaded
    on the card. bf16: batches 1 and 250 of seeded uint8 images against the
    live module's eval forward on the card (max |dlogit| printed, the same
    top-1 on every row); float32 with TF32 off: |dlogit| <= 1e-4. int8: the
    artifact under 0.35x the float32 one's bytes, and its logits equal to
    those of a float artifact built from the same dequantized weights (the
    float32 artifact's program with the int8 artifact's weights, stored
    unquantized). Then bresnet50 (weight standardisation over 53 convs) and
    the spectral BNet trunk of model_bnet_spectral, each with seeded weights
    on the card, exported and served in float32: the artifact's logits
    within 1e-4 of the wrapped live module's (the parametrizations run
    inside the program).
    No program holds a custom op, resnet50(fused_stats=True)'s included,
    and the serving path launches none of the port's kernels. The
    artifacts stay in ``work`` (bench_models times the bf16 one)."""
    import torch
    import yaml

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.models import bresnet50
    from sota_imagenet_tpu_torch.models.cmodel import CModel
    from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, weight_standardization_fn
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.callbacks import ForwardSpectralNorm
    from sota_imagenet_tpu_torch.utils import export as E

    counters = kernel_counters()
    result = {"phase": "serve", "gpu": gpu}
    images = _serve_images()
    for fn in counters.values():
        fn.launches = 0  # counts from here are the serving path's
    try:
        def export(name, *extra):
            t = time.perf_counter()
            cli.export_main(["-c", R50, "--ckpt", ckpt, "--out", os.path.join(work, name), "--device", "cpu",
                             *extra])
            result[f"export_s_{name}"] = time.perf_counter() - t
            return os.path.join(work, name)

        bf16_dir, f32_dir, q8_dir = export("bf16"), export("f32", *F32), export("int8", "--quantize", "int8", *F32)
        live = cli.build_model(C.load(R50, strict_env=False))
        live.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True)["state"]["model"])
        live = live.to(device="cuda", memory_format=torch.channels_last)

        serve, meta = E.load_exported(bf16_dir)
        got, want = serve(images), _live_logits(live, images, torch.bfloat16)
        one = serve(images[:1])
        result["bf16"] = {
            "meta": meta, "bytes": _dir_bytes(bf16_dir), "max_abs_diff": float((got - want).abs().max()),
            "top1_equal_rows": int((got.argmax(-1) == want.argmax(-1)).sum()),
            "batch1_max_abs_diff": float((one - _live_logits(live, images[:1], torch.bfloat16)).abs().max()),
            "batch1_shape": list(one.shape), "finite": bool(torch.isfinite(got).all()),
        }
        serve32, _ = E.load_exported(f32_dir)
        got32 = serve32(images)
        result["f32"] = {"bytes": _dir_bytes(f32_dir), "max_abs_logit": float(got32.abs().max()),
                         "max_abs_diff": float((got32 - _live_logits(live, images, torch.float32)).abs().max())}
        serve8, _ = E.load_exported(q8_dir)
        # the same dequantized weights as a float artifact: int8 changes the stored weights, nothing else
        deq_dir = os.path.join(work, "dequantized")
        shutil.copytree(f32_dir, deq_dir)
        E.save_params(os.path.join(deq_dir, "params.npz"), E.load_params(os.path.join(q8_dir, "params.npz")))
        serve_deq, _ = E.load_exported(deq_dir)
        got8, got_deq = serve8(images), serve_deq(images)
        result["int8"] = {"bytes": _dir_bytes(q8_dir), "bytes_over_f32": _dir_bytes(q8_dir) / _dir_bytes(f32_dir),
                          "equal_to_dequantized_float": bool(torch.equal(got8, got_deq)),
                          "max_abs_diff_to_f32": float((got8 - got32).abs().max()),
                          "top1_equal_to_f32_rows": int((got8.argmax(-1) == got32.argmax(-1)).sum())}
        result["custom_ops"] = {name: E.custom_ops(torch.export.load(os.path.join(d, "model.pt2")))
                                for name, d in (("bf16", bf16_dir), ("int8", q8_dir))}
        fused = E.export_inference(cli.build_model(C.load(R50, overrides=list(FUSED), strict_env=False)),
                                   os.path.join(work, "fused"), image_size=SERVE_SIZE)
        result["custom_ops"]["fused_stats"] = E.custom_ops(torch.export.load(os.path.join(fused, "model.pt2")))
        result["artifact_bf16"], result["checkpoint"] = bf16_dir, ckpt
        del live, serve, serve32, serve8, serve_deq

        # the forward parametrizations inside the program, float32 on the card, 8 images
        small = images[:8]
        sgd = {"_target_": "sgd", "momentum": 0.9}
        ws = ParametrizedModel(bresnet50(), weight_standardization_fn(BRESNET_GAMMA))
        steps.init_state(ws, lambda m: build_optimizer(sgd, m.named_parameters()), device=torch.device("cuda"), seed=0)
        result["bresnet50_ws"] = {**_export_and_compare("bresnet50_ws", ws, SERVE_SIZE, torch.float32, small, work),
                                  "standardised_kernels": len(ws.selected[0])}
        extra = C.to_dict(C.load(BNET, strict_env=False).model)["extra_kwargs"]
        spectral = ParametrizedModel(CModel(layer_config=yaml.safe_load(BNET_TRUNK), extra_kwargs=extra),
                                     ForwardSpectralNorm().step_options()["parametrization"])
        steps.init_state(spectral, lambda m: build_optimizer(sgd, m.named_parameters()), device=torch.device("cuda"),
                         seed=0)
        result["bnet_spectral"] = {**_export_and_compare("bnet_spectral", spectral, SERVE_SIZE, torch.float32, small,
                                                         work), "spectral_kernels": len(spectral.stateful_names())}
        result["kernel_launches"] = {k: fn.launches for k, fn in counters.items()}
    finally:  # the line also when a step raised: what was measured up to it
        print(f"[serve] {json.dumps(result)}", flush=True)
    problems = []
    if result["bf16"]["top1_equal_rows"] != SERVE_BATCH or not result["bf16"]["finite"]:
        problems.append("bf16 top-1 differs from the live module's (or is not finite)")
    if result["bf16"]["batch1_shape"] != [1, 1000] or result["bf16"]["meta"]["batch_size"] is not None:
        problems.append("the symbolic-batch artifact did not serve batch 1")
    if result["f32"]["max_abs_diff"] > 1e-4:
        problems.append("float32 logits more than 1e-4 from the live module's")
    if result["int8"]["bytes_over_f32"] >= 0.35 or not result["int8"]["equal_to_dequantized_float"]:
        problems.append("int8 artifact too large or not the dequantized float artifact's logits")
    for name in ("bresnet50_ws", "bnet_spectral"):
        if result[name]["max_abs_diff"] > 1e-4 or result[name]["custom_ops"]:
            problems.append(f"{name} artifact disagrees with its wrapped live module")
    if result["bresnet50_ws"]["standardised_kernels"] != 53:
        problems.append("bresnet50 standardises other than 53 kernels")
    if any(result["custom_ops"].values()):
        problems.append(f"custom ops in an exported program: {result['custom_ops']}")
    if any(result["kernel_launches"].values()):
        problems.append(f"the serving path launched a kernel of the port: {result['kernel_launches']}")
    if problems:
        raise AssertionError(f"serve: {problems}")
    return result


def bench_models_phase(gpu: str, served: dict = None) -> dict:
    """tools/bench_models.py on the card: the --eval leg (batch 250, bf16,
    224 px) of its five families, and r50's train leg (batch 128). With
    ``served`` (serve's result), r50's bf16 artifact at batch 250 beside the
    live module of the same checkpoint (CUDA events; no other process on
    the card)."""
    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.tools import bench_models
    from sota_imagenet_tpu_torch.utils import export as E

    lines = bench_models.main(["--eval"]) + bench_models.main(["resnet50"])
    torch.cuda.empty_cache()
    result = {"phase": "bench_models", "lines": lines, "gpu": gpu}
    if served is not None:
        images = _serve_images()
        serve, _ = E.load_exported(served["artifact_bf16"])
        live = cli.build_model(C.load(R50, strict_env=False))
        live.load_state_dict(torch.load(served["checkpoint"], map_location="cpu", weights_only=True)["state"]["model"])
        live = live.to(device="cuda", memory_format=torch.channels_last)
        result["serve_ms_b250"] = {"artifact": median_ms(lambda: serve(images), reps=5, per_rep=4, warmup=3),
                                   "live": median_ms(lambda: _live_logits(live, images, torch.bfloat16), reps=5,
                                                     per_rep=4, warmup=3)}
        result["serve_img_per_s_b250"] = {k: SERVE_BATCH / v * 1e3 for k, v in result["serve_ms_b250"].items()}
        del serve, live
        torch.cuda.empty_cache()
    rates = {l["model"] + "_" + l["mode"]: l["img_per_sec"] for l in lines}
    rates.update({f"resnet50_{k}_serve": v for k, v in result.get("serve_img_per_s_b250", {}).items()})
    print(f"[bench_models] {json.dumps(rates)} | {gpu}", flush=True)
    if len(lines) != 6 or not all(math.isfinite(l["img_per_sec"]) and l["img_per_sec"] > 0 for l in lines):
        raise AssertionError(f"bench_models: {lines}")
    return result


def soak_phase(gpu: str) -> dict:
    """``python -m sota_imagenet_tpu_torch.tools.soak debug=true`` on
    configs/tpu_soak.yaml (10 steps an epoch): phase 1 killed with SIGKILL
    once the checkpoint to resume from holds epoch 1, phase 2 resumed with
    run.auto_resume=true; fails unless phase 2 loaded that checkpoint,
    resumed at its epoch and finished every epoch to the sixth across the
    160 -> 224 px boundary (soak.verdict). The tool runs as a process of its
    own, so its watch for the checkpoint never waits on this process's
    interpreter while serve traces beside it."""
    import torch

    torch.cuda.empty_cache()  # the tool's two phases are processes of their own on this card
    with tempfile.TemporaryDirectory() as tmp:  # the tool's log dir is made in here
        out = subprocess.run([sys.executable, "-m", "sota_imagenet_tpu_torch.tools.soak", "debug=true"],
                             capture_output=True, text=True, timeout=1200, env=dict(os.environ, TMPDIR=tmp))
        lines = out.stdout.strip().splitlines()
        try:
            result = {"phase": "soak", **json.loads(lines[-1]), "rc": out.returncode, "gpu": gpu}
        except (IndexError, json.JSONDecodeError):
            raise AssertionError(f"soak: rc {out.returncode}, no verdict line; stderr:\n{out.stderr[-3000:]}")
        if not result["ok"]:
            for name in ("phase1.log", "phase2.log"):
                with open(os.path.join(result["log_dir"], name)) as f:
                    print(f"[soak] {name} tail:\n{f.read()[-3000:]}", flush=True)
    print(f"[soak] {json.dumps(result)}", flush=True)
    if not result["ok"] or out.returncode != 0:
        raise AssertionError(f"soak: rc {out.returncode}, {[k for k, v in result['checks'].items() if not v]}")
    return result


RESUME_OPTIM = "optim={_target_: adamw, weight_decay: 0.05}"


@contextlib.contextmanager
def saver_timing():
    """How long each ``CheckpointSaver.on_epoch_end`` of the runs inside
    holds the epoch loop, and each ``save_checkpoint`` call in it (wall ms;
    the second save of an epoch that improves the best waits for the
    first's write, since one save at most is in flight). The CLI's own
    save of model_last.ckpt is not among them: ``cli`` binds the function
    when imported, before the patch."""
    from sota_imagenet_tpu_torch import cli  # noqa: F401 - imported first, it binds the save itself
    from sota_imagenet_tpu_torch.train import callbacks, checkpoint

    real_end, real_save = callbacks.CheckpointSaver.on_epoch_end, checkpoint.save_checkpoint
    held = {"on_epoch_end_ms": [], "save_call_ms": []}

    def on_epoch_end(self, *a, **kw):
        t0 = time.perf_counter()
        real_end(self, *a, **kw)
        held["on_epoch_end_ms"].append((time.perf_counter() - t0) * 1e3)

    def save(*a, **kw):
        t0 = time.perf_counter()
        out = real_save(*a, **kw)
        held["save_call_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    callbacks.CheckpointSaver.on_epoch_end, checkpoint.save_checkpoint = on_epoch_end, save
    try:
        yield held
    finally:
        callbacks.CheckpointSaver.on_epoch_end, checkpoint.save_checkpoint = real_end, real_save


def resume_phase(gpu: str, ckpt: str, saver_a: dict) -> dict:
    """Trainer A's ``model_last.ckpt`` (SGD, with the optimizer, step 10)
    resumed through ``cli.main`` under AdamW (RESUME_OPTIM,
    ``run.load_start_epoch=false``) for one debug epoch: the restore falls
    back to the params, as the JAX package's does. Checks: before the first
    step the weights equal the checkpoint's bit for bit, the optimizer is a
    fresh AdamW with no state and the step is 0; 10 steps, a finite loss,
    fused_aug 10 in 10. Then the same file loaded under r50_baseline's SGD
    restores the step and every momentum buffer bit for bit. Then the saves
    of that state, timed: for model.ckpt (weights and buffers) and
    model_last.ckpt (with the optimizer), how long ``save_checkpoint``
    holds its caller with the background write, the write after it
    returns, and one synchronous save (``block=True``) of the same payload,
    with the files' bytes; beside trainer A's CheckpointSaver
    (saver_timing). The saves write warm, into the page cache of a local
    temporary directory. The times are reported, not checked."""
    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.callbacks import Callback
    from sota_imagenet_tpu_torch.train.checkpoint import finalize_checkpoints, load_checkpoint, save_checkpoint

    disk = torch.load(ckpt, map_location="cpu", weights_only=True)["state"]

    class AtBegin(Callback):
        def on_begin(self):
            st = self.runner.state
            self.step, self.optimizer, self.optimizer_state = st.step, type(st.optimizer).__name__, len(st.optimizer.state)
            mine = st.model.state_dict()
            self.weights_equal = mine.keys() == disk["model"].keys() and all(
                torch.equal(v.cpu(), disk["model"][k]) for k, v in mine.items())

        def on_epoch_end(self, epoch, train_metrics, val_metrics):
            self.loss, self.step_after = train_metrics["loss"], self.runner.state.step

    probe, counters = AtBegin(), kernel_counters()
    with tempfile.TemporaryDirectory() as logdir:
        overrides = [*TRAINER_OVERRIDES, RESUME_OPTIM, f"run.resume={ckpt}", "run.load_start_epoch=false",
                     f"log.dir={logdir}"]
        for fn in counters.values():
            fn.launches = 0  # counts from here are this path's
        t0 = time.perf_counter()
        val = cli.main(["-c", R50, *overrides], callbacks=[probe])
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    cfg = C.load(R50, overrides=list(TRAINER_OVERRIDES), strict_env=False)
    model = cli.build_model(cfg)
    state, epoch = load_checkpoint(ckpt, steps.init_state(model, cli.optimizer_factory(cfg, model), device="cuda"))
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    saved = disk["optimizer"]["state"]
    sgd_exact = state.step == disk["step"] and len(saved) == len(params) and all(
        torch.equal(state.optimizer.state[p]["momentum_buffer"].cpu(), saved[i]["momentum_buffer"])
        for i, p in enumerate(params))
    saves = {}
    with tempfile.TemporaryDirectory() as d:
        for name, with_optimizer in (("model.ckpt", False), ("model_last.ckpt", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(d, state, epoch, name=name, include_optimizer=with_optimizer)
            t1 = time.perf_counter()
            finalize_checkpoints()
            t2 = time.perf_counter()
            save_checkpoint(d, state, epoch, name=name, include_optimizer=with_optimizer, block=True)
            t3 = time.perf_counter()
            saves[name] = {"bytes": os.path.getsize(os.path.join(d, name)), "background_held_ms": (t1 - t0) * 1e3,
                           "write_after_return_ms": (t2 - t1) * 1e3, "synchronous_ms": (t3 - t2) * 1e3}
    sgd_step = state.step
    del state, model
    result = {"phase": "resume", "optimizer_at_begin": probe.optimizer, "step_at_begin": probe.step,
              "optimizer_state_at_begin": probe.optimizer_state, "weights_equal_checkpoint": probe.weights_equal,
              "step_after": probe.step_after, "train_loss": probe.loss, "val": val, "kernel_launches": launches,
              "wall_s": wall, "sgd_resume_exact": sgd_exact, "sgd_resume_step": sgd_step,
              "saves": saves, "trainer_a_saver": saver_a, "gpu": gpu}
    print(f"[resume] {json.dumps(result)}", flush=True)
    if not (probe.optimizer == "AdamW" and probe.step == 0 and probe.optimizer_state == 0 and probe.weights_equal):
        raise AssertionError(f"resume: at the first step {probe.optimizer}, step {probe.step}, "
                             f"{probe.optimizer_state} optimizer states, weights equal {probe.weights_equal}")
    if probe.step_after != 10 or not math.isfinite(probe.loss) or not all(math.isfinite(v) for v in val.values()):
        raise AssertionError(f"resume: step {probe.step_after} after the epoch, loss {probe.loss}, val {val}")
    if launches != {"fused_aug": 10, "conv1x1_stats": 0, "moments": 0}:
        raise AssertionError(f"resume: kernel launches {launches} in 10 train steps")
    if not sgd_exact:
        raise AssertionError("resume: the file under SGD did not restore the step and every momentum buffer")
    return result


class LearnProcess:
    """learn_phase run by this script in a process of its own on the same
    card (``learn_process``), started at once; ``join`` waits for it,
    prints its output and returns its result line, and raises unless it
    passed. Its kernel counters are its own process's, set to 0 before it
    drives its path, as in this one. ``stop`` kills it if it is still
    running."""

    def __init__(self, timeout: float = 900):
        self.timeout, self.t0, self.seconds = timeout, time.perf_counter(), math.nan
        self.out = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen([sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.learn_process())"],
                                     cwd=os.path.dirname(os.path.abspath(__file__)), stdout=self.out,
                                     stderr=subprocess.STDOUT, text=True)

    def join(self) -> dict:
        try:
            rc = self.proc.wait(timeout=max(self.timeout - (time.perf_counter() - self.t0), 1))
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"learn: still running after {self.timeout} s")
        finally:
            self.seconds = time.perf_counter() - self.t0
        self.out.seek(0)
        result = None
        for line in self.out.read().splitlines():
            if line.startswith("[learn] {"):
                result = json.loads(line[len("[learn] "):])
            else:
                print(f"[learn:process] {line}")
        if rc != 0 or result is None:
            raise AssertionError(f"learn: its process exited {rc}" + ("" if result else " with no result line"))
        print(f"[learn] {json.dumps(result)}", flush=True)
        return result

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()


def learn_process() -> int:
    """The entry of a LearnProcess: learn_phase on the card, its result
    line printed by the phase; 0 iff it passed."""
    import torch

    from sota_imagenet_tpu_torch.tools.bench_models import gpu_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        learn_phase(gpu_line())
    except Exception:  # noqa: BLE001 - the traceback is the parent's report
        traceback.print_exc()
        return 1
    return 0


PHASES = ("build", "kernels", "learn", "model", "model_legacy", "model_remat", "model_skip", "model_debug_nans",
          "model_ddp", "trainer_a", "trainer_b", "trainer_c", "trainer_s", "trainer_c_remat", "trainer_d", "trainer_e",
          "trainer_i", "trainer_j", "trainer_k", "trainer_l", "trainer_m", "trainer_n", "trainer_o", "trainer_q",
          "trainer_r", "trainer_p", "trainer_p1", "model_mesh", "trainer_u", "trainer_v", "wheel", "serve", "resume",
          "soak", "bench_models", "data", "trainer_f", "trainer_t", "trainer_g", "packed", "trainer_h", "profile")
# the profiler runs inside these trainers from the end of step 1 to the end of step 3 (1-based): steps 2
# and 3; their ms/step is the median of steps 5-10, the others' of steps 4-10 (trainer_phase; H, of two
# epochs, is profiled in its first and timed in its second)
PROFILE = (0, 2)
FUSED = ("model={_target_: resnet50, fused_stats: true}",)
# under run.remat=full every conv1x1_stats of the forward runs again in the recompute: 2 launches per fused
# conv a step, as many as the JAX step's jaxpr holds pallas_calls (tests/test_torch_remat.py)
REMAT_FULL_CONV1X1_PER_STEP = 72
R50 = "configs/exp/1.r50_baseline.yaml"
NFNET = "configs/exp/15.eca_nfnet_l0.yaml"
RAND_INTERP = "configs/exp/2.r50_rand_interp.yaml"
DEVICE_RESAMPLE = ("loader.device_resample=true", "val_loader.rectangular=true")
HBM_CACHE = "configs/exp/r50_hbm_cache.yaml"
NFNET_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0, 0.01]}]",)  # the recipe's warmup, cut to the one debug epoch
NF_LAMB = "configs/exp/41.nf_conv-act_lamb.yaml"
NF_LAMB_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.003, 0], lr_mode: cos}]",)  # the recipe's cosine in one epoch
NONDEEP = "configs/exp/80_1.non-deeps_ufo-0.5_no-res.yaml"
NONDEEP_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.1, 0], lr_mode: cos}]",)  # the recipe's cosine in one epoch
ADAMP = "configs/exp/51.r50_adamp.yaml"
ADAMP_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0, 0.001]}]",)  # the recipe's warmup, cut to the one debug epoch
SAM_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.005, 0], lr_mode: cos}]",)  # the recipe's cosine in one epoch
CONVMIXER = "configs/exp/66.conv-mix_original.yaml"
CONVMIXER_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.001, 0.1]}]",)  # the recipe's warmup, cut to the one debug epoch
EXP48 = "configs/old_exp/exp85-114/exp48.GEnet_no_dim_red_ctmx.yaml"
EXP48_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.0, 0.2]}]",)  # the recipe's warmup, cut to the one debug epoch
EXP57 = "configs/old_exp/exp1-85/exp57.GENet_no_dim_red_ctmx_ws_adamp.yaml"
EXP26 = "configs/old_exp/exp1-85/exp26.csp_simpl_Dark_less_cls.yaml"
DENSENET = "configs/old_exp/first_attempts/densenet121_baseline.yaml"
TRESNET = "configs/old_exp/first_attempts/tresnetm.yaml"
EFFNET = "configs/old_exp/first_attempts/effnetb0_tf.yaml"
EFFNET_STAGE = ("run.stages=[{start: 0, end: 1, lr: [0.096, 0.001], lr_mode: poly}]",)  # the recipe's poly decay in one epoch
# recipe -> the model's parameter count (the JAX model's: tests/test_torch_bnet_family.py and
# tests/test_torch_extras.py hold them equal), its block class, how many, and the optimizer class
LEGACY = {"bnet": (21_577_576, "BNetBlock", 14, "SGD"), "effnet": (5_290_476, "_MBConv", 16, "RMSprop")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES), help=f"comma-separated subset of {','.join(PHASES)}")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        parser.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")
    for needs_a in ("serve", "resume"):
        if needs_a in phases and "trainer_a" not in phases:
            parser.error(f"{needs_a} reads trainer_a's checkpoint: add trainer_a")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this drive runs only on the card", file=sys.stderr)
        return 1
    try:
        import sota_imagenet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout ({e})", file=sys.stderr)
        return 1

    import numpy
    import PIL

    from sota_imagenet_tpu_torch.tools.bench_models import gpu_line

    gpu = gpu_line()
    print(f"[env] {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} numpy "
          f"{numpy.__version__} Pillow {PIL.__version__} | {gpu}")
    # plain versions and the model phase compare f32 products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed, results, seconds = [], {}, {}

    def run(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            results[name] = fn(*a, **kw)
        except Exception:  # noqa: BLE001 - report every phase, fail at the end
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            failed.append(name)
        seconds[name] = time.perf_counter() - t0
        print(f"[{name}] seconds {seconds[name]:.1f}", flush=True)

    run("build", build_phase)
    if "build" in failed:
        return 1
    if "kernels" in phases:
        run("fused_aug", kernel_phase)
        run("conv1x1_stats", conv_stats_phase)
        run("moments", moments_phase)
        run("nf_fused", nf_fused_phase)
    aug_only = {"fused_aug": 1}
    serve_dir = tempfile.TemporaryDirectory()  # trainer A's checkpoint and serve's artifacts, until bench_models
    trainer_a_ckpt = os.path.join(serve_dir.name, "trainer_a.ckpt")
    saver_a = None
    if "trainer_a" in phases:  # alone on the card: the main path's ms/step; serve and resume read its checkpoint
        with saver_timing() as saver_a:
            run("trainer_a", trainer_phase, "trainer_a", R50, (), gpu, aug_only, keep_ckpt=trainer_a_ckpt)
    # learn trains in a process of its own beside the phases that check values and time nothing: the model
    # phases and the rank drives, then serve (its exports trace on one host core, its checks on the card hold
    # values) with the soak's two processes beside it from the start; all end before anything is timed again
    learn = LearnProcess() if "learn" in phases else None
    soak = threading.Thread(target=run, args=("soak", soak_phase, gpu)) if "soak" in phases else None
    if soak is not None:
        soak.start()
    # the installed-wheel check is pip and nvcc on the host and one launch on the card: it runs beside the
    # value-checking model phases, as learn does
    wheel = threading.Thread(target=run, args=("wheel", wheel_phase, gpu)) if "wheel" in phases else None
    if wheel is not None:
        wheel.start()
    try:
        # the phases that hold the card to the CPU run on the algorithms cuDNN's heuristics pick for each
        # shape, not its autotuner's (trainer A's cli.main turned it on): the autotuner picks by timings that
        # the processes beside these phases disturb, and in one run its pick left model_cmodel_tables' trunk's
        # float32 gradients 1.7e-3 off the CPU's (relative L2), where its other picks left them 7e-6 off
        with _deterministic_cudnn():
            if "model" in phases:
                run("model", model_phase)
                run("model_fused_silu", model_phase, fused_stats=True, norm_act="silu")
                run("model_fused_relu", model_phase, fused_stats=True, check=False)
                run("model_nfnet", nfnet_model_phase)
                run("model_nf_lamb", nf_lamb_model_phase)
                run("model_nondeep", nondeep_model_phase)
                run("model_bresnet", bresnet_model_phase)
                run("model_bresnet_leaky_relu", bresnet_model_phase, norm_act="leaky_relu", check=False)
                run("model_bnet", bnet_model_phase)
                run("model_bnet_spectral", bnet_model_phase, spectral=True)
                run("model_zoo", zoo_model_phase)
                run("model_sam", sam_model_phase)
                run("model_cmodel_tables", cmodel_tables_model_phase)
                run("model_losses", losses_model_phase)
            if "model_legacy" in phases:
                run("model_legacy", legacy_model_phase)
            if "model_remat" in phases:
                run("model_remat", remat_model_phase)
            if "model_skip" in phases:
                run("model_skip", skip_model_phase)
            if "model_debug_nans" in phases:
                run("model_debug_nans", debug_nans_model_phase)
            if "model_ddp" in phases:
                run("ddp_probe", ddp_probe_phase, gpu)
                run("model_ddp", model_ddp_phase, gpu)
            if "model_mesh" in phases:
                run("model_mesh", mesh_model_phase, gpu)
        if "serve" in phases:
            run("serve", serve_phase, gpu, serve_dir.name, trainer_a_ckpt)
        if "resume" in phases:
            run("resume", resume_phase, gpu, trainer_a_ckpt, saver_a)
        if wheel is not None:
            wheel.join()
        if soak is not None:
            soak.join()
        if learn is not None:
            run("learn", learn.join)
            seconds["learn"] = learn.seconds
    finally:
        if learn is not None:
            learn.stop()
    if "trainer_b" in phases:
        hard = "configs/exp/3.r50_hard-aug_rand-interp.yaml"
        run("trainer_b", trainer_phase, "trainer_b", hard, ("loader.re_prob=0.3",), gpu, aug_only)
    if "trainer_c" in phases:
        run("trainer_c", trainer_phase, "trainer_c", R50, FUSED, gpu, {"fused_aug": 1, "conv1x1_stats": 36},
            profile_window=PROFILE)
    if "trainer_s" in phases:
        # r50_baseline under remat 'convs', its steps 2-3 traced by the config's own Profiler callback
        run("trainer_s", trainer_phase, "trainer_s", R50, ("run.remat=convs",), gpu, aug_only, profiler_clb=PROFILE)
    if "trainer_c_remat" in phases:
        run("trainer_c_remat", trainer_phase, "trainer_c_remat", R50, (*FUSED, "run.remat=full"), gpu,
            {"fused_aug": 1, "conv1x1_stats": REMAT_FULL_CONV1X1_PER_STEP})
    if "trainer_d" in phases:
        run("trainer_d", trainer_phase, "trainer_d", NFNET, NFNET_STAGE, gpu, aug_only, recipe="nfnet",
            profile_window=PROFILE)
    if "trainer_e" in phases:
        run("trainer_e", tiny_phase, gpu)
    recipes = (("trainer_i", NF_LAMB, NF_LAMB_STAGE, "nf_lamb"), ("trainer_j", NONDEEP, NONDEEP_STAGE, "nondeep"),
               ("trainer_k", BRESNET, BRESNET_STAGE, "bresnet"), ("trainer_l", ADAMP, ADAMP_STAGE, "adamp"),
               ("trainer_m", SAM, SAM_STAGE, "sam"), ("trainer_n", ADACOS, ADACOS_STAGE, "adacos"),
               ("trainer_o", CONVMIXER, CONVMIXER_STAGE, "convmixer"), ("trainer_q", EXP48, EXP48_STAGE, "bnet"),
               ("trainer_r", EFFNET, EFFNET_STAGE, "effnet"))
    for name, config, stage, recipe in recipes:
        if name in phases:
            window = None if recipe == "adacos" else PROFILE
            run(name, trainer_phase, name, config, stage, gpu, aug_only, recipe=recipe, profile_window=window)
    if "trainer_p" in phases:
        run("trainer_p", trainer_p_phase, gpu)
    if "trainer_p1" in phases:
        run("trainer_p1", trainer_p1_phase, gpu)
    mesh_trainers = [n for n in MESH_TRAINERS if n in phases]
    if mesh_trainers:
        run("trainer_" + "".join(n[-1] for n in mesh_trainers), mesh_trainers_phase, mesh_trainers, gpu)
        results.update(results.pop("trainer_" + "".join(n[-1] for n in mesh_trainers), {}))
    if "bench_models" in phases:
        run("bench_models", bench_models_phase, gpu, results.get("serve"))
    serve_dir.cleanup()
    if "trainer_p1" in results and "trainer_a" in results:
        a, p1 = results["trainer_a"]["ms_per_step_median"], results["trainer_p1"]["ms_per_step_median"]
        print(f"[trainer_p1] {json.dumps({'ms_per_step_p1': p1, 'ms_per_step_a': a, 'collectives_cost_ms': p1 - a})}")
    cached = {"packed", "trainer_h"} & set(phases)
    with tempfile.TemporaryDirectory() as data_root:
        if {"data", "trainer_f", "trainer_g", "trainer_t"} & set(phases) or cached:
            run("imagefolder", write_imagefolder, data_root)
            print(f"[data] ImageFolder of JPEGs written: {json.dumps(results.get('imagefolder'))}", flush=True)
        if "data" in phases:
            run("data", data_phase, data_root, gpu)
        if "trainer_f" in phases:
            run("trainer_f", trainer_phase, "trainer_f", RAND_INTERP, (), gpu, aug_only, tree=data_root)
        if "trainer_t" in phases:
            records_root = os.path.join(data_root, "tfrecords")
            run("records_tfrecord", write_records, data_root, records_root)
            print(f"[trainer_t] records written: {json.dumps(results.get('records_tfrecord'))}", flush=True)
            run("trainer_t", trainer_phase, "trainer_t", RAND_INTERP, (), gpu, aug_only, tree=records_root,
                tfrecord=True)
        if "trainer_g" in phases:
            run("trainer_g", trainer_phase, "trainer_g", R50, DEVICE_RESAMPLE, gpu, aug_only, tree=data_root,
                val_shapes=3)
        packed_root = os.path.join(data_root, "packed")
        if cached:
            run("packing", pack_tree, data_root, packed_root)
            print(f"[packed] records written: {json.dumps(results.get('packing'))}", flush=True)
        if "packed" in phases:
            run("packed", packed_phase, packed_root, results.get("packing"), gpu)
        if "trainer_h" in phases:
            run("trainer_h", trainer_phase, "trainer_h", HBM_CACHE, (), gpu, aug_only, tree=packed_root, cache=True,
                profile_window=PROFILE)
    if "profile" in phases:
        # trainer A's own steps stay unprofiled (the main path's ms/step): its profile is a run of its own
        run("profile", trainer_phase, "profile", R50, (), gpu, aug_only, profile_window=PROFILE)
    for trainer in ("trainer_q", "trainer_r"):
        if trainer in results:
            results[trainer]["layer_shares"] = legacy_layer_shares(trainer, results[trainer])
    if "trainer_h" in results:
        # the cache's input stage inside H's step: the gather and the augment kernel, as shares of its device time
        prof = results["trainer_h"]["profile"]
        by_group, device_step = prof["by_group_ms_per_step"], prof["device_ms"] / prof["steps"]
        shares = {g: {"ms_per_step": by_group.get(g, 0.0), "share_of_step": by_group.get(g, 0.0) / device_step}
                  for g in ("gather", "fused_aug", "memcpy")}
        print(f"[trainer_h] {json.dumps({'device_ms_per_step': device_step, 'input_stage': shares})}")
        results["trainer_h"]["input_stage"] = shares
    for other, base in (("trainer_s", "trainer_a"), ("trainer_c_remat", "trainer_c")):
        if other in results and base in results:
            o, b = results[other], results[base]
            print(f"[{other}] {json.dumps({'ms_per_step': o['ms_per_step_median'], 'ms_per_step_' + base: b['ms_per_step_median'], 'max_memory_allocated_gib': o['max_memory_allocated_gib'], 'max_memory_allocated_gib_' + base: b['max_memory_allocated_gib'], 'peak_ratio': o['max_memory_allocated_gib'] / b['max_memory_allocated_gib'], 'steady_peak_gib': o['max_memory_allocated_steady_gib'], 'steady_peak_gib_' + base: b['max_memory_allocated_steady_gib'], 'steady_peak_ratio': o['max_memory_allocated_steady_gib'] / b['max_memory_allocated_steady_gib']})}")
            # the memory gate of run.remat: a remat trainer peaks below its plain twin in the same run
            if not o["max_memory_allocated_gib"] < b["max_memory_allocated_gib"]:
                print(f"[{other}] FAILED: peak {o['max_memory_allocated_gib']} GiB, not below {base}'s "
                      f"{b['max_memory_allocated_gib']}", flush=True)
                failed.append(f"{other}_memory_gate")
    if "trainer_t" in results and "trainer_f" in results:
        t, f = results["trainer_t"], results["trainer_f"]
        print(f"[trainer_t] {json.dumps({'epoch_img_per_s': t['epoch_img_per_s'], 'epoch_img_per_s_trainer_f': f['epoch_img_per_s'], 'val_weights_sum': sum(t['val_weights']), 'records': results.get('records_tfrecord')})}")
    if "trainer_a" in results and "trainer_h" in results:
        a, h = results["trainer_a"], results["trainer_h"]
        print(f"[trainer_h] {json.dumps({'ms_per_step_h': h['ms_per_step_median'], 'ms_per_step_a': a['ms_per_step_median'], 'epoch_img_per_s_h': h['epoch_img_per_s'], 'img_per_s_a': a['img_per_s']})}")
    for trainer, result in results.items():
        if not isinstance(result, dict) or "profile" not in result:
            continue
        # the profiler (shapes recorded, thousands of ops a step) slows a launch-bound host: the device
        # time per profiled step over the unprofiled steps' median is the busy share of record
        device_ms_step = result["profile"]["device_ms"] / result["profile"]["steps"]
        step_ms = results.get("trainer_a" if trainer == "profile" else trainer, {}).get("ms_per_step_median", math.nan)
        print(f"[{trainer}] {json.dumps({'device_ms_per_step': device_ms_step, 'ms_per_step': step_ms, 'busy_share_unprofiled': device_ms_step / step_ms})}")
    print(f"[seconds] {json.dumps(seconds)}", flush=True)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    if phases != list(PHASES):
        print(f"chip_smoke: ran only {phases}; a full run prints the result lines", file=sys.stderr)
        return 0
    kernels = [results["fused_aug"], results["conv1x1_stats"], results["moments"], results["nf_fused"]]
    # launches on each kernel's own main path: fused_aug on r50_baseline (trainer A; beside it
    # the hard-aug recipe, the NFNet recipe, tiny_synthetic and the two folder trainers), conv1x1_stats with fused_stats
    # (trainer C); no path calls moments
    kernels[0]["launches"] = results["trainer_a"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_hard_aug"] = results["trainer_b"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_nfnet_recipe"] = results["trainer_d"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_tiny_synthetic"] = results["trainer_e"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_folder"] = results["trainer_f"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_folder_device_resample"] = results["trainer_g"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_hbm_cache"] = results["trainer_h"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_learn"] = results["learn"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_nf_lamb"] = results["trainer_i"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_nondeep"] = results["trainer_j"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_bresnet"] = results["trainer_k"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_adamp"] = results["trainer_l"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_sam"] = results["trainer_m"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_adacos"] = results["trainer_n"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_convmixer"] = results["trainer_o"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_bnet_exp48"] = results["trainer_q"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_effnet_b0"] = results["trainer_r"]["kernel_launches"]["fused_aug"]
    # the data-parallel trainers: one augment launch a step on each rank
    kernels[0]["launches_ddp_two_ranks"] = [r["fused_aug"] for r in results["trainer_p"]["launches_per_rank"]]
    kernels[0]["launches_ddp_nccl_one_rank"] = results["trainer_p1"]["launches_per_rank"][0]["fused_aug"]
    kernels[0]["launches_remat"] = results["trainer_s"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_tfrecord"] = results["trainer_t"]["kernel_launches"]["fused_aug"]
    kernels[0]["launches_spatial_two_ranks"] = [r["fused_aug"] for r in results["trainer_u"]["launches_per_rank"]]
    kernels[0]["launches_head_tp_two_ranks"] = [r["fused_aug"] for r in results["trainer_v"]["launches_per_rank"]]
    kernels[0]["launches_installed_wheel"] = results["wheel"]["launches"]
    kernels[0]["launches_resume_adamw"] = results["resume"]["kernel_launches"]["fused_aug"]
    kernels[1]["launches"] = results["trainer_c"]["kernel_launches"]["conv1x1_stats"]
    kernels[1]["launches_remat_full"] = results["trainer_c_remat"]["kernel_launches"]["conv1x1_stats"]
    kernels[1]["launches_per_step_by_remat_policy"] = next(
        r for r in results["model_remat"]["cases"] if r["case"] == "r50_fused_stats")["conv1x1_stats_launches"]
    kernels[1]["launches_by_path"] = results["trainer_c"]["conv1x1_stats_launches_by_path"]
    kernels[3]["launches"] = results["trainer_d"]["nf_fused"]["launches"]  # the NFNet recipe, val included
    kernels[3]["launches_per_train_step"] = results["trainer_d"]["nf_fused"]["launches_per_step"]
    kernels[3]["fallbacks"] = results["trainer_d"]["nf_fused"]["fallbacks"]
    kernels[2]["launches"] = max(r["kernel_launches"]["moments"] for k, r in results.items()
                                 if k.startswith("trainer") and "kernel_launches" in r)
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
