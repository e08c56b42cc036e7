"""Callbacks (port of ``sota_imagenet_tpu/train/callbacks.py``:36-130,205-355,387-472;
reference pytorch_tools fit_wrapper callbacks).

Two kinds, as in the JAX package:

  * host callbacks run between steps and observe the Runner (epoch, state,
    metrics). ``on_batch_end`` receives the step's metrics as device
    tensors: reading one there would stall the device every step, so the
    callbacks here only read metrics the Runner has already reduced at
    epoch end;
  * step contributors add options to the train step through
    ``step_options()``: a ``mixup_fn`` (CutmixMixup, Cutmix, Mixup), an
    ``aux_loss`` of the model's parameters added to the criterion
    (OrthoLossClb, NormLossClb; the Runner sums several), a
    ``post_step_transform`` of the model after each optimizer step
    (WeightNorm), a ``grad_transform`` of the gradients before the update
    (AdaptiveGradientClipping). The Runner collects them when it builds the
    steps of a stage. A ``parametrization`` (ForwardWeightNorm,
    ForwardSpectralNorm) is taken once, when the Runner builds its state:
    it wraps the model in a ``ParametrizedModel``. OrthoInitClb
    re-initialises the kernels once, at ``on_begin``.

The auxiliary pieces select the parameters that are ``kernel`` leaves in
the JAX model (``utils.weights.kernel_parameters``), as the JAX callbacks
select them by flax path.

SAM and SAMOriginal add the ``sam`` option of the train step (its second
forward and backward at the perturbed weights).

The TensorBoard sinks (``TensorBoard``, ``WeightDistributionTB``,
``SpectralDistributionTB``, ``GradDistributionTB``) write through the
Runner's ``tb_writer``, which the ``TensorBoard`` callback opens
(``torch.utils.tensorboard``, imported when it starts; where the package
cannot be imported it logs one warning and the run goes on without the
sinks). They name and order their tags as the JAX package does, by the flax
paths of the weights (``utils.weights.flax_params``). Scalars and the
parameter histogram are device tensors buffered during the epoch and read
once at its end; the weight and spectrum histograms run on the host once an
epoch.

``Profiler`` traces a window of steps with ``torch.profiler`` on rank 0.
"""

from __future__ import annotations

import functools
import os
import socket
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.models.parametrize import (
    SpectralNormParametrization,
    backward_weight_norm,
    weight_standardization_fn,
)
from sota_imagenet_tpu_torch.optim.factory import agc
from sota_imagenet_tpu_torch.train.steps import cutmix_mixup
from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.logging import get_logger
from sota_imagenet_tpu_torch.utils.misc import process_count, process_index
from sota_imagenet_tpu_torch.utils.weights import flax_params, kernel_parameters


class Callback:
    """Base/no-op callback."""

    runner = None  # set by Runner

    def set_runner(self, runner):
        self.runner = runner

    def on_begin(self):
        pass

    def on_epoch_begin(self, epoch: int):
        pass

    def on_batch_end(self, step: int, metrics: Dict[str, Any]):
        pass

    def on_epoch_end(self, epoch: int, train_metrics: Dict[str, float], val_metrics: Optional[Dict[str, float]]):
        pass

    def on_end(self):
        pass

    # contributions to the train step (mixup_fn)
    def step_options(self) -> Dict[str, Any]:
        return {}


class CutmixMixup(Callback):
    """Random cutmix-or-mixup per batch (reference callbacks.py:232-247), on
    the device inside the train step."""

    def __init__(
        self,
        cutmix_alpha: float = 1.0,
        mixup_alpha: float = 0.2,
        prob: float = 0.5,
        stop_epoch: Optional[int] = None,
    ):
        self.cutmix_alpha = cutmix_alpha
        self.mixup_alpha = mixup_alpha
        self.prob = prob
        # legacy progressive recipes turn cutmix OFF for a final clean stage:
        # stages starting at/after stop_epoch build their train step without the mixup_fn
        self.stop_epoch = stop_epoch

    def step_options(self):
        if self.stop_epoch is not None and getattr(self.runner, "base_epoch", 0) >= self.stop_epoch:
            return {}
        return {
            "mixup_fn": functools.partial(
                cutmix_mixup, cutmix_alpha=self.cutmix_alpha, mixup_alpha=self.mixup_alpha, prob=self.prob
            )
        }


class Cutmix(Callback):
    """Cutmix-only batch transform (reference pt_clb.Cutmix). ``num_classes``
    is accepted for reference-config compatibility: labels are already one-hot."""

    def __init__(self, alpha: float = 1.0, num_classes: Optional[int] = None, prob: float = 0.5):
        self.alpha = alpha
        self.prob = prob

    def step_options(self):
        return {
            "mixup_fn": functools.partial(
                cutmix_mixup, cutmix_alpha=self.alpha, mixup_alpha=1.0, prob=self.prob, choice_prob=1.0
            )
        }


class Mixup(Callback):
    """Mixup-only batch transform (reference pt_clb.Mixup)."""

    def __init__(self, alpha: float = 0.2, num_classes: Optional[int] = None, prob: float = 0.5):
        self.alpha = alpha
        self.prob = prob

    def step_options(self):
        return {
            "mixup_fn": functools.partial(
                cutmix_mixup, cutmix_alpha=1.0, mixup_alpha=self.alpha, prob=self.prob, choice_prob=0.0
            )
        }


class SAMOriginal(Callback):
    """ASAM as SamsungLabs has it (reference callbacks.py:279-337;
    callbacks.py:133-149 of the JAX package): a second gradient inside the
    train step at the weights moved by ``rho`` along the gradient scaled by
    max(p^2, eta) (``steps.SamPerturbation`` kind ``sam_original``)."""

    def __init__(self, rho: float = 0.5, eta: float = 0.01, bn_from_perturbed: bool = True):
        self.rho, self.eta = rho, eta
        self.bn_from_perturbed = bn_from_perturbed

    def step_options(self):
        return {"sam": {"kind": "sam_original", "rho": self.rho, "eta": self.eta,
                        "bn_from_perturbed": self.bn_from_perturbed}}


class SAM(Callback):
    """Layer-wise or unit-wise adaptive SAM (reference callbacks.py:339-419;
    callbacks.py:152-168 of the JAX package). ``bn_from_perturbed=True``
    matches the reference (its perturbed forward also moves the BN
    statistics); False keeps the clean pass's."""

    def __init__(self, unitwise: bool = False, rho: float = 0.01, bn_from_perturbed: bool = True):
        self.unitwise, self.rho = unitwise, rho
        self.bn_from_perturbed = bn_from_perturbed

    def step_options(self):
        return {"sam": {"kind": "asam_unitwise" if self.unitwise else "asam", "rho": self.rho,
                        "bn_from_perturbed": self.bn_from_perturbed}}


class WeightNorm(Callback):
    """Backward centered weight normalization: project the kernels to the unit
    sphere after every optimizer step (reference callbacks.py:104-123)."""

    def step_options(self):
        return {"post_step_transform": backward_weight_norm}


class ForwardWeightNorm(Callback):
    """Weight-standardise the convs through a forward parametrization
    (reference callbacks.py:62-84; callbacks.py:171-185 of the JAX package):
    ``use_std=True`` (needs ``gamma``) is scaled WS, ``False`` zero mean
    only. Depthwise kernels are left alone."""

    def __init__(self, gamma: Optional[float] = None, use_std: bool = False):
        if use_std and gamma is None:
            raise ValueError("use_std=True requires gamma")
        self.gamma = gamma if use_std else None

    def step_options(self):
        return {"parametrization": weight_standardization_fn(self.gamma)}


class ForwardSpectralNorm(Callback):
    """Spectral-norm parametrization of every conv (reference
    callbacks.py:87-101; callbacks.py:188-202 of the JAX package): a
    persistent u/v pair per kernel, ``n_iters`` power iterations per training
    forward, eval reusing the pair; the pairs are buffers of the wrapper, so
    they are checkpointed and EMA'd."""

    def __init__(self, n_iters: int = 1):
        self.n_iters = n_iters

    def step_options(self):
        return {"parametrization": SpectralNormParametrization(self.n_iters)}


class AdaptiveGradientClipping(Callback):
    """AGC (the pytorch_tools callback of reference config 80_1; NFNet
    arXiv:2102.06171; callbacks.py:215-227 of the JAX package): each unit's
    gradient is clipped to ``clipping`` times its parameter's norm
    (``optim.factory.AGC``). ``clip_factor`` is pytorch_tools' name for
    ``clipping``. ``transform`` is the one AGC object every stage's step
    uses, so a probe can set its ``record``."""

    def __init__(self, clipping: float = 0.01, eps: float = 1e-3, clip_factor: Optional[float] = None):
        self.clipping = clip_factor if clip_factor is not None else clipping
        self.eps = eps
        self.transform = agc(self.clipping, self.eps)

    def step_options(self):
        return {"grad_transform": self.transform}


class _Kernels:
    """The kernel parameters of the model a step passes, found once per model:
    the walk behind ``kernel_parameters`` is host work that a loss called on
    every microbatch should not repeat."""

    def __init__(self):
        self._model, self._kernels = None, []

    def __call__(self, model: torch.nn.Module) -> list:
        if model is not self._model:
            self._model, self._kernels = model, list(kernel_parameters(model).values())
        return self._kernels


def _iter_matrices(kernels):
    """Each conv (4-d) and dense (2-d) kernel as an (out, fan_in) matrix
    (callbacks.py:237-245 of the JAX package). The JAX package flattens an
    HWIO kernel to (O, H*W*I), the port an OIHW one to (O, I*H*W): the same
    columns in another order, which neither the Gram matrix m m^T nor the row
    norms depend on."""
    for w in kernels:
        if w.dim() in (2, 4):
            yield w.reshape(w.shape[0], -1)


class OrthoLossClb(Callback):
    """Kernel (type 1) or convolutional (type 2) orthogonality loss added to
    the criterion (reference OrthoLoss/OrthoLoss2 + OrthoLossClb,
    callbacks.py:126-203), in float32.

    Type 1: for each conv and dense kernel with ``min_filters`` <= O <=
    fan_in, ``||W W^T - I||_F``, counted where it exceeds ``min_norm * O``.
    Type 2: for each conv kernel with O <= fan_in, the correlation of the
    filters with each other at every offset (``conv2d(w, w, padding=k-1)``,
    (O, O, 2k-1, 2k-1), the JAX (O, 2k-1, 2k-1, O) permuted), each row over
    its filter's squared norm, against the identity at the centre offset. As
    in the JAX package, type 2 skips no strided conv (the reference's stride
    test never matched, callbacks.py:170)."""

    def __init__(self, weight: float = 0.01, type: int = 1, eps: float = 1e-2, min_filters: int = 384, min_norm: float = 1.0, **_):
        self.weight = weight
        self.type = type
        self.eps = eps
        self.min_filters = min_filters
        self.min_norm = min_norm
        self._kernels = _Kernels()

    def _type1(self, model):
        kernels = self._kernels(model)
        loss = torch.zeros((), dtype=torch.float32, device=kernels[0].device)
        for mat in _iter_matrices(kernels):
            o, f = mat.shape
            if o > f or o < self.min_filters:
                continue  # no more filters than dims can be orthonormal (callbacks.py:143-146)
            m = mat.float()
            n = torch.linalg.matrix_norm(m @ m.T - torch.eye(o, device=m.device))
            loss = loss + torch.where(n / o > self.min_norm, n, 0.0)
        return loss * self.weight

    def _type2(self, model):
        kernels = self._kernels(model)
        loss = torch.zeros((), dtype=torch.float32, device=kernels[0].device)
        for w in kernels:
            if w.dim() != 4 or w.shape[0] > w[0].numel():
                continue
            o, k = w.shape[0], w.shape[2]
            w32 = w.float()
            corr = F.conv2d(w32, w32, padding=k - 1)
            corr = corr / (w32.reshape(o, -1).square().sum(dim=1).view(-1, 1, 1, 1) + 1e-4)
            target = torch.zeros_like(corr)
            target[:, :, k - 1, k - 1] = torch.eye(o, device=w.device)
            loss = loss + torch.linalg.vector_norm(corr - target)
        return loss * self.weight

    def step_options(self):
        return {"aux_loss": self._type1 if self.type == 1 else self._type2}


class NormLossClb(Callback):
    """(1 - ||filter||)^2 regularizer (reference NormLoss, callbacks.py:206-229):
    the mean over the filters of each conv and dense kernel of at least 64
    elements (ECA's is smaller, callbacks.py:215)."""

    def __init__(self, weight: float = 1e-4):
        self.weight = weight
        self._kernels = _Kernels()

    def _loss(self, model):
        kernels = self._kernels(model)
        loss = torch.zeros((), dtype=torch.float32, device=kernels[0].device)
        for mat in _iter_matrices(kernels):
            if mat.numel() >= 64:
                loss = loss + (1.0 - torch.linalg.vector_norm(mat.float(), dim=1)).square().mean()
        return loss * self.weight

    def step_options(self):
        return {"aux_loss": self._loss}


class OrthoInitClb(Callback):
    """Orthogonal (re)initialization of every kernel with ndim >= 2 (ECA's
    included) at ``on_begin``, once (reference callbacks.py:250-266). The
    draws come from a CPU generator seeded 0 in the model's order, in
    float64, and are copied into the parameters. As in the JAX package
    (callbacks.py:353-355), only the weights are replaced: an EMA copy keeps
    the weights it was made from."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain
        self._done = False

    def on_begin(self):
        if self._done or self.runner is None:
            return
        self._done = True
        get_logger().info("Applying orthogonal initialization")
        generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for w in kernel_parameters(self.runner.state.model).values():
                if w.dim() >= 2:
                    w.copy_(torch.nn.init.orthogonal_(torch.empty(w.shape, dtype=torch.float64), self.gain, generator))


class Profiler(Callback):
    """A ``torch.profiler`` trace over a window of steps (callbacks.py:358-386
    of the JAX package; the reference had no profiler). It starts at the end
    of step ``start_step`` (the Runner's numbering, the JAX Runner's:
    ``i + epoch * steps_per_epoch``) and stops at the end of step
    ``start_step + num_steps``, after a synchronisation of the card, so it
    holds the ``num_steps`` steps between; ``on_end`` stops one still open.
    It records the host and, where there is one, the card. Only rank 0
    profiles. The trace is a Chrome trace JSON that TensorBoard's profiler
    plugin reads, ``<log_dir>/<host>_<pid>.<start>-<stop>.pt.trace.json``
    (``path`` after the stop). Over the window the port's spans
    (``utils/trace.py``) are on and mirrored into the trace, so it shows
    the layers (``fit.step``, ``step.forward``, ``feed.augment``, ...); the
    spans' state before the window is restored after it."""

    def __init__(self, log_dir: str = ".", start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.path = None
        self._prof = None

    def on_batch_end(self, step, metrics):
        if process_index() != 0:
            return
        if step == self.start_step and self._prof is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self._spans_before = trace.enable(mirror=True)
        elif step >= self.stop_step and self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        trace.restore(self._spans_before)
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        name = f"{socket.gethostname()}_{os.getpid()}.{self.start_step}-{self.stop_step}.pt.trace.json"
        self.path = os.path.join(self.log_dir, name)
        prof.export_chrome_trace(self.path)
        get_logger().info(f"Profiler trace written to {self.path}")

    def on_end(self):
        if self._prof is not None:
            self._stop()


class ConsoleLogger(Callback):
    """Epoch summary lines (reference ConsoleLogger + FileLogger; both write
    through the shared logger, which has stdout + file sinks)."""

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        log = get_logger()
        tm = " | ".join(f"{k}: {v:.4f}" for k, v in train_metrics.items() if k in ("loss", "Acc@1", "Acc@5"))
        log.info(f"Epoch {epoch:3d} | Train {tm}")
        if val_metrics:
            vm = " | ".join(f"{k}: {v:.4f}" for k, v in val_metrics.items() if k in ("loss", "Acc@1", "Acc@5"))
            log.info(f"Epoch {epoch:3d} | Val   {vm}")


class Timer(Callback):
    """Per-epoch wall clock (train + val, ending at the epoch's metric read),
    train images/sec (reference Timer, train.py:137) and the share of the
    epoch the host waited for its input (``input_wait_share``), in %."""

    def on_epoch_begin(self, epoch):
        self._t0 = time.time()
        self._images = 0

    def on_batch_end(self, step, metrics):
        self._images += getattr(self.runner, "batch_size", 0) if self.runner else 0

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        dt = time.time() - self._t0
        ips = self._images / dt if dt > 0 else 0.0
        wait = train_metrics.get("input_wait_share")
        wait_s = f" | input wait {wait * 100:.1f}%" if wait is not None else ""
        get_logger().info(f"Epoch {epoch:3d} | {dt:.1f}s | {ips:.1f} img/s{wait_s}")


class CheckpointSaver(Callback):
    """Save the state each epoch and keep the best by a monitored val metric
    (pytorch_tools CheckpointSaver monitors loss; reference train.py:134).
    Every rank calls it, and rank 0 writes in the background
    (``save_checkpoint``); ``on_end`` waits for the last write."""

    def __init__(
        self,
        save_dir: str = ".",
        save_name: str = "model.ckpt",
        include_optimizer: bool = False,
        monitor: str = "loss",  # val metric; lower is better unless it's an Acc
    ):
        self.save_dir = save_dir
        self.save_name = save_name
        self.include_optimizer = include_optimizer
        self.monitor = monitor
        self._best: Optional[float] = None

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        if self.runner is None:
            return
        from sota_imagenet_tpu_torch.train.checkpoint import save_checkpoint

        state = self.runner.state
        if process_index() == 0:
            os.makedirs(self.save_dir, exist_ok=True)
        save_checkpoint(self.save_dir, state, epoch, name=self.save_name, include_optimizer=self.include_optimizer)
        val = (val_metrics or {}).get(self.monitor)
        if val is None:
            return
        if self.monitor.startswith("Acc"):
            better = self._best is None or val > self._best
        else:
            better = self._best is None or val < self._best
        if better:
            self._best = val
            save_checkpoint(self.save_dir, state, epoch, name="model_best.ckpt", include_optimizer=self.include_optimizer)
            get_logger().info(f"Epoch {epoch:3d} | new best {self.monitor}: {val:.4f}")

    def on_end(self):
        from sota_imagenet_tpu_torch.train.checkpoint import finalize_checkpoints

        finalize_checkpoints()  # the last save in flight, before the run ends


def tensorboard_writer(log_dir: str):
    """A ``torch.utils.tensorboard.SummaryWriter`` on ``log_dir``; None, with
    one warning, where the tensorboard package cannot be imported."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        get_logger().warning(f"TensorBoard sinks off: torch.utils.tensorboard cannot be imported ({e}); "
                             "metrics go to stdout and logs.txt only")
        return None
    return SummaryWriter(log_dir)


def _read_once(rows):
    """Each row's device tensors as host floats, in one read for all of them."""
    tensors = [v for row in rows for v in row if isinstance(v, torch.Tensor)]
    flat = iter(torch.cat([t.detach().reshape(-1).double() for t in tensors]).tolist() if tensors else [])
    out = []
    for row in rows:
        vals = []
        for v in row:
            if isinstance(v, torch.Tensor):
                vals.append([next(flat) for _ in range(v.numel())] if v.dim() else next(flat))
            else:
                vals.append(float(v))
        out.append(vals)
    return out


class TensorBoard(Callback):
    """The train metrics every ``log_every`` steps and the val metrics every
    epoch as scalars (reference TensorBoard, train.py:139; callbacks.py:473-516
    of the JAX package). The step's metrics are device tensors: they are
    buffered during the epoch and read in one go at its end, so no step
    waits for the device; the tags and steps are the JAX package's."""

    def __init__(self, log_dir: str = ".", log_every: int = 50):
        self.log_dir = log_dir
        self.log_every = log_every
        self.writer = None
        self._buf = []  # [(step, metrics)], flushed per epoch

    def on_begin(self):
        if process_index() == 0 and self.writer is None:
            self.writer = tensorboard_writer(self.log_dir)

    def on_batch_end(self, step, metrics):
        if self.writer is None or step % self.log_every:
            return
        self._buf.append((step, metrics))

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        if self.writer is None:
            return
        buf, self._buf = self._buf, []
        # the tags of each step in sorted order, as the JAX package's device_get of the metric dicts gives them
        keys = [sorted(m) for _, m in buf]
        values = _read_once([[m[k] for k in ks] for (_, m), ks in zip(buf, keys)])
        for (step, _), ks, vals in zip(buf, keys, values):
            for k, v in zip(ks, vals):
                self.writer.add_scalar(f"train/{k}", v, step)
        for k, v in (val_metrics or {}).items():
            self.writer.add_scalar(f"val/{k}", float(v), epoch)

    def on_end(self):
        if self.writer is not None:
            self.writer.close()


def _tb_writer(callback: Callback):
    return getattr(callback.runner, "tb_writer", None) if callback.runner is not None else None


class WeightDistributionTB(Callback):
    """A histogram of each parameter at the start of every epoch, on the host
    (reference callbacks.py:11-17; callbacks.py:519-529 of the JAX package),
    tagged ``model/<flax path>``."""

    def on_epoch_begin(self, epoch):
        tb = _tb_writer(self)
        if tb is None or process_index() != 0:
            return
        for path, leaf in flax_params(self.runner.state.model).items():
            tb.add_histogram(f"model/{path}", leaf.detach().cpu().numpy().ravel(), epoch)


class SpectralDistributionTB(Callback):
    """The singular values of every conv and Dense kernel at the start of each
    epoch, on the host (reference callbacks.py:20-28; callbacks.py:532-545 of
    the JAX package): each kernel as the JAX package reshapes it, (out,
    fan_in) from the flax layout, tagged ``spectrum/<flax path>``."""

    def on_epoch_begin(self, epoch):
        tb = _tb_writer(self)
        if tb is None or process_index() != 0:
            return
        for path, leaf in flax_params(self.runner.state.model).items():
            if leaf.dim() < 2 or "kernel" not in path:
                continue
            mat = leaf.detach().cpu().numpy().reshape(-1, leaf.shape[-1]).T
            tb.add_histogram(f"spectrum/{path}", np.linalg.svd(mat, compute_uv=False), epoch)


LOG_EDGES = np.linspace(-15.0, 5.0, 65, dtype=np.float32)  # GradDistributionTB's bins of log10 |p|


def log_histogram(leaves, subsample: int, edges: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX ``GradDistributionTB`` histogram on the device (callbacks.py:562-579
    of the JAX package): every ``subsample``-th value of each leaf, raveled in
    the flax layout, as log10 |v| (+1e-30) clipped to [-15, 5], counted into
    ``edges``'s 64 bins as ``jnp.histogram`` counts (a value on an edge
    falls in the bin above it, the last edge in the last bin), with the
    values' min, max, sum and sum of squares."""
    vals = torch.cat([leaf.detach().float().reshape(-1)[::subsample].abs() for leaf in leaves])
    logs = torch.log10(vals + 1e-30).clamp(-15.0, 5.0)
    return {"counts": bin_counts(logs, edges), "min": logs.min(), "max": logs.max(), "sum": logs.sum(),
            "sumsq": logs.square().sum()}


def bin_counts(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(x, bins=edges)``'s counts: a value on an edge falls in
    the bin above it, one on the last edge in the last bin, values outside
    the edges in none."""
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], len(edges) - 1, idx)
    return torch.bincount(idx, minlength=len(edges) + 1)[1:len(edges)]


class GradDistributionTB(Callback):
    """The distribution of log10 |params| every ``log_every`` steps (reference
    callbacks.py:30-60; callbacks.py:548-616 of the JAX package): the
    histogram is computed on the device (``log_histogram``) and only its 64
    counts and four scalars are buffered, read once at the epoch's end and
    written as ``optim/model_params_log``. In one process without a writer
    it does nothing."""

    def __init__(self, log_every: int = 500, subsample: int = 10):
        self.log_every = log_every
        self.subsample = subsample
        self._edges = None
        self._buf = []  # [(step, device stats)], flushed per epoch

    def on_batch_end(self, step, metrics):
        if step % self.log_every or self.runner is None:
            return
        if process_count() == 1 and _tb_writer(self) is None:
            return  # one process, no sink: no device work
        leaves = list(flax_params(self.runner.state.model).values())
        if self._edges is None or self._edges.device != leaves[0].device:
            self._edges = torch.from_numpy(LOG_EDGES).to(leaves[0].device)
        self._buf.append((step, log_histogram(leaves, self.subsample, self._edges)))

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        tb = _tb_writer(self)
        buf, self._buf = self._buf, []
        if tb is None or not buf:
            return
        keys = ("counts", "min", "max", "sum", "sumsq")
        for (step, _), (counts, lo, hi, total, sumsq) in zip(buf, _read_once([[s[k] for k in keys] for _, s in buf])):
            tb.add_histogram_raw(
                "optim/model_params_log", min=lo, max=hi, num=int(sum(counts)), sum=total, sum_squares=sumsq,
                bucket_limits=LOG_EDGES[1:].tolist(), bucket_counts=counts, global_step=step,
            )


# registry entries so configs instantiate these by target path
registry.register("Callback", aliases=("pytorch_tools.fit_wrapper.callbacks.Callback",))(Callback)
registry.register("CutmixMixup", aliases=("src.callbacks.CutmixMixup", "sota_imagenet.callbacks.CutmixMixup"))(
    CutmixMixup
)
registry.register("Cutmix", aliases=("pytorch_tools.fit_wrapper.callbacks.Cutmix", "pt_clb.Cutmix"))(Cutmix)
registry.register("Mixup", aliases=("pytorch_tools.fit_wrapper.callbacks.Mixup", "pt_clb.Mixup"))(Mixup)


for _name, _cls in (("WeightNorm", WeightNorm), ("OrthoLossClb", OrthoLossClb), ("NormLossClb", NormLossClb),
                   ("OrthoInitClb", OrthoInitClb), ("ForwardWeightNorm", ForwardWeightNorm),
                   ("ForwardSpectralNorm", ForwardSpectralNorm)):
    registry.register(_name, aliases=(f"src.callbacks.{_name}",))(_cls)
registry.register(
    "AdaptiveGradientClipping", aliases=("pytorch_tools.fit_wrapper.callbacks.AdaptiveGradientClipping",)
)(AdaptiveGradientClipping)
for _name, _cls in (("SAM", SAM), ("SAMOriginal", SAMOriginal), ("WeightDistributionTB", WeightDistributionTB),
                   ("SpectralDistributionTB", SpectralDistributionTB), ("GradDistributionTB", GradDistributionTB)):
    registry.register(_name, aliases=(f"src.callbacks.{_name}",))(_cls)
registry.register("Profiler")(Profiler)
