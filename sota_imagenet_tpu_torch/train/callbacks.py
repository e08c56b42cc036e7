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

The callbacks of the JAX package that are not ported (SAM, the TensorBoard
sinks, the profiler) are registered under their names and raise
NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Dict, Optional

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
from sota_imagenet_tpu_torch.utils.logging import get_logger
from sota_imagenet_tpu_torch.utils.weights import kernel_parameters


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
    """Per-epoch wall clock (train + val, ending at the epoch's metric read)
    and train images/sec (reference Timer, train.py:137)."""

    def on_epoch_begin(self, epoch):
        self._t0 = time.time()
        self._images = 0

    def on_batch_end(self, step, metrics):
        self._images += getattr(self.runner, "batch_size", 0) if self.runner else 0

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        dt = time.time() - self._t0
        ips = self._images / dt if dt > 0 else 0.0
        util = train_metrics.get("input_utilization")
        util_s = f" | host-wait-free {util * 100:.1f}%" if util is not None else ""
        get_logger().info(f"Epoch {epoch:3d} | {dt:.1f}s | {ips:.1f} img/s{util_s}")


class CheckpointSaver(Callback):
    """Save the state each epoch and keep the best by a monitored val metric
    (pytorch_tools CheckpointSaver monitors loss; reference train.py:134)."""

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


# registry entries so configs instantiate these by target path
registry.register("Callback", aliases=("pytorch_tools.fit_wrapper.callbacks.Callback",))(Callback)
registry.register("CutmixMixup", aliases=("src.callbacks.CutmixMixup", "sota_imagenet.callbacks.CutmixMixup"))(
    CutmixMixup
)
registry.register("Cutmix", aliases=("pytorch_tools.fit_wrapper.callbacks.Cutmix", "pt_clb.Cutmix"))(Cutmix)
registry.register("Mixup", aliases=("pytorch_tools.fit_wrapper.callbacks.Mixup", "pt_clb.Mixup"))(Mixup)


def _register_unported(name: str, item: str, aliases: tuple = ()) -> None:
    def make(*args, **kwargs):
        raise registry.NotPortedError(f"callback {name!r}", item)

    registry.register(name, aliases=aliases)(make)


for _name, _cls in (("WeightNorm", WeightNorm), ("OrthoLossClb", OrthoLossClb), ("NormLossClb", NormLossClb),
                   ("OrthoInitClb", OrthoInitClb), ("ForwardWeightNorm", ForwardWeightNorm),
                   ("ForwardSpectralNorm", ForwardSpectralNorm)):
    registry.register(_name, aliases=(f"src.callbacks.{_name}",))(_cls)
registry.register(
    "AdaptiveGradientClipping", aliases=("pytorch_tools.fit_wrapper.callbacks.AdaptiveGradientClipping",)
)(AdaptiveGradientClipping)
for _name in ("SAM", "SAMOriginal"):
    _register_unported(_name, "Queue 1 item 9", aliases=(f"src.callbacks.{_name}",))
for _name in ("WeightDistributionTB", "SpectralDistributionTB", "GradDistributionTB"):
    _register_unported(_name, "Queue 1 item 7", aliases=(f"src.callbacks.{_name}",))
_register_unported("Profiler", "Queue 1 item 9")
