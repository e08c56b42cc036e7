"""Callbacks (port of ``sota_imagenet_tpu/train/callbacks.py``:36-130,387-472;
reference pytorch_tools fit_wrapper callbacks).

Two kinds, as in the JAX package:

  * host callbacks run between steps and observe the Runner (epoch, state,
    metrics). ``on_batch_end`` receives the step's metrics as device
    tensors: reading one there would stall the device every step, so the
    callbacks here only read metrics the Runner has already reduced at
    epoch end;
  * step contributors (CutmixMixup, Cutmix, Mixup) add options to the train
    step through ``step_options()``; the Runner collects them when it builds
    the steps of a stage.

The callbacks of the JAX package that are not ported (SAM, the weight-norm
and ortho family, AGC, the TensorBoard sinks, the profiler) are registered
under their names and raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Dict, Optional

from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.train.steps import cutmix_mixup
from sota_imagenet_tpu_torch.utils.logging import get_logger


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


for _name in ("SAM", "SAMOriginal", "ForwardWeightNorm", "ForwardSpectralNorm", "WeightNorm", "OrthoLossClb",
              "NormLossClb", "OrthoInitClb"):
    _register_unported(_name, "Queue 1 item 9", aliases=(f"src.callbacks.{_name}",))
_register_unported(
    "AdaptiveGradientClipping", "Queue 1 item 9", aliases=("pytorch_tools.fit_wrapper.callbacks.AdaptiveGradientClipping",)
)
for _name in ("WeightDistributionTB", "SpectralDistributionTB", "GradDistributionTB"):
    _register_unported(_name, "Queue 1 item 7", aliases=(f"src.callbacks.{_name}",))
_register_unported("Profiler", "Queue 1 item 9")
