"""Host callbacks (port of ``sota_imagenet_tpu/train/callbacks.py``:36-64,387-472;
reference pytorch_tools fit_wrapper callbacks).

Callbacks run between steps and observe the Runner (epoch, state, metrics).
``on_batch_end`` receives the step's metrics as device tensors: reading one
there would stall the device every step, so the callbacks here only read
metrics the Runner has already reduced at epoch end. The TensorBoard and
weight-histogram sinks are not ported yet (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

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
