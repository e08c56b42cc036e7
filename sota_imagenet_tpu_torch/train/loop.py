"""Runner: the epoch/step loop (port of ``sota_imagenet_tpu/train/loop.py``:26-327;
pt.fit_wrapper.Runner equivalent, reference train.py:145-173).

Per-step metrics stay on the device during the epoch and are reduced once
at epoch end (loop.py:250-253): the loop itself never waits for the device,
so the host runs ahead while the card works through the queued steps. The
train step's metrics are the global batch's already; the val pass's are
summed over the ranks at its end (``reduce_metrics``).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.train import steps as steps_lib
from sota_imagenet_tpu_torch.train.callbacks import Callback
from sota_imagenet_tpu_torch.train.schedule import make_lr_schedule
from sota_imagenet_tpu_torch.train.state import TrainState
from sota_imagenet_tpu_torch.utils import debug_nans, trace
from sota_imagenet_tpu_torch.utils.logging import get_logger
from sota_imagenet_tpu_torch.utils.misc import resolve_device


def reduce_metrics(dev_metrics: List[Dict[str, Any]], over_ranks: bool = False) -> Dict[str, float]:
    """Mean of each metric over a list of per-step dicts, with ONE device read
    for all tensor-valued metrics (host floats such as lr are averaged in f32).

    Masked val batches carry ``_weight``, their real sample count: then each
    metric is the mean weighted by it (loop.py:305-312 of the JAX package),
    so padded and all-padding batches count only their real samples, and
    ``_weight`` itself is not returned.

    ``over_ranks``: the steps' metrics are this rank's (the val pass's), and
    the result is the global batches': the weighted sums and the weights are
    summed over the ranks before the division, and unweighted means (equal
    batches on every rank) averaged over them. Every rank must call it."""
    if not dev_metrics:
        return {}
    keys = list(dev_metrics[0])
    if "_weight" in keys:
        keys.remove("_weight")
        rows = torch.stack([torch.stack([m[k].float() for k in (*keys, "_weight")]) for m in dev_metrics]).tolist()
        sums = [sum(row[i] * row[-1] for row in rows) for i in range(len(keys))] + [sum(row[-1] for row in rows)]
        if over_ranks:
            device = dev_metrics[0]["_weight"].device
            sums = par.all_reduce_(torch.tensor(sums, dtype=torch.float64, device=device), "metrics").tolist()
        return {k: sums[i] / max(sums[-1], 1.0) for i, k in enumerate(keys)}
    tensor_keys = [k for k in keys if isinstance(dev_metrics[0][k], torch.Tensor)]
    out: Dict[str, float] = {}
    if tensor_keys:
        means = torch.stack([torch.stack([m[k].float() for m in dev_metrics]).mean() for k in tensor_keys])
        if over_ranks:
            means = par.all_reduce_(means, "metrics") / par.data_count()
        out.update(zip(tensor_keys, means.tolist()))
    for k in keys:
        if k not in out:
            out[k] = float(np.mean(np.asarray([m[k] for m in dev_metrics], np.float32)))
    return {k: out[k] for k in keys}


class Runner:
    def __init__(
        self,
        model: torch.nn.Module,
        criterion: Callable,
        optimizer_factory: Callable[[torch.nn.Module], torch.optim.Optimizer],
        *,
        lr_phases: List[dict],
        callbacks: Optional[List[Callback]] = None,
        accumulate_steps: int = 1,
        ema_decay: float = 0.0,
        remat: Any = False,
        input_dtype: torch.dtype = torch.bfloat16,
        device=None,
        debug_nans: bool = False,
        tp_params=None,
    ):
        self.device = resolve_device(device)
        self.tp_params = tp_params  # mesh.tp_params: the head-TP patterns (parallel/tp.py)
        self.model = model
        self.criterion = criterion
        self.optimizer_factory = optimizer_factory
        self.lr_phases = lr_phases
        self.callbacks = callbacks or []
        self.accumulate_steps = accumulate_steps
        self.ema_decay = ema_decay
        self.remat = remat
        self.input_dtype = input_dtype
        self.debug_nans = bool(debug_nans)
        self.state: Optional[TrainState] = None
        self.epoch = 0
        self.batch_size = 0
        self.tb_writer = None  # the TensorBoard sinks' writer: the last callback's ``writer`` after on_begin
        self.val_metrics: Dict[str, float] = {}
        self.train_metrics: Dict[str, float] = {}
        self._began = False
        self._train_step = None
        self._eval_step = None
        self._eval_step_ema = None
        for c in self.callbacks:
            c.set_runner(self)

    def init_state(self, seed: int = 0) -> TrainState:
        # through the parametrized wrapper (loop.py:98-108 of the JAX package): a
        # stateful parametrization seeds its state from the initial weights
        self.state = steps_lib.init_state(
            self._effective_model(self._collect_step_options()), self.optimizer_factory, device=self.device,
            seed=seed, ema_decay=self.ema_decay, criterion=self.criterion, tp_params=self.tp_params,
        )
        if self.debug_nans:
            for m in (self.state.model, self.state.ema):
                if m is not None:
                    debug_nans.watch_forward(m)
        return self.state

    def _effective_model(self, opts: Dict[str, Any]) -> torch.nn.Module:
        """The model with the callbacks' forward parametrization (WS, spectral
        norm), if one is given: train and eval, the EMA's too, run through it
        (loop.py:141-149 of the JAX package)."""
        fn = opts.pop("parametrization", None)
        return self.model if fn is None else ParametrizedModel(self.model, fn)

    def _collect_step_options(self) -> Dict[str, Any]:
        """The callbacks' step options; several auxiliary losses are summed (loop.py:86-96 of the JAX package)."""
        opts: Dict[str, Any] = {}
        aux_losses = []
        for c in self.callbacks:
            o = dict(c.step_options())
            if "aux_loss" in o:
                aux_losses.append(o.pop("aux_loss"))
            opts.update(o)
        if aux_losses:
            opts["aux_loss"] = lambda model: sum(f(model) for f in aux_losses)
        return opts

    def _build_steps(self, steps_per_epoch: int, base_epoch: int):
        # visible to stage-aware callbacks (CutmixMixup.stop_epoch) when
        # step_options are collected below
        self.base_epoch = base_epoch
        lr_schedule = make_lr_schedule(self.lr_phases, steps_per_epoch, base_epoch=base_epoch, base_step=self.state.step)
        opts = self._collect_step_options()
        opts.pop("parametrization", None)  # already in the state's model (init_state)
        self._train_step = steps_lib.build_train_step(
            self.criterion,
            lr_schedule,
            accumulate_steps=self.accumulate_steps,
            ema_decay=self.ema_decay,
            remat=self.remat,
            input_dtype=self.input_dtype,
            **opts,
        )
        if self.debug_nans:
            self._train_step = debug_nans.check_step(self._train_step)
        self._build_eval_steps()

    def _build_eval_steps(self):
        self._eval_step = steps_lib.build_eval_step(self.criterion, input_dtype=self.input_dtype)
        self._eval_step_ema = steps_lib.build_eval_step(self.criterion, input_dtype=self.input_dtype, use_ema=True)

    def _ensure_began(self):
        if not self._began:
            self._began = True
            for c in self.callbacks:
                c.on_begin()
                self.tb_writer = getattr(c, "writer", None) or self.tb_writer

    def fit(
        self,
        loader,
        val_loader=None,
        *,
        epochs: int,
        start_epoch: int = 0,
        steps_per_epoch: Optional[int] = None,
        val_steps: Optional[int] = None,
    ):
        if self.state is None:
            raise RuntimeError("call init_state() first")
        self._ensure_began()
        cached = isinstance(loader, DeviceCacheFeed)
        if cached:
            loader.ensure_filled()  # before the first epoch's clock starts, as the JAX loop fills in fused_step
            get_logger().info("Device-cache input path: gather + augment on the device")
        spe = steps_per_epoch or len(loader)
        self.batch_size = loader.batch_size
        self._build_steps(spe, base_epoch=start_epoch)
        for epoch in range(start_epoch, epochs):
            self.epoch = epoch
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            for c in self.callbacks:
                c.on_epoch_begin(epoch)
            dev_metrics: List[Dict[str, Any]] = []
            t0 = time.time()
            data_time = 0.0  # host time blocked waiting for input batches
            it = iter(loader)
            try:
                i = 0
                while i < spe:
                    unit = self.state.step  # the spans of one step share it
                    with trace.span("fit.wait_batch", unit):
                        td = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            break
                        data_time += time.perf_counter() - td
                    with trace.span("fit.step", unit):
                        self.state, m = self._train_step(self.state, batch)
                    dev_metrics.append(m)
                    step = int(i + epoch * spe)
                    with trace.span("fit.callbacks", unit):
                        for c in self.callbacks:
                            c.on_batch_end(step, m)
                    i += 1
            finally:
                if hasattr(it, "close"):
                    it.close()  # stops the feed's producer when the epoch ends early (debug)
            with trace.span("fit.epoch_end"):
                self.train_metrics = reduce_metrics(dev_metrics)  # the epoch's single device read
            wall = time.time() - t0
            self.train_metrics["epoch_time_s"] = wall
            self.train_metrics["data_time_s"] = data_time
            # the share of the epoch the host spent blocked waiting for its next batch (a host-side
            # proxy: the device may still be busy with queued steps while the host waits)
            self.train_metrics["input_wait_share"] = data_time / max(wall, 1e-9)
            if cached and epoch == start_epoch:
                self.train_metrics["cache_fill_s"] = loader.fill_s
                self.train_metrics["cache_mb"] = loader.fill_mb
            # validate with EMA weights when EMA is on (reference ModelEma, train.py:135)
            self.val_metrics = (
                self.evaluate(val_loader, steps=val_steps, use_ema=self.ema_decay > 0, _internal=True)
                if val_loader is not None
                else {}
            )
            for c in self.callbacks:
                c.on_epoch_end(epoch, self.train_metrics, self.val_metrics)
        return self.train_metrics, self.val_metrics

    def evaluate(self, loader, steps: Optional[int] = None, use_ema: bool = False, _internal: bool = False):
        self._ensure_began()
        if self._eval_step is None:
            self._build_eval_steps()
        fn = self._eval_step_ema if use_ema else self._eval_step
        dev_metrics = []
        it = iter(loader)
        try:
            for batch in itertools.islice(it, steps):
                dev_metrics.append(fn(self.state, batch))
        finally:
            if hasattr(it, "close"):
                it.close()
        metrics = reduce_metrics(dev_metrics, over_ranks=True)
        if not _internal:
            self.val_metrics = metrics
        return metrics

    def close(self):
        for c in self.callbacks:
            c.on_end()
        from sota_imagenet_tpu_torch.train.checkpoint import finalize_checkpoints

        finalize_checkpoints()  # any save still in flight
