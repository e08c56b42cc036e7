"""Train and eval steps (port of the core path of ``sota_imagenet_tpu/train/steps.py``:
init_state :115-140, build_train_step :185-352, build_eval_step :355-406).

One train step: forward (activation dtype) → loss (f32) → backward →
grad_norm (global L2 norm of the raw gradients, before weight decay) → SGD
with the schedule's lr for this step → EMA of params and BN buffers →
metrics. Everything stays on the device: the lr is a host float computed
from the host step count, and the metrics are device tensors the Runner
reduces once per epoch, so no step reads the device.

Step features of the JAX package that are not in this slice raise
NotImplementedError naming the ROADMAP item: gradient accumulation, SAM,
mixup/cutmix, remat, grad_transform (AGC), post_step_transform (WeightNorm),
auxiliary losses, and the masked rectangular-val eval branch.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from sota_imagenet_tpu_torch.losses.base import call_criterion
from sota_imagenet_tpu_torch.train.metrics import classification_metrics
from sota_imagenet_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def init_state(
    model: torch.nn.Module,
    optimizer_factory: Callable[[torch.nn.Module], torch.optim.Optimizer],
    *,
    device: torch.device,
    seed: int = 0,
    ema_decay: float = 0.0,
) -> TrainState:
    """Initialize the model's parameters from ``seed`` (on the host, so the
    weights do not depend on the device), move it to ``device`` in
    channels_last memory, and build its optimizer and EMA copy."""
    if hasattr(model, "reset_parameters"):
        model.reset_parameters(torch.Generator().manual_seed(int(seed)))
    model.to(device=device, memory_format=torch.channels_last)
    ema = copy.deepcopy(model).requires_grad_(False) if ema_decay else None
    return TrainState(step=0, model=model, optimizer=optimizer_factory(model), ema=ema)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to sota_imagenet_tpu_torch yet (ROADMAP.md {item})")


def build_train_step(
    criterion: Callable,
    lr_schedule: Callable[[int], float] = lambda step: 0.1,
    *,
    accumulate_steps: int = 1,
    ema_decay: float = 0.0,
    mixup_fn: Optional[Callable] = None,
    aux_loss: Optional[Callable] = None,
    sam: Optional[Dict[str, Any]] = None,
    grad_transform: Optional[Callable] = None,
    post_step_transform: Optional[Callable] = None,
    remat: Any = False,
    input_dtype: torch.dtype = torch.bfloat16,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, Any]]]:
    if accumulate_steps > 1:
        raise _not_ported("run.accumulate_steps > 1", "Queue 1 item 9")
    if sam:
        raise _not_ported("SAM", "Queue 1 item 9")
    if mixup_fn is not None:
        raise _not_ported("cutmix/mixup", "Queue 1 item 9")
    if remat:
        raise _not_ported("run.remat", "Queue 1 item 9")
    if grad_transform is not None or post_step_transform is not None or aux_loss is not None:
        raise _not_ported("grad_transform / post_step_transform / aux_loss", "Queue 1 item 9")

    def train_step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        images, labels = batch["image"], batch["label"]
        logits = model(images.to(input_dtype))
        loss, _ = call_criterion(criterion, logits, labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        grad_norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        lr = lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        if ema_decay:
            with torch.no_grad():
                ema_t = list(state.ema.state_dict().values())
                new_t = list(model.state_dict().values())
                # e * decay + p * (1 - decay), over params and BN buffers
                # (the reference ModelEma averages the full state_dict)
                torch._foreach_mul_(ema_t, ema_decay)
                torch._foreach_add_(ema_t, new_t, alpha=1.0 - ema_decay)
        metrics = classification_metrics(logits.detach(), labels, loss)
        metrics["grad_norm"] = grad_norm
        metrics["lr"] = lr
        state.step += 1
        return state, metrics

    return train_step


def build_eval_step(
    criterion: Callable, *, input_dtype: torch.dtype = torch.bfloat16, use_ema: bool = False
) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    def eval_step(state: TrainState, batch: Batch):
        if "mask" in batch:
            raise _not_ported("masked (rectangular / padded) validation", "Queue 1 item 12")
        model = state.ema if (use_ema and state.ema is not None) else state.model
        model.eval()
        with torch.no_grad():
            logits = model(batch["image"].to(input_dtype))
            loss, _ = call_criterion(criterion, logits, batch["label"])
            return classification_metrics(logits, batch["label"], loss)

    return eval_step
