"""Phase-based LR scheduling (port of ``sota_imagenet_tpu/train/schedule.py``:18-73;
pytorch_tools PhasesScheduler equivalent).

The reference builds ``[{ep:(start,end), lr:(a,b), mode:linear|cos}]`` from
run.stages (train.py:121-126) and updates lr every batch. Here the phases
become a plain ``lr(step) -> float`` evaluated on the host each step, in
float32 like the JAX schedule, so the step needs no device read.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np

from sota_imagenet_tpu_torch.config import DataStage

f32 = np.float32


def phases_from_stages(stages: Sequence[DataStage]) -> List[dict]:
    out = []
    for st in stages:
        if st.lr is None:
            continue
        # lr_ep: the phase's true epoch span when it extends past the stage
        # (legacy mid-phase data changes); consecutive stages cut from the
        # same phase produce identical entries — deduplicate them
        ep = tuple(st.lr_ep) if st.lr_ep is not None else (st.start, st.end)
        ph = dict(ep=ep, lr=tuple(st.lr), mode=st.lr_mode or "linear")
        if not out or out[-1] != ph:
            out.append(ph)
    return out


def make_lr_schedule(
    phases: Sequence[dict],
    steps_per_epoch: int,
    base_epoch: float = 0.0,
    base_step: int = 0,
) -> Callable[[int], float]:
    """Piecewise linear/cosine/poly schedule over *fractional epochs* (the
    reference interpolates per batch). Beyond the last phase, holds its final
    lr. ``base_epoch``/``base_step`` anchor the epoch<->step mapping across
    stages whose steps_per_epoch differ: epoch = base_epoch + (step - base_step) / spe.
    """
    if not phases:
        return lambda step: 0.0
    spans = []
    for ph in phases:
        (e0, e1) = ph["ep"]
        (a, b) = ph["lr"]
        spans.append((f32(e0), f32(e1), f32(a), f32(b), ph.get("mode", "linear")))

    def schedule(step: int) -> float:
        ep = f32(base_epoch) + (f32(step) - f32(base_step)) / f32(steps_per_epoch)
        lr = spans[0][2]
        for e0, e1, a, b, mode in spans:
            t = np.clip((ep - e0) / f32(max(e1 - e0, 1e-9)), f32(0.0), f32(1.0))
            if mode == "cos":
                val = b + (a - b) * f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * t))
            elif mode == "poly":
                # quadratic decay between the endpoints (effnetb0_tf.yaml "mode": "poly")
                val = b + (a - b) * (f32(1.0) - t) ** 2
            else:
                val = a + (b - a) * t
            if ep >= e0:
                lr = val
        return float(lr)

    return schedule
