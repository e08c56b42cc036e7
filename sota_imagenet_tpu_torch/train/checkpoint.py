"""Checkpoints with ``torch.save`` (port of ``sota_imagenet_tpu/train/checkpoint.py``
:86-171; reference train.py:98-109,134,183-184).

Payload: ``{"state": {step, model, optimizer, ema, loss_state}, "epoch"}``,
state dicts of tensors (``loss_state``: a stateful criterion's tensors, or
None). Saves are atomic: written to ``<name>.tmp-<pid>`` and renamed
over ``<name>``, so a crash leaves the previous complete file.

Restore semantics follow the JAX package: a checkpoint written without the
optimizer state (``log.save_optim=false``, the reference default) restores
params, BN buffers and EMA only, and does NOT restore ``step`` — the fresh
optimizer and the lr schedule's step anchor restart together (the resumed
epoch is carried by the epoch counter instead). The criterion's state is
optional, as in the JAX restore (checkpoint.py:169): it is restored where
the checkpoint holds it with the same keys, and a checkpoint without it
leaves the run's fresh ``init_state()``.

Over ranks (JAX checkpoint.py:50-51, 80, 86-90): every rank calls
``save_checkpoint`` (a ZeRO-1 optimizer gathers its whole state in
``state_dict``; under head TP the class shards of the weights, the EMA and
the optimizer state are gathered whole, ``parallel/tp.py``), rank 0 writes,
and the others wait for it at a barrier; a resume loads the same file on
every rank, each keeping its shards, so a checkpoint resumes with or without
head TP.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel import tp
from sota_imagenet_tpu_torch.train.state import TrainState
from sota_imagenet_tpu_torch.utils.logging import get_logger
from sota_imagenet_tpu_torch.utils.misc import process_index


def save_checkpoint(
    directory: str, state: TrainState, epoch: int, name: str = "model.ckpt", include_optimizer: bool = True
) -> str:
    path = os.path.join(os.path.abspath(directory), name)
    payload = {
        "state": {
            "step": int(state.step),
            "model": tp.full_state_dict(state.model),
            "optimizer": (tp.full_optimizer_state(state.model, state.optimizer, state.optimizer.state_dict())
                          if include_optimizer else None),
            "ema": tp.full_state_dict(state.ema) if state.ema is not None else None,
            "loss_state": state.loss_state,
        },
        "epoch": int(epoch),
    }
    if process_index() == 0:
        tmp = f"{path}.tmp-{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    par.barrier()
    return path


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore into ``state`` in place (onto the model's device)."""
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    disk = payload["state"]
    state.model.load_state_dict(tp.shard_state_dict(state.model, disk["model"]))
    if state.ema is not None and disk.get("ema") is not None:
        state.ema.load_state_dict(tp.shard_state_dict(state.ema, disk["ema"]))
    saved_ls = disk.get("loss_state")
    if state.loss_state is not None and saved_ls is not None:
        if set(saved_ls) == set(state.loss_state):
            state.loss_state = {k: saved_ls[k].to(device=v.device, dtype=v.dtype) for k, v in state.loss_state.items()}
        else:
            get_logger().info("Partial restore: loss_state keys differ; keeping the criterion's initial state")
    if disk.get("optimizer") is None:
        get_logger().info("Checkpoint has no optimizer state (log.save_optim=false); restoring params/batch_stats")
    else:
        state.optimizer.load_state_dict(tp.shard_optimizer_state(state.model, state.optimizer, disk["optimizer"]))
        state.step = int(disk["step"])
    return state, int(payload["epoch"])
