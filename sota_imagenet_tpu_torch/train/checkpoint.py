"""Checkpoints with ``torch.save`` (port of ``sota_imagenet_tpu/train/checkpoint.py``;
reference train.py:98-109,134,183-184).

Payload: ``{"state": {step, model, optimizer, ema, loss_state}, "epoch",
"optimizer_layout"}``, state dicts of tensors (``loss_state``: a stateful
criterion's tensors, or None; ``optimizer_layout``: ``optimizer_layout`` of
the optimizer saved, or None without it).

Saves run in the background, as the JAX package's do (checkpoint.py:1-21
there): ``save_checkpoint`` gathers on every rank what is collective (a
ZeRO-1 optimizer's whole state, the head TP shards of the weights, the EMA
and the optimizer state, ``parallel/tp.py``), rank 0 copies the payload to
host memory, and a thread writes it to ``<name>.tmp-<pid>`` and renames it
over ``<name>``: a crash at any point leaves the previous complete file or
the new one. At most one save is in flight. ``finalize_checkpoints`` waits
for it, raises what the write raised, and holds every rank until the file
is in place; it runs before every save and every load, and at the end of a
run (``Runner.close``, ``CheckpointSaver.on_end``, and after the CLI's
``model_last.ckpt``, saved with ``block=True``).

The restore decides as the JAX package's (checkpoint.py:120-171 there):

* a full restore, the optimizer state and ``step`` included, only where
  everything saved matches the live state: the model's keys, an EMA on
  both sides or on neither, the criterion's state on both sides (with the
  same keys) or on neither, and the optimizer saved with the live one's
  layout (``optimizer_layout``). The hyperparameters stay this run's (the
  JAX chain takes them from the config, never from a checkpoint);
* otherwise the params and BN buffers only, which are required (a
  different model raises), the EMA and the criterion's state where they
  match, and a fresh optimizer and ``step``: the lr schedule's step anchor
  and the optimizer restart together, the resumed epoch carried by the
  epoch counter. An optimizer's state is loaded whole or not at all.

The layout is the optimizer's class chain and the parameter count of each
group; hyperparameter values are not part of it. In the JAX package a zero
momentum or weight decay drops a transform from the optax chain, so there
a change of either to or from 0 falls back; here the state a torch
optimizer keeps does not change with them (tests/test_torch_checkpoint.py
holds both). A checkpoint written before the layout was recorded is
matched by its wrappers' keys and its groups' hyperparameter names.

Over ranks (JAX checkpoint.py:50-51, 80, 86-90), a resume loads the same
file on every rank, each keeping its shards, so a checkpoint resumes with
or without head TP or ZeRO-1.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Optional, Tuple

import torch

from sota_imagenet_tpu_torch.optim.zero1 import Zero1
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel import tp
from sota_imagenet_tpu_torch.train.state import TrainState
from sota_imagenet_tpu_torch.utils.logging import get_logger
from sota_imagenet_tpu_torch.utils.misc import process_index

# the wrappers a state dict written before the layout was recorded shows by its keys
_WRAPPERS = ("ApplyIfFinite", "Lookahead")


class _Writer(threading.Thread):
    """Rank 0's write of one host payload: ``torch.save`` to a tmp file, then the rename."""

    def __init__(self, payload: dict, path: str):
        super().__init__(name="checkpoint-writer")
        self.payload, self.path, self.error = payload, path, None

    def run(self):
        try:
            tmp = f"{self.path}.tmp-{os.getpid()}"
            torch.save(self.payload, tmp)
            os.replace(tmp, self.path)
        except BaseException as e:  # noqa: BLE001 - raised again by finalize_checkpoints
            self.error = e
        self.payload = None


# this rank's save in flight: the writer on rank 0, the path on the others
_pending = None


def finalize_checkpoints() -> None:
    """Wait for the save in flight, hold every rank until its file is in
    place, and raise what its write raised. Every rank calls it."""
    global _pending
    pending, _pending = _pending, None
    if pending is None:
        return
    if isinstance(pending, _Writer):
        pending.join()
    par.barrier()
    if isinstance(pending, _Writer) and pending.error is not None:
        raise pending.error


def _to_host(x, devices: set):
    """A copy of ``x`` in host memory: every tensor copied, so that the steps
    after the save change nothing in it. A card's tensors are copied
    asynchronously into pinned memory; ``devices`` collects their cards,
    which the caller synchronises before the copy is read."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            devices.add(x.device)
        return x.detach().to("cpu", copy=True, non_blocking=True)
    if isinstance(x, dict):  # a copy of the same type: a state dict keeps its ``_metadata``
        out = copy.copy(x)
        for k, v in x.items():
            out[k] = _to_host(v, devices)
        return out
    if type(x) in (list, tuple):
        return type(x)(_to_host(v, devices) for v in x)
    return x


def _chain(opt):
    """``opt`` and the optimizers it wraps, outermost first."""
    while opt is not None:
        yield opt
        opt = getattr(opt, "inner", None)


def optimizer_layout(opt: torch.optim.Optimizer) -> dict:
    """What an optimizer's state dict holds, as the restore compares it: the
    class of each optimizer along its chain of wrappers, outermost first
    (ZeRO-1 left out: it saves the unsharded optimizer's state dict), and
    the parameter count of each group."""
    return {"classes": [type(o).__name__ for o in _chain(opt) if not isinstance(o, Zero1)],
            "groups": [len(g["params"]) for g in opt.param_groups]}


def _names(groups) -> list:
    return sorted({k for g in groups for k in g if k != "params"})


def _legacy_layouts(saved: dict, opt) -> Tuple[dict, dict]:
    """The saved and the live layout of a state dict written without one:
    the wrappers by their keys (``inner``; ``skip`` for ApplyIfFinite) and
    the groups by their hyperparameter names and parameter counts."""
    wrappers, groups = [], None
    while True:
        if groups is None and "param_groups" in saved:
            groups = saved["param_groups"]
        if not isinstance(saved.get("inner"), dict):
            break
        wrappers.append("ApplyIfFinite" if "skip" in saved else "Lookahead")
        saved = saved["inner"]
    live = optimizer_layout(opt)
    return ({"wrappers": wrappers, "names": _names(groups or []), "groups": [len(g["params"]) for g in groups or []]},
            {"wrappers": [c for c in live["classes"] if c in _WRAPPERS], "names": _names(opt.param_groups),
             "groups": live["groups"]})


def _optimizer_matches(payload: dict, opt) -> bool:
    saved = payload["state"].get("optimizer")
    if saved is None:
        return False
    if payload.get("optimizer_layout") is None:
        old, live = _legacy_layouts(saved, opt)
        return old == live
    return payload["optimizer_layout"] == optimizer_layout(opt)


def _with_run_hyperparameters(saved: dict, opt) -> dict:
    """``saved`` with each group's hyperparameters taken from ``opt``, this
    run's optimizer (ZeRO-1 keeps its own groups in ``load_state_dict``)."""
    if isinstance(opt, Zero1):
        return saved
    out = dict(saved)
    if "param_groups" in saved:
        out["param_groups"] = [{**{k: v for k, v in live.items() if k != "params"}, "params": disk["params"]}
                               for disk, live in zip(saved["param_groups"], opt.param_groups)]
    if isinstance(saved.get("inner"), dict):
        out["inner"] = _with_run_hyperparameters(saved["inner"], opt.inner)
    return out


def save_checkpoint(
    directory: str, state: TrainState, epoch: int, name: str = "model.ckpt", include_optimizer: bool = True,
    block: bool = False,
) -> str:
    """Gather and copy ``state`` to host memory and start its write (see the
    module docstring); with ``block`` also wait for it. Every rank calls it."""
    path = os.path.join(os.path.abspath(directory), name)
    finalize_checkpoints()  # at most one save in flight
    global _pending
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
        "optimizer_layout": optimizer_layout(state.optimizer) if include_optimizer else None,
    }
    if process_index() == 0:
        devices = set()
        host = _to_host(payload, devices)
        for device in devices:
            torch.cuda.synchronize(device)
        _pending = _Writer(host, path)
        _pending.start()
    else:
        _pending = path
    if block:
        finalize_checkpoints()
    return path


def _load_module(module: torch.nn.Module, saved: dict) -> None:
    module.load_state_dict(tp.shard_state_dict(module, saved))


def _same_keys(module: Optional[torch.nn.Module], saved: Optional[dict]) -> bool:
    return module is not None and saved is not None and set(module.state_dict()) == set(saved)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore into ``state`` in place (onto the model's device), fully or in
    part as the module docstring says; returns it and the saved epoch."""
    finalize_checkpoints()  # a save of this file may be in flight
    device = next(state.model.parameters()).device
    payload = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    disk = payload["state"]
    saved_ema, saved_ls = disk.get("ema"), disk.get("loss_state")
    ema_ok = _same_keys(state.ema, saved_ema)
    ls_ok = state.loss_state is not None and saved_ls is not None and set(saved_ls) == set(state.loss_state)
    full = (_same_keys(state.model, disk["model"]) and _optimizer_matches(payload, state.optimizer)
            and (ema_ok or (state.ema is None and saved_ema is None))
            and (ls_ok or (state.loss_state is None and saved_ls is None)))
    log = get_logger()
    if not full:
        if disk.get("optimizer") is None:
            log.info("Checkpoint has no optimizer state (log.save_optim=false); restoring params/batch_stats")
        else:
            log.info("Full checkpoint restore failed (the saved state does not match this run's); retrying params-only")
    # the params and BN buffers are required: a different model raises here
    _load_module(state.model, disk["model"])
    if ema_ok:
        _load_module(state.ema, saved_ema)
    elif state.ema is not None and saved_ema is not None:
        log.info("Partial restore: field 'ema' structure mismatch; keeping fresh value")
    if ls_ok:
        state.loss_state = {k: saved_ls[k].to(device=v.device, dtype=v.dtype) for k, v in state.loss_state.items()}
    elif state.loss_state is not None and saved_ls is not None:
        log.info("Partial restore: field 'loss_state' structure mismatch; keeping fresh value")
    if full:
        saved_opt = tp.shard_optimizer_state(state.model, state.optimizer, disk["optimizer"])
        state.optimizer.load_state_dict(_with_run_hyperparameters(saved_opt, state.optimizer))
        state.step = int(disk["step"])
    return state, int(payload["epoch"])
