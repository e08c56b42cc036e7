"""Run the port on N ranks of a gloo process group, one spawned process each:
the harness of the data-parallel checks (``tools/dryrun_multichip.py``, the
CPU tests, ``chip_smoke.py``'s two-rank phases).

``run_ranks(fn, world, args, tmp_dir)`` spawns ``world`` processes that join
a group through a ``file://`` rendezvous under ``tmp_dir`` (no port to
collide with another run's), calls ``fn(*args)`` on each and returns their
results in rank order; an exception on a rank is raised here with its
traceback. The children start from a fresh import of torch and this package
(never ``fork``: the parent may hold CUDA or other threads), so ``fn`` is a
function of an importable module and its arguments and results pickle.

``train_steps(spec)`` runs a few train steps of a model on this rank's rows
of given global batches (every rank the same spec; the mesh's spatial and
model axes from the spec, the data axis the ranks they leave) and returns
what they left, in numpy; run with no group it is the one-process replay of the same
steps (``train_legs``: several specs in one spawn). ``cli_rank(argv,
device)`` is ``cli.main`` on a rank.
"""

from __future__ import annotations

import copy
import multiprocessing
import os
import queue
import traceback
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist



def _child(fn, rank: int, world: int, init_file: str, args: tuple, threads: int, backend, env, out) -> None:
    os.environ.update(env or {})
    torch.set_num_threads(threads)
    try:
        if backend:
            dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world)
        try:
            out.put((rank, fn(*args), None))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent, with its traceback
        out.put((rank, None, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: tuple = (), *, tmp_dir: str, timeout: float = 600.0,
              threads: int = 1, backend: Optional[str] = "gloo", env: Optional[Dict[str, str]] = None) -> List[Any]:
    """``fn(*args)`` on each of ``world`` ranks of a ``backend`` group; their
    results in rank order. ``backend=None`` joins no group: ``fn`` may join
    one itself, from ``env`` (set in each child first, e.g. torchrun's)."""
    ctx = multiprocessing.get_context("spawn")
    init_file = os.path.join(tmp_dir, f"rendezvous-{uuid.uuid4().hex}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, world, init_file, args, threads, backend, env, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors = []
    try:
        for _ in range(world):
            rank, res, err = out.get(timeout=timeout)
            results[rank] = res
            if err:
                errors.append(f"rank {rank}:\n{err}")
                break
    except queue.Empty:
        errors.append(f"no result from ranks {sorted(set(range(world)) - set(results))} in {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


def _numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _optimizer_numpy(sd: dict) -> dict:
    """An optimizer state dict's tensors in numpy (the structure kept)."""
    if isinstance(sd, torch.Tensor):
        return sd.detach().cpu().numpy().copy()
    if isinstance(sd, dict):
        return {k: _optimizer_numpy(v) for k, v in sd.items()}
    if isinstance(sd, (list, tuple)):
        return type(sd)(_optimizer_numpy(v) for v in sd)
    return sd


def train_steps(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Train steps of the port on this rank's rows of each global batch.

    ``spec``: ``model`` (a config node for ``config.instantiate``, or a
    function of an importable module that builds the model), ``init``
    (its state_dict in numpy), ``dtype`` ("float64" or "float32"),
    ``device``, ``optim`` (a config node for ``build_optimizer``), ``zero1``,
    ``criterion`` (a config node), ``lr`` (a constant), ``accumulate_steps``,
    ``ema_decay``, ``sam`` (the step's option or None), ``bn_stats`` (the
    statistics groups), ``remat`` (the step's policy), ``skip_nonfinite``
    (N: the optimizer in ``ApplyIfFinite``), ``mixup`` (None, or ``{"cutmix_alpha",
    "mixup_alpha", "draws": [one dict of numpy scalars a step]}``: the
    pre-drawn values ``apply_cutmix_mixup`` takes), ``batches`` (a list of
    global (images NHWC, one-hot labels) in numpy), ``seed``, ``spatial`` and
    ``model_axis`` (the mesh's axes; the data axis takes the other ranks) with
    ``tp_params`` (the head-TP patterns). Returns the metrics of each step,
    the model's and the EMA's state_dicts, the criterion's state and the
    optimizer's (the unsharded one under ZeRO-1, the whole head under TP),
    all in numpy, the collectives' counts and the skip's counters (or None)."""
    from sota_imagenet_tpu_torch.config import instantiate
    from sota_imagenet_tpu_torch.losses.base import StatefulLoss
    from sota_imagenet_tpu_torch.models.layers import bind_generator
    from sota_imagenet_tpu_torch.models.norms import set_bn_stats_groups
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.optim.skip_nonfinite import ApplyIfFinite
    from sota_imagenet_tpu_torch.optim.zero1 import Zero1
    from sota_imagenet_tpu_torch.parallel import mesh as par
    from sota_imagenet_tpu_torch.parallel import tp
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.state import TrainState

    device, dtype = torch.device(spec.get("device", "cpu")), getattr(torch, spec.get("dtype", "float64"))
    if device.type == "cuda":
        # float32 products in float32, and cuDNN's deterministic algorithms: two runs of a spec give the same bits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    set_bn_stats_groups(spec.get("bn_stats", 1))
    par.create_mesh(spatial=spec.get("spatial", 1) if dist.is_initialized() else 1,
                    model=spec.get("model_axis", 1) if dist.is_initialized() else 1)
    try:
        make = spec["model"]
        model = instantiate(copy.deepcopy(make)) if isinstance(make, dict) else make()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["init"].items()})
        model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        if par.axis_size("model") > 1:
            tp.apply_head_tp(model, spec.get("tp_params"))

        def build(named):
            return build_optimizer(dict(spec["optim"]), named)

        opt = Zero1(build, model.named_parameters()) if spec.get("zero1") else build(model.named_parameters())
        if spec.get("skip_nonfinite"):
            opt = ApplyIfFinite(opt, int(spec["skip_nonfinite"]))
        ema_decay = spec.get("ema_decay", 0.0)
        generator = torch.Generator(device=device)
        bind_generator(model, generator)
        criterion = instantiate(copy.deepcopy(spec["criterion"]))
        state = TrainState(
            step=0, model=model, optimizer=opt, ema=copy.deepcopy(model).requires_grad_(False) if ema_decay else None,
            generator=generator, seed=int(spec.get("seed", 0)),
            loss_state=criterion.init_state(device) if isinstance(criterion, StatefulLoss) else None,
        )
        mixup = spec.get("mixup")
        mixup_fn = None
        if mixup:
            draws = iter(mixup["draws"])

            def mixup_fn(gen, images, labels):
                d = {k: torch.as_tensor(v, device=images.device) for k, v in next(draws).items()}
                return steps.apply_cutmix_mixup(images, labels, d, mixup["cutmix_alpha"], mixup["mixup_alpha"])

        step = steps.build_train_step(
            criterion, lambda i: float(spec.get("lr", 0.1)), accumulate_steps=spec.get("accumulate_steps", 1),
            ema_decay=ema_decay, mixup_fn=mixup_fn, sam=spec.get("sam"), remat=spec.get("remat", False),
            input_dtype=dtype,
        )
        world, rank = par.data_count(), par.data_index()
        par.STATS.reset()
        metrics = []
        for images, labels in spec["batches"]:
            b = images.shape[0] // world
            batch = {
                "image": torch.from_numpy(images[rank * b : (rank + 1) * b]).to(device, dtype),
                "label": torch.from_numpy(labels[rank * b : (rank + 1) * b]).to(device, dtype),
            }
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        collectives = dict(par.STATS.calls)
        return {
            "metrics": metrics,
            "model": _numpy(tp.full_state_dict(state.model)),
            "ema": _numpy(tp.full_state_dict(state.ema)) if state.ema is not None else None,
            "loss_state": _numpy(state.loss_state) if state.loss_state is not None else None,
            "optimizer": _optimizer_numpy(tp.full_optimizer_state(state.model, state.optimizer,
                                                                  state.optimizer.state_dict())),
            "collectives": collectives,
            "skip": state.optimizer.counters() if isinstance(state.optimizer, ApplyIfFinite) else None,
            "shards": {k: list(v) for k, v in tp.sharded(state.model).items()},
            "bytes": {k: v.numel() * v.element_size() for k, v in state.model.state_dict().items()},
        }
    finally:
        set_bn_stats_groups(1)
        par.set_mesh(None)


def train_legs(specs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """``train_steps`` of each spec, one after the other on this rank (one spawn for many legs)."""
    return [train_steps(s) for s in specs]


def cli_rank(argv: List[str], device: Optional[str] = "cpu", env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """``cli.main(argv)`` on this rank: its val metrics, its model's
    state_dict in numpy and the run dir of its log (with ``env`` set first,
    e.g. a TMPDIR)."""
    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.train.callbacks import Callback

    os.environ.update(env or {})

    class Keep(Callback):
        def on_end(self):
            self.model = _numpy(self.runner.state.model.state_dict())

    keep = Keep()
    val = cli.main(list(argv), device=device, callbacks=[keep])
    return {"val": val, "model": keep.model}
