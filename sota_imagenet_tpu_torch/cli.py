"""Train, export and dataset-prep CLI of the port (port of ``sota_imagenet_tpu/cli.py``:27-460; reference
train.py).

Usage:
    python -m sota_imagenet_tpu_torch.cli -c configs/exp/1.r50_baseline.yaml [key=value ...]   (or sota-train-torch)
    python -m sota_imagenet_tpu_torch.cli -c <yaml> run.evaluate=true run.resume=<run_dir>/model_last.ckpt
    torchrun --nproc_per_node=N -m sota_imagenet_tpu_torch.cli [--device cpu] -c <yaml> [mesh.zero1=true] ...
    torchrun --nproc_per_node=2 -m sota_imagenet_tpu_torch.cli -c <yaml> mesh.spatial=2   (or mesh.model=2)
    python -m sota_imagenet_tpu_torch.cli records packed <data_dir> [--size 224] ...   (records_main; sota-records-torch)
    python -m sota_imagenet_tpu_torch.cli records resize <data_dir> [--size 512] [--workers N]
    python -m sota_imagenet_tpu_torch.cli records tfrecord <data_dir> [--out DIR] [--workers N]
    python -m sota_imagenet_tpu_torch.cli export -c <yaml> --ckpt <ckpt> --out <dir> [--ema]
        [--batch poly|N] [--image-size S] [--quantize int8] [--device cpu|cuda] [key=value ...]   (export_main;
        sota-export-torch)

Mirrors the reference main() flow (reference train.py:22-185): config →
run dir + git snapshot → model / criterion / optimizer → resume → callbacks
→ stage loop over the DataManager → final eval + save. It runs on one CUDA
device unless the caller passes ``device="cpu"``. Under torchrun (or with a
``torch.distributed`` group the caller set up) each process is one rank of
the ``data`` axis (``parallel/mesh.py``): NCCL when each rank has a card of
its own, gloo on the CPU or when ranks share a card; the batch of the
config is the global one, rank 0 logs and writes, and ``mesh.zero1`` shards
the optimizer state (``optim/zero1.py``). The ranks form the mesh
(data, spatial, model) of the JAX CLI (``parallel/mesh.create_mesh``):
``mesh.spatial`` shards the image height over ranks (``parallel/spatial.py``,
every stage's image size checked by ``validate_spatial_extent``) and
``mesh.model`` shards the head's classes (``parallel/tp.py``, the leaves
``mesh.tp_params`` names). The TensorBoard sinks write event files into the run dir;
where the tensorboard package is missing they log one warning and the run
goes on.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import time
from typing import Iterable, Optional

import torch

from sota_imagenet_tpu_torch import config as C
from sota_imagenet_tpu_torch.config import instantiate, parse_stages
from sota_imagenet_tpu_torch.data.pipeline import DataManager
from sota_imagenet_tpu_torch.models.norms import resolve_bn_stats, set_bn_stats_groups
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, weight_standardization_fn
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.optim.factory import needs_layout
from sota_imagenet_tpu_torch.optim.skip_nonfinite import ApplyIfFinite
from sota_imagenet_tpu_torch.optim.zero1 import Zero1
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel.spatial import validate_spatial_extent
from sota_imagenet_tpu_torch.train.callbacks import (
    Callback,
    CheckpointSaver,
    ConsoleLogger,
    TensorBoard,
    Timer,
    WeightDistributionTB,
)
from sota_imagenet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.train.schedule import phases_from_stages
from sota_imagenet_tpu_torch.utils.logging import get_logger, setup_logger
from sota_imagenet_tpu_torch.utils.misc import (
    count_parameters,
    filter_from_weight_decay,
    process_count,
    process_index,
    resolve_device,
    set_random_seed,
)
from sota_imagenet_tpu_torch.utils.weights import apply_sigmoid_trick, flax_ranks, unit_dims


def find_auto_resume(log_dir: str, exp_name: str) -> Optional[str]:
    """Newest checkpoint for this experiment, for preemption recovery."""
    cands = sorted(glob.glob(os.path.join(log_dir, f"*_{exp_name}", "*", "model*.ckpt")), key=os.path.getmtime)
    return cands[-1] if cands else None


def build_model(cfg):
    """Instantiate ``cfg.model`` with the two keys the CLI derives for it. A
    model that does not take one (CModel sizes its head and sets its norm
    kwargs in the layer list; NFNet has no norm) is built without it, as in
    the JAX CLI (cli.py:156-178). Only the TypeError that names the derived
    key drops it: any other error of a constructor is raised."""
    model_cfg = dict(cfg.model)
    derived = {}
    divisor = max(int(cfg.loader.get("classes_divisor", 1) or 1), 1)
    if divisor > 1 and "num_classes" not in model_cfg:
        # legacy classes_divisor: the classifier width follows the merged label space
        derived["num_classes"] = -(-int(cfg.loader.num_classes) // divisor)
    if cfg.bn_momentum != 0.1 and "bn_momentum" not in model_cfg:
        derived["bn_momentum"] = cfg.bn_momentum  # patch_bn_mom equivalent (reference train.py:76)
    while True:
        try:
            return instantiate({**model_cfg, **derived})
        except TypeError as e:
            key = next((k for k in derived if f"unexpected keyword argument '{k}'" in str(e)), None)
            if key is None:
                raise
            if key == "num_classes":
                get_logger().warning(
                    f"classes_divisor={divisor}: model does not take num_classes; size the head in the config"
                )
            del derived[key]


def optimizer_factory(cfg, model):
    """The trainer's optimizer factory (the Runner's ``optimizer_factory``,
    called on the model it trains): the config's optimizer over a model's
    parameters. Weight decay applies to EVERY parameter unless
    ``filter_from_wd`` is set (cli.py:199-202 of the JAX package; the mask
    read off ``model``); the unit-wise optimizers, AdamP and SGDP take each
    parameter's units and rank from the weights plan; ``mesh.zero1`` keeps
    each rank's share of the state (cli.py:285-290 of the JAX package);
    ``run.skip_nonfinite`` wraps it all in ``ApplyIfFinite``."""
    mask = filter_from_weight_decay(model.named_parameters(), cfg.filter_from_wd) if cfg.filter_from_wd is not None else None
    layout = needs_layout(cfg.optim)

    def make_optimizer(m):
        units = {"unit_dim": unit_dims(m), "flax_rank": flax_ranks(m)} if layout else {}

        def build(named):
            return build_optimizer(dict(cfg.optim), named, wd_mask=mask, **units)

        opt = Zero1(build, m.named_parameters()) if cfg.mesh.zero1 else build(m.named_parameters())
        # AMP-skip parity (cli.py:241-246 of the JAX package): drop non-finite updates, over the whole gradient
        return ApplyIfFinite(opt, int(cfg.run.skip_nonfinite)) if cfg.run.skip_nonfinite else opt

    return make_optimizer


def parametrized_model(cfg, model):
    """``model`` wrapped in every forward parametrization the trainer runs it
    through: ``weight_standardization`` (conv_to_ws_conv, reference
    train.py:66-67), then each callback's ``parametrization`` (the Runner's
    wrap, loop.py:141-149 of the JAX package), in the config's order."""
    if cfg.weight_standardization:
        model = ParametrizedModel(model, weight_standardization_fn(cfg.init_gamma))
    for clb_cfg in cfg.run.extra_callbacks or []:
        fn = instantiate(clb_cfg).step_options().get("parametrization")
        if fn is not None:
            model = ParametrizedModel(model, fn)
    return model


def _git_snapshot(run_dir: str) -> None:
    """Reproducibility artifacts (reference train.py:32-36); best effort."""
    for fname, cmd in (("commit_hash.txt", ["git", "rev-parse", "--short", "HEAD"]), ("diff.txt", ["git", "diff"])):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        with open(os.path.join(run_dir, fname), "w") as f:
            f.write(out)


def main(argv=None, *, device=None, callbacks: Iterable[Callback] = ()):
    """Train (or evaluate) as the config says; returns the final val metrics.

    ``device``: None runs on this rank's card (raising if no GPU is
    present), or where ``--device`` says; tests pass ``"cpu"``. ``callbacks`` are appended to the default host callbacks
    (Timer, ConsoleLogger, CheckpointSaver), for tools that observe a run."""
    parser = argparse.ArgumentParser(description="sota_imagenet_tpu_torch trainer")
    parser.add_argument("--config", "-c", default=None, help="experiment YAML")
    parser.add_argument("--device", default=None, help="cpu to run on the CPU (default: this rank's card)")
    parser.add_argument("overrides", nargs="*", help="dotted overrides key=value")
    args = parser.parse_args(argv)
    device = args.device if device is None else device
    # the process group first (cli.py:73-74 of the JAX package): the device and everything built depend on the rank
    backend = par.init_distributed(device)
    device = resolve_device(device)

    start_time = time.time()
    cfg = C.load(args.config, overrides=args.overrides, strict_env=False)
    # the mesh of the JAX CLI (cli.py:132), its shape errors included (a data axis alone names the ranks it
    # does not match); rank 0 of the world logs and writes
    if cfg.mesh.spatial == cfg.mesh.model == 1:
        par.data_axis(cfg.mesh.data, process_count())
    mesh = par.create_mesh(data=cfg.mesh.data, model=cfg.mesh.model, spatial=cfg.mesh.spatial)
    data = mesh.shape["data"]
    is_master = process_index() == 0

    # run dir: logs/<date>_<exp>/<time> (reference configs/base.yaml:13-15), rank 0's on every rank
    run_dir = par.broadcast_object(
        os.path.join(cfg.log.dir, time.strftime("%Y-%m-%d") + "_" + cfg.log.exp_name, time.strftime("%H-%M-%S"))
    )
    if is_master:
        os.makedirs(run_dir, exist_ok=True)
        _git_snapshot(run_dir)
        with open(os.path.join(run_dir, "config.yaml"), "w") as f:
            f.write(C.to_yaml(cfg))
    log = setup_logger(os.path.join(run_dir, "logs.txt") if is_master else None, is_master)
    log.info(C.to_yaml(cfg))
    if device.type == "cuda":
        # float32 matmuls and convs in full float32 (the JAX reference's
        # numerics); bf16 runs are unaffected. cuDNN picks its fastest
        # algorithms for the fixed shapes of a run.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        log.info(f"PyTorch {torch.__version__} | device: {device} ({torch.cuda.get_device_name(device)})")
    else:
        log.info(f"PyTorch {torch.__version__} | device: {device}")
    if backend is not None:
        log.info(f"Data parallel: {data} ranks over {backend}")
    if mesh.shape["spatial"] > 1:
        # every stage's image size keeps >= 2 deepest-feature rows per spatial rank (cli.py:137-143, :188-195)
        validate_spatial_extent(mesh, cfg.loader.image_size)
        for st in parse_stages(cfg.run.stages):
            if (st.extra_args or {}).get("image_size"):
                validate_spatial_extent(mesh, st.extra_args["image_size"])
        log.info(f"Spatial partitioning: image H sharded over {mesh.shape['spatial']} devices")
    # the BatchNorm statistics view (cli.py:148-153 of the JAX package), before the model is built
    bn_groups = resolve_bn_stats(cfg.run.bn_stats, data)
    set_bn_stats_groups(bn_groups)
    if bn_groups > 1:
        log.info(f"BatchNorm statistics: {bn_groups} groups (run.bn_stats={cfg.run.bn_stats})")
    if cfg.debug_nans:
        # the counterpart of jax_debug_nans (cli.py:123-124 of the JAX package): the Runner's guard
        log.info("debug_nans: the first NaN of a forward, a backward or the new parameters raises")
    seed = cfg.random_seed if cfg.random_seed is not None else 0
    if cfg.random_seed is not None:
        set_random_seed(cfg.random_seed)
    input_dtype = torch.bfloat16 if cfg.run.bf16 else torch.float32

    log.info("Loading model")
    model = build_model(cfg)
    if cfg.weight_standardization:
        # conv_to_ws_conv (reference train.py:66-67; cli.py:179-184 of the JAX package): a forward
        # WS parametrization over every ungrouped conv kernel
        model = ParametrizedModel(model, weight_standardization_fn(cfg.init_gamma))
    if cfg.log.print_model:
        log.info(str(model))
    criterion = instantiate(cfg.criterion)
    lr_phases = phases_from_stages(parse_stages(cfg.run.stages))
    log.info(f"Learning rate stages: {lr_phases}")
    make_optimizer = optimizer_factory(cfg, model)
    # the TensorBoard sinks (cli.py:205-212 of the JAX package): scalars every 50 steps, and with
    # log.histogram the weights' histograms every epoch; the config's callbacks may add more
    sinks = [TensorBoard(run_dir, log_every=50)] if cfg.log.tensorboard else []
    if cfg.log.histogram:
        sinks.append(WeightDistributionTB())
    runner = Runner(
        model,
        criterion,
        make_optimizer,
        lr_phases=lr_phases,
        callbacks=[
            Timer(),
            ConsoleLogger(),
            CheckpointSaver(run_dir, save_name="model.ckpt", include_optimizer=cfg.log.save_optim),
            *sinks,
            *(instantiate(clb_cfg) for clb_cfg in cfg.run.extra_callbacks or []),
            *callbacks,
        ],
        accumulate_steps=cfg.run.accumulate_steps,
        ema_decay=cfg.run.ema_decay,
        remat=cfg.run.remat,
        input_dtype=input_dtype,
        device=device,
        debug_nans=cfg.debug_nans,
        tp_params=cfg.mesh.tp_params,
    )
    runner.init_state(seed=seed)
    if cfg.get("sigmoid_trick", False):
        # the focal prior's classifier bias (cli.py:225-236 of the JAX package), the EMA copy's too
        divisor = max(int(cfg.loader.get("classes_divisor", 1) or 1), 1)
        apply_sigmoid_trick(runner.state.model, num_classes=-(-int(cfg.loader.num_classes) // divisor))
        if runner.state.ema is not None:
            runner.state.ema.load_state_dict(runner.state.model.state_dict())
        log.info("sigmoid_trick: classifier bias initialized to -log(C-1)")
    log.info(f"Model params: {count_parameters(runner.state.model) / 1e6:.2f}M")
    if cfg.mesh.zero1:
        log.info(f"ZeRO-1: optimizer state sharded over {data} data-parallel ranks")
    if mesh.shape["model"] > 1:
        log.info(f"Head TP: matching params class-sharded over {mesh.shape['model']} devices")

    start_epoch = cfg.run.start_epoch
    if cfg.run.auto_resume and not cfg.run.resume:
        found = find_auto_resume(cfg.log.dir, cfg.log.exp_name)
        if found:
            cfg.run.resume = found
            log.info(f"auto_resume: found {cfg.run.resume}")
    if cfg.run.resume:
        runner.state, ckpt_epoch = load_checkpoint(cfg.run.resume, runner.state)
        log.info(f"Loaded checkpoint from {cfg.run.resume}")
        if cfg.run.load_start_epoch:
            start_epoch = ckpt_epoch

    data_manager = DataManager(cfg, device=device, seed=seed + 777, out_dtype=input_dtype)

    if cfg.run.evaluate:
        data_manager.set_stage(0)
        # debug caps the val pass at 20 steps here too, so an eval of a debug
        # run's checkpoint reproduces that run's final val metrics
        metrics = runner.evaluate(data_manager.val_loader, steps=20 if cfg.debug else None)
        log.info(f"Eval: {metrics}")
        runner.close()
        return metrics

    for idx in range(len(data_manager)):
        data_manager.set_stage(idx)
        if data_manager.end_epoch <= start_epoch:
            continue
        runner.fit(
            data_manager.loader,
            data_manager.val_loader,
            epochs=data_manager.end_epoch,
            start_epoch=max(data_manager.start_epoch, start_epoch),
            steps_per_epoch=10 if cfg.debug else None,
            val_steps=20 if cfg.debug else None,
        )

    vm = runner.val_metrics
    if vm:
        log.info(f"Acc@1 {vm.get('Acc@1', 0):.3f} Acc@5 {vm.get('Acc@5', 0):.3f}")
    m = (time.time() - start_time) / 60
    log.info(f"Total time: {int(m / 60)}h {m % 60:.1f}m")
    save_checkpoint(run_dir, runner.state, data_manager.tot_epochs, name="model_last.ckpt", block=True)
    runner.close()
    return vm


def export_main(argv=None):
    """Trained checkpoint -> serving artifact (port of ``sota_imagenet_tpu/cli.py``
    :337-408; see ``utils/export.py`` for the artifact). The model is built
    as the trainer builds it (``build_model``: ``loader.classes_divisor``'s
    head too) and wrapped in every forward parametrization the trainer uses,
    since the checkpoint holds the raw kernels: a WS or spectral run exported
    without them would serve un-normalized kernels. ``--ema`` exports the
    EMA's weights and buffers where the checkpoint holds them. The image size
    is the final stage's; the input dtype follows ``run.bf16``. It loads the
    checkpoint on the card unless ``--device cpu``; the trace itself runs on
    the CPU (``export_inference``). The config is the run's: its YAML and
    the dotted overrides it was trained with, or the run dir's
    ``config.yaml``."""
    parser = argparse.ArgumentParser(description="sota_imagenet_tpu_torch exporter")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("--ckpt", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--ema", action="store_true", help="export the EMA weights")
    parser.add_argument("--batch", default="poly", help="fixed batch size or 'poly' (symbolic)")
    parser.add_argument("--image-size", type=int, default=None)
    parser.add_argument(
        "--quantize",
        choices=["int8"],
        default=None,
        help="per-output-channel int8 weight quantization (~3-4x smaller artifact vs fp32)",
    )
    parser.add_argument("--device", default=None, help="cpu to load the checkpoint on the CPU (default: the card)")
    parser.add_argument("overrides", nargs="*", help="the run's dotted overrides key=value")
    args = parser.parse_args(argv)

    from sota_imagenet_tpu_torch.train import steps as steps_lib
    from sota_imagenet_tpu_torch.utils.export import export_inference, resolve_final_image_size

    device = resolve_device(args.device)
    cfg = C.load(args.config, overrides=args.overrides, strict_env=False)
    model = build_model(cfg)
    make_optimizer = optimizer_factory(cfg, model)
    model = parametrized_model(cfg, model)
    size = args.image_size or resolve_final_image_size(cfg)
    input_dtype = torch.bfloat16 if cfg.run.bf16 else torch.float32
    state = steps_lib.init_state(
        model, make_optimizer, device=device, ema_decay=cfg.run.ema_decay, criterion=instantiate(cfg.criterion)
    )
    state, epoch = load_checkpoint(args.ckpt, state)
    served = state.ema if (args.ema and state.ema is not None) else state.model
    bs = None if args.batch == "poly" else int(args.batch)
    out = export_inference(served, args.out, image_size=size, batch_size=bs, input_dtype=input_dtype,
                           quantize=args.quantize)
    print(
        f"exported epoch-{epoch} weights -> {out} (batch={'symbolic' if bs is None else bs}, size={size}"
        + (f", quantize={args.quantize}" if args.quantize else "")
        + ")"
    )
    return out


def records_main(argv=None):
    """Dataset prep (port of ``sota_imagenet_tpu/cli.py:411-460``, the JAX
    package's ``sota-records``). Subcommands:

      records packed   <data_dir> [--out DIR] [--size 224] [--workers N]
                       [--crops-per-image K] [--val-full-crop]
      records resize   <data_dir> [--size 512] [--workers N]
      records tfrecord <data_dir> [--out DIR] [--workers N]
    """
    parser = argparse.ArgumentParser(description="sota_imagenet_tpu_torch dataset prep")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("tfrecord", help="ImageFolder tree -> sharded TFRecords (+DALI-style .idx)")
    p.add_argument("data_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--workers", type=int, default=os.cpu_count())

    p = sub.add_parser("packed", help="ImageFolder tree -> decode-free packed uint8 records")
    p.add_argument("data_dir")
    p.add_argument("--out", default=None)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--workers", type=int, default=os.cpu_count())
    p.add_argument("--crops-per-image", type=int, default=1)
    p.add_argument("--val-full-crop", action="store_true")

    p = sub.add_parser("resize", help="pre-resize an ImageFolder tree (reference resize_imagenet.py)")
    p.add_argument("data_dir")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--workers", type=int, default=os.cpu_count())

    args = parser.parse_args(argv)
    if args.cmd == "tfrecord":
        from sota_imagenet_tpu_torch.data.records import create_records

        return create_records(args.data_dir, out_dir=args.out, workers=args.workers)
    if args.cmd == "resize":
        from sota_imagenet_tpu_torch.data.resize_tool import main as resize_tool_main

        return resize_tool_main([args.data_dir, "--size", str(args.size), "--workers", str(args.workers)])
    from sota_imagenet_tpu_torch.data.packed import create_packed_records

    create_packed_records(
        args.data_dir,
        out_dir=args.out,
        image_size=args.size,
        workers=args.workers,
        crops_per_image=args.crops_per_image,
        full_crop=args.val_full_crop,
    )


def train_script() -> int:
    """The ``sota-train-torch`` console script: ``main`` on the command line.
    A console script exits with what its function returns, and ``sys.exit``
    of a non-zero value, such as ``main``'s val metrics, gives status 1: so
    it returns 0 once ``main`` has returned."""
    main()
    return 0


def export_script() -> int:
    """The ``sota-export-torch`` console script: ``export_main``, then 0 (see ``train_script``)."""
    export_main()
    return 0


def records_script() -> int:
    """The ``sota-records-torch`` console script: ``records_main``, then 0 (see ``train_script``)."""
    records_main()
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["records"]:
        records_main(sys.argv[2:])
    elif sys.argv[1:2] == ["export"]:
        export_main(sys.argv[2:])
    else:
        main()
