"""What the data-parallel tests run on each spawned rank (tests/test_torch_dist.py,
tests/test_torch_ddp_cli.py). A rank imports torch and
sota_imagenet_tpu_torch only, never JAX, so this module does not either; the
tests hold what comes back against one process and the JAX package. It
holds no test of its own."""

from __future__ import annotations

import numpy as np
import torch

from sota_imagenet_tpu_torch.models.norms import BatchNorm
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.utils.misc import process_count, process_index


def _rows(x: np.ndarray) -> np.ndarray:
    """This rank's rows of a global array."""
    b = x.shape[0] // process_count()
    return x[process_index() * b : (process_index() + 1) * b]


def collectives(x: np.ndarray) -> dict:
    """Each collective of parallel/mesh.py on this rank's rows of the global
    float64 ``x`` (B, C): the differentiable sum and its gradient, the
    gather, the mirror, the microbatch rows (2 parts) and the mean."""
    local = torch.from_numpy(_rows(x)).requires_grad_(True)
    total = par.all_reduce_sum(local.sum(0) * (process_index() + 1.0))
    # the loss of this rank: d/d local = (rank + 1) * sum over ranks of the cotangent (rank' + 1) ... see the test
    (total * torch.arange(1.0, total.shape[0] + 1, dtype=total.dtype)).sum().backward()
    mean = torch.from_numpy(_rows(x)).clone()
    par.average_([mean])
    ints = torch.arange(4, dtype=torch.int64) + 10 * process_index()
    return {
        "sum": total.detach().numpy(),
        "grad": local.grad.numpy(),
        "gather": par.gather_rows(torch.from_numpy(_rows(x))).numpy(),
        "gather_int": par.gather_rows(ints).numpy(),
        "gather_bool": par.gather_rows(ints % 3 == 0).numpy(),
        "mirror": par.mirror(torch.from_numpy(_rows(x))).numpy(),
        "microbatch": par.microbatch_rows(torch.from_numpy(_rows(x)), 2).numpy(),
        "mean": mean.numpy(),
        "global_mean": par.global_mean(torch.from_numpy(_rows(x)), 0).numpy(),
    }


def batchnorm(x: np.ndarray, groups: int, cotangent: np.ndarray) -> dict:
    """A train-mode BatchNorm over this rank's rows of the global NCHW
    float64 ``x`` with ``groups`` statistics groups: its output, the
    gradients of sum(y * cotangent) (x's rows, and weight and bias summed
    over the ranks, as the step's gradient mean times the ranks) and the
    running buffers."""
    bn = BatchNorm(x.shape[1], stats_groups=groups).double()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1], dtype=torch.float64))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, x.shape[1], dtype=torch.float64))
    xr = torch.from_numpy(_rows(x)).requires_grad_(True)
    y = bn(xr)
    (y * torch.from_numpy(_rows(cotangent))).sum().backward()
    grads = [bn.weight.grad.clone(), bn.bias.grad.clone()]
    for g in grads:
        par.all_reduce_(g, "test")
    return {
        "y": y.detach().numpy(),
        "dx": xr.grad.numpy(),
        "dweight": grads[0].numpy(),
        "dbias": grads[1].numpy(),
        "running_mean": bn.running_mean.numpy(),
        "running_var": bn.running_var.numpy(),
    }


def checks(x: np.ndarray, bn_x: np.ndarray, bn_cot: np.ndarray, bn_groups) -> dict:
    """The collectives and a BatchNorm for each of ``bn_groups``, in one spawn."""
    return {"collectives": collectives(x), "bn": {g: batchnorm(bn_x, g, bn_cot) for g in bn_groups}}


def cli_train_eval(config: str, overrides: list, log_dir: str) -> dict:
    """On this rank: ``cli.main`` trains as the config says; then an eval
    resumed from its ``model_last.ckpt``; then the same config with
    ``mesh.data=3``, which must raise. Returns each part's result."""
    import glob
    import os

    from sota_imagenet_tpu_torch.tools.ranks import cli_rank

    argv = ["-c", config, *overrides, f"log.dir={log_dir}"]
    train = cli_rank(argv)
    ckpts = sorted(glob.glob(os.path.join(log_dir, "*", "*", "model_last.ckpt")))
    evaluated = cli_rank([*argv, "run.evaluate=true", f"run.resume={ckpts[0]}"])
    try:
        cli_rank([*argv, "mesh.data=3"])
        bad = None
    except ValueError as e:
        bad = str(e)
    return {"train": train, "eval": evaluated, "ckpts": ckpts, "bad": bad,
            "files": sorted(os.path.relpath(f, log_dir) for f in glob.glob(os.path.join(log_dir, "*", "*", "*")))}


def tfrecord_batches(root: str, is_train: bool, batch_size: int, image_size: int, device_resample: bool) -> list:
    """Two epochs of this rank's ``TFRecordLoader`` batches (``batch_size`` is the global batch)."""
    from sota_imagenet_tpu_torch.data.pipeline import TFRecordLoader

    loader = TFRecordLoader(root, is_train=is_train, batch_size=batch_size // process_count(), image_size=image_size,
                            workers=2, random_interpolation=True, drop_last=is_train, device_resample=device_resample)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out.append([tuple(np.asarray(a) for a in b) for b in loader])
    return out
