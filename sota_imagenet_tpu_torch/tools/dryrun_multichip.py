"""The data-parallel gate on the CPU (the port's ``__graft_entry__.dryrun_multichip``):
N gloo ranks train a truncated Bottleneck ResNet in float64 and must equal
one process that replays the same global batches.

    python -m sota_imagenet_tpu_torch.tools.dryrun_multichip 4

The model is the JAX gate's: ``resnet50`` cut to ``layers=(1, 1)``, 64 px,
100 classes. Each step runs the whole train step with everything that
crosses ranks on: sync-BN, CutmixMixup (pre-drawn values; the partner of
global row i is global row B-1-i), EMA 0.999, SGD with momentum under
ZeRO-1, unit-wise SAM and ``accumulate_steps=2``, on a global batch of 4
rows a rank. A second leg takes the same steps with ``run.bn_stats=local``.
Each leg prints its timestamps and the worst relative difference of its
leaves from the replay (the change of each tensor over the steps, its
denominator floored at 1e-6 of the whole state's change, as the JAX gate
does), and fails above 1e-6; the ranks must hold the same weights bit for
bit. Exit status 0 when every leg holds.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from sota_imagenet_tpu_torch.tools.ranks import run_ranks, train_steps

SIZE, PER_RANK, STEPS, TOL = 64, 4, 2, 1e-6


def truncated_resnet():
    """The JAX gate's model: a Bottleneck ResNet of two one-block stages, 100 classes."""
    from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet

    return ResNet(block=Bottleneck, layers=(1, 1), num_classes=100)


def spec(world: int, bn_stats: int, per_rank: int = PER_RANK, steps: int = STEPS) -> dict:
    """The gate's steps for ``world`` ranks: the model's seeded weights, the batches and the pre-drawn mixup values."""
    model = truncated_resnet()
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = per_rank * world
    batches = [(rng.uniform(-2.0, 2.0, (batch, SIZE, SIZE, 3)), np.eye(100)[rng.integers(0, 100, batch)])
               for _ in range(steps)]
    draws = [{"apply": np.bool_(True), "use_cutmix": np.bool_(i % 2 == 0), "lam_m": np.float32(rng.beta(0.2, 0.2)),
              "lam_c": np.float32(rng.beta(1.0, 1.0)), "cy": np.int64(rng.integers(SIZE)),
              "cx": np.int64(rng.integers(SIZE))} for i in range(steps)]
    return {
        "model": truncated_resnet, "init": {k: v.numpy().copy() for k, v in model.state_dict().items()}, "dtype": "float64",
        "optim": {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}, "zero1": True, "lr": 0.05,
        "criterion": {"_target_": "CrossEntropyLoss", "smoothing": 0.1}, "accumulate_steps": 2, "ema_decay": 0.999,
        "sam": {"kind": "asam_unitwise", "rho": 0.05, "eta": 0.01, "bn_from_perturbed": True},
        "bn_stats": bn_stats, "mixup": {"cutmix_alpha": 1.0, "mixup_alpha": 0.2, "draws": draws}, "batches": batches,
    }


def worst_leaf(got: dict, want: dict, init: dict):
    """(worst per-leaf relative difference of the change from ``init``, its leaf, the global one)."""
    keys = [k for k in init if init[k].dtype.kind == "f"]
    diff = {k: float(np.linalg.norm(got[k] - want[k])) for k in keys}
    delta = {k: float(np.linalg.norm(want[k] - init[k])) for k in keys}
    total = sum(d * d for d in delta.values()) ** 0.5
    rel = {k: diff[k] / max(delta[k], 1e-6 * total) for k in keys}
    worst = max(rel, key=rel.get)
    return rel[worst], worst, sum(d * d for d in diff.values()) ** 0.5 / max(total, 1e-300)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ranks", type=int, nargs="?", default=4)
    args = parser.parse_args(argv)
    t0 = time.monotonic()

    def log(msg: str) -> None:
        print(f"[dryrun_multichip +{time.monotonic() - t0:7.1f}s] {msg}", flush=True)

    ok = True
    for leg, groups in (("sync-BN", 1), ("bn_stats=local", args.ranks)):
        s = spec(args.ranks, groups)
        log(f"{leg}: {args.ranks} gloo ranks, float64, global batch {PER_RANK * args.ranks} @ {SIZE}px, "
            f"mixup + EMA + ZeRO-1 + SAM + accumulate_steps=2, {STEPS} steps...")
        with tempfile.TemporaryDirectory() as tmp:
            ranks = run_ranks(train_steps, args.ranks, (s,), tmp_dir=tmp)
        log(f"{leg}: ranks done; one-process replay...")
        one = train_steps(s)
        log(f"{leg}: replay done")
        same = all(np.array_equal(r["model"][k], ranks[0]["model"][k]) for r in ranks for k in r["model"])
        for what in ("model", "ema"):
            rel, leaf, glob = worst_leaf(ranks[0][what], one[what], s["init"])
            print(f"  {leg} {what}: worst leaf {leaf} rel {rel:.3e}, global rel {glob:.3e}", flush=True)
            ok &= rel < TOL and glob < TOL
        loss = [(a["loss"], b["loss"]) for a, b in zip(ranks[0]["metrics"], one["metrics"])]
        print(f"  {leg} loss by step (ranks, replay): {loss}; the ranks' weights equal bit for bit: {same}", flush=True)
        ok &= same
    log(f"dryrun_multichip {'OK' if ok else 'FAILED'}: {args.ranks} ranks == one-process replay (tolerance {TOL})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
