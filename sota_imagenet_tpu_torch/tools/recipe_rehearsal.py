"""A compressed full-recipe accuracy rehearsal on the card (port of
``scripts/tpu_recipe_rehearsal.py``).

Runs a recipe's exact shape (r50_baseline: warmup 0.001 -> 1.0 over 8/90 of
training, then cosine to 0, SGD momentum 0.9, wd 3e-5, label smoothing 0.1,
bf16, no EMA; the eca_nfnet_l0/AdamW recipe; or the norm-free CModel with
LAMB, OrthoInit and OrthoLoss of 41.nf_conv-act_lamb.yaml) through the port's
``cli.main`` on a generated 100-class corpus (texture x hue, 200 train and
25 val images a class, 160 px JPEGs) for 30-36 epochs, and holds the val
curve to ``check_curve``: it must rise to a plateau >= ``--threshold`` and
stay there.

With ``--override loader.use_packed=true`` (or ``loader.backend=packed``;
the same for ``val_loader``) the corpus is first packed by
``data/packed.create_packed_records`` (train at the loader's image size, val
at the val loader's), that loader's backend is set to ``packed`` (the
rehearsal configs name ``backend: folder``, which ``use_packed`` alone does
not override) and the run reads the packed tree; add
``loader.device_cache=true`` (and the val_loader pair) for the decode-free
A/B that the JAX package ran with its script.

Usage: python -m sota_imagenet_tpu_torch.tools.recipe_rehearsal [--recipe r50_baseline|nfnet|nf_lamb]
       [--epochs N] [--data DIR] [--override k=v ...] [--keep]
Prints one JSON line with the val curve; exits 0 iff the curve passes.
"""

from __future__ import annotations

import argparse
import colorsys
import json
import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np

from sota_imagenet_tpu_torch.tools.accuracy_proof import CONFIGS, ValCurve, run_cli

N_HUES = 20
N_TEX = 5
N_CLASSES = N_HUES * N_TEX
TRAIN_PER_CLASS = 200
VAL_PER_CLASS = 25
SRC_SIZE = 160


def _make_image(rng: np.random.Generator, cls: int) -> np.ndarray:
    """Class = (texture, hue), each invariant to the recipe's augmentations
    (the crop rescales frequency but keeps orientation; mirror keeps the
    stripe orientations; the hues are 18 degrees apart)."""
    tex, hue_i = cls % N_TEX, cls // N_TEX
    r, g, b = colorsys.hsv_to_rgb(hue_i / N_HUES, 0.85, 0.8)
    base = np.array([r, g, b]) * 255.0
    f = 2 * np.pi * rng.uniform(5, 8)  # cycles vary; frequency is not a label
    ph1, ph2 = rng.uniform(0, 2 * np.pi, 2)
    t = np.linspace(0, 1, SRC_SIZE)
    yy, xx = t[:, None], t[None, :]
    if tex == 0:  # horizontal stripes
        field = np.sin(f * yy + ph1) * np.ones_like(xx)
    elif tex == 1:  # vertical stripes
        field = np.sin(f * xx + ph1) * np.ones_like(yy)
    elif tex == 2:  # checkerboard (product grating)
        field = np.sin(f * yy + ph1) * np.sin(f * xx + ph2)
    elif tex == 3:  # isotropic blobs: block-upsampled low-pass noise
        k = 10
        up = (SRC_SIZE + k - 1) // k
        coarse = rng.normal(0, 1, (k, k))
        field = np.kron(coarse, np.ones((up, up)))[:SRC_SIZE, :SRC_SIZE]
        field = field / (np.abs(field).max() + 1e-6)
    else:  # flat (no texture)
        field = np.zeros((SRC_SIZE, SRC_SIZE))
    img = base[None, None, :] * (0.65 + 0.35 * field)[..., None]
    img = img + rng.normal(0, 10, (SRC_SIZE, SRC_SIZE, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _gen_class_dir(task) -> None:
    from PIL import Image

    d, cls, n, seed = task
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(_make_image(rng, cls)).save(os.path.join(d, f"{i}.jpg"), "JPEG", quality=92)


def generate_corpus(root: str, workers: int = 4) -> None:
    """root/{train,val}/class_<c>/<i>.jpg; each class dir from its own seed,
    zlib.crc32 of "<split>/<class>" (stable across interpreters), written by a
    pool of ``workers`` spawned processes."""
    tasks = []
    for split, n in (("train", TRAIN_PER_CLASS), ("val", VAL_PER_CLASS)):
        for cls in range(N_CLASSES):
            d = os.path.join(root, split, f"class_{cls:03d}")
            os.makedirs(d, exist_ok=True)
            tasks.append((d, cls, n, zlib.crc32(f"{split}/{cls}".encode())))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        pool.map(_gen_class_dir, tasks)


def check_curve(accs, threshold: float, tol: float = 2.0, collapse: float = 15.0):
    """Rises to a plateau and stays there. Fails when the final quarter's
    mean misses ``threshold``, when a tail epoch falls more than ``tol``
    points below the running best (a late regression), or when any epoch
    falls more than ``collapse`` below it (divergence). Earlier dips are
    recorded in ``dips`` and do not fail the run."""
    best = 0.0
    dips = []
    collapsed = False
    late_ok = True
    tail_start = len(accs) - max(len(accs) // 4, 1)
    for i, a in enumerate(accs):
        if a < best - tol:
            dips.append((i, a, best))
            if i >= tail_start:
                late_ok = False
        if a < best - collapse:
            collapsed = True
        best = max(best, a)
    tail = accs[tail_start:]
    plateau = float(np.mean(tail))
    return bool(tail) and plateau >= threshold and late_ok and not collapsed, plateau, dips


# Recipe shapes: config, warmup fraction of the epochs (0 = pure cosine),
# warmup and cosine lr endpoints, default epochs, provenance.
RECIPES = {
    "r50_baseline": dict(
        config="tpu_rehearsal.yaml",
        warm_frac=8 / 90,
        warm_lr=(0.001, 1.0),
        cos_lr=(1.0, 0.0),
        epochs=30,
        desc=(
            "r50_baseline shape (warmup 8/90 -> cosine, sgd m0.9 wd3e-5, "
            "smooth 0.1, bf16, no EMA — faithful to 1.r50_baseline.yaml)"
        ),
    ),
    "nfnet": dict(
        config="tpu_rehearsal_nfnet.yaml",
        warm_frac=5 / 360,
        # batch-scaled 0.01 -> 0.0025: the reference ran at effective batch
        # 1024, 256 here (scripts/tpu_recipe_rehearsal.py:157-166)
        warm_lr=(0.0, 0.0025),
        cos_lr=(0.0025, 0.0),
        epochs=36,
        desc=(
            "eca_nfnet_l0 shape (warmup 5/360 -> cosine, adamw wd1e-3, "
            "smooth 0.1, heavy aug + random interp, CutmixMixup p1, "
            "EMA eval w/ compression-scaled decay, accumulate 2, peak lr "
            "batch-scaled 1024->256 — faithful to 15.eca_nfnet_l0.yaml)"
        ),
    ),
    "nf_lamb": dict(
        config="tpu_rehearsal_nf_lamb.yaml",
        warm_frac=0.0,
        warm_lr=None,
        # the reference's own lr for LAMB (41.nf_conv-act_lamb.yaml:3,100-101): LAMB's
        # trust ratio makes lr the per-layer relative step size, so it is not batch-rescaled
        cos_lr=(0.001, 0.0),
        epochs=30,
        desc=(
            "nf_conv-act CModel + LAMB shape (pure cosine 0.001->0, badam "
            "lamb wd5e-3, smooth 0.1, heavy aug, CutmixMixup p1 + "
            "OrthoInit/OrthoLoss — faithful to 41.nf_conv-act_lamb.yaml)"
        ),
    ),
}


def stages_override(recipe: dict, epochs: int) -> str:
    if recipe["warm_frac"] > 0:
        warm = max(1, round(epochs * recipe["warm_frac"]))
        w0, w1 = recipe["warm_lr"]
        c0, c1 = recipe["cos_lr"]
        return (
            f"run.stages=[{{start: 0, end: {warm}, lr: [{w0}, {w1}]}}, "
            f"{{start: {warm}, end: {epochs}, lr: [{c0}, {c1}], lr_mode: cos}}]"
        )
    c0, c1 = recipe["cos_lr"]
    return f"run.stages=[{{start: 0, end: {epochs}, lr: [{c0}, {c1}], lr_mode: cos}}]"


def pack_corpus(data: str, out: str, config: str, overrides, workers: int) -> dict:
    """Packed records of the corpus at the run's sizes: train at
    loader.image_size, val at the size the val loader will ask for."""
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.data.packed import create_packed_records

    cfg = C.load(config, overrides=list(overrides), strict_env=False)
    train_size = int(cfg.loader.image_size)
    val_size = train_size if cfg.val_loader.get("follow_train_size", True) else int(cfg.val_loader.image_size)
    t0 = time.perf_counter()
    create_packed_records(data, out, image_size=train_size, workers=workers, splits=("train",))
    create_packed_records(data, out, image_size=val_size, workers=workers, splits=("val",))
    return {"train_size": train_size, "val_size": val_size, "pack_s": time.perf_counter() - t0}


def main(argv=None, *, device=None) -> dict:
    ap = argparse.ArgumentParser(description="compressed full-recipe accuracy rehearsal of the port")
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="r50_baseline")
    ap.add_argument("--epochs", type=int, default=None, help="default: per recipe")
    ap.add_argument("--threshold", type=float, default=95.0)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--data", default=None, help="reuse an existing corpus dir")
    ap.add_argument(
        "--override",
        action="append",
        default=[],
        help="extra cli overrides (e.g. loader.use_packed=true loader.device_cache=true): the decode-free A/B",
    )
    args = ap.parse_args(argv)
    recipe = RECIPES[args.recipe]
    epochs = args.epochs or recipe["epochs"]
    config = os.path.join(CONFIGS, recipe["config"])

    work = tempfile.mkdtemp(prefix="port_rehearsal_")
    timing = {}
    data = args.data
    if data is None:
        data = os.path.join(work, "data")
        print(f"generating {N_CLASSES}x{TRAIN_PER_CLASS}+{VAL_PER_CLASS} corpus -> {data}", flush=True)
        t0 = time.perf_counter()
        generate_corpus(data)
        timing["corpus_s"] = time.perf_counter() - t0
    overrides = [f"log.dir={work}/logs", stages_override(recipe, epochs), *args.override]
    asked = {o.replace(" ", "") for o in args.override}
    to_pack = [s for s in ("loader", "val_loader") if {f"{s}.use_packed=true", f"{s}.backend=packed"} & asked]
    overrides += [f"{s}.backend=packed" for s in to_pack]
    packed = None
    if to_pack:
        packed = os.path.join(work, "packed")
        timing.update(pack_corpus(data, packed, config, overrides, workers=os.cpu_count() or 1))
    print(f"cli.main -c {config} {' '.join(overrides)}", flush=True)
    curve = ValCurve()
    t0 = time.perf_counter()
    run_cli(config, packed or data, overrides, device=device, callbacks=[curve])
    timing["train_s"] = time.perf_counter() - t0
    accs = curve.curve
    ok_curve, plateau, dips = check_curve(accs, args.threshold) if accs else (False, 0.0, [])
    result = {
        "recipe": recipe["desc"],
        "overrides": args.override,
        "classes": N_CLASSES,
        "epochs": epochs,
        "val_curve": accs,
        "plateau_acc1": plateau,
        "best_acc1": max(accs, default=0.0),
        "final_acc1_raw_weights": curve.raw_acc1,
        "dips": dips,
        **timing,
        "ok": ok_curve and len(accs) == epochs,
    }
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        print(f"work dir kept: {work}", file=sys.stderr)
    elif not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
