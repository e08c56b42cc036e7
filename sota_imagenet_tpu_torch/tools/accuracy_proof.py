"""The port learns, on the card, through the real data path, and the
artifact it exports serves what it learned (port of
``scripts/tpu_accuracy_proof.py``).

Writes a 20-class JPEG corpus from a seed (class = hue, or texture x hue:
factors that survive RandomResizedCrop, mirror and the colour twist), then
trains ResNet-50 on it with the port's ``cli.main`` and
``configs/tpu_accuracy.yaml`` (112 px, folder backend: host decode ->
DeviceFeed -> the fused_aug kernel -> bf16 train step with EMA 0.99 and a
cosine schedule) and holds the val accuracy to ``--threshold``. It catches
sign errors, schedule faults, EMA/eval wiring and input corruption that a
few finite steps cannot. Val Acc@1 is read each epoch from a callback (the
EMA weights, as the run validates); the raw weights are scored once at the
end too.

The serving closure (the JAX script's :138-200): the run's
``model_last.ckpt`` is exported with ``--ema`` on the CPU (``cli
export_main``, the run's own config.yaml), the artifact is loaded on the
card (``utils/export.load_exported``) and scores the val folder through
``decode_val`` in chunks of 100; ``ok`` also needs its Acc@1 within 2.0
points of the run's final val Acc@1 (same weights, same preprocessing: a
drift means the artifact serves something other than what was trained).

Usage: python -m sota_imagenet_tpu_torch.tools.accuracy_proof [--epochs 30] [--corpus hue|texture] [--keep]
Prints one JSON line: {"final_acc1", "best_acc1", "artifact_acc1", "curve", "ok", ...}; exits 0 iff ok.
"""

from __future__ import annotations

import argparse
import colorsys
import contextlib
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Iterable, List, Optional

import numpy as np

from sota_imagenet_tpu_torch.train.callbacks import Callback

N_CLASSES = 20
TRAIN_PER_CLASS = 100
VAL_PER_CLASS = 20
SRC_SIZE = 180
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")


def _make_image(rng: np.random.Generator, cls: int) -> np.ndarray:
    """Class = one of 20 hues (18 degrees apart) on a striped texture of
    random phase. Hue survives RandomResizedCrop, mirror and resampling; a
    stripe frequency would not (the crop rescales it)."""
    hue = cls / N_CLASSES
    r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 0.8)
    base = np.array([r, g, b]) * 255.0
    yy = np.linspace(0, 2 * np.pi * 6, SRC_SIZE)[:, None]
    stripes = 0.65 + 0.35 * np.sin(yy + rng.uniform(0, 2 * np.pi))  # phase-random
    img = base[None, None, :] * stripes[..., None]
    img = img + rng.normal(0, 15, (SRC_SIZE, SRC_SIZE, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _make_texture_image(rng: np.random.Generator, cls: int) -> np.ndarray:
    """Class = texture family x hue (5 x 4 = 20), so colour alone resolves
    only a fifth of the label. Stripe orientation, not frequency, is a
    factor (the crop rescales frequency; mirror keeps orientation); the four
    hues are 90 degrees apart, far outside the colour twist's +-20."""
    tex, hue_i = cls % 5, cls // 5
    r, g, b = colorsys.hsv_to_rgb(hue_i / 4.0, 0.8, 0.8)
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
    elif tex == 3:  # isotropic blobs: low-pass 2D noise
        k, up = 16, (SRC_SIZE + 15) // 16
        coarse = rng.normal(0, 1, (k, k))
        field = np.kron(coarse, np.ones((up, up)))[:SRC_SIZE, :SRC_SIZE]
        from scipy import ndimage

        field = ndimage.gaussian_filter(field, SRC_SIZE / 32)
        field = field / (np.abs(field).max() + 1e-6)
    else:  # flat (no texture)
        field = np.zeros((SRC_SIZE, SRC_SIZE))
    img = base[None, None, :] * (0.65 + 0.35 * field)[..., None]
    img = img + rng.normal(0, 10, (SRC_SIZE, SRC_SIZE, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_corpus(root: str, corpus: str = "hue") -> None:
    """root/{train,val}/class_<c>/<i>.jpg, JPEG quality 92, all from default_rng(0)."""
    from PIL import Image

    make = _make_texture_image if corpus == "texture" else _make_image
    rng = np.random.default_rng(0)
    for split, n in (("train", TRAIN_PER_CLASS), ("val", VAL_PER_CLASS)):
        for cls in range(N_CLASSES):
            d = os.path.join(root, split, f"class_{cls:03d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                Image.fromarray(make(rng, cls)).save(os.path.join(d, f"{i}.jpg"), "JPEG", quality=92)


class ValCurve(Callback):
    """Val Acc@1 of every epoch (what the run validates: the EMA weights when
    ema_decay > 0), and at the end the raw weights' val Acc@1 on the same
    loader."""

    def __init__(self):
        self.curve: List[float] = []
        self.raw_acc1: Optional[float] = None
        self._val_loader = None

    def on_begin(self):
        evaluate = self.runner.evaluate

        def capture(loader, *a, **kw):
            self._val_loader = loader
            return evaluate(loader, *a, **kw)

        self.runner.evaluate = capture

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        if val_metrics:
            self.curve.append(float(val_metrics["Acc@1"]))

    def on_end(self):
        if self._val_loader is not None:
            self.raw_acc1 = float(self.runner.evaluate(self._val_loader, use_ema=False, _internal=True)["Acc@1"])


@contextlib.contextmanager
def imagenet_dir(path: str):
    """IMAGENET_DIR set to ``path`` for the configs' ``${env:IMAGENET_DIR}``, then restored."""
    before = os.environ.get("IMAGENET_DIR")
    os.environ["IMAGENET_DIR"] = path
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("IMAGENET_DIR", None)
        else:
            os.environ["IMAGENET_DIR"] = before


def run_cli(config: str, data: str, overrides: Iterable[str], device=None, callbacks=()) -> dict:
    """The port's cli.main on ``config`` with IMAGENET_DIR at ``data``."""
    from sota_imagenet_tpu_torch import cli

    with imagenet_dir(data):
        return cli.main(["-c", config, *overrides], device=device, callbacks=list(callbacks))


def artifact_acc1(work: str, data: str, device=None) -> dict:
    """Export the run's last checkpoint (EMA weights) on the CPU, serve the
    val folder through the artifact on ``device`` and return its Acc@1 with
    the export's and the scoring's seconds."""
    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.data.decode import decode_val
    from sota_imagenet_tpu_torch.data.pipeline import scan_image_folder
    from sota_imagenet_tpu_torch.utils.export import load_exported

    ckpt = sorted(glob.glob(os.path.join(work, "logs", "*", "*", "model_last.ckpt")))[-1]
    serve_dir = os.path.join(work, "serve")
    t0 = time.perf_counter()
    # the artifact serves the weights the run validated: the EMA's
    cli.export_main(["-c", os.path.join(os.path.dirname(ckpt), "config.yaml"), "--ckpt", ckpt, "--out", serve_dir,
                     "--ema", "--device", "cpu"])
    export_s = time.perf_counter() - t0
    serve, meta = load_exported(serve_dir, device=device)
    files, labels, _ = scan_image_folder(os.path.join(data, "val"))
    correct = 0
    t1 = time.perf_counter()
    for i in range(0, len(files), 100):
        images = np.stack([decode_val(f, meta["image_size"]) for f in files[i : i + 100]])
        pred = serve(images).argmax(-1).cpu().numpy()
        correct += int((pred == np.asarray(labels[i : i + 100])).sum())
    return {"artifact_acc1": 100.0 * correct / len(files), "export_s": export_s,
            "artifact_score_s": time.perf_counter() - t1}


def main(argv=None, *, device=None, overrides: Iterable[str] = ()) -> dict:
    """Generate the corpus, train, print and return the verdict. ``device``
    and ``overrides`` (appended to the run's own) are for callers such as
    the CPU tests, which shrink the run."""
    ap = argparse.ArgumentParser(description="the port learns a generated corpus on the card")
    ap.add_argument("--epochs", type=int, default=30)  # the JAX package on a TPU: 15 epochs topped out ~73%, 30 reached 100%
    ap.add_argument("--keep", action="store_true", help="keep the corpus and run dir")
    ap.add_argument("--threshold", type=float, default=90.0)
    ap.add_argument("--corpus", choices=("hue", "texture"), default="hue")
    ap.add_argument("--config", default="tpu_accuracy.yaml", help="config under configs/")
    args = ap.parse_args(argv)

    work = tempfile.mkdtemp(prefix="port_acc_")
    data = os.path.join(work, "data")
    t0 = time.perf_counter()
    generate_corpus(data, corpus=args.corpus)
    corpus_s = time.perf_counter() - t0
    run = [
        f"log.dir={work}/logs",
        "run.stages=[{start: 0, end: 2, lr: [0.01, 0.2]}, "
        f"{{start: 2, end: {args.epochs}, lr: [0.2, 0.0], lr_mode: cos}}]",
        *overrides,
    ]
    curve = ValCurve()
    t1 = time.perf_counter()
    run_cli(os.path.join(CONFIGS, args.config), data, run, device=device, callbacks=[curve])
    train_s = time.perf_counter() - t1
    accs = curve.curve
    best = max(accs, default=float("nan"))
    final = accs[-1] if accs else float("nan")
    ok = len(accs) == args.epochs and best >= args.threshold
    served = artifact_acc1(work, data, device) if ok else {"artifact_acc1": float("nan")}
    ok = ok and abs(served["artifact_acc1"] - final) <= 2.0
    result = {
        "final_acc1": final,
        "best_acc1": best,
        **served,
        "final_acc1_raw_weights": curve.raw_acc1,
        "curve": accs,
        "epochs": args.epochs,
        "corpus": args.corpus,
        "config": args.config,
        "corpus_s": corpus_s,
        "train_s": train_s,
        "ok": ok,
    }
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        print(f"work dir kept for debugging: {work}", file=sys.stderr)
    elif not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
