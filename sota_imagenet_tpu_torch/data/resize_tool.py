"""Offline longest-side resize of an ImageNet tree (port of
``sota_imagenet_tpu/data/resize_tool.py``; reference resize_imagenet.py:
default 512, LANCZOS, mirror tree named ``<dir>_<size>``, skip-if-exists,
multiprocess). Plain PIL: the JPEGs it writes are the JAX tool's, byte for
byte.

Usage:
    python -m sota_imagenet_tpu_torch.data.resize_tool /data/imagenet/raw-data --size 512
    python -m sota_imagenet_tpu_torch.cli records resize /data/imagenet/raw-data --size 512
"""

from __future__ import annotations

import argparse
import os
from functools import partial
from multiprocessing import Pool
from typing import List, Tuple

from PIL import Image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def resize_img(src_dst: Tuple[str, str], size: int = 512) -> None:
    src, dst = src_dst
    if os.path.exists(dst):  # skip-if-exists (reference resize_imagenet.py)
        return
    img = Image.open(src)
    w, h = img.size
    if max(w, h) > size:
        scale = size / max(w, h)
        img = img.convert("RGB").resize((max(int(w * scale), 1), max(int(h * scale), 1)), Image.LANCZOS)
    else:
        img = img.convert("RGB")
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    img.save(dst, "JPEG", quality=95)


def collect_tasks(src_root: str, dst_root: str) -> List[Tuple[str, str]]:
    tasks = []
    for dirpath, _, filenames in os.walk(src_root):
        rel = os.path.relpath(dirpath, src_root)
        for fn in filenames:
            if fn.lower().endswith(IMG_EXTENSIONS):
                tasks.append((os.path.join(dirpath, fn), os.path.join(dst_root, rel, fn)))
    return tasks


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="longest-side resize of an ImageFolder tree into <dir>_<size>")
    parser.add_argument("data_dir")
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    args = parser.parse_args(argv)
    dst_root = args.data_dir.rstrip("/") + f"_{args.size}"
    tasks = collect_tasks(args.data_dir, dst_root)
    print(f"{len(tasks)} images -> {dst_root}")
    with Pool(args.workers) as pool:
        pool.map(partial(resize_img, size=args.size), tasks)
    return dst_root


if __name__ == "__main__":
    main()
