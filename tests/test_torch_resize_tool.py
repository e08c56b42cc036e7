"""The port's offline resize (``sota_imagenet_tpu_torch/data/resize_tool.py``
and ``cli records resize``) against the JAX tool
(``sota_imagenet_tpu/data/resize_tool.py``; tests/test_resize_tool.py): on
the same tree of seeded images (JPEG, PNG, grayscale, one past the cap in
each orientation, one under it, a file that is not an image) both write the
same mirror tree ``<dir>_<size>``, each JPEG byte for byte the JAX tool's,
and neither rewrites a file that exists."""

import os

import numpy as np
import pytest
from PIL import Image

from sota_imagenet_tpu.data import resize_tool as jax_resize
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.data import resize_tool


def _tree(root, seed=0):
    rng = np.random.default_rng(seed)
    # (relative path, width, height, mode)
    files = [("train/n01/big.JPEG", 300, 200, "RGB"), ("train/n01/tall.png", 60, 260, "RGB"),
             ("train/n02/gray.jpg", 240, 180, "L"), ("val/n02/small.jpeg", 100, 70, "RGB")]
    for rel, w, h, mode in files:
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shape = (h, w) if mode == "L" else (h, w, 3)
        Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode).save(path)
    with open(os.path.join(root, "train", "n01", "notes.txt"), "w") as f:
        f.write("not an image")
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture
def trees(tmp_path):
    return _tree(str(tmp_path / "port" / "raw")), _tree(str(tmp_path / "jax" / "raw"))


@pytest.mark.parametrize("entry", ["resize_tool", "records_resize"])
def test_resize_writes_the_jax_tools_jpegs_byte_for_byte(trees, entry):
    port, jax_tree = trees
    if entry == "resize_tool":
        assert resize_tool.main([port, "--size", "128", "--workers", "1"]) == port + "_128"
    else:
        cli.records_main(["resize", port, "--size", "128", "--workers", "1"])
    jax_resize.main([jax_tree, "--size", "128", "--workers", "1"])
    got, want = _files(port + "_128"), _files(jax_tree + "_128")
    assert got == want == ["train/n01/big.JPEG", "train/n01/tall.png", "train/n02/gray.jpg", "val/n02/small.jpeg"]
    for rel in got:
        with open(os.path.join(port + "_128", rel), "rb") as a, open(os.path.join(jax_tree + "_128", rel), "rb") as b:
            assert a.read() == b.read(), rel
    sizes = {rel: Image.open(os.path.join(port + "_128", rel)).size for rel in got}
    assert sizes == {"train/n01/big.JPEG": (128, 85), "train/n01/tall.png": (29, 128),
                     "train/n02/gray.jpg": (128, 96), "val/n02/small.jpeg": (100, 70)}
    assert all(Image.open(os.path.join(port + "_128", rel)).format == "JPEG" for rel in got)


def test_resize_skips_files_that_exist(trees):
    port, _ = trees
    resize_tool.main([port, "--size", "128", "--workers", "1"])
    out = os.path.join(port + "_128", "train", "n01", "big.JPEG")
    with open(out, "wb") as f:
        f.write(b"kept")
    resize_tool.main([port, "--size", "128", "--workers", "2"])
    with open(out, "rb") as f:
        assert f.read() == b"kept"
    assert resize_tool.collect_tasks(port, port + "_128") == jax_resize.collect_tasks(port, port + "_128")
