"""A wheel of the repo carries the port's CUDA sources, and an installed
port builds its kernels where it may write.

* ``pip wheel`` of a copy of the tree (offline: no index, no build
  isolation, no dependencies) holds all four ``sota_imagenet_tpu_torch/csrc``
  ``.cu`` files beside the port's modules (``MANIFEST.in``), so
  ``ops/cuda_build.py`` finds them next to an installed package.
* ``cuda_build.build_dir``: a checkout builds into its ``_build/``; a package
  directory that cannot be written (a read-only site-packages) builds into
  ``$XDG_CACHE_HOME/sota_imagenet_tpu_torch/<hash of the package's path>``,
  a directory that can.
"""

import glob
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from sota_imagenet_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parent.parent
CU = sorted(p.name for p in (REPO / "sota_imagenet_tpu_torch" / "csrc").glob("*.cu"))


def _copy_tree(dst: Path) -> None:
    """What a wheel is built from, without build outputs or caches."""
    for name in ("pyproject.toml", "MANIFEST.in", "README.md", "LICENSE"):
        shutil.copy2(REPO / name, dst / name)
    ignore = shutil.ignore_patterns("__pycache__", "_build", "*.pyc", "*.so")
    for pkg in ("sota_imagenet_tpu", "sota_imagenet_tpu_torch"):
        shutil.copytree(REPO / pkg, dst / pkg, ignore=ignore)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory) -> Path:
    src, out = tmp_path_factory.mktemp("tree"), tmp_path_factory.mktemp("wheel")
    _copy_tree(src)
    env = {**os.environ, "PIP_NO_INDEX": "1", "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-deps", "--no-build-isolation", "--no-index",
         "--disable-pip-version-check", "-q", "-w", str(out)],
        cwd=src, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (whl,) = glob.glob(str(out / "*.whl"))
    return Path(whl)


def test_the_wheel_holds_every_cuda_source(wheel):
    assert len(CU) == 4, CU
    names = set(zipfile.ZipFile(wheel).namelist())
    for cu in CU:
        assert f"sota_imagenet_tpu_torch/csrc/{cu}" in names, sorted(n for n in names if "csrc" in n)
    assert "sota_imagenet_tpu_torch/ops/cuda_build.py" in names


def test_a_checkout_builds_into_its_own_build_dir():
    assert cuda_build.build_dir() == cuda_build.PACKAGE_DIR / "_build"
    assert cuda_build.build_dir(REPO / "sota_imagenet_tpu_torch") == REPO / "sota_imagenet_tpu_torch" / "_build"


def test_a_read_only_package_builds_into_a_user_cache(tmp_path, monkeypatch):
    pkg = tmp_path / "site-packages" / "sota_imagenet_tpu_torch"
    pkg.mkdir(parents=True)
    cache = tmp_path / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    real = os.access
    # the process may be root, which writes anywhere: the package's tree is made read-only to os.access
    monkeypatch.setattr(os, "access", lambda p, mode: False if str(p).startswith(str(tmp_path / "site-packages"))
                        else real(p, mode))
    out = cuda_build.build_dir(pkg)
    assert out.parent == cache / "sota_imagenet_tpu_torch" and out != pkg / "_build"
    assert out == cuda_build.build_dir(pkg)  # the same package, the same cache
    out.mkdir(parents=True)
    (out / "probe").write_text("ok")
    assert (out / "probe").read_text() == "ok"
    # another installed copy takes another directory
    other = tmp_path / "site-packages" / "v2" / "sota_imagenet_tpu_torch"
    assert cuda_build.build_dir(other) != out
