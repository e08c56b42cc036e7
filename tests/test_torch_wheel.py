"""A wheel of the repo carries the port's CUDA sources, and an installed
port builds its kernels where it may write.

* ``pip wheel`` of a copy of the tree (offline: no index, no build
  isolation, no dependencies) holds all five ``sota_imagenet_tpu_torch/csrc``
  ``.cu`` files beside the port's modules (``MANIFEST.in``), so
  ``ops/cuda_build.py`` finds them next to an installed package.
* ``cuda_build.build_dir``: a checkout builds into its ``_build/``; a package
  directory that cannot be written (a read-only site-packages) builds into
  ``$XDG_CACHE_HOME/sota_imagenet_tpu_torch/<hash of the package's path>``,
  a directory that can.
* The wheel installs the port's three console scripts (``sota-train-torch``,
  ``sota-export-torch``, ``sota-records-torch``; ``cli.train_script`` and the
  two beside it), and installed outside the checkout each answers
  ``--help`` and exits 0 after a run that succeeds: a one-epoch
  ``tiny_synthetic`` training on the CPU, the export of its checkpoint, and
  a resize of a small ImageFolder.
"""

import configparser

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
SCRIPTS = {"sota-train-torch": "sota_imagenet_tpu_torch.cli:train_script",
           "sota-export-torch": "sota_imagenet_tpu_torch.cli:export_script",
           "sota-records-torch": "sota_imagenet_tpu_torch.cli:records_script"}


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
    assert len(CU) == 5, CU
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


def test_the_wheel_names_the_ports_console_scripts(wheel):
    with zipfile.ZipFile(wheel) as z:
        (name,) = [n for n in z.namelist() if n.endswith(".dist-info/entry_points.txt")]
        entry_points = configparser.ConfigParser()
        entry_points.read_string(z.read(name).decode())
    scripts = dict(entry_points["console_scripts"])
    for script, target in SCRIPTS.items():
        assert scripts.get(script) == target, scripts


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed into a directory of its own: (its bin/, the environment that imports it, a work dir)."""
    site, work = tmp_path_factory.mktemp("site"), tmp_path_factory.mktemp("work")
    env = {**os.environ, "PIP_NO_INDEX": "1", "PIP_DISABLE_PIP_VERSION_CHECK": "1"}
    proc = subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps", "--no-index", "-q", "--target",
                           str(site), str(wheel)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    env["PYTHONPATH"] = str(site)
    return site / "bin", env, work


def _run(installed, script, *args):
    bin_dir, env, work = installed
    return subprocess.run([str(bin_dir / script), *args], cwd=work, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_an_installed_script_answers_help(installed, script):
    proc = _run(installed, script, "--help")
    assert proc.returncode == 0 and "usage:" in proc.stdout, proc.stdout + proc.stderr


def test_the_installed_scripts_exit_0_after_a_run(installed, tmp_path):
    from PIL import Image

    logs = tmp_path / "logs"
    proc = _run(installed, "sota-train-torch", "--device", "cpu", "-c", str(REPO / "configs" / "tiny_synthetic.yaml"),
                "loader.batch_size=8", "val_loader.batch_size=8", "log.tensorboard=false", f"log.dir={logs}",
                "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    (ckpt,) = glob.glob(str(logs / "*_tiny_synthetic" / "*" / "model_last.ckpt"))
    out = tmp_path / "artifact"
    proc = _run(installed, "sota-export-torch", "-c", os.path.join(os.path.dirname(ckpt), "config.yaml"),
                "--ckpt", ckpt, "--out", str(out), "--device", "cpu")
    assert proc.returncode == 0 and (out / "model.pt2").exists(), proc.stdout[-2000:] + proc.stderr[-2000:]
    tree = tmp_path / "tree"
    (tree / "train" / "a").mkdir(parents=True)
    Image.new("RGB", (40, 24), (200, 30, 30)).save(tree / "train" / "a" / "0.jpg")
    proc = _run(installed, "sota-records-torch", "resize", str(tree), "--size", "16", "--workers", "1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert Image.open(tmp_path / "tree_16" / "train" / "a" / "0.jpg").size == (16, 9)
