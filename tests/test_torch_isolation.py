"""The port stands alone: importing every module of sota_imagenet_tpu_torch
pulls in no JAX, and neither the package nor chip_smoke.py imports the JAX
package (only the port's tests import both)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "sota_imagenet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sota_imagenet_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {mod}"


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sota_imagenet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "assert len(names) >= 34, names\n"
        "print(len(names))\n" % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
