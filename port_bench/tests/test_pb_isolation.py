"""What the benchmark loads: the reference nothing of the port, and no run
JAX or the JAX package (compared by whole top-level names)."""

import os
import subprocess
import sys

import pytest

from port_bench import harness

ROOT = str(harness.ROOT)


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_the_reference_imports_nothing_of_the_port():
    line = _python(
        "import sys, port_bench.reference.models, port_bench.reference.train, port_bench.flops, port_bench.rooflines\n"
        "print(sorted({m.split('.')[0] for m in sys.modules if m.split('.')[0].startswith('sota_imagenet_tpu')}))"
    )
    assert line == "[]"


@pytest.mark.parametrize("cell", ["r50.cache", "nfnet_l0.feed", "r50.serve"])
def test_a_run_loads_no_jax(cell):
    line = _python(
        "from port_bench import harness; harness.cache_env()\n"
        "from port_bench.tests._tiny import tiny_run\n"
        f"tiny_run({cell!r})\n"
        "print(harness.forbidden_modules())"
    )
    assert line == "[]"


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sota_imagenet_tpu_torch_fake", object())
    assert "sota_imagenet_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.fake_sub", object())
    assert "jax.fake_sub" in harness.forbidden_modules()


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "r50.cache", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(harness.BENCH, tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "r50.cache", "--seed", "1",
                          "--seconds", "1"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
