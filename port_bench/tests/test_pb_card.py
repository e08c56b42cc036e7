"""One short run of each cell on the card, through the command the
benchmark's check runs: ``correct`` true and the cell's metrics present.
Needs a card; the test decides that itself and skips without one.

    python -m pytest -m cuda port_bench/tests/test_pb_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from port_bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark_spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    import torch

    chips = harness.cell_spec(cell)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA device(s)")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", cell, "--seed", str(2 ** 31 + 99),
                          "--seconds", "3", "--trace", str(trace)], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    kind = "per_layer" if trace else "end_to_end"
    wanted = {m["name"] for m in harness.cell_metrics(harness.benchmark_spec(), cell, kind)}
    assert set(result["metrics"]) == wanted
