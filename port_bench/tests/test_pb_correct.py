"""``correct`` on the CPU at a size a test run holds: a sound run passes
its cell's limits; each fault the cell can have, planted under the timed
path, and the control (the reference in float8 in the program's place)
fail them."""

import pytest

from port_bench import faults
from port_bench.drivers import train as T
from port_bench.reference.train import fp8_quant
from port_bench.tests._tiny import tiny_run

TRAIN = ["r50.cache", "nfnet_l0.feed"]


@pytest.mark.parametrize("cell", TRAIN + ["r50.serve"])
def test_a_sound_run_is_correct(cell):
    result, checks, _ = tiny_run(cell)
    assert result["correct"], checks
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_broken_step_is_not_correct(cell, fault):
    result, checks, _ = tiny_run(cell, fault=faults.TRAIN[fault])
    assert not result["correct"], checks


def test_an_altered_answer_is_not_correct():
    result, checks, _ = tiny_run("r50.serve", fault=faults.SERVE["altered_answer"])
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", TRAIN)
def test_the_control_is_not_correct(cell):
    """The reference rounded to float8 on every conv and linear, read as the program is read."""
    from port_bench import run

    _, _, out = tiny_run(cell)
    ctl = T.reference_readings(out["ctx"], out["info"], out["proof"], quant=fp8_quant)
    g = T.gaps(ctl, out["ref"])
    limits = run.limits_of(cell)
    assert any(g[k] > limits[k] for k in limits if k in g), g


@pytest.mark.parametrize("cell", TRAIN)
def test_traced_runs_report_the_cells_layers(cell):
    result, _, _ = tiny_run(cell, trace=True)
    assert "input_wait_share.train" in result["metrics"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
