"""``run.skip_nonfinite`` in the port (``optim/skip_nonfinite.ApplyIfFinite``
and the train step's schedule at the optimizer's own count) against the JAX
package's ``optax.apply_if_finite`` wrap (cli.py:241-246), both through their
Runners on the same weights and batches: the tiny CModel of JAX
tests/test_train.py, SGD with momentum 0.9, float32 (JAX
tests/test_skip_nonfinite.py's setup). A poisoned batch holds an inf, which
BatchNorm turns into NaN: loss and gradients, and the running statistics
go to inf and NaN.

* JAX tests/test_skip_nonfinite.py's four cases: a skipped step, then
  recovery; NaN parameters without the guard; giving up after N; the
  schema's default;
* the lr lag: with a schedule that moves every step, a skip then three clean
  steps give JAX's parameters (the update reads the schedule at the count of
  applied updates, not at the step);
* the counters survive a checkpoint and a resume;
* with EMA and AGC, the skipped step still moves the EMA toward the unchanged
  weights and the BN buffers take the step's (NaN) values, as JAX's.

Float32 on both sides: the parameters within 1e-5 relative of JAX's (the
CPU's float32 convolutions differ in order), equal bit for bit to their
values before a skipped step.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sota_imagenet_tpu.config import parse_stages as jparse_stages
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import callbacks as jcallbacks
from sota_imagenet_tpu.train.loop import Runner as JRunner
from sota_imagenet_tpu.train.schedule import phases_from_stages as jphases
from sota_imagenet_tpu_torch.config import RunnerConfig, parse_stages
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.optim.skip_nonfinite import ApplyIfFinite
from sota_imagenet_tpu_torch.train import callbacks
from sota_imagenet_tpu_torch.train.checkpoint import finalize_checkpoints, load_checkpoint, save_checkpoint
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.train.schedule import phases_from_stages
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]
SGD = {"_target_": "sgd", "momentum": 0.9}
FLAT = [dict(start=0, end=2, lr=[0.1, 0.1])]
MOVING = [dict(start=0, end=2, lr=[0.2, 0.01])]  # linear over 8 steps: a new lr every step
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(poison=False, seed=0, bs=8):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(bs, 16, 16, 3)).astype(np.float32)
    if poison:
        img[0, 0, 0, 0] = np.inf
    return img, np.eye(10, dtype=np.float32)[np.arange(bs) % 10]


def _jax_run(skip_n, pattern, stages=FLAT, ema=0.0, agc=False):
    """The JAX Runner's steps over ``pattern`` (True = poisoned): the initial
    weights and, after each step, the weights, BN buffers, EMA and counters."""
    def tx_factory(sched):
        tx = jax_build_optimizer(SGD, sched)
        return optax.apply_if_finite(tx, max_consecutive_errors=skip_n) if skip_n else tx

    runner = JRunner(JCModel(layer_config=LAYERS), JCrossEntropyLoss(smoothing=0.1), tx_factory,
                     lr_phases=jphases(jparse_stages(stages)), input_dtype=jnp.float32, ema_decay=ema,
                     callbacks=[jcallbacks.AdaptiveGradientClipping(0.01)] if agc else None)
    runner.init_state((8, 16, 16, 3))
    runner._build_steps(steps_per_epoch=4, base_epoch=0)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out = {"init": (host(runner.state.params), host(runner.state.batch_stats)), "steps": []}
    for i, poison in enumerate(pattern):
        img, lab = _batch(poison, seed=i)
        runner.state, m = runner._train_step(runner.state, {"image": jnp.asarray(img), "label": jnp.asarray(lab)},
                                             jax.random.PRNGKey(0))
        s = runner.state
        rec = {"params": host(s.params), "stats": host(s.batch_stats), "loss": float(m["loss"]), "lr": float(m["lr"])}
        if ema:
            rec["ema"] = host(s.ema_params)
        if skip_n:
            o = s.opt_state
            rec["counters"] = {"notfinite_count": int(o.notfinite_count), "last_finite": bool(o.last_finite),
                               "total_notfinite": int(o.total_notfinite)}
        out["steps"].append(rec)
    return out


def _port_runner(skip_n, stages=FLAT, ema=0.0, agc=False):
    def make_optimizer(m):
        opt = build_optimizer(SGD, m.named_parameters())
        return ApplyIfFinite(opt, skip_n) if skip_n else opt

    runner = Runner(CModel(layer_config=copy.deepcopy(LAYERS)), CrossEntropyLoss(smoothing=0.1), make_optimizer,
                    lr_phases=phases_from_stages(parse_stages(stages)), input_dtype=torch.float32, ema_decay=ema,
                    device="cpu", callbacks=[callbacks.AdaptiveGradientClipping(0.01)] if agc else None)
    runner.init_state()
    return runner


def _port_run(skip_n, pattern, init, stages=FLAT, ema=0.0, agc=False, runner=None, start=0):
    runner = runner or _port_runner(skip_n, stages, ema, agc)
    if init is not None:
        sd = flax_to_torch_model(runner.state.model, *init)
        runner.state.model.load_state_dict(sd)
        if runner.state.ema is not None:
            runner.state.ema.load_state_dict(sd)
    runner._build_steps(steps_per_epoch=4, base_epoch=0)
    steps = []
    for i, poison in enumerate(pattern, start=start):
        img, lab = _batch(poison, seed=i)
        runner.state, m = runner._train_step(runner.state, {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})
        rec = {"model": {k: v.clone() for k, v in runner.state.model.state_dict().items()}, "loss": float(m["loss"]),
               "lr": float(m["lr"])}
        if ema:
            rec["ema"] = {k: v.clone() for k, v in runner.state.ema.state_dict().items()}
        if skip_n:
            c = runner.state.optimizer.counters()
            rec["counters"] = {k: c[k] for k in ("notfinite_count", "last_finite", "total_notfinite")}
        steps.append(rec)
    return runner, steps


def _want(runner, params, stats):
    return flax_to_torch_model(runner.state.model, params, stats)


def _params_close(got: dict, want: dict, keys=None):
    keys = keys or [k for k in want if "running" not in k]
    a = np.concatenate([got[k].numpy().ravel() for k in keys])
    b = np.concatenate([want[k].numpy().ravel() for k in keys])
    assert np.all(np.isfinite(a)) and np.linalg.norm(a - b) / np.linalg.norm(b) < TOL


def _nonfinite(sd: dict) -> bool:
    return any(not torch.isfinite(v).all() for k, v in sd.items() if "running" not in k)


def test_poisoned_step_skipped_then_recovers():
    j = _jax_run(3, [True, False])
    runner, p = _port_run(3, [True, False], j["init"])
    init = _want(runner, *j["init"])
    assert not np.isfinite(p[0]["loss"]) and not np.isfinite(j["steps"][0]["loss"])  # the bad step is visible
    for k, v in init.items():
        if "running" not in k:
            assert torch.equal(p[0]["model"][k], v), k  # but not applied
    assert p[0]["counters"] == j["steps"][0]["counters"] == {"notfinite_count": 1, "last_finite": False,
                                                            "total_notfinite": 1}
    assert np.isfinite(p[1]["loss"])
    _params_close(p[1]["model"], _want(runner, j["steps"][1]["params"], j["steps"][1]["stats"]))
    assert p[1]["counters"] == j["steps"][1]["counters"] == {"notfinite_count": 0, "last_finite": True,
                                                            "total_notfinite": 1}
    assert runner.state.optimizer.update_count == 1 and runner.state.step == 2


def test_without_skip_params_go_nan():
    j = _jax_run(0, [True])
    _, p = _port_run(0, [True], j["init"])
    assert _nonfinite(p[0]["model"])
    assert any(not np.all(np.isfinite(a)) for a in jax.tree_util.tree_leaves(j["steps"][0]["params"]))


def test_sustained_divergence_gives_up():
    pattern = [True] * 4
    j = _jax_run(2, pattern)
    runner, p = _port_run(2, pattern, j["init"])
    assert [s["counters"]["notfinite_count"] for s in p] == [s["counters"]["notfinite_count"] for s in j["steps"]]
    assert not _nonfinite(p[1]["model"]) and _nonfinite(p[2]["model"])  # the third bad step in a row is applied
    assert any(not np.all(np.isfinite(a)) for a in jax.tree_util.tree_leaves(j["steps"][3]["params"]))
    assert _nonfinite(p[3]["model"]) and runner.state.optimizer.update_count == 2


def test_config_schema_default():
    assert RunnerConfig().skip_nonfinite == 0


def test_the_update_reads_the_schedule_at_the_applied_count():
    pattern = [True, False, False, False]
    j = _jax_run(3, pattern, stages=MOVING)
    runner, p = _port_run(3, pattern, j["init"], stages=MOVING)
    for i, (got, want) in enumerate(zip(p, j["steps"])):
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6), i  # the metric: the schedule at the step
        if i:
            _params_close(got["model"], _want(runner, want["params"], want["stats"]))
    # the lag is real: the last update used lr(2), not lr(3)
    assert runner.state.optimizer.update_count == 3 and p[-1]["lr"] != p[-2]["lr"]


def test_counters_survive_a_checkpoint_and_a_resume(tmp_path):
    pattern = [True, False, True, False]
    _, whole = _port_run(3, pattern, None)
    first, part = _port_run(3, pattern[:3], None)
    path = save_checkpoint(str(tmp_path), first.state, 0, name="model.ckpt")
    finalize_checkpoints()  # the write runs in the background
    disk = torch.load(path, weights_only=True)["state"]["optimizer"]["skip"]
    assert disk == {"notfinite_count": 1, "last_finite": False, "total_notfinite": 2, "update_count": 1}
    resumed = _port_runner(3)
    resumed.state, _ = load_checkpoint(path, resumed.state)
    assert resumed.state.optimizer.counters() == disk and resumed.state.step == 3
    _, rest = _port_run(3, pattern[3:], None, runner=resumed, start=3)
    for k, v in whole[-1]["model"].items():  # the buffers hold the poisoned batches' NaN, equal as NaN
        np.testing.assert_array_equal(rest[-1]["model"][k].numpy(), v.numpy(), err_msg=k)
    assert rest[-1]["counters"] == whole[-1]["counters"]


def test_skipped_step_moves_the_ema_and_the_buffers_as_jax():
    pattern = [False, True, False]
    j = _jax_run(3, pattern, ema=0.9, agc=True)
    runner, p = _port_run(3, pattern, j["init"], ema=0.9, agc=True)
    for i in (1, 2):
        want = _want(runner, j["steps"][i]["params"], j["steps"][i]["stats"])
        want_ema = _want(runner, j["steps"][i]["ema"], j["steps"][i]["stats"])
        _params_close(p[i]["model"], want)
        _params_close(p[i]["ema"], want_ema)
        buffers = [k for k in want if "running" in k]
        # the poisoned batch's statistics reach the running buffers in both packages (inf or NaN from here on)
        for k in buffers:
            np.testing.assert_array_equal(np.isfinite(p[i]["model"][k].numpy()), np.isfinite(want[k].numpy()), err_msg=k)
            assert not np.isfinite(want[k].numpy()).any(), k
    # the EMA moved toward the weights the skip left unchanged
    conv = next(k for k in p[0]["model"] if k.endswith("weight"))
    assert not torch.equal(p[1]["ema"][conv], p[0]["ema"][conv])
    assert torch.equal(p[1]["model"][conv], p[0]["model"][conv])
