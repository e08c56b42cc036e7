"""The port's checkpoints against the JAX package's (``train/checkpoint.py`` of each).

* The restore decides as the JAX one: for each pair of configs (the
  optimizer saved and the one resumed, an EMA turned on or off, Lookahead,
  the non-finite skip) the JAX ``load_checkpoint`` restores fully or falls
  back to the params, and the port's must do the same: weights exact both
  ways; on a full restore the optimizer state and ``step`` as saved, on a
  fallback a fresh optimizer and ``step`` 0. A different model raises in
  both. A change of momentum or weight decay to or from 0 falls back in
  JAX only (the optax chain drops a transform; a torch optimizer keeps the
  same state), and the port keeps the run's hyperparameters.
* A checkpoint written before the optimizer's layout was recorded still
  loads, fully under the same optimizer.
* The CLI resumes a full ``tiny_synthetic`` checkpoint under AdamW (it raised
  ``KeyError: 'step'`` before) and under SGD (the state restored).
* The background write: ``save_checkpoint`` returns before the write ends
  and the file holds the state as it was at the call; a load waits for it;
  a writer's exception is raised at ``finalize_checkpoints``; a process
  killed mid-write leaves the previous file, which loads, and
  ``find_auto_resume`` never returns the tmp file.
"""

import glob
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.optim.skip_nonfinite import ApplyIfFinite
from sota_imagenet_tpu_torch.train import checkpoint, steps
from sota_imagenet_tpu_torch.train.callbacks import Callback
from sota_imagenet_tpu_torch.train.checkpoint import finalize_checkpoints, load_checkpoint, save_checkpoint

ROOT = os.path.join(os.path.dirname(__file__), "..")
SAVED_STEP = 7

SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
ADAMW = {"_target_": "adamw", "weight_decay": 0.05}
# name -> (optimizer saved, EMA saved, skip saved, optimizer resumed, EMA resumed, skip resumed)
PAIRS = {
    "sgd_to_adamw": (SGD, 0.0, 0, ADAMW, 0.0, 0),
    "adamw_to_sgd": (ADAMW, 0.0, 0, SGD, 0.0, 0),
    "sgd_to_sgd": (SGD, 0.0, 0, SGD, 0.0, 0),
    "adamw_to_adamw_other_weight_decay": (ADAMW, 0.0, 0, {"_target_": "adamw", "weight_decay": 0.01}, 0.0, 0),
    "ema_turned_on": (SGD, 0.0, 0, SGD, 0.5, 0),
    "ema_turned_off": (SGD, 0.5, 0, SGD, 0.0, 0),
    "ema_on_both": (SGD, 0.5, 0, SGD, 0.5, 0),
    "lookahead_turned_on": (SGD, 0.0, 0, {**SGD, "lookahead": True}, 0.0, 0),
    "skip_nonfinite_turned_on": (SGD, 0.0, 0, SGD, 0.0, 3),
    "skip_nonfinite_on_both": (SGD, 0.0, 3, SGD, 0.0, 3),
}
# where JAX falls back and the port restores: the same torch state, the run's hyperparameter
ZERO_HYPERPARAMETER = {
    "weight_decay_to_0": (SGD, {"_target_": "sgd", "momentum": 0.9}),
    "momentum_to_0": (SGD, {"_target_": "sgd", "weight_decay": 1e-4}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# The JAX package's decisions
# --------------------------------------------------------------------------- #

JAX_LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]


def _jax_state(optim, ema, skip, layers=JAX_LAYERS, seed=0):
    import jax
    import optax

    from sota_imagenet_tpu.models.cmodel import CModel
    from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
    from sota_imagenet_tpu.train import steps as jax_steps

    tx = jax_build_optimizer(dict(optim))
    if skip:
        tx = optax.apply_if_finite(tx, max_consecutive_errors=skip)
    return jax_steps.init_state(CModel(layer_config=layers), tx, (2, 16, 16, 3), jax.random.PRNGKey(seed), ema_decay=ema)


@pytest.fixture(scope="module")
def jax_restores(tmp_path_factory):
    """Pair name -> whether the JAX restore was full (it kept the saved
    step), or "raises" for a different model."""
    import jax.numpy as jnp

    from sota_imagenet_tpu.train.checkpoint import load_checkpoint as jax_load
    from sota_imagenet_tpu.train.checkpoint import save_checkpoint as jax_save

    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    pairs = {**PAIRS, **{k: (a, 0.0, 0, b, 0.0, 0) for k, (a, b) in ZERO_HYPERPARAMETER.items()}}
    out = {}
    for name, (a, ea, sa, b, eb, sb) in pairs.items():
        saved = _jax_state(a, ea, sa, seed=1).replace(step=jnp.asarray(SAVED_STEP, jnp.int32))
        path = jax_save(d, saved, 3, name=f"{name}.ckpt", block=True)
        restored, epoch = jax_load(path, _jax_state(b, eb, sb))
        assert epoch == 3
        out[name] = int(restored.step) == SAVED_STEP
    path = jax_save(d, _jax_state(SGD, 0.0, 0, seed=1), 2, name="model.ckpt", block=True)
    other = [{"module": "conv3x3", "args": [3, 4]}, {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
             {"module": "Linear", "args": [4, 10]}]
    try:
        jax_load(path, _jax_state(SGD, 0.0, 0, layers=other))
        out["different_model"] = "restores"
    except Exception:  # noqa: BLE001 - any error: the JAX restore refuses the other model
        out["different_model"] = "raises"
    return out


# --------------------------------------------------------------------------- #
# The port
# --------------------------------------------------------------------------- #


def _net(width: int = 8) -> torch.nn.Module:
    return torch.nn.Sequential(
        torch.nn.Conv2d(3, width, 3, stride=2, padding=1, bias=False), torch.nn.BatchNorm2d(width), torch.nn.ReLU(),
        torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(), torch.nn.Linear(width, 10))


def _port_state(optim, ema=0.0, skip=0, model=None, seed=0):
    torch.manual_seed(seed)

    def make(m):
        opt = build_optimizer(dict(optim), m.named_parameters())
        return ApplyIfFinite(opt, skip) if skip else opt

    return steps.init_state(model or _net(), make, device="cpu", ema_decay=ema)


def _trained(optim, ema=0.0, skip=0):
    """A state two optimizer steps in, its EMA moved off the weights, at step ``SAVED_STEP``."""
    state = _port_state(optim, ema, skip, seed=1)
    x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        state.model(x).square().mean().backward()
        state.optimizer.step()
        state.optimizer.zero_grad()
    if state.ema is not None:
        with torch.no_grad():
            for p in state.ema.parameters():
                p.mul_(0.5)
    state.step = SAVED_STEP
    return state


def _opt_tensors(opt) -> dict:
    """Every state tensor of an optimizer's state dict, by a path of keys."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, torch.Tensor):
            out[prefix] = x
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)

    walk("", {k: v for k, v in opt.state_dict().items() if k != "param_groups"})
    return out


def _assert_same_module(a: torch.nn.Module, b: torch.nn.Module):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_the_restore_decides_as_jax(pair, jax_restores, tmp_path):
    a, ea, sa, b, eb, sb = PAIRS[pair]
    saved = _trained(a, ea, sa)
    path = save_checkpoint(str(tmp_path), saved, 3)
    fresh = _port_state(b, eb, sb)
    init_ema = {k: v.clone() for k, v in fresh.ema.state_dict().items()} if fresh.ema is not None else None
    init_opt = {k: v.clone() for k, v in _opt_tensors(fresh.optimizer).items()}
    restored, epoch = load_checkpoint(path, fresh)
    full = jax_restores[pair]
    assert epoch == 3 and (restored.step == SAVED_STEP) == full
    _assert_same_module(restored.model, saved.model)
    if full:
        want, got = _opt_tensors(saved.optimizer), _opt_tensors(restored.optimizer)
        assert want and want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
    else:  # the fresh optimizer's state: none, or Lookahead's slow copy of the initial weights, as in JAX
        got = _opt_tensors(restored.optimizer)
        assert restored.step == 0 and got.keys() == init_opt.keys()
        for k, v in init_opt.items():
            assert torch.equal(got[k], v), k
    if restored.ema is not None:
        if saved.ema is not None:  # restored where both hold one, fully or in part
            _assert_same_module(restored.ema, saved.ema)
        else:  # a fresh EMA keeps its initial copy, as the JAX template's
            for k, v in restored.ema.state_dict().items():
                assert torch.equal(v, init_ema[k]), k


@pytest.mark.parametrize("pair", sorted(ZERO_HYPERPARAMETER))
def test_a_zero_momentum_or_weight_decay_falls_back_in_jax_only(pair, jax_restores, tmp_path):
    a, b = ZERO_HYPERPARAMETER[pair]
    assert jax_restores[pair] is False
    saved = _trained(a)
    restored, _ = load_checkpoint(save_checkpoint(str(tmp_path), saved, 3), _port_state(b))
    assert restored.step == SAVED_STEP
    for k, v in _opt_tensors(saved.optimizer).items():
        assert torch.equal(v, _opt_tensors(restored.optimizer)[k]), k
    # the groups' hyperparameters are this run's, not the checkpoint's
    group = restored.optimizer.param_groups[0]
    assert (group["momentum"], group["weight_decay"]) == (b.get("momentum", 0.0), b.get("weight_decay", 0.0))


def test_a_different_model_raises_in_both(jax_restores, tmp_path):
    assert jax_restores["different_model"] == "raises"
    path = save_checkpoint(str(tmp_path), _trained(SGD), 2)
    other = _port_state(SGD, model=_net(width=4))
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(RuntimeError):
        load_checkpoint(path, other)
    assert other.step == 0 and not _opt_tensors(other.optimizer)
    assert before.keys() == other.model.state_dict().keys()


@pytest.mark.parametrize("resumed,full", [(SGD, True), (ADAMW, False), ({**SGD, "lookahead": True}, False)])
def test_a_checkpoint_without_the_layout_still_loads(resumed, full, tmp_path):
    """The port's format before the layout was recorded: no ``optimizer_layout``."""
    saved = _trained(SGD)
    path = save_checkpoint(str(tmp_path), saved, 4, block=True)
    payload = torch.load(path, weights_only=True)
    del payload["optimizer_layout"]
    old = os.path.join(tmp_path, "old.ckpt")
    torch.save(payload, old)
    restored, epoch = load_checkpoint(old, _port_state(resumed))
    assert epoch == 4 and (restored.step == SAVED_STEP) == full
    _assert_same_module(restored.model, saved.model)
    assert ("/state/0/momentum_buffer" in _opt_tensors(restored.optimizer)) == full


# --------------------------------------------------------------------------- #
# The CLI: a full tiny_synthetic checkpoint resumed under another optimizer
# --------------------------------------------------------------------------- #

CONFIG = os.path.join(ROOT, "configs", "tiny_synthetic.yaml")
CLI_OVERRIDES = ["loader.batch_size=8", "val_loader.batch_size=8", "log.save_optim=true", "log.tensorboard=false",
                 "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]"]


class _AtBegin(Callback):
    """What the run holds before its first step: the step, the optimizer's state tensors, the weights."""

    def on_begin(self):
        st = self.runner.state
        self.step, self.optimizer = st.step, {k: v.clone() for k, v in _opt_tensors(st.optimizer).items()}
        self.model = {k: v.clone() for k, v in st.model.state_dict().items()}
        self.optimizer_class = type(st.optimizer).__name__


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("logs"))
    cli.main(["-c", CONFIG, *CLI_OVERRIDES, f"log.dir={logdir}"], device="cpu")
    (ckpt,) = glob.glob(os.path.join(logdir, "*_tiny_synthetic", "*", "model_last.ckpt"))
    return ckpt


@pytest.mark.parametrize("optim,full", [("{_target_: adamw, weight_decay: 0.05}", False),
                                        ("{_target_: sgd, momentum: 0.9, weight_decay: 1e-4}", True)])
def test_the_cli_resumes_a_full_checkpoint_under_any_optimizer(tiny_run, optim, full, tmp_path):
    ckpt = tiny_run
    disk = torch.load(ckpt, weights_only=True)
    assert disk["state"]["step"] == 10 and disk["state"]["optimizer"]["state"]
    assert disk["optimizer_layout"]["classes"] == ["SGD"]
    probe = _AtBegin()
    # a run dir of its own: one started in the same second as tiny_run's would write over its checkpoint
    val = cli.main(["-c", CONFIG, *CLI_OVERRIDES, f"log.dir={tmp_path}", f"optim={optim}", f"run.resume={ckpt}",
                    "run.load_start_epoch=false"], device="cpu", callbacks=[probe])
    assert np.isfinite(val["loss"])
    for k, v in disk["state"]["model"].items():
        assert torch.equal(probe.model[k], v), k
    if full:
        assert probe.step == 10 and probe.optimizer_class == "SGD"
        saved = {f"/state/{i}/{k}": v for i, st in disk["state"]["optimizer"]["state"].items() for k, v in st.items()}
        assert saved.keys() == probe.optimizer.keys()
        for k, v in saved.items():
            assert torch.equal(probe.optimizer[k], v), k
    else:
        assert probe.step == 0 and probe.optimizer_class == "AdamW" and not probe.optimizer


# --------------------------------------------------------------------------- #
# The background write
# --------------------------------------------------------------------------- #


def test_save_returns_before_the_write_ends_and_writes_the_state_at_the_call(tmp_path, monkeypatch):
    state = _trained(SGD)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    release, real_save = threading.Event(), torch.save

    def held_save(obj, f):
        assert release.wait(30)
        real_save(obj, f)

    monkeypatch.setattr(checkpoint.torch, "save", held_save)
    path = save_checkpoint(str(tmp_path), state, 5)
    assert not os.path.exists(path)  # the writer waits; the call has returned
    with torch.no_grad():  # the steps after the save move the weights in place
        for p in state.model.parameters():
            p.add_(1.0)
    release.set()
    finalize_checkpoints()
    disk = torch.load(path, weights_only=True)
    assert disk["epoch"] == 5 and not glob.glob(path + ".tmp-*")
    for k, v in want.items():
        assert torch.equal(disk["state"]["model"][k], v), k


def test_a_load_waits_for_the_write_in_flight(tmp_path, monkeypatch):
    state = _trained(SGD)
    path = save_checkpoint(str(tmp_path), state, 1, block=True)
    real_save = torch.save

    def slow_save(obj, f):
        time.sleep(0.3)
        real_save(obj, f)

    monkeypatch.setattr(checkpoint.torch, "save", slow_save)
    save_checkpoint(str(tmp_path), state, 2)
    _, epoch = load_checkpoint(path, _port_state(SGD))
    assert epoch == 2


def test_a_writer_error_is_raised_at_finalize(tmp_path, monkeypatch):
    state = _trained(SGD)
    path = save_checkpoint(str(tmp_path), state, 1, block=True)

    def failing_save(obj, f):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(checkpoint.torch, "save", failing_save)
    save_checkpoint(str(tmp_path), state, 2)
    with pytest.raises(OSError, match="No space left"):
        finalize_checkpoints()
    finalize_checkpoints()  # raised once, then nothing is in flight
    monkeypatch.undo()
    assert torch.load(path, weights_only=True)["epoch"] == 1


KILLED_WRITER = r"""
import os, sys, time
import torch
sys.path.insert(0, sys.argv[2])
import test_torch_checkpoint as T
from sota_imagenet_tpu_torch.train import checkpoint

state = T._trained(T.SGD)
checkpoint.save_checkpoint(sys.argv[1], state, 1, block=True)

def stuck_save(obj, f):
    with open(f, "wb") as out:
        out.write(b"half a checkpoint")
        out.flush()
    print("WRITING", flush=True)
    time.sleep(600)

torch.save = stuck_save
checkpoint.save_checkpoint(sys.argv[1], state, 2)
time.sleep(600)
"""


def test_a_process_killed_mid_write_leaves_the_previous_file(tmp_path):
    run_dir = tmp_path / "2026-01-01_tiny" / "00-00-00"
    run_dir.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen([sys.executable, "-c", KILLED_WRITER, str(run_dir), os.path.dirname(__file__)],
                             stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert child.stdout.readline().strip() == "WRITING"
    finally:
        child.send_signal(signal.SIGKILL)
        child.wait(60)
    (tmp,) = glob.glob(str(run_dir / "model.ckpt.tmp-*"))
    assert open(tmp, "rb").read() == b"half a checkpoint"
    found = cli.find_auto_resume(str(tmp_path), "tiny")
    assert found == str(run_dir / "model.ckpt")
    restored, epoch = load_checkpoint(found, _port_state(SGD))
    assert epoch == 1 and restored.step == SAVED_STEP
