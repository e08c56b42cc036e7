"""The ``Profiler`` callback (``train/callbacks.Profiler``; JAX
callbacks.py:358-386) and ``debug_nans`` (``utils/debug_nans.py``; the JAX
CLI's ``jax_debug_nans``, cli.py:123-124) in the port.

* The Profiler writes one Chrome trace on rank 0, holding the steps of its
  window (its ``aten::convolution`` events: one a step of the tiny CModel),
  and nothing on another rank; the step numbers its ``on_batch_end`` sees
  are the JAX Runner's (JAX loop.py:248, port loop.py:207), over two epochs.
* ``debug_nans``: an inf in the batch becomes NaN in BatchNorm, and the
  forward hook names that module; a NaN made in a backward raises through
  anomaly detection; a NaN in the new parameters raises; an inf alone does
  not; a clean run gives the same numbers bit for bit with and without it.
* ``cli.main`` with ``debug_nans=true`` runs the guard and no longer warns
  that it has no effect; the Profiler runs in the CLI.
"""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.config import parse_stages as jparse_stages
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train.callbacks import Callback as JCallback
from sota_imagenet_tpu.train.loop import Runner as JRunner
from sota_imagenet_tpu.train.schedule import phases_from_stages as jphases
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.config import parse_stages
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import callbacks, steps
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.train.schedule import phases_from_stages
from sota_imagenet_tpu_torch.utils import debug_nans

LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]
STAGES = [dict(start=0, end=2, lr=[0.1, 0.1])]
TINY = os.path.join(os.path.dirname(__file__), "..", "configs", "tiny_synthetic.yaml")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, poison=False, bs=8):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(bs, 16, 16, 3)).astype(np.float32)
    if poison:
        img[0, 0, 0, 0] = np.inf
    return img, np.eye(10, dtype=np.float32)[np.arange(bs) % 10]


class _Loader:
    """A few batches, as the Runners take them."""

    def __init__(self, to, n=3):
        self.to, self.n, self.batch_size = to, n, 8

    def __len__(self):
        return self.n

    def __iter__(self):
        for i in range(self.n):
            img, lab = _batch(i)
            yield {"image": self.to(img), "label": self.to(lab)}


def _runner(cbs=(), debug=False, model=None):
    runner = Runner(model or CModel(layer_config=copy.deepcopy(LAYERS)), CrossEntropyLoss(smoothing=0.1),
                    lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters()),
                    lr_phases=phases_from_stages(parse_stages(STAGES)), input_dtype=torch.float32, device="cpu",
                    callbacks=list(cbs), debug_nans=debug)
    runner.init_state(seed=0)
    return runner


def test_profiler_traces_its_window_on_rank_0(tmp_path):
    prof = callbacks.Profiler(log_dir=str(tmp_path), start_step=1, num_steps=2)
    _runner([prof]).fit(_Loader(torch.from_numpy, n=5), epochs=1)
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert prof.path == path and ".1-3." in os.path.basename(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    convs = [e for e in events if e.get("name") == "aten::convolution"]
    assert len(convs) == 2  # steps 2 and 3 (0-based 2 and 3 end the window), one conv each


def test_profiler_does_nothing_on_other_ranks(tmp_path, monkeypatch):
    monkeypatch.setattr(callbacks, "process_index", lambda: 1)
    prof = callbacks.Profiler(log_dir=str(tmp_path), start_step=0, num_steps=1)
    _runner([prof]).fit(_Loader(torch.from_numpy), epochs=1)
    assert not os.listdir(tmp_path) and prof.path is None


def test_profiler_stops_at_the_end_of_the_run(tmp_path):
    prof = callbacks.Profiler(log_dir=str(tmp_path), start_step=1, num_steps=50)
    runner = _runner([prof])
    runner.fit(_Loader(torch.from_numpy), epochs=1)
    assert prof.path is None
    runner.close()
    assert prof.path and os.path.exists(prof.path)


def test_on_batch_end_steps_are_the_jax_runners():
    class Steps(callbacks.Callback):
        seen = []

        def on_batch_end(self, step, metrics):
            self.seen.append(step)

    class JSteps(JCallback):
        seen = []

        def on_batch_end(self, step, metrics):
            self.seen.append(step)

    port = Steps()
    _runner([port]).fit(_Loader(torch.from_numpy), epochs=2)
    jrunner = JRunner(JCModel(layer_config=LAYERS), JCrossEntropyLoss(smoothing=0.1),
                      lambda sched: jax_build_optimizer({"_target_": "sgd", "momentum": 0.9}, sched),
                      lr_phases=jphases(jparse_stages(STAGES)), input_dtype=jnp.float32, callbacks=[JSteps()])
    jrunner.init_state((8, 16, 16, 3))
    jrunner.fit(_Loader(jnp.asarray), epochs=2)
    assert port.seen == JSteps.seen == [0, 1, 2, 3, 4, 5]


def test_debug_nans_names_the_module_where_the_inf_becomes_nan():
    runner = _runner(debug=True)
    runner._build_steps(steps_per_epoch=4, base_epoch=0)
    img, lab = _batch(poison=True)
    with pytest.raises(FloatingPointError, match=r"forward output of .*\(BatchNorm"):
        runner._train_step(runner.state, {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})


class _NanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


class _NanInBackward(torch.nn.Module):
    """A linear head on NHWC images whose backward, and only it, makes a NaN."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 10)

    def forward(self, x):
        return _NanGrad.apply(self.fc(x.mean((1, 2))))


def test_debug_nans_raises_on_a_nan_made_in_the_backward():
    runner = _runner(debug=True, model=_NanInBackward())
    runner._build_steps(steps_per_epoch=4, base_epoch=0)
    img, lab = _batch()
    with pytest.raises(FloatingPointError, match="NaN in the backward.*_NanGradBackward"):
        runner._train_step(runner.state, {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})


def test_debug_nans_checks_the_new_parameters():
    runner = _runner()
    step = debug_nans.check_step(steps.build_train_step(CrossEntropyLoss(), lambda s: float("nan"),
                                                         input_dtype=torch.float32))
    img, lab = _batch()
    with pytest.raises(FloatingPointError, match="new parameters of step 1"):
        step(runner.state, {"image": torch.from_numpy(img), "label": torch.from_numpy(lab)})


def test_an_inf_alone_does_not_raise():
    model = torch.nn.Sequential(torch.nn.ReLU(), torch.nn.Identity())
    debug_nans.watch_forward(model)
    out = model(torch.tensor([1.0, float("inf")]))
    assert torch.isinf(out).any()
    with pytest.raises(FloatingPointError, match="ReLU"):
        model(torch.tensor([1.0, float("nan")]))


def test_a_clean_run_is_the_same_with_debug_nans():
    states = []
    for debug in (False, True):
        runner = _runner(debug=debug)
        runner.fit(_Loader(torch.from_numpy), epochs=2)
        states.append(runner.state.model.state_dict())
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_cli_runs_the_guard_without_the_old_warning(tmp_path):
    val = cli.main(["-c", TINY, f"log.dir={tmp_path}", "debug_nans=true", "log.tensorboard=false"], device="cpu")
    assert all(np.isfinite(v) for v in val.values())
    (logs,) = glob.glob(os.path.join(tmp_path, "*", "*", "logs.txt"))
    with open(logs) as f:
        text = f.read()
    assert "has no effect" not in text and "debug_nans: the first NaN" in text
