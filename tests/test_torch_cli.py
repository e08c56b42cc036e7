"""The port's training CLI end to end on the CPU: r50_baseline's recipe with
a ResNet-18 at 32 px (synthetic data, f32, debug: 10 train / 20 val steps,
one 1-epoch warmup stage), then an eval of its last checkpoint, which must
reproduce the run's final val metrics exactly. The same for a full-width
ResNet-50 with ``fused_stats`` (every 1x1 conv + BN through conv1x1_stats,
whose CPU path is the kernel's plain version)."""

import glob
import math
import os

import pytest
import torch

from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.train.callbacks import Callback

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "exp", "1.r50_baseline.yaml")
OVERRIDES = [
    "loader.backend=synthetic",
    "val_loader.backend=synthetic",
    "model={_target_: resnet18}",
    "loader.image_size=32",
    "loader.batch_size=8",
    "val_loader.batch_size=8",
    "run.bf16=false",
    "debug=true",
    "run.stages=[{start: 0, end: 1, lr: [0.001, 1.0]}]",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several workers share the
    cores, and oversubscribed OpenMP threads slow these small CPU runs by
    one to two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Record(Callback):
    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        self.train_metrics = dict(train_metrics)
        self.steps = self.runner.state.step


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("logs")
    rec = _Record()
    val = cli.main(["-c", CONFIG, *OVERRIDES, f"log.dir={logdir}"], device="cpu", callbacks=[rec])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_r50_baseline", "*"))
    return {"val": val, "record": rec, "run_dir": run_dir, "logdir": str(logdir)}


def test_train_run_finishes_with_artifacts(trained):
    rec = trained["record"]
    assert rec.steps == 10
    assert math.isfinite(rec.train_metrics["loss"])
    assert set(trained["val"]) == {"loss", "Acc@1", "Acc@5"}
    assert all(math.isfinite(v) for v in trained["val"].values())
    files = set(os.listdir(trained["run_dir"]))
    for name in ("config.yaml", "logs.txt", "commit_hash.txt", "diff.txt", "model.ckpt", "model_best.ckpt", "model_last.ckpt"):
        assert name in files, name
    with open(os.path.join(trained["run_dir"], "logs.txt")) as f:
        log = f.read()
    assert "Epoch   0 | Train loss" in log and "TensorBoard sinks are not ported yet" in log


def test_eval_of_last_checkpoint_reproduces_val_metrics(trained, tmp_path):
    ckpt = os.path.join(trained["run_dir"], "model_last.ckpt")
    metrics = cli.main(
        ["-c", CONFIG, *OVERRIDES, f"log.dir={tmp_path}", "run.evaluate=true", f"run.resume={ckpt}"], device="cpu"
    )
    assert metrics == trained["val"]


def test_resume_without_optimizer_state_keeps_fresh_step(trained):
    """model.ckpt is written without the optimizer (log.save_optim=false):
    restoring it loads weights but not the step, as the JAX package does."""
    from sota_imagenet_tpu_torch.models import resnet18
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.checkpoint import load_checkpoint

    disk = torch.load(os.path.join(trained["run_dir"], "model.ckpt"), weights_only=True)
    assert disk["state"]["optimizer"] is None and disk["state"]["step"] == 10
    state = steps.init_state(resnet18(), lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()), device="cpu")
    state, epoch = load_checkpoint(os.path.join(trained["run_dir"], "model.ckpt"), state)
    assert epoch == 0 and state.step == 0
    assert torch.equal(state.model.fc.weight, disk["state"]["model"]["fc.weight"])
    state, _ = load_checkpoint(os.path.join(trained["run_dir"], "model_last.ckpt"), state)
    assert state.step == 10  # the full checkpoint carries the optimizer and the step


def test_main_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", CONFIG, *OVERRIDES])


@pytest.mark.parametrize(
    "override",
    ["run.accumulate_steps=2", "mesh.data=2", "run.bn_stats=local", "weight_standardization=true",
     "loader.device_cache=true"],
)
def test_unported_options_raise(override, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-c", CONFIG, *OVERRIDES, override, f"log.dir={tmp_path}"], device="cpu")


FUSED = ["model={_target_: resnet50, fused_stats: true}"]


@pytest.fixture(scope="module")
def trained_fused(tmp_path_factory):
    from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats
    from sota_imagenet_tpu_torch.ops.fused_aug import fused_augment

    logdir = tmp_path_factory.mktemp("logs_fused")
    rec = _Record()
    launches = (conv1x1_stats.launches, fused_augment.launches)
    val = cli.main(["-c", CONFIG, *OVERRIDES, *FUSED, f"log.dir={logdir}"], device="cpu", callbacks=[rec])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_r50_baseline", "*"))
    return {
        "val": val,
        "record": rec,
        "run_dir": run_dir,
        "cuda_launches": (conv1x1_stats.launches - launches[0], fused_augment.launches - launches[1]),
    }


def test_fused_stats_train_run_finishes(trained_fused):
    """resnet50(fused_stats=True) trains through cli.main: 10 finite steps,
    the fused modules in the checkpoint, no kernel launched on the CPU."""
    rec = trained_fused["record"]
    assert rec.steps == 10 and math.isfinite(rec.train_metrics["loss"])
    assert all(math.isfinite(v) for v in trained_fused["val"].values())
    assert trained_fused["cuda_launches"] == (0, 0)
    disk = torch.load(os.path.join(trained_fused["run_dir"], "model_last.ckpt"), weights_only=True)
    keys = disk["state"]["model"]
    assert sum(k.endswith("running_var") and ".f" in k for k in keys) == 36  # fconv1/fconv3 x 16, fdown x 4
    assert not any(".conv3." in k or "downsample" in k for k in keys)


def test_fused_stats_eval_of_last_checkpoint_reproduces_val_metrics(trained_fused, tmp_path):
    ckpt = os.path.join(trained_fused["run_dir"], "model_last.ckpt")
    metrics = cli.main(
        ["-c", CONFIG, *OVERRIDES, *FUSED, f"log.dir={tmp_path}", "run.evaluate=true", f"run.resume={ckpt}"],
        device="cpu",
    )
    assert metrics == trained_fused["val"]
