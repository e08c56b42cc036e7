"""The slice's configs through the port's CLI on the CPU at a tiny size
(synthetic data, float32, debug: 10 train and 20 val steps):

  * ``configs/exp/adacos_sphere.yaml`` (the ConvActBlock CModel, its
    SphereLinearLayer head and AdaCos) at 32 px: the loss state moves, is
    saved in ``model_last.ckpt``, and the eval of that checkpoint reproduces
    the run's final val metrics exactly (the eval reads the restored state);
  * ``configs/exp/r50_fixmatch.yaml`` and ``r50_hard_negative.yaml`` with a
    ResNet-18 at 32 px: their criteria (FixMatchLoss; HardNegativeWrapper
    over BinaryKLDivLoss) train to a finite loss and a checkpoint;
  * ``configs/exp/66.conv-mix_original.yaml`` with its ConvMixer cut to 32
    channels and two blocks at 32 px.
"""

import glob
import math
import os

import pytest
import torch

from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.train.callbacks import Callback

EXP = os.path.join(os.path.dirname(__file__), "..", "configs", "exp")
TINY = ["loader.backend=synthetic", "val_loader.backend=synthetic", "loader.image_size=32", "val_loader.image_size=32",
        "loader.batch_size=8", "val_loader.batch_size=8", "run.bf16=false", "debug=true", "log.tensorboard=false"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: several pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Record(Callback):
    def on_begin(self):
        self.initial_loss_state = {k: float(v) for k, v in (self.runner.state.loss_state or {}).items()}

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        self.train_metrics = dict(train_metrics)
        self.steps = self.runner.state.step
        self.loss_state = {k: v.clone() for k, v in (self.runner.state.loss_state or {}).items()}


def _run(config, overrides, logdir):
    rec = _Record()
    val = cli.main(["-c", os.path.join(EXP, config), *TINY, *overrides, f"log.dir={logdir}"], device="cpu",
                   callbacks=[rec])
    (ckpt,) = glob.glob(os.path.join(logdir, "*", "*", "model_last.ckpt"))
    return val, rec, ckpt


def test_adacos_sphere_trains_saves_its_loss_state_and_eval_reproduces_val(tmp_path):
    stages = "run.stages=[{start: 0, end: 1, lr: [0.001, 0.5]}]"  # the recipe's warmup, cut to the one debug epoch
    val, rec, ckpt = _run("adacos_sphere.yaml", [stages], tmp_path / "train")
    assert rec.steps == 10 and math.isfinite(rec.train_metrics["loss"])
    assert rec.initial_loss_state == {"running_B": 1000.0, "running_cos": pytest.approx(0.7), "prev_s": 20.0}
    moved = {k: float(v) for k, v in rec.loss_state.items()}
    assert moved["running_B"] != 1000.0 and all(math.isfinite(v) for v in moved.values())
    saved = torch.load(ckpt, weights_only=True)["state"]["loss_state"]
    assert all(torch.equal(saved[k], v) for k, v in rec.loss_state.items())
    again = cli.main(["-c", os.path.join(EXP, "adacos_sphere.yaml"), *TINY, stages, f"log.dir={tmp_path / 'eval'}",
                      "run.evaluate=true", f"run.resume={ckpt}"], device="cpu")
    assert again == val


@pytest.mark.parametrize("config", ["r50_fixmatch.yaml", "r50_hard_negative.yaml"])
def test_loss_recipes_train_with_a_resnet18(config, tmp_path):
    val, rec, _ = _run(config, ["model={_target_: resnet18}", "run.stages=[{start: 0, end: 1, lr: [0.001, 0.5]}]"],
                       tmp_path)
    assert rec.steps == 10 and math.isfinite(rec.train_metrics["loss"])
    assert set(val) == {"loss", "Acc@1", "Acc@5"} and all(math.isfinite(v) for v in val.values())


def test_conv_mixer_recipe_trains_cut_to_two_blocks(tmp_path):
    layers = ("model.layer_config=[[-1, 1, nn.Conv2d, [3, 32, 4], {stride: 4}], [-1, 1, nn.GELU], "
              "[-1, 1, nn.BatchNorm2d, 32], [-1, 2, ConvMixerBlock, [32, 7]], "
              "[-1, 1, pt.modules.FastGlobalAvgPool2d, [], {flatten: True}], [-1, 1, nn.Linear, [32, 1000]]]")
    val, rec, _ = _run("66.conv-mix_original.yaml", [layers, "run.stages=[{start: 0, end: 1, lr: [0.001, 0.1]}]"],
                       tmp_path)
    assert rec.steps == 10 and math.isfinite(rec.train_metrics["loss"])
    assert all(math.isfinite(v) for v in val.values())
