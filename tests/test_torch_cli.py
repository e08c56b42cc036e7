"""The port's training CLI end to end on the CPU: r50_baseline's recipe with
a ResNet-18 at 32 px (synthetic data, f32, debug: 10 train / 20 val steps,
one 1-epoch warmup stage), then an eval of its last checkpoint, which must
reproduce the run's final val metrics exactly. The same for a full-width
ResNet-50 with ``fused_stats`` (every 1x1 conv + BN through conv1x1_stats,
whose CPU path is the kernel's plain version).

Then ``configs/tiny_synthetic.yaml`` as it stands (a CModel, two debug
epochs: the train loss falls, and the eval+resume drive reproduces the final
val metrics exactly), and the NFNet/AdamW recipe ``15.eca_nfnet_l0.yaml``
(accumulation 2, CutmixMixup, EMA, drop rates, ``filter_from_wd: [gain]``)
with a narrow NFNet at 32 px, the norm-free recipe 41.nf_conv-act_lamb
with a narrow trunk, and the non-deep recipe 80_1 (AGC) at full width.
Last, the folder backend from a JPEG tree,
and ``configs/exp/r50_hbm_cache.yaml`` from packed records of that tree
through the device cache, train and val."""

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
    def on_begin(self):
        self.losses = []

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        self.train_metrics = dict(train_metrics)
        self.losses.append(train_metrics["loss"])
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
    assert "Epoch   0 | Train loss" in log
    # log.tensorboard defaults to true: the scalar sink's event file sits in the run dir
    assert any(name.startswith("events.out.tfevents.") for name in files)


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


@pytest.mark.parametrize("override", ["mesh.spatial=2", "mesh.model=2"])
def test_unported_options_raise(override, tmp_path):
    # both axes are ported (parallel/spatial.py, parallel/tp.py): one process cannot hold a mesh of two
    # ranks, and the CLI raises the JAX create_mesh's error (tests/test_torch_spatial.py and
    # tests/test_torch_tp.py train with them on two ranks)
    with pytest.raises(ValueError, match=r"1 devices not divisible by spatial\*model=2"):
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


# --------------------------------------------------------------------------- #
# tiny_synthetic (CModel) and the NFNet/AdamW recipe
# --------------------------------------------------------------------------- #

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
TINY = os.path.join(CONFIGS, "tiny_synthetic.yaml")
NFNET = os.path.join(CONFIGS, "exp", "15.eca_nfnet_l0.yaml")
NFNET_OVERRIDES = [
    "loader.backend=synthetic",
    "val_loader.backend=synthetic",
    "loader.image_size=32",
    "loader.batch_size=8",
    "val_loader.batch_size=8",
    "run.bf16=false",
    "debug=true",
    "model={_target_: NFNet, depths: [1, 1], channels: [32, 64], stem_chs: [8, 8, 8, 16], group_size: 16, "
    "drop_rate: 0.2, drop_path_rate: 0.15}",
    "run.stages=[{start: 0, end: 1, lr: [0, 0.01]}]",
]


@pytest.fixture(scope="module")
def trained_tiny(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("logs_tiny")
    rec = _Record()
    val = cli.main(["-c", TINY, f"log.dir={logdir}"], device="cpu", callbacks=[rec])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_tiny_synthetic", "*"))
    return {"val": val, "record": rec, "run_dir": run_dir}


def test_tiny_synthetic_trains_with_a_falling_loss(trained_tiny):
    rec = trained_tiny["record"]
    assert rec.steps == 20 and len(rec.losses) == 2  # two debug epochs of 10 steps
    assert all(math.isfinite(v) for v in rec.losses) and rec.losses[1] < rec.losses[0] - 0.05
    files = set(os.listdir(trained_tiny["run_dir"]))
    assert {"config.yaml", "logs.txt", "model.ckpt", "model_last.ckpt"} <= files
    disk = torch.load(os.path.join(trained_tiny["run_dir"], "model_last.ckpt"), weights_only=True)
    assert "layers.1.1.conv.gain" in disk["state"]["model"]  # the CModel's layer list, repeat included


def test_tiny_synthetic_eval_of_last_checkpoint_reproduces_val_metrics(trained_tiny, tmp_path):
    ckpt = os.path.join(trained_tiny["run_dir"], "model_last.ckpt")
    metrics = cli.main(["-c", TINY, f"log.dir={tmp_path}", "run.evaluate=true", f"run.resume={ckpt}"], device="cpu")
    assert metrics == trained_tiny["val"]


# AdamP (config 51's decay), unit-wise SAM (config 32's) and the TensorBoard sinks on tiny_synthetic
ADAMP_SAM = ["optim={_target_: adamp, weight_decay: 1e-2}", "log.tensorboard=true", "log.save_optim=true",
             "run.extra_callbacks=[{_target_: SAM, unitwise: true, rho: 0.01}, {_target_: GradDistributionTB, "
             "log_every: 5}]"]


@pytest.fixture(scope="module")
def trained_tiny_adamp_sam(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("logs_tiny_adamp_sam")
    rec = _Record()
    val = cli.main(["-c", TINY, *ADAMP_SAM, f"log.dir={logdir}"], device="cpu", callbacks=[rec])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_tiny_synthetic", "*"))
    return {"val": val, "record": rec, "run_dir": run_dir}


def test_tiny_synthetic_with_adamp_sam_and_tensorboard_trains(trained_tiny_adamp_sam):
    rec = trained_tiny_adamp_sam["record"]
    assert rec.steps == 20 and all(math.isfinite(v) for v in rec.losses) and rec.losses[1] < rec.losses[0]
    files = set(os.listdir(trained_tiny_adamp_sam["run_dir"]))
    assert any(name.startswith("events.out.tfevents.") for name in files)
    disk = torch.load(os.path.join(trained_tiny_adamp_sam["run_dir"], "model_last.ckpt"), weights_only=True)
    state = disk["state"]["optimizer"]["state"]
    assert disk["state"]["step"] == 20 and {"exp_avg", "exp_avg_sq", "step"} <= set(state[0])


def test_tiny_synthetic_with_adamp_sam_eval_of_last_checkpoint_reproduces_val_metrics(trained_tiny_adamp_sam,
                                                                                       tmp_path):
    ckpt = os.path.join(trained_tiny_adamp_sam["run_dir"], "model_last.ckpt")
    metrics = cli.main(["-c", TINY, *ADAMP_SAM, f"log.dir={tmp_path}", "run.evaluate=true", f"run.resume={ckpt}"],
                       device="cpu")
    assert metrics == trained_tiny_adamp_sam["val"]


@pytest.fixture(scope="module")
def trained_nfnet(tmp_path_factory):
    logdir = tmp_path_factory.mktemp("logs_nfnet")
    rec = _Record()
    val = cli.main(["-c", NFNET, *NFNET_OVERRIDES, f"log.dir={logdir}"], device="cpu", callbacks=[rec])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_eca_nfnet_l0", "*"))
    return {"val": val, "record": rec, "run_dir": run_dir}


def test_nfnet_recipe_runs_to_model_last(trained_nfnet):
    """accumulate_steps 2, CutmixMixup, EMA 0.9997, AdamW and the gain mask through cli.main."""
    rec = trained_nfnet["record"]
    assert rec.steps == 10 and math.isfinite(rec.train_metrics["loss"])
    assert all(math.isfinite(v) for v in trained_nfnet["val"].values())
    disk = torch.load(os.path.join(trained_nfnet["run_dir"], "model_last.ckpt"), weights_only=True)["state"]
    model, ema = disk["model"], disk["ema"]
    assert set(model) == set(ema) and all(v.is_floating_point() for v in ema.values())
    # ten AdamW steps moved the weights, and the EMA (decay 0.9997) lags them
    moved = [k for k in model if not torch.equal(model[k], ema[k])]
    assert len(moved) == len(model)
    # two parameter groups: the mask keeps gains and the other 1-d leaves out of the decay
    groups = disk["optimizer"]["param_groups"]
    assert [g["weight_decay"] for g in groups] == [1e-3, 0.0]
    n_no_decay = sum(1 for v in model.values() if v.dim() <= 1)
    assert len(groups[1]["params"]) == n_no_decay and len(groups[0]["params"]) == len(model) - n_no_decay
    assert all(int(s["step"]) == 10 for s in disk["optimizer"]["state"].values())  # one optimizer step per train step


def test_nfnet_eval_of_last_checkpoint_reads_the_weights_and_its_ema_reproduces_val_metrics(trained_nfnet, tmp_path):
    """A run with an EMA validates with the EMA weights; run.evaluate scores
    the checkpoint's own weights (Runner.evaluate's default, as in the JAX
    CLI). So the checkpoint's EMA, put in the weights' place, reproduces the
    run's final val metrics exactly (eval draws nothing random), and the
    checkpoint as saved scores differently: ten AdamW steps against an EMA
    of decay 0.9997 that has barely left the initial weights."""
    ckpt = os.path.join(trained_nfnet["run_dir"], "model_last.ckpt")
    disk = torch.load(ckpt, weights_only=True)
    disk["state"]["model"] = disk["state"]["ema"]
    swapped = os.path.join(tmp_path, "ema_as_model.ckpt")
    torch.save(disk, swapped)

    def evaluate(path):
        return cli.main(
            ["-c", NFNET, *NFNET_OVERRIDES, f"log.dir={tmp_path}", "run.evaluate=true", f"run.resume={path}"],
            device="cpu",
        )

    assert evaluate(swapped) == trained_nfnet["val"]
    metrics = evaluate(ckpt)
    assert set(metrics) == {"loss", "Acc@1", "Acc@5"} and all(math.isfinite(v) for v in metrics.values())
    assert metrics["loss"] != trained_nfnet["val"]["loss"]
    assert evaluate(ckpt) == metrics


NF_LAMB = os.path.join(CONFIGS, "exp", "41.nf_conv-act_lamb.yaml")
NF_LAMB_OVERRIDES = [
    "loader.backend=synthetic",
    "val_loader.backend=synthetic",
    "loader.image_size=32",
    "loader.batch_size=8",
    "val_loader.batch_size=8",
    "run.bf16=false",
    "debug=true",
    "model.layer_config=[[-1, 1, ConvActBlock, [3, 8], {stride: 2}], [-1, 1, VarEMA], "
    "[-1, 1, ConvActBlock, [8, 16], {stride: 2}], [-1, 1, VarEMA], [-1, 1, NormFreeBlockTimm, [16, 32, 16]], "
    "[-1, 1, VarEMA], [-1, 1, scaled_conv1x1, [32, 64]], [-1, 1, 'torch.nn.SiLU'], "
    "[-1, 1, FastGlobalAvgPool2d, [], {flatten: true}], [-1, 1, 'torch.nn.Dropout', [0.2]], [-1, 1, nn.Linear, [64, 1000]]]",
    "run.stages=[{start: 0, end: 1, lr: [0.003, 0], lr_mode: cos}]",
]


class _OrthoProbe(_Record):
    """Reads the kernels at on_begin, after OrthoInitClb's (the CLI's own callbacks come first)."""

    def on_begin(self):
        super().on_begin()
        from sota_imagenet_tpu_torch.utils.weights import kernel_parameters

        def gram_error(w):
            m = w.detach().double().reshape(w.shape[0], -1)
            g = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
            return float((g - torch.eye(g.shape[0], dtype=g.dtype)).abs().max())

        self.ortho_errors = [gram_error(w) for w in kernel_parameters(self.runner.state.model).values()]
        self.ema_init = {k: v.clone() for k, v in self.runner.state.ema.state_dict().items()} if self.runner.state.ema else None

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        super().on_epoch_end(epoch, train_metrics, val_metrics)
        self.optimizer = type(self.runner.state.optimizer).__name__


def test_nf_lamb_recipe_runs_with_ortho_init_ortho_loss_and_lamb(tmp_path):
    """41.nf_conv-act_lamb.yaml (LAMB through badam, wd 5e-3, the gain mask,
    CutmixMixup, OrthoInitClb, OrthoLossClb type 1, VarEMA monitors, drop-path)
    through cli.main with a narrow trunk at 32 px."""
    probe = _OrthoProbe()
    val = cli.main(["-c", NF_LAMB, *NF_LAMB_OVERRIDES, f"log.dir={tmp_path}"], device="cpu", callbacks=[probe])
    assert probe.steps == 10 and math.isfinite(probe.train_metrics["loss"]) and all(math.isfinite(v) for v in val.values())
    # 2 ConvActBlock convs, 4 NormFreeBlockTimm convs, its ECA, the 1x1 head conv, the Linear
    assert probe.optimizer == "Lamb" and len(probe.ortho_errors) == 9 and max(probe.ortho_errors) < 1e-5
    (run_dir,) = glob.glob(os.path.join(tmp_path, "*_nf_conv_act_lamb", "*"))
    disk = torch.load(os.path.join(run_dir, "model_last.ckpt"), weights_only=True)["state"]
    assert [g["weight_decay"] for g in disk["optimizer"]["param_groups"]] == [5e-3, 0.0]
    std_emas = [v for k, v in disk["model"].items() if k.endswith("std_ema")]
    assert len(std_emas) == 3 and all(abs(float(v) - 1.0) > 1e-3 for v in std_emas)  # the monitors moved


NONDEEP = os.path.join(CONFIGS, "exp", "80_1.non-deeps_ufo-0.5_no-res.yaml")
NONDEEP_OVERRIDES = [
    "loader.backend=synthetic",
    "val_loader.backend=synthetic",
    "loader.image_size=32",
    "val_loader.image_size=32",
    "loader.batch_size=4",
    "val_loader.batch_size=4",
    "run.bf16=false",
    "debug=true",
    "run.stages=[{start: 0, end: 1, lr: [0.1, 0], lr_mode: cos}]",
]


class _AGCProbe(_Record):
    """Reads the step options the Runner built the stage's step from, and turns on AGC's record."""

    def on_begin(self):
        super().on_begin()
        self.options = self.runner._collect_step_options()
        self.options["grad_transform"].record = True

    def on_epoch_end(self, epoch, train_metrics, val_metrics):
        super().on_epoch_end(epoch, train_metrics, val_metrics)
        self.stats = {k: float(v) for k, v in self.options["grad_transform"].stats.items()}
        self.kinds = {type(m).__name__ for m in self.runner.state.model.modules()}


def test_non_deep_recipe_runs_with_agc_at_full_width(tmp_path):
    """80_1.non-deeps_ufo-0.5_no-res.yaml through cli.main: the full-width
    non-deep CModel (SpaceToDepth 4, 14 NonDeepBlocks, 4 with UFO, the fat
    head) at 32 px, SGD, CutmixMixup and AGC 0.01 (``clip_factor``)."""
    from sota_imagenet_tpu_torch.optim.factory import AGC

    probe = _AGCProbe()
    val = cli.main(["-c", NONDEEP, *NONDEEP_OVERRIDES, f"log.dir={tmp_path}"], device="cpu", callbacks=[probe])
    assert probe.steps == 10 and math.isfinite(probe.train_metrics["loss"]) and all(math.isfinite(v) for v in val.values())
    assert {"grad_transform", "mixup_fn"} <= set(probe.options) and isinstance(probe.options["grad_transform"], AGC)
    assert probe.options["grad_transform"].clipping == 0.01
    assert 0 < probe.stats["clipped"] <= probe.stats["units"] and probe.stats["max_ratio_after"] <= 1.0 + 1e-6
    assert {"NonDeepBlock", "UFO", "SEVar3", "SpaceToDepth", "ScaledStdConv", "BatchNorm"} <= probe.kinds
    (run_dir,) = glob.glob(os.path.join(tmp_path, "*_non-deeps_ufo_proj_ufo-0.5_no-res_agc", "*"))
    disk = torch.load(os.path.join(run_dir, "model_last.ckpt"), weights_only=True)["state"]
    assert sum(v.numel() for k, v in disk["model"].items() if not k.endswith(("running_mean", "running_var"))) == 24_811_912


@pytest.mark.parametrize(
    "callback",
    ["SAMOriginal", "src.callbacks.SAM", "WeightDistributionTB", "SpectralDistributionTB", "GradDistributionTB",
     "Profiler"],
)
def test_ported_callbacks_run_in_the_cli(callback, tmp_path):
    """The SAM callbacks, the TensorBoard sinks and the Profiler (its default
    window, from step 10, lies past the run's ten steps) build and train."""
    rec = _Record()
    cli.main(["-c", CONFIG, *OVERRIDES, f"run.extra_callbacks=[{{_target_: {callback}}}]", f"log.dir={tmp_path}"],
             device="cpu", callbacks=[rec])
    assert rec.steps == 10 and math.isfinite(rec.train_metrics["loss"])


@pytest.mark.parametrize(
    "model, takes_it",
    [
        ("{_target_: resnet18}", True),
        ("{_target_: NFNet, depths: [1], channels: [32], stem_chs: [8, 8, 8, 16], group_size: 16}", False),
        ("{_target_: CModel, layer_config: [[-1, 1, ConvBnAct, [3, 8]]]}", False),
    ],
    ids=["resnet18", "nfnet", "cmodel"],
)
def test_bn_momentum_reaches_only_models_that_take_it(model, takes_it):
    """cfg.bn_momentum != 0.1 is passed to the model; one that does not take the
    keyword is built without it, as the JAX CLI does (cli.py:170-178)."""
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.models.norms import BatchNorm

    cfg = C.load(CONFIG, overrides=[f"model={model}", "bn_momentum=0.03"], strict_env=False)
    built = cli.build_model(cfg)
    momenta = {m.momentum for m in built.modules() if isinstance(m, BatchNorm)}
    assert momenta == ({0.03} if takes_it else momenta - {0.03})
    if takes_it:
        assert momenta


# --------------------------------------------------------------------------- #
# tiny_synthetic from an ImageFolder tree of JPEGs (the folder backend)
# --------------------------------------------------------------------------- #

N_FOLDER_TRAIN, N_FOLDER_VAL = 40, 13


def _write_folder_tree(root):
    """root/{train,val}/class_<c>/*: 32-96 px JPEGs of low-frequency content,
    the class tied to the colour; one PNG and one grayscale JPEG per split."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, n in (("train", N_FOLDER_TRAIN), ("val", N_FOLDER_VAL)):
        for i in range(n):
            c = i % 4
            os.makedirs(os.path.join(root, split, f"class_{c}"), exist_ok=True)
            w, h = (int(v) for v in rng.integers(32, 97, 2))
            base = np.clip(rng.integers(0, 64, (4, 5, 3)) + np.array([60 * c, 200 - 50 * c, 120]), 0, 255)
            img = Image.fromarray(base.astype(np.uint8)).resize((w, h), Image.BILINEAR)
            stem = os.path.join(root, split, f"class_{c}", f"{i:03d}")
            if i == 3:
                img.save(stem + ".png")
            elif i == 4:
                img.convert("L").save(stem + ".jpg", quality=90)
            else:
                img.save(stem + ".jpg", quality=90)
    return str(root)


def _folder_overrides(root):
    return ["loader.backend=folder", "val_loader.backend=folder", f"loader.root_data_dir={root}",
            f"val_loader.root_data_dir={root}", "loader.batch_size=8", "val_loader.batch_size=5",
            "loader.workers=2", "val_loader.workers=2"]


class _EvalProbe(Callback):
    """Wraps the Runner's eval steps once they are built, recording each val
    batch's real sample count (``_weight``) and batch size."""

    def on_begin(self):
        self.passes = []

    def on_epoch_begin(self, epoch):
        self.passes.append([])
        for name in ("_eval_step", "_eval_step_ema"):
            step = getattr(self.runner, name)
            if getattr(step, "probed", False):
                continue

            def probed(state, batch, step=step):
                m = step(state, batch)
                self.passes[-1].append((float(m["_weight"]), batch["image"].shape[0]))
                return m

            probed.probed = True
            setattr(self.runner, name, probed)


@pytest.fixture(scope="module")
def trained_folder(tmp_path_factory):
    root = _write_folder_tree(tmp_path_factory.mktemp("imagefolder"))
    logdir = tmp_path_factory.mktemp("logs_folder")
    rec, probe = _Record(), _EvalProbe()
    val = cli.main(["-c", TINY, *_folder_overrides(root), f"log.dir={logdir}"], device="cpu", callbacks=[rec, probe])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_tiny_synthetic", "*"))
    return {"val": val, "record": rec, "probe": probe, "run_dir": run_dir, "root": root}


def test_folder_backend_trains_and_scores_every_val_image_once(trained_folder):
    rec, probe = trained_folder["record"], trained_folder["probe"]
    assert rec.steps == 2 * (N_FOLDER_TRAIN // 8) and len(rec.losses) == 2  # two epochs of 5 full batches
    assert all(math.isfinite(v) for v in (*rec.losses, *trained_folder["val"].values()))
    assert set(trained_folder["val"]) == {"loss", "Acc@1", "Acc@5"}
    assert len(probe.passes) == 2
    for batches in probe.passes:  # 13 images: two full batches of 5 and a tail of 3 padded to 5
        assert batches == [(5.0, 5), (5.0, 5), (3.0, 5)]
    assert os.path.exists(os.path.join(trained_folder["run_dir"], "model_last.ckpt"))


def test_folder_backend_eval_of_last_checkpoint_reproduces_val_metrics(trained_folder, tmp_path):
    ckpt = os.path.join(trained_folder["run_dir"], "model_last.ckpt")
    metrics = cli.main(
        ["-c", TINY, *_folder_overrides(trained_folder["root"]), f"log.dir={tmp_path}", "run.evaluate=true",
         f"run.resume={ckpt}"],
        device="cpu",
    )
    assert metrics == trained_folder["val"]


def test_rectangular_val_with_device_resample_runs(trained_folder, tmp_path):
    val = cli.main(
        ["-c", TINY, *_folder_overrides(trained_folder["root"]), f"log.dir={tmp_path}", "loader.device_resample=true",
         "val_loader.rectangular=true", "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]"],
        device="cpu",
    )
    assert set(val) == {"loss", "Acc@1", "Acc@5"} and all(math.isfinite(v) for v in val.values())


def test_imagenet_dir_resolves_alike_in_both_config_loaders(trained_folder, monkeypatch):
    """``root_data_dir: ${env:IMAGENET_DIR}`` (config.py:69 of the JAX package)
    resolves to the same path in both loaders, and the auto backend then
    finds the folder tree; unset, both leave the same placeholder."""
    from sota_imagenet_tpu import config as JC
    from sota_imagenet_tpu_torch import config as TC
    from sota_imagenet_tpu_torch.data import pipeline as P

    monkeypatch.delenv("IMAGENET_DIR", raising=False)
    unset = (TC.load(CONFIG, strict_env=False), JC.load(CONFIG, strict_env=False))
    assert unset[0].loader.root_data_dir == unset[1].loader.root_data_dir
    monkeypatch.setenv("IMAGENET_DIR", trained_folder["root"])
    cfg, jcfg = TC.load(CONFIG, strict_env=False), JC.load(CONFIG, strict_env=False)
    for split in ("loader", "val_loader"):
        assert cfg[split].root_data_dir == jcfg[split].root_data_dir == trained_folder["root"]
    assert isinstance(P._build_host_loader(cfg.loader, True), P.FolderLoader)
    assert isinstance(P._build_host_loader(cfg.val_loader, False), P.FolderLoader)


# --------------------------------------------------------------------------- #
# r50_hbm_cache.yaml: packed records of the tree, through the device cache
# --------------------------------------------------------------------------- #

HBM_CACHE = os.path.join(CONFIGS, "exp", "r50_hbm_cache.yaml")


@pytest.fixture(scope="module")
def trained_cache(trained_folder, tmp_path_factory):
    """The tree packed at 32 px by the records CLI, then r50_hbm_cache.yaml
    (use_packed and device_cache for train and val) with IMAGENET_DIR at the
    packed tree, a ResNet-18 and one 2-epoch stage."""
    packed = str(tmp_path_factory.mktemp("packed"))
    cli.records_main(["packed", trained_folder["root"], "--out", packed, "--size", "32", "--workers", "1"])
    logdir = tmp_path_factory.mktemp("logs_cache")
    overrides = ["model={_target_: resnet18, num_classes: 4}", "loader.image_size=32", "loader.num_classes=4",
                 "val_loader.num_classes=4", "loader.batch_size=8", "val_loader.batch_size=5", "run.bf16=false",
                 "loader.fill_chunk_mb=0.01", "run.stages=[{start: 0, end: 2, lr: [0.05, 0.0]}]"]
    rec, probe = _Record(), _EvalProbe()
    epochs = []

    class Metrics(Callback):
        def on_epoch_end(self, epoch, train_metrics, val_metrics):
            epochs.append(dict(train_metrics))

    from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed

    sweeps = {True: 0, False: 0}  # epochs iterated through a cache, by is_train
    original = DeviceCacheFeed.__iter__

    def counted(feed):
        sweeps[feed.is_train] += 1
        return original(feed)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IMAGENET_DIR", packed)
        mp.setattr(DeviceCacheFeed, "__iter__", counted)
        val = cli.main(["-c", HBM_CACHE, *overrides, f"log.dir={logdir}"], device="cpu", callbacks=[rec, probe, Metrics()])
    (run_dir,) = glob.glob(os.path.join(logdir, "*_r50_hbm_cache", "*"))
    return {"val": val, "record": rec, "probe": probe, "epochs": epochs, "run_dir": run_dir, "packed": packed,
            "overrides": overrides, "sweeps": sweeps}


def test_hbm_cache_config_trains_from_packed_records(trained_cache):
    assert trained_cache["sweeps"] == {True: 2, False: 2}, "train and val went through the cache, two epochs each"
    rec, probe, epochs = trained_cache["record"], trained_cache["probe"], trained_cache["epochs"]
    assert rec.steps == 2 * (N_FOLDER_TRAIN // 8) and all(math.isfinite(v) for v in rec.losses)
    for batches in probe.passes:  # 13 cached val images: 5 + 5 + 3 of a padded 5, each epoch
        assert batches == [(5.0, 5), (5.0, 5), (3.0, 5)]
    assert epochs[0]["cache_mb"] == N_FOLDER_TRAIN * 32 * 32 * 3 / 1e6 and epochs[0]["cache_fill_s"] > 0
    assert "cache_mb" not in epochs[1]
    assert all(math.isfinite(v) for v in trained_cache["val"].values())
    assert os.path.exists(os.path.join(trained_cache["run_dir"], "model_last.ckpt"))


def test_hbm_cache_eval_of_last_checkpoint_reproduces_val_metrics(trained_cache, tmp_path, monkeypatch):
    monkeypatch.setenv("IMAGENET_DIR", trained_cache["packed"])
    ckpt = os.path.join(trained_cache["run_dir"], "model_last.ckpt")
    metrics = cli.main(["-c", HBM_CACHE, *trained_cache["overrides"], f"log.dir={tmp_path}", "run.evaluate=true",
                        f"run.resume={ckpt}"], device="cpu")
    assert metrics == trained_cache["val"]
