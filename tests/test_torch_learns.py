"""The port learns: the colour task of
tests/test_e2e.py::test_loop_learns_separable_task (two classes, red-ish and
blue-ish 16 px images, a one-conv CModel, SGD at lr 0.05) through the port's
Runner, once fed by DeviceFeed and once by the device cache filled from the
same loader. Train Acc@1 must pass 95 within 6 epochs, the JAX test's
criterion: it catches sign errors in the loss, the gradient or the update,
and input corruption, which shape tests cannot."""

import numpy as np
import pytest
import torch

from sota_imagenet_tpu_torch.config import parse_stages
from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
from sota_imagenet_tpu_torch.data.pipeline import DeviceFeed, SyntheticLoader
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.ops.augment import build_val_augment
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.train.schedule import phases_from_stages


class ColorLoader(SyntheticLoader):
    """The JAX test's pool: 4 batches of 32, label 0 red-ish, 1 blue-ish."""

    def __init__(self):
        super().__init__(batch_size=32, image_size=16, num_classes=2, length=8, seed=0)
        rng = np.random.default_rng(1)
        labels = rng.integers(0, 2, size=(self._pool.shape[0], 32)).astype(np.int32)
        pool = np.zeros_like(self._pool)
        for i in range(pool.shape[0]):
            for j in range(32):
                base = (200, 40, 40) if labels[i, j] == 0 else (40, 40, 200)
                pool[i, j] = np.clip(rng.normal(0, 20, (16, 16, 3)) + base, 0, 255)
        self._pool = pool.astype(np.uint8)
        self._labels = labels


@pytest.mark.parametrize("feed", ["device_feed", "device_cache"])
def test_loop_learns_separable_task(feed):
    torch.manual_seed(0)
    model = CModel(
        layer_config=[
            {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
            {"module": "ReLU"},
            {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
            {"module": "Linear", "args": [8, 2]},
        ]
    )
    runner = Runner(
        model,
        CrossEntropyLoss(),
        lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters()),
        lr_phases=phases_from_stages(parse_stages([dict(start=0, end=6, lr=[0.05, 0.05])])),
        input_dtype=torch.float32,
        device="cpu",
    )
    runner.init_state(seed=0)
    aug = build_val_augment(num_classes=2, out_dtype=torch.float32)
    if feed == "device_feed":
        loader = DeviceFeed(ColorLoader(), aug, device="cpu", prefetch=1)
    else:
        loader = DeviceCacheFeed(ColorLoader(), aug, device="cpu")
    train_m, _ = runner.fit(loader, None, epochs=6, start_epoch=0)
    assert len(loader) == 8 and runner.epoch == 5
    assert train_m["Acc@1"] > 95.0, train_m


def test_narrow_nf_cmodel_with_lamb_learns_separable_task():
    """The norm-free family's pieces on the same task: ConvActBlocks, a VarEMA
    monitor and a NormFreeBlockTimm with ECA (the 24.nf_conv-act kinds, at
    widths 8-16), LAMB (lr 0.02, wd 5e-3, the gain mask), OrthoInit and the
    type-1 OrthoLoss, through the Runner."""
    from sota_imagenet_tpu_torch.train.callbacks import OrthoInitClb, OrthoLossClb
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    torch.manual_seed(0)
    model = CModel(
        layer_config=[
            [-1, 1, "ConvActBlock", [3, 8], {"stride": 2}],
            [-1, 1, "VarEMA"],
            [-1, 1, "NormFreeBlockTimm", [8, 16, 8], {"groups_width": 8, "attention_type": "eca9",
                                                      "regnet_attention": True}],
            [-1, 1, "FastGlobalAvgPool2d", [], {"flatten": True}],
            [-1, 1, "Linear", [16, 2]],
        ],
        extra_kwargs={"ConvActBlock": {"activation": "swish_hard", "conv_kwargs": {"gamma": 2, "gain_init": 0.1}},
                      "NormFreeBlockTimm": {"activation": "swish_hard", "conv_kwargs": {"gamma": 2}},
                      "VarEMA": {"use": False}},
    )
    mask = filter_from_weight_decay(model.named_parameters(), ["gain"])
    runner = Runner(
        model,
        CrossEntropyLoss(smoothing=0.1),
        lambda m: build_optimizer({"_target_": "badam", "lamb": True, "weight_decay": 5e-3}, m.named_parameters(),
                                  wd_mask=mask),
        lr_phases=phases_from_stages(parse_stages([dict(start=0, end=6, lr=[0.02, 0.02])])),
        callbacks=[OrthoInitClb(), OrthoLossClb(type=1, weight=1e-3, min_filters=8, min_norm=0.1)],
        input_dtype=torch.float32,
        device="cpu",
    )
    runner.init_state(seed=0)
    loader = DeviceFeed(ColorLoader(), build_val_augment(num_classes=2, out_dtype=torch.float32), device="cpu", prefetch=1)
    train_m, _ = runner.fit(loader, None, epochs=6, start_epoch=0)
    assert type(runner.state.optimizer).__name__ == "Lamb"
    assert train_m["Acc@1"] > 95.0, train_m


def test_narrow_nondeep_cmodel_with_agc_learns_separable_task():
    """The non-deep family's pieces on the same task: the SpaceToDepth-4 stem,
    NonDeepBlocks with BatchNorm and scaled convs (SEVar3, and UFO with its
    projection), a GEM head (80_1's kinds at width 16), SGD (lr 0.1, wd
    3e-5, the gain mask) with AGC at 0.1, through the Runner."""
    from sota_imagenet_tpu_torch.train.callbacks import AdaptiveGradientClipping
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    torch.manual_seed(0)
    model = CModel(
        layer_config=[
            [-1, 1, "SpaceToDepth", 4],
            [-1, 1, "NonDeepBlock", [48, 16]],
            [-1, 1, "NonDeepBlock", [16, 16], {"ufo_kwargs": {"residual": False, "last_proj": True, "num_heads": 4}}],
            [-1, 1, "NonDeepBlock", [16, 16]],
            [-1, 1, "GEM_pool"],
            [-1, 1, "Linear", [16, 2]],
        ],
        extra_kwargs={"NonDeepBlock": {"norm": "nn.BatchNorm2d", "scaled": True}},
    )
    mask = filter_from_weight_decay(model.named_parameters(), ["gain"])
    clip = AdaptiveGradientClipping(clip_factor=0.1)
    runner = Runner(
        model,
        CrossEntropyLoss(smoothing=0.1),
        lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}, m.named_parameters(),
                                  wd_mask=mask),
        lr_phases=phases_from_stages(parse_stages([dict(start=0, end=6, lr=[0.1, 0.1])])),
        callbacks=[clip],
        input_dtype=torch.float32,
        device="cpu",
    )
    runner.init_state(seed=0)
    clip.transform.record = True
    loader = DeviceFeed(ColorLoader(), build_val_augment(num_classes=2, out_dtype=torch.float32), device="cpu", prefetch=1)
    train_m, _ = runner.fit(loader, None, epochs=6, start_epoch=0)
    assert int(clip.transform.stats["clipped"]) > 0  # AGC was at work in the last step
    assert train_m["Acc@1"] > 95.0, train_m
