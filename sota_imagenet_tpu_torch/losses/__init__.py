"""The criteria of the port, registered under the JAX package's names and
aliases (``sota_imagenet_tpu/losses/__init__.py``): the legacy flat-schema
criterion names of configs/_old_configs sit beside the canonical ones."""

from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.losses.angular import (
    AdaCos,
    AdditiveAngularMarginLoss,
    AngularPenaltySMLoss,
    ArcCosSoftmax,
    ArcCosSoftmaxCenter,
    DSoftmax_intra,
    LargeMarginCosineLoss,
    MyLoss1,
    NegativeContrastive,
    SphereCosMAELoss,
    SphereLinearLayer,
    SphereMAELoss,
    SphereMLPLayer,
)
from sota_imagenet_tpu_torch.losses.base import FnLoss, Loss, StatefulLoss, SumLoss, WeightedLoss, call_criterion
from sota_imagenet_tpu_torch.losses.smooth import (
    BinaryFocalLoss,
    BinaryKLDivLoss,
    CrossEntropyLoss,
    FocalLoss,
    SigmoidLoss,
)
from sota_imagenet_tpu_torch.losses.wrappers import FixMatchLoss, HardNegativeWrapper

registry.register(
    "cross_entropy",
    aliases=(
        "pytorch_tools.losses.smooth.CrossEntropyLoss",
        "CrossEntropyLoss",
        # legacy 'a-softmax' / normalized CE: the sphere head is the model's, the criterion plain
        # (tempered / normalized) CE
        "a-softmax",
        "normalized_ce",
    ),
)(CrossEntropyLoss)
registry.register("focal", aliases=("pytorch_tools.losses.FocalLoss", "FocalLoss"))(FocalLoss)
# a-focal: BinaryFocalLoss with a temperature (exp91)
registry.register("binary_focal", aliases=("BinaryFocalLoss", "a-focal"))(BinaryFocalLoss)
registry.register(
    "binary_kl", aliases=("pytorch_tools.losses.BinaryKLDivLoss", "BinaryKLDivLoss", "kld")
)(BinaryKLDivLoss)
registry.register("sigmoid_loss", aliases=("SigmoidLoss", "sigmoid"))(SigmoidLoss)
registry.register("hard_negative", aliases=("src.utils.HardNegativeWrapper", "HardNegativeWrapper"))(
    HardNegativeWrapper
)
registry.register("fixmatch", aliases=("src.utils.FixMatchLoss", "FixMatchLoss"))(FixMatchLoss)
# 'mlp_adacos' (exp102) is the AdaCos criterion; its MLP projector is the model's SphereMLPLayer
registry.register("adacos", aliases=("src.angular_losses.AdaCos", "AdaCos", "mlp_adacos"))(AdaCos)
registry.register("arcface", aliases=("src.angular_losses.AdditiveAngularMarginLoss", "AdditiveAngularMarginLoss"))(
    AdditiveAngularMarginLoss
)
registry.register("cosface", aliases=("src.angular_losses.LargeMarginCosineLoss", "LargeMarginCosineLoss"))(
    LargeMarginCosineLoss
)
registry.register("angular_penalty", aliases=("src.angular_losses.AngularPenaltySMLoss", "AngularPenaltySMLoss"))(
    AngularPenaltySMLoss
)
registry.register("sphere_mae", aliases=("SphereMAELoss",))(SphereMAELoss)
registry.register("sphere_cos_mae", aliases=("SphereCosMAELoss",))(SphereCosMAELoss)
registry.register("negative_contrastive", aliases=("NegativeContrastive",))(NegativeContrastive)
registry.register("dsoftmax_intra", aliases=("DSoftmax_intra",))(DSoftmax_intra)
registry.register("myloss1", aliases=("MyLoss1", "my_loss_1"))(MyLoss1)
registry.register("arccos_softmax", aliases=("ArcCosSoftmax", "arc-softmax"))(ArcCosSoftmax)
registry.register("arccos_softmax_center", aliases=("ArcCosSoftmaxCenter", "arc-softmax-center"))(
    ArcCosSoftmaxCenter
)

__all__ = [
    "AdaCos", "AdditiveAngularMarginLoss", "AngularPenaltySMLoss", "ArcCosSoftmax", "ArcCosSoftmaxCenter",
    "BinaryFocalLoss", "BinaryKLDivLoss", "CrossEntropyLoss", "DSoftmax_intra", "FixMatchLoss", "FnLoss",
    "FocalLoss", "HardNegativeWrapper", "LargeMarginCosineLoss", "Loss", "MyLoss1", "NegativeContrastive",
    "SigmoidLoss", "SphereCosMAELoss", "SphereLinearLayer", "SphereMAELoss", "SphereMLPLayer", "StatefulLoss",
    "SumLoss", "WeightedLoss", "call_criterion",
]
