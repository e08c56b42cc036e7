"""Model zoo of the port. Registers the model target names configs use (with
the reference-compatible ``pytorch_tools.models.*`` aliases)."""

from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.models.cmodel import CModel, vgg16_bn
from sota_imagenet_tpu_torch.models.nfnet import NFBlock, NFNet, eca_nfnet_l0, eca_nfnet_l1
from sota_imagenet_tpu_torch.models.resnet import (
    BasicBlock, Bottleneck, ResNet, bresnet50, resnet18, resnet34, resnet50, resnet101,
)

registry.register("resnet18", aliases=("pytorch_tools.models.resnet18",))(resnet18)
registry.register("resnet34", aliases=("pytorch_tools.models.resnet34",))(resnet34)
registry.register("resnet50", aliases=("pytorch_tools.models.resnet50",))(resnet50)
registry.register("resnet101", aliases=("pytorch_tools.models.resnet101",))(resnet101)
registry.register("bresnet50")(bresnet50)
registry.register("eca_nfnet_l0", aliases=("timm.models.eca_nfnet_l0",))(eca_nfnet_l0)
registry.register("eca_nfnet_l1", aliases=("timm.models.eca_nfnet_l1",))(eca_nfnet_l1)
registry.register("NFNet")(NFNet)
registry.register("CModel", aliases=("src.model.CModel", "sota_imagenet.model.CModel", "cmodel"))(CModel)
registry.register("vgg16_bn", aliases=("timm.models.vgg16_bn", "pytorch_tools.models.vgg16_bn"))(vgg16_bn)

__all__ = [
    "BasicBlock", "Bottleneck", "CModel", "bresnet50", "NFBlock", "NFNet", "ResNet", "eca_nfnet_l0", "eca_nfnet_l1",
    "resnet18", "resnet34", "resnet50", "resnet101", "vgg16_bn",
]
