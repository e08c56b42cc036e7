"""Model zoo of the port. Registers the model target names configs use (with
the reference-compatible ``pytorch_tools.models.*`` aliases)."""

from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet, resnet18, resnet34, resnet50, resnet101

registry.register("resnet18", aliases=("pytorch_tools.models.resnet18",))(resnet18)
registry.register("resnet34", aliases=("pytorch_tools.models.resnet34",))(resnet34)
registry.register("resnet50", aliases=("pytorch_tools.models.resnet50",))(resnet50)
registry.register("resnet101", aliases=("pytorch_tools.models.resnet101",))(resnet101)

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet34", "resnet50", "resnet101"]
