"""Model zoo of the port. Registers every model target name of the JAX
package's zoo (``sota_imagenet_tpu/models/__init__.py``), with the
reference-compatible aliases (``pytorch_tools.models.*``, ``timm.models.*``)."""

from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.models import bnet, extras
from sota_imagenet_tpu_torch.models.bnet import BNet, BNetBlock
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

# --- the BNet family (legacy ``arch:`` names, JAX models/__init__.py:19-26) ---
registry.register("BNet", aliases=("bnet",))(bnet.bnet)
registry.register("simpl_resnet34")(bnet.simpl_resnet34)
registry.register("simpl_resnet50")(bnet.simpl_resnet50)
registry.register("simpl_preactresnet34")(bnet.simpl_preactresnet34)
registry.register("csp_simpl_resnet34")(bnet.csp_simpl_resnet34)
registry.register("simpl_dark")(bnet.simpl_dark)
registry.register("csp_simpl_dark")(bnet.csp_simpl_dark)
registry.register("GENet_normal", aliases=("genet_normal",))(bnet.genet_normal)


# --- the SE and ResNeXt ResNets (JAX models/__init__.py:29-67): the port's ResNet with their options ---
def _variant(layers, defaults, kwargs):
    kwargs.pop("pretrained", None)
    kw = {**defaults, **kwargs}
    if kw.pop("deep_stem", False):  # the legacy model_params' flag (se_resnet50_better.yaml)
        kw["stem_type"] = "deep"
    return ResNet(block=Bottleneck, layers=layers, **kw)


def se_resnet50(**kwargs):
    """SE-ResNet-50 (legacy ``arch: se_resnet50``)."""
    return _variant((3, 4, 6, 3), {"attn_type": "se"}, kwargs)


def resnext50_32x4d(**kwargs):
    return _variant((3, 4, 6, 3), {"groups": 32, "base_width": 4}, kwargs)


def resnext101_32x4d(**kwargs):
    """ResNeXt-101 32x4d (legacy ``arch: resnext101_32x4d``)."""
    return _variant((3, 4, 23, 3), {"groups": 32, "base_width": 4}, kwargs)


def se_resnext50_32x4d(**kwargs):
    return _variant((3, 4, 6, 3), {"groups": 32, "base_width": 4, "attn_type": "se"}, kwargs)


registry.register("se_resnet50", aliases=("pytorch_tools.models.se_resnet50",))(se_resnet50)
registry.register("resnext50_32x4d")(resnext50_32x4d)
registry.register("resnext101_32x4d")(resnext101_32x4d)
registry.register("se_resnext50_32x4d")(se_resnext50_32x4d)

# --- the legacy one-off architectures (models/extras.py; JAX models/__init__.py:70-74) ---
registry.register("darknet53", aliases=("timm_darknet53",))(extras.darknet53)
registry.register("cspdarknet53", aliases=("timm_cspdarknet53",))(extras.cspdarknet53)
registry.register("densenet121")(extras.densenet121)
registry.register("efficientnet_b0", aliases=("effnetb0", "effnetb0_tf"))(extras.efficientnet_b0)
registry.register("tresnetm")(extras.tresnetm)

registry.register("vgg16_bn", aliases=("timm.models.vgg16_bn", "pytorch_tools.models.vgg16_bn"))(vgg16_bn)
registry.register("CModel", aliases=("src.model.CModel", "sota_imagenet.model.CModel", "cmodel"))(CModel)

__all__ = [
    "BasicBlock", "BNet", "BNetBlock", "Bottleneck", "CModel", "bresnet50", "NFBlock", "NFNet", "ResNet",
    "eca_nfnet_l0", "eca_nfnet_l1", "resnet18", "resnet34", "resnet50", "resnet101", "resnext50_32x4d",
    "resnext101_32x4d", "se_resnet50", "se_resnext50_32x4d", "vgg16_bn",
]
