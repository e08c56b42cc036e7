from sota_imagenet_tpu_torch import registry
from sota_imagenet_tpu_torch.losses.base import Loss, StatefulLoss, SumLoss, WeightedLoss, call_criterion
from sota_imagenet_tpu_torch.losses.smooth import CrossEntropyLoss

registry.register(
    "cross_entropy",
    aliases=(
        "pytorch_tools.losses.smooth.CrossEntropyLoss",
        "CrossEntropyLoss",
        # legacy 'a-softmax' / normalized CE: the criterion side is plain
        # (tempered / normalized) CE
        "a-softmax",
        "normalized_ce",
    ),
)(CrossEntropyLoss)

__all__ = ["CrossEntropyLoss", "Loss", "StatefulLoss", "SumLoss", "WeightedLoss", "call_criterion"]
