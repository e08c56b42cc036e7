from sota_imagenet_tpu_torch.optim.factory import build_optimizer, sgd

__all__ = ["build_optimizer", "sgd"]
