"""PyTorch/CUDA port of sota_imagenet_tpu for NVIDIA Hopper (H100).

The JAX package beside it is the reference; this package imports torch and
never jax, nor anything of sota_imagenet_tpu. Entry point:
``python -m sota_imagenet_tpu_torch.cli -c <yaml> [key=value ...]``.
"""
