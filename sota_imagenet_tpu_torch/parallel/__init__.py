"""Data parallelism over ``torch.distributed`` (port of ``sota_imagenet_tpu/parallel``)."""
