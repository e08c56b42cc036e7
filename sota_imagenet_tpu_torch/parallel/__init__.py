"""The mesh over ``torch.distributed``: data parallelism, spatial partitioning and head TP (port of ``sota_imagenet_tpu/parallel``)."""
