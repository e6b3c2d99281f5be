"""Layers API of the serving slice: build Programs with the same ops,
names and attrs as ``paddle_tpu.layers``."""

from paddle_tpu_torch.layers.io import data
from paddle_tpu_torch.layers.nn import batch_norm, conv2d, fc, pool2d
from paddle_tpu_torch.layers.tensor import (elementwise_add, elementwise_div,
                                            elementwise_mul, elementwise_sub)

__all__ = ["data", "fc", "conv2d", "pool2d", "batch_norm", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div"]
