"""Layers API: build Programs with the same ops, names and attrs as
``paddle_tpu.layers``."""

from paddle_tpu_torch.layers.io import data
from paddle_tpu_torch.layers.nn import (accuracy, batch_norm, conv2d,
                                        cross_entropy, fc, pool2d, topk)
from paddle_tpu_torch.layers.tensor import (elementwise_add, elementwise_div,
                                            elementwise_mul, elementwise_sub,
                                            mean)

__all__ = ["data", "fc", "conv2d", "pool2d", "batch_norm", "cross_entropy",
           "topk", "accuracy", "mean", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div"]
