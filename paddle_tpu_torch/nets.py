"""Composite network helpers (``paddle_tpu/nets.py``)."""

from __future__ import annotations

from paddle_tpu_torch import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act=None, param_attr=None,
                         pool_type="max"):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)
