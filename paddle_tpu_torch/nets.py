"""Composite network helpers (``paddle_tpu/nets.py``):
``simple_img_conv_pool``, ``img_conv_group``, ``sequence_conv_pool`` and
``glu``."""

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


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=None,
                   pool_stride=1, pool_type="max"):
    """Convs (each with batch norm and dropout where asked), then a pool,
    as ``paddle_tpu/nets.py:16-38`` builds them (VGG's groups)."""
    tmp = input
    n = len(conv_num_filter)
    if not isinstance(conv_padding, (list, tuple)):
        conv_padding = [conv_padding] * n
    if not isinstance(conv_with_batchnorm, (list, tuple)):
        conv_with_batchnorm = [conv_with_batchnorm] * n
    if conv_batchnorm_drop_rate is None:
        conv_batchnorm_drop_rate = [0.0] * n
    elif not isinstance(conv_batchnorm_drop_rate, (list, tuple)):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * n
    for i, nf in enumerate(conv_num_filter):
        local_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(input=tmp, num_filters=nf,
                            filter_size=conv_filter_size,
                            padding=conv_padding[i], act=local_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(x=tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(input=tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, act="sigmoid",
                       pool_type="max"):
    """``sequence_conv`` then ``sequence_pool``.  The pool needs LoD rows,
    so this runs over LoD input (the JAX helper, whose conv takes padded
    input only, runs over neither)."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    """Gated linear unit: input split in two halves a, b along ``dim``,
    a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))
