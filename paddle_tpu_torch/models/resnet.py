"""ResNet (``paddle_tpu/models/resnet.py``): bottleneck ResNet-50/101/152
for ImageNet, basic blocks for CIFAR."""

from __future__ import annotations

from paddle_tpu_torch import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, bias_attr=False)
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def _shortcut(input, ch_in, ch_out, stride, is_test=False):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test)
    return input


def bottleneck_block(input, ch_in, ch_out, stride, is_test=False):
    short = _shortcut(input, ch_in, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def basic_block(input, ch_in, ch_out, stride, is_test=False):
    short = _shortcut(input, ch_in, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def _layer_group(block_fn, input, ch_in, ch_out, count, stride, is_test=False):
    out = block_fn(input, ch_in, ch_out, stride, is_test=is_test)
    in_ch = ch_out * (4 if block_fn is bottleneck_block else 1)
    for _ in range(count - 1):
        out = block_fn(out, in_ch, ch_out, 1, is_test=is_test)
    return out


_DEPTH_CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet_imagenet(input, class_dim: int = 1000, depth: int = 50,
                    is_test: bool = False):
    """Bottleneck ResNet over 3x224x224 NCHW input."""
    counts = _DEPTH_CFG[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test)
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max")
    res1 = _layer_group(bottleneck_block, pool1, 64, 64, counts[0], 1, is_test)
    res2 = _layer_group(bottleneck_block, res1, 256, 128, counts[1], 2, is_test)
    res3 = _layer_group(bottleneck_block, res2, 512, 256, counts[2], 2, is_test)
    res4 = _layer_group(bottleneck_block, res3, 1024, 512, counts[3], 2, is_test)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim: int = 10, depth: int = 32,
                   is_test: bool = False):
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    res1 = _layer_group(basic_block, conv1, 16, 16, n, 1, is_test)
    res2 = _layer_group(basic_block, res1, 16, 32, n, 2, is_test)
    res3 = _layer_group(basic_block, res2, 32, 64, n, 2, is_test)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")
