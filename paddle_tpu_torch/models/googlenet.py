"""GoogLeNet / Inception-v1 (``paddle_tpu/models/googlenet.py``): the
main tower of ``benchmark/run.py``'s googlenet cell, each inception
module's four branches concatenated on the channel axis, no auxiliary
heads."""

from paddle_tpu_torch import layers

__all__ = ["googlenet"]


def _conv(x, nf, k, pad=0, stride=1, act="relu"):
    return layers.conv2d(x, num_filters=nf, filter_size=k, padding=pad,
                         stride=stride, act=act)


def inception(x, c1, c3r, c3, c5r, c5, proj):
    """One inception module: 1x1 | 1x1->3x3 | 1x1->5x5 | pool->1x1."""
    b1 = _conv(x, c1, 1)
    b3 = _conv(_conv(x, c3r, 1), c3, 3, pad=1)
    b5 = _conv(_conv(x, c5r, 1), c5, 5, pad=2)
    bp = _conv(layers.pool2d(x, pool_size=3, pool_stride=1, pool_padding=1,
                             pool_type="max"), proj, 1)
    return layers.concat([b1, b3, b5, bp], axis=1)


def googlenet(input, class_dim: int = 1000, is_test: bool = False):
    """input: (B, 3, 224, 224) -> softmax over class_dim.  The stem is
    the 7x7 conv at stride 2 (the reference config's)."""
    x = _conv(input, 64, 7, pad=3, stride=2)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = _conv(x, 64, 1)
    x = _conv(x, 192, 3, pad=1)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = inception(x, 64, 96, 128, 16, 32, 32)      # 3a
    x = inception(x, 128, 128, 192, 32, 96, 64)    # 3b
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = inception(x, 192, 96, 208, 16, 48, 64)     # 4a
    x = inception(x, 160, 112, 224, 24, 64, 64)    # 4b
    x = inception(x, 128, 128, 256, 24, 64, 64)    # 4c
    x = inception(x, 112, 144, 288, 32, 64, 64)    # 4d
    x = inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    x = inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = inception(x, 384, 192, 384, 48, 128, 128)  # 5b
    # a global average pool, so that inputs under 224 keep a 1x1 map
    x = layers.pool2d(x, pool_size=7, pool_type="avg", global_pooling=True)
    x = layers.dropout(x, dropout_prob=0.4, is_test=is_test)
    return layers.fc(input=x, size=class_dim, act="softmax")
