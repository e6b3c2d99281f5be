"""AlexNet (``paddle_tpu/models/alexnet.py``): the single-tower network
of ``benchmark/run.py``'s alexnet cell."""

from paddle_tpu_torch import layers


def alexnet(input, class_dim: int = 1000, is_test: bool = False):
    conv1 = layers.conv2d(input=input, num_filters=64, filter_size=11,
                          stride=4, padding=2, act="relu")
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2)
    norm1 = layers.lrn(pool1, n=5)
    conv2 = layers.conv2d(input=norm1, num_filters=192, filter_size=5,
                          padding=2, act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2)
    norm2 = layers.lrn(pool2, n=5)
    conv3 = layers.conv2d(input=norm2, num_filters=384, filter_size=3,
                          padding=1, act="relu")
    conv4 = layers.conv2d(input=conv3, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          padding=1, act="relu")
    pool3 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2)
    fc1 = layers.fc(input=pool3, size=4096, act="relu")
    d1 = layers.dropout(x=fc1, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=d1, size=4096, act="relu")
    d2 = layers.dropout(x=fc2, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=d2, size=class_dim, act="softmax")
