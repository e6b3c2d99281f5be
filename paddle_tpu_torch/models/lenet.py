"""LeNet-5 (``paddle_tpu/models/lenet.py``)."""

from paddle_tpu_torch import layers, nets


def lenet5(img, class_dim: int = 10):
    c1 = nets.simple_img_conv_pool(img, num_filters=20, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    c2 = nets.simple_img_conv_pool(c1, num_filters=50, filter_size=5,
                                   pool_size=2, pool_stride=2, act="relu")
    return layers.fc(input=c2, size=class_dim, act="softmax")
