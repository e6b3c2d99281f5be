"""VGG-16 (``paddle_tpu/models/vgg.py``): five ``img_conv_group``s with
batch norm, then three fcs, as ``benchmark/run.py``'s vgg16 cell."""

from paddle_tpu_torch import layers, nets


def vgg16(input, class_dim: int = 1000, is_test: bool = False):
    def group(inp, nfs):
        return nets.img_conv_group(
            inp, conv_num_filter=nfs, pool_size=2, conv_padding=1,
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            pool_stride=2, pool_type="max")

    g1 = group(input, [64, 64])
    g2 = group(g1, [128, 128])
    g3 = group(g2, [256, 256, 256])
    g4 = group(g3, [512, 512, 512])
    g5 = group(g4, [512, 512, 512])
    fc1 = layers.fc(input=g5, size=4096, act="relu")
    d1 = layers.dropout(x=fc1, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=d1, size=4096, act="relu")
    d2 = layers.dropout(x=fc2, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=d2, size=class_dim, act="softmax")
