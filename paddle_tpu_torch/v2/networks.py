"""The v2 network compositions (``paddle_tpu/v2/networks.py``):
``simple_img_conv_pool``, ``simple_lstm``, ``bidirectional_lstm`` and
``stacked_lstm`` over the v2 layers, and every other name of the v1
``trainer_config_helpers.networks.__all__`` (``img_conv_group``,
``sequence_conv_pool``, ...) resolved through the module's
``__getattr__``.  The names this module defines win."""

from __future__ import annotations

from paddle_tpu_torch.v2 import layer as L
from paddle_tpu_torch.v2.pooling import Max


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride, act=None, num_channel=None, **kwargs):
    conv = L.img_conv(input=input, filter_size=filter_size,
                      num_filters=num_filters, num_channels=num_channel,
                      act=act)
    return L.img_pool(input=conv, pool_size=pool_size, stride=pool_stride,
                      pool_type=Max())


def simple_lstm(input, size, reverse=False, **kwargs):
    """A bias-free fc to 4 x size, then lstmemory."""
    proj = L.fc(input=input, size=size * 4, bias_attr=False)
    return L.lstmemory(input=proj, size=size, reverse=reverse)


def bidirectional_lstm(input, size, return_seq=False, **kwargs):
    fwd = simple_lstm(input, size)
    bwd = simple_lstm(input, size, reverse=True)
    if return_seq:
        return L.concat([fwd, bwd])
    return L.concat([L.last_seq(fwd), L.first_seq(bwd)])


def stacked_lstm(input, size, depth=2, **kwargs):
    x = input
    for _ in range(depth):
        x = simple_lstm(x, size)
    return x


def __getattr__(name):
    # the public names of the v1 networks module; never a dunder (that
    # would hand this module's star-import the v1 __all__) or a private
    if name.startswith("_"):
        raise AttributeError(
            f"module 'paddle_tpu_torch.v2.networks' has no attribute "
            f"{name!r}")
    from paddle_tpu_torch.trainer_config_helpers import networks as _v1n

    if name in _v1n.__all__:
        return getattr(_v1n, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.v2.networks' has no attribute {name!r}")
