"""NN layers (``paddle_tpu/layers/nn.py``): fc, conv2d, pool2d,
batch_norm, and the loss and metric layers of the training slice:
cross_entropy, topk, accuracy."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["fc", "conv2d", "pool2d", "batch_norm", "cross_entropy", "topk",
           "accuracy"]


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, name: Optional[str] = None,
       **kwargs):
    """One input: ``mul`` by a (in_features, size) weight, bias, act."""
    helper = LayerHelper("fc", param_attr=None, bias_attr=bias_attr,
                         act=act, name=name, **kwargs)
    dtype = input.dtype
    lead = input.shape[num_flatten_dims:] if input.shape is not None else None
    if lead is None or any(s is None or s < 0 for s in lead):
        raise ValueError(
            f"fc input {input.name!r} has unknown feature dims past "
            f"num_flatten_dims={num_flatten_dims}; the weight shape must "
            "be static")
    in_features = 1
    for s in lead:
        in_features *= s
    w = helper.create_parameter(param_attr, shape=[in_features, size],
                                dtype=dtype)
    tmp = helper.create_tmp_variable(
        dtype, tuple(input.shape[:num_flatten_dims]) + (size,),
        input.lod_level)
    helper.append_op(
        type="mul",
        inputs={"X": [input], "Y": [w]},
        outputs={"Out": [tmp]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
    )
    pre_act = helper.append_bias_op(tmp, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def _conv_out_size(size, k, p, s, d=1):
    if size is None or size < 0:
        return -1
    ke = (k - 1) * d + 1
    return (size + 2 * p - ke) // s + 1


def conv2d(input, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
           act: Optional[str] = None, name: Optional[str] = None, **kwargs):
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name, **kwargs)
    dtype = input.dtype
    fs = filter_size if isinstance(filter_size, (list, tuple)) else (filter_size, filter_size)
    st = stride if isinstance(stride, (list, tuple)) else (stride, stride)
    pd = padding if isinstance(padding, (list, tuple)) else (padding, padding)
    dl = dilation if isinstance(dilation, (list, tuple)) else (dilation, dilation)
    n, c, h, w = input.shape
    filt = helper.create_parameter(
        param_attr,
        shape=[num_filters, c // groups, fs[0], fs[1]],
        dtype=dtype,
        default_initializer=NormalInitializer(
            0.0, (2.0 / (fs[0] * fs[1] * (c // groups))) ** 0.5
        ),
    )
    out_shape = (
        n,
        num_filters,
        _conv_out_size(h, fs[0], pd[0], st[0], dl[0]),
        _conv_out_size(w, fs[1], pd[1], st[1], dl[1]),
    )
    pre_bias = helper.create_tmp_variable(dtype, out_shape)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [filt]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(st), "paddings": list(pd), "dilations": list(dl),
               "groups": groups},
    )
    # per-channel bias, broadcast along axis=1 (N, C, H, W)
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool_out_extent(size, k, p, s, ceil_mode=False):
    """Pool output extent along one dim (floor or ceil).  Returns -1 for
    an unknown input size."""
    if size is None or size < 0:
        return -1
    span = size + 2 * p - k
    return (-(-span // s) if ceil_mode else span // s) + 1


def pool_extra_padding(size, k, p, s):
    """Extra high-side padding that realises a ceil-mode extent in a
    floor-mode window reduction."""
    out = pool_out_extent(size, k, p, s, ceil_mode=True)
    return max(0, (out - 1) * s + k - (size + 2 * p))


def pool2d(input, pool_size=2, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling: bool = False, exclusive: bool = False,
           ceil_mode: bool = False, name=None, **kwargs):
    helper = LayerHelper("pool2d", name=name, **kwargs)
    ks = pool_size if isinstance(pool_size, (list, tuple)) else (pool_size, pool_size)
    st = pool_stride if isinstance(pool_stride, (list, tuple)) else (pool_stride, pool_stride)
    pd = pool_padding if isinstance(pool_padding, (list, tuple)) else (pool_padding, pool_padding)
    n, c, h, w = input.shape
    if global_pooling:
        out_shape = (n, c, 1, 1)
    else:
        out_shape = (
            n, c,
            pool_out_extent(h, ks[0], pd[0], st[0], ceil_mode),
            pool_out_extent(w, ks[1], pd[1], st[1], ceil_mode),
        )
    out = helper.create_tmp_variable(input.dtype, out_shape)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": list(ks), "strides": list(st),
               "paddings": list(pd), "global_pooling": global_pooling,
               "exclusive": exclusive, "ceil_mode": ceil_mode},
    )
    return out


def batch_norm(input, act=None, is_test: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None, moving_mean_name=None,
               moving_variance_name=None, **kwargs):
    helper = LayerHelper("batch_norm", act=act, name=name, **kwargs)
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype, is_bias=True)
    # running stats: persistable but not trainable
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, initializer=ConstantInitializer(0.0),
                  trainable=False),
        shape=[c], dtype="float32")
    variance = helper.create_parameter(
        ParamAttr(name=moving_variance_name, initializer=ConstantInitializer(1.0),
                  trainable=False),
        shape=[c], dtype="float32")
    saved_mean = helper.create_tmp_variable("float32", (c,))
    saved_var = helper.create_tmp_variable("float32", (c,))
    out = helper.create_tmp_variable(dtype, input.shape)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout},
    )
    return helper.append_activation(out)


def cross_entropy(input, label, soft_label: bool = False, **kwargs):
    helper = LayerHelper("cross_entropy", **kwargs)
    out = helper.create_tmp_variable(input.dtype,
                                     tuple(input.shape[:-1]) + (1,),
                                     input.lod_level)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label},
    )
    return out


def topk(input, k: int = 1, **kwargs):
    helper = LayerHelper("top_k", **kwargs)
    vals = helper.create_tmp_variable(input.dtype,
                                      tuple(input.shape[:-1]) + (k,))
    idx = helper.create_tmp_variable("int64", tuple(input.shape[:-1]) + (k,))
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [vals], "Indices": [idx]},
                     attrs={"k": k})
    return vals, idx


def accuracy(input, label, k: int = 1, **kwargs):
    helper = LayerHelper("accuracy", **kwargs)
    vals, idx = topk(input, k=k, **kwargs)
    acc = helper.create_tmp_variable("float32", (1,))
    correct = helper.create_tmp_variable("int32", ())
    total = helper.create_tmp_variable("int32", ())
    helper.append_op(
        type="accuracy",
        inputs={"Out": [vals], "Indices": [idx], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]},
    )
    return acc
