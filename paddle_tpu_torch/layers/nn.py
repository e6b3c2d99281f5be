"""NN layers (``paddle_tpu/layers/nn.py``): fc (one input or several),
conv2d, pool2d,
batch_norm, the loss and metric layers of the training slice
(cross_entropy, topk, accuracy), and the transformer's embedding,
layer_norm, scaled_dot_product_attention, multi_head_attention and
softmax_with_cross_entropy, the sequence slice's fused ``lstm``
(``dynamic_lstm``), the image models' dropout and lrn, and the raw
``mul``, ``square_error_cost``, ``sigmoid_cross_entropy_with_logits``
and ``log_loss`` (wide_deep's loss), and the seq2seq decoder's
``gru_unit``."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["fc", "conv2d", "pool2d", "batch_norm", "cross_entropy", "topk",
           "accuracy", "embedding", "layer_norm",
           "scaled_dot_product_attention", "multi_head_attention",
           "softmax_with_cross_entropy", "lstm", "dynamic_lstm", "dropout",
           "lrn", "mul", "square_error_cost",
           "sigmoid_cross_entropy_with_logits", "log_loss", "gru_unit",
           "linear_chain_crf"]


def fc(input, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, name: Optional[str] = None,
       in_features_hints=None, **kwargs):
    """One ``mul`` per input by its own (in_features, size) weight, a
    ``sum`` of them where there are several, bias, act.  ``param_attr``
    may be a list, one per input; ``in_features_hints`` (one per input)
    gives the weight's rows where an input's feature dims are unknown."""
    inputs_list = list(input) if isinstance(input, (list, tuple)) else [input]
    hints_list = (list(in_features_hints) if in_features_hints is not None
                  else [None] * len(inputs_list))
    if isinstance(param_attr, (list, tuple)):
        attrs_list = list(param_attr)
        assert len(attrs_list) == len(inputs_list), \
            (len(attrs_list), len(inputs_list))
    else:
        attrs_list = [param_attr] * len(inputs_list)
    helper = LayerHelper("fc", param_attr=None, bias_attr=bias_attr,
                         act=act, name=name, **kwargs)
    dtype = inputs_list[0].dtype
    mul_results = []
    for inp, attr, hint in zip(inputs_list, attrs_list, hints_list):
        in_shape = inp.shape
        lead = in_shape[num_flatten_dims:] if in_shape is not None else ()
        if in_shape is None or any(s is None or s < 0 for s in lead):
            if hint is None:
                raise ValueError(
                    f"fc input {inp.name!r} has unknown feature dims past "
                    f"num_flatten_dims={num_flatten_dims}; the weight shape "
                    "must be static")
            in_features = int(hint)
        else:
            in_features = 1
            for s in lead:
                in_features *= s
        w = helper.create_parameter(attr, shape=[in_features, size],
                                    dtype=dtype)
        out_lead = (tuple(in_shape[:num_flatten_dims]) if in_shape is not None
                    else (-1,) * num_flatten_dims)
        tmp = helper.create_tmp_variable(dtype, out_lead + (size,),
                                         inp.lod_level)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype, mul_results[0].shape,
                                              mul_results[0].lod_level)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def dropout(x, dropout_prob: float, is_test: bool = False, seed=None,
            name=None, **kwargs):
    helper = LayerHelper("dropout", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    mask = helper.create_tmp_variable(x.dtype, x.shape)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test},
    )
    return out


def lrn(input, n=5, k=2.0, alpha=1e-4, beta=0.75, **kwargs):
    """MidOut is declared float32 whatever the input's dtype."""
    helper = LayerHelper("lrn", **kwargs)
    out = helper.create_tmp_variable(input.dtype, input.shape)
    mid = helper.create_tmp_variable("float32", input.shape)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


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


def embedding(input, size, is_sparse: bool = False, padding_idx=None,
              param_attr=None, dtype="float32", **kwargs):
    """size = [vocab, dim]: a ``lookup_table`` of a (vocab, dim) weight.
    With ``is_sparse`` the table's gradient is a ``SparseGrad`` of the
    looked-up rows, and Momentum, Adam and Adagrad update only those rows
    (SGD scatter-adds them)."""
    helper = LayerHelper("embedding", param_attr=param_attr, **kwargs)
    w = helper.create_parameter(
        param_attr, shape=list(size), dtype=dtype,
        default_initializer=NormalInitializer(0.0, 0.02),
    )
    out = helper.create_tmp_variable(
        dtype, tuple(input.shape[:-1]) + (size[1],), input.lod_level
    )
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "padding_idx": padding_idx},
    )
    return out


def layer_norm(input, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None, name=None,
               **kwargs):
    """LayerNorm over dims [begin_norm_axis:)."""
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name, **kwargs)
    dtype = input.dtype
    norm_shape = [int(s) for s in input.shape[begin_norm_axis:]]
    inputs = {"X": [input]}
    if scale:
        g = helper.create_parameter(
            param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [g]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape, dtype=dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_tmp_variable(dtype, input.shape, input.lod_level)
    mean = helper.create_tmp_variable("float32", input.shape[:begin_norm_axis])
    var = helper.create_tmp_variable("float32", input.shape[:begin_norm_axis])
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def scaled_dot_product_attention(q, k, v, causal: bool = False, name=None,
                                 **kwargs):
    """q, k, v: (B, S, H, D) -> (B, S, H, D)."""
    helper = LayerHelper("sdp_attention", name=name, **kwargs)
    out = helper.create_tmp_variable(q.dtype, q.shape, q.lod_level)
    helper.append_op(
        type="scaled_dot_product_attention",
        inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [out]},
        attrs={"causal": causal},
    )
    return out


def multi_head_attention(input, num_heads: int, causal: bool = False,
                         param_attr=None, tp_axis: Optional[str] = None,
                         name=None, **kwargs):
    """Self-attention block on (B, S, d_model): one qkv projection,
    ``split`` into q, k, v, heads by ``reshape``, attention, the heads
    merged by ``reshape``, the output projection.  ``tp_axis`` (Megatron
    sharding of the projections) waits for the parallel slice."""
    if tp_axis is not None:
        raise NotImplementedError(
            "paddle_tpu_torch: tensor-parallel sharding (tp_axis) comes with "
            "the parallel slice")
    B, S, d = input.shape
    if d % num_heads:
        raise ValueError(f"d_model {d} is not a multiple of num_heads "
                         f"{num_heads}")
    head_dim = d // num_heads
    qkv = fc(input, 3 * d, num_flatten_dims=2,
             param_attr=param_attr,
             bias_attr=False, name=name and name + "_qkv", **kwargs)
    helper = LayerHelper("mha", name=name, **kwargs)
    q = helper.create_tmp_variable(input.dtype, (B, S, d))
    k = helper.create_tmp_variable(input.dtype, (B, S, d))
    v = helper.create_tmp_variable(input.dtype, (B, S, d))
    helper.append_op(
        type="split", inputs={"X": [qkv]},
        outputs={"Out": [q, k, v]},
        attrs={"num": 3, "axis": 2},
    )
    heads = []
    for t in (q, k, v):
        rs = helper.create_tmp_variable(input.dtype,
                                        (B, S, num_heads, head_dim))
        helper.append_op(type="reshape", inputs={"X": [t]},
                         outputs={"Out": [rs]},
                         attrs={"shape": [0, 0, num_heads, head_dim]})
        heads.append(rs)
    ctx_out = scaled_dot_product_attention(*heads, causal=causal, **kwargs)
    merged = helper.create_tmp_variable(input.dtype, (B, S, d))
    helper.append_op(type="reshape", inputs={"X": [ctx_out]},
                     outputs={"Out": [merged]},
                     attrs={"shape": [0, 0, d]})
    return fc(merged, d, num_flatten_dims=2,
              param_attr=param_attr,
              bias_attr=False, name=name and name + "_proj", **kwargs)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               **kwargs):
    helper = LayerHelper("softmax_with_cross_entropy", **kwargs)
    softmax = helper.create_tmp_variable(logits.dtype, logits.shape)
    loss = helper.create_tmp_variable(logits.dtype,
                                      tuple(logits.shape[:-1]) + (1,))
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={"soft_label": soft_label},
    )
    return loss


def lstm(input, size: int, h0=None, c0=None, param_attr=None, bias_attr=None,
         use_peepholes: bool = False, is_reverse: bool = False,
         gate_activation="sigmoid", cell_activation="tanh",
         candidate_activation="tanh", lengths=None, **kwargs):
    """Fused LSTM over padded (B, T, 4*size) gate projections; pair with
    an fc(num_flatten_dims=2) for the input projection.  The outputs get
    the JAX layer's shapes (``paddle_tpu/layers/nn.py:544-584``), which
    read "time" from Input's second dim: for a LoD input (N, 4*size)
    that is 4*size, not a time axis (a fault of the reference's layer,
    kept so that the programs stay equal; the op itself takes LoD input
    correctly)."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         **kwargs)
    dtype = input.dtype
    w = helper.create_parameter(param_attr, shape=[size, 4 * size],
                                dtype=dtype)
    bias_size = 7 * size if use_peepholes else 4 * size
    b = helper.create_parameter(bias_attr, shape=[1, bias_size], dtype=dtype,
                                is_bias=True)
    batch = input.shape[0]
    time = input.shape[1]
    hidden = helper.create_tmp_variable(dtype, (batch, time, size))
    cell = helper.create_tmp_variable(dtype, (batch, time, size))
    bg = helper.create_tmp_variable(dtype, input.shape)
    bc = helper.create_tmp_variable(dtype, (batch, time, size))
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    if h0 is not None:
        inputs["H0"] = [h0]
    if c0 is not None:
        inputs["C0"] = [c0]
    if lengths is not None:
        # with is_reverse, the op reverses inside each row's valid window
        inputs["Length"] = [lengths]
    helper.append_op(
        type="lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell], "BatchGate": [bg],
                 "BatchCellPreAct": [bc]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation},
    )
    return hidden, cell


dynamic_lstm = lstm


def square_error_cost(input, label, **kwargs):
    """(input - label)^2, elementwise."""
    helper = LayerHelper("square_error_cost", **kwargs)
    minus_out = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]})
    sq = helper.create_tmp_variable(input.dtype, input.shape)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [sq]})
    return sq


def sigmoid_cross_entropy_with_logits(x, label, **kwargs):
    """Per-element sigmoid cross entropy of logits ``x``."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **kwargs)
    out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def log_loss(input, label, epsilon: float = 1e-4, **kwargs):
    """Negative log likelihood of a probability ``input``."""
    helper = LayerHelper("log_loss", **kwargs)
    out = helper.create_tmp_variable(input.dtype, input.shape,
                                     input.lod_level)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, **kwargs):
    """The raw ``mul`` op: x flattened to 2-D at ``x_num_col_dims`` times y
    flattened at ``y_num_col_dims``."""
    helper = LayerHelper("mul", **kwargs)
    shape = None
    if x.shape is not None and y.shape is not None:
        shape = (tuple(x.shape[:x_num_col_dims])
                 + tuple(y.shape[y_num_col_dims:]))
    out = helper.create_tmp_variable(x.dtype, shape)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def gru_unit(input, hidden, size: int, param_attr=None, bias_attr=None,
             activation: str = "tanh", **kwargs):
    """One GRU step (``gru_unit`` op).  ``size`` is 3 x the hidden width;
    ``input`` is the (B, size) projection.  Returns (Hidden,
    ResetHiddenPrev, Gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr, **kwargs)
    d = size // 3
    w = helper.create_parameter(param_attr, shape=[d, size],
                                dtype=input.dtype)
    ins = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if bias_attr is not False:  # False = no bias, the v1 idiom
        b = helper.create_parameter(
            bias_attr, shape=[size], dtype=input.dtype,
            default_initializer=ConstantInitializer(0.0))
        ins["Bias"] = [b]
    gate = helper.create_tmp_variable(input.dtype, (input.shape[0], size))
    rhp = helper.create_tmp_variable(input.dtype, (input.shape[0], d))
    out = helper.create_tmp_variable(input.dtype, (input.shape[0], d))
    helper.append_op(type="gru_unit",
                     inputs=ins,
                     outputs={"Gate": [gate], "ResetHiddenPrev": [rhp],
                              "Hidden": [out]},
                     attrs={"activation": activation})
    return out, rhp, gate


def linear_chain_crf(input, label, length=None, param_attr=None, **kwargs):
    """The linear-chain CRF's negative log-likelihood over padded
    emissions (B, T, D) with per-row lengths: the (B, 1) cost.  The
    transition parameter (D + 2, D), rows [start; end; pairwise], is
    named through ``param_attr``."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr, **kwargs)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[2 + num_tags, num_tags], dtype=input.dtype)
    batch = input.shape[0]
    ll = helper.create_tmp_variable(input.dtype, (batch, 1))
    alpha = helper.create_tmp_variable(input.dtype, (batch, num_tags))
    eexp = helper.create_tmp_variable(input.dtype, input.shape)
    texp = helper.create_tmp_variable(input.dtype, (2 + num_tags, num_tags))
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op(
        type="linear_chain_crf", inputs=inputs,
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [eexp], "TransitionExps": [texp]})
    return ll
