"""Sequence layers (``paddle_tpu/layers/sequence.py``): ``sequence_pool``
and its first- and last-step forms, ``sequence_softmax``,
``sequence_expand`` and ``sequence_conv``."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_pool", "sequence_softmax", "sequence_first_step",
           "sequence_last_step", "sequence_expand", "sequence_conv"]


def sequence_pool(input, pool_type: str, **kwargs):
    helper = LayerHelper("sequence_pool", **kwargs)
    # one row per sequence (batch, D): the lod collapses by a level
    shape = (-1,) + tuple(input.shape[1:]) if input.shape else None
    out = helper.create_tmp_variable(input.dtype, shape,
                                     max(input.lod_level - 1, 0))
    max_index = helper.create_tmp_variable("int32", shape)
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_first_step(input, **kwargs):
    return sequence_pool(input, "first", **kwargs)


def sequence_last_step(input, **kwargs):
    return sequence_pool(input, "last", **kwargs)


def sequence_softmax(input, **kwargs):
    helper = LayerHelper("sequence_softmax", **kwargs)
    out = helper.create_tmp_variable(input.dtype, input.shape, input.lod_level)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, **kwargs):
    helper = LayerHelper("sequence_expand", **kwargs)
    out = helper.create_tmp_variable(x.dtype, x.shape, y.lod_level)
    helper.append_op(type="seq_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def sequence_conv(input, num_filters, filter_size=3, act=None, param_attr=None,
                  bias_attr=None, lengths=None, **kwargs):
    """A context-window conv over sequence steps.  Padded (B, T, D) input,
    the JAX layer's program: ``context_project`` (rows past ``lengths``
    zeroed first), then a position-wise ``fc`` of ``num_filters``.  LoD
    (N, D) input, which the JAX layer refuses (it unpacks three dims):
    the ``sequence_conv`` op over the packed rows, a (filter_size D,
    num_filters) filter, then bias and ``act``, as fluid's layer builds
    it."""
    from paddle_tpu_torch.layers.nn import fc

    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, **kwargs)
    if input.lod_level and len(input.shape) == 2:
        filt = helper.create_parameter(
            helper.param_attr, shape=[filter_size * input.shape[1],
                                      num_filters], dtype=input.dtype)
        pre_bias = helper.create_tmp_variable(
            input.dtype, (-1, num_filters), input.lod_level)
        helper.append_op(
            type="sequence_conv", inputs={"X": [input], "Filter": [filt]},
            outputs={"Out": [pre_bias]},
            attrs={"contextStride": 1,
                   "contextStart": -int(filter_size // 2),
                   "contextLength": int(filter_size)})
        return helper.append_activation(helper.append_bias_op(pre_bias))
    B, T, D = input.shape
    expanded = helper.create_tmp_variable(input.dtype,
                                          (B, T, D * filter_size))
    ctx_ins = {"X": [input]}
    if lengths is not None:
        ctx_ins["Length"] = [lengths]
    helper.append_op(
        type="context_project", inputs=ctx_ins, outputs={"Out": [expanded]},
        attrs={"context_length": int(filter_size),
               "context_start": -(int(filter_size) // 2)})
    return fc(expanded, num_filters, num_flatten_dims=2,
              param_attr=param_attr, bias_attr=bias_attr, act=act, **kwargs)
