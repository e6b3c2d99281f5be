"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``mean`` and the
elementwise layers with an optional activation (:165, :180-195)."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper


def mean(x, **kwargs):
    helper = LayerHelper("mean", **kwargs)
    out = helper.create_tmp_variable(x.dtype, ())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, **kwargs):
        helper = LayerHelper(op_type, act=act, **kwargs)
        out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
