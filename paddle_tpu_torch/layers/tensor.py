"""Tensor layers (``paddle_tpu/layers/tensor.py``): ``reshape``,
``transpose``, ``mean``, ``concat`` (:66-77), the elementwise layers with an optional
activation (:148-165, :180-195) and ``reduce_sum/mean/max/min``
(:198-223)."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper


def reshape(x, shape, **kwargs):
    helper = LayerHelper("reshape", **kwargs)
    out = helper.create_tmp_variable(x.dtype, tuple(shape))
    helper.append_op(type="reshape", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape)})
    return out


def transpose(x, perm, **kwargs):
    helper = LayerHelper("transpose", **kwargs)
    shape = tuple(x.shape[i] for i in perm) if x.shape else None
    out = helper.create_tmp_variable(x.dtype, shape)
    helper.append_op(type="transpose", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(perm)})
    return out


def concat(input, axis=0, **kwargs):
    helper = LayerHelper("concat", **kwargs)
    xs = list(input)
    shape = list(xs[0].shape) if xs[0].shape else None
    if shape is not None:
        shape[axis] = sum(v.shape[axis] for v in xs) if all(
            v.shape and v.shape[axis] is not None and v.shape[axis] >= 0
            for v in xs) else -1
    out = helper.create_tmp_variable(
        xs[0].dtype, tuple(shape) if shape else None, xs[0].lod_level)
    helper.append_op(type="concat", inputs={"X": xs}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return out


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


def _reduce(op_type):
    def layer(input, dim=0, keep_dim=False, reduce_all=False, **kwargs):
        helper = LayerHelper(op_type, **kwargs)
        shape = None
        if input.shape is not None:
            if reduce_all:
                shape = (1,) * len(input.shape) if keep_dim else ()
            elif keep_dim:
                shape = tuple(1 if i == dim else s
                              for i, s in enumerate(input.shape))
            else:
                shape = tuple(s for i, s in enumerate(input.shape)
                              if i != dim)
        out = helper.create_tmp_variable(input.dtype, shape)
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]},
                         attrs={"dim": dim, "keep_dim": keep_dim,
                                "reduce_all": reduce_all})
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
