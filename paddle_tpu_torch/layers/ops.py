"""The generated single-input layers (``paddle_tpu/layers/ops.py``): one
layer per unary op, each appending that op with the attrs it names.
Every op here is registered in the port (``ops/activation_ops.py``,
``ops/math_ops.py``)."""

from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

_UNARY = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "sqrt", "abs", "ceil",
    "floor", "round", "reciprocal", "log", "square", "softplus", "softsign",
    "tanh_shrink", "softmax", "sign",
]

_UNARY_ATTRS = {
    "leaky_relu": ("alpha",),
    "elu": ("alpha",),
    "relu6": ("threshold",),
    "pow": ("factor",),
    "stanh": ("scale_a", "scale_b"),
    "brelu": ("t_min", "t_max"),
    "soft_relu": ("threshold",),
    "hard_shrink": ("threshold",),
    "thresholded_relu": ("threshold",),
    "hard_sigmoid": ("slope", "offset"),
    "swish": ("beta",),
    "clip": ("min", "max"),
}

__all__ = list(_UNARY) + list(_UNARY_ATTRS)


def _make_unary(op_type, attr_names=()):
    def layer(x, *args, **kwargs):
        attrs = {}
        for i, a in enumerate(attr_names):
            if i < len(args):
                attrs[a] = args[i]
            elif a in kwargs:
                attrs[a] = kwargs.pop(a)
        helper = LayerHelper(op_type, **kwargs)
        out = helper.create_tmp_variable(x.dtype, x.shape, x.lod_level)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


for _n in _UNARY:
    globals()[_n] = _make_unary(_n)
for _n, _a in _UNARY_ATTRS.items():
    globals()[_n] = _make_unary(_n, _a)
