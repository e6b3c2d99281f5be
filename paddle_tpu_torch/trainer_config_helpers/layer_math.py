"""v1 layer math (``paddle_tpu/trainer_config_helpers/layer_math.py``):
the unary math layers (each a one-projection mixed layer with the math
activation) and the ``+``, ``-`` and ``*`` overloads on ``LayerOutput``,
installed when this module is imported."""

from paddle_tpu_torch.trainer_config_helpers import activations as act
from paddle_tpu_torch.trainer_config_helpers.layers import (
    LayerOutput, identity_projection, mixed_layer, repeat_layer,
    scaling_layer, slope_intercept_layer)

__all__ = []


def _register_unary(op_name, activation):
    def op(input, name=None):
        with mixed_layer(size=input.size, name=name,
                         act=activation) as m:
            m += identity_projection(input=input)
        return m._lo

    op.__name__ = op_name
    globals()[op_name] = op
    __all__.append(op_name)


_register_unary("exp", act.ExpActivation())
_register_unary("log", act.LogActivation())
_register_unary("abs", act.AbsActivation())
_register_unary("sigmoid", act.SigmoidActivation())
_register_unary("tanh", act.TanhActivation())
_register_unary("square", act.SquareActivation())
_register_unary("relu", act.ReluActivation())
_register_unary("sqrt", act.SqrtActivation())
_register_unary("reciprocal", act.ReciprocalActivation())


def add(layeroutput, other):
    """A number: a slope_intercept_layer.  A layer of equal size: a mixed
    layer of two identity projections.  A size-1 layer: repeated to the
    other's size first."""
    if isinstance(other, (int, float)):
        return slope_intercept_layer(input=layeroutput, intercept=other)
    if not isinstance(other, LayerOutput):
        raise TypeError("LayerOutput can only be added with another "
                        "LayerOutput or a number")
    if layeroutput.size == other.size:
        with mixed_layer(size=layeroutput.size) as m:
            m += identity_projection(input=layeroutput)
            m += identity_projection(input=other)
        return m._lo
    if other.size != 1 and layeroutput.size != 1:
        raise ValueError(
            "two LayerOutputs can be added only with equal sizes or one "
            f"size-1 operand; got {layeroutput.size} and {other.size}")
    if layeroutput.size == 1:
        layeroutput, other = other, layeroutput
    rep = repeat_layer(input=other, num_repeats=layeroutput.size)
    with mixed_layer(size=layeroutput.size) as m:
        m += identity_projection(input=layeroutput)
        m += identity_projection(input=rep)
    return m._lo


LayerOutput.__radd__ = add
LayerOutput.__add__ = add


def sub(layeroutput, other):
    if isinstance(other, (int, float)):
        return slope_intercept_layer(input=layeroutput, intercept=-other)
    neg = slope_intercept_layer(input=other, slope=-1.0)
    return add(layeroutput, neg)


LayerOutput.__sub__ = sub


def rsub(layeroutput, other):
    neg = slope_intercept_layer(input=layeroutput, slope=-1.0)
    return add(neg, other)


LayerOutput.__rsub__ = rsub


def mul(layeroutput, other):
    """A number: a slope_intercept_layer; a size-1 layer: a
    scaling_layer."""
    if isinstance(other, (int, float)):
        return slope_intercept_layer(input=layeroutput, slope=other)
    if not isinstance(other, LayerOutput):
        raise TypeError("LayerOutput can only be multiplied by another "
                        "LayerOutput or a number")
    if other.size == 1:
        return scaling_layer(input=layeroutput, weight=other)
    if layeroutput.size == 1:
        return scaling_layer(input=other, weight=layeroutput)
    raise ValueError("layer multiplication needs a size-1 operand")


LayerOutput.__mul__ = mul
LayerOutput.__rmul__ = mul
