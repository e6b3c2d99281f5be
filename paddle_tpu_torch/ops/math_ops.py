"""Dense math ops of the serving slice: ``mul`` and the elementwise
family (``paddle_tpu/ops/math_ops.py:142/186``)."""

from __future__ import annotations

import functools

import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import matmul as kmatmul
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import elementwise
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)


def _static_numel(shape):
    """Product of dims, or None if any is dynamic."""
    n = 1
    for d in shape:
        if d is None or d < 0:
            return None
        n *= d
    return n


def _infer_mul_shape(op, block):
    """Out keeps X's leading dims and Y's trailing dims; the contracted
    extents must agree when both are static."""
    xv = block.find_var(op.input("X")[0]) if op.input("X") else None
    yv = block.find_var(op.input("Y")[0]) if op.input("Y") else None
    ov = block.find_var(op.output("Out")[0]) if op.output("Out") else None
    if xv is None or yv is None or ov is None:
        raise SkipInferShape
    if xv.shape is None or yv.shape is None:
        raise SkipInferShape
    xn = op.attr("x_num_col_dims", 1)
    yn = op.attr("y_num_col_dims", 1)
    if not (0 < xn <= len(xv.shape) and 0 < yn <= len(yv.shape)):
        raise ValueError(
            f"num_col_dims ({xn}, {yn}) out of range for shapes "
            f"{xv.shape} x {yv.shape}")
    k_x = _static_numel(xv.shape[xn:])
    k_y = _static_numel(yv.shape[:yn])
    if k_x is not None and k_y is not None and k_x != k_y:
        raise ValueError(
            f"contracted extents differ: X{list(xv.shape)} flattened at "
            f"{xn} gives K={k_x}, Y{list(yv.shape)} flattened at {yn} "
            f"gives K={k_y}")
    if ov.shape is None:
        ov.shape = tuple(xv.shape[:xn]) + tuple(yv.shape[yn:])


def _flatten2d(x, num_col_dims):
    lead = 1
    for s in x.shape[:num_col_dims]:
        lead *= s
    return torch.reshape(x, (lead, -1))


@register_op("mul", inputs=("X", "Y"), infer_shape=_infer_mul_shape)
def _mul(ctx):
    """Flattening matmul: X flattened to 2-D at x_num_col_dims, Y at
    y_num_col_dims, then the ``matmul`` kernel."""
    x = unwrap(ctx.input("X"))
    y = unwrap(ctx.input("Y"))
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    out_dt = amp.out_dtype(x)
    x2, y2 = amp.cast_operands(_flatten2d(x, xn), _flatten2d(y, yn))
    out = kmatmul.matmul(x2.contiguous(), y2.contiguous()).to(out_dt)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    ctx.set_output("Out", rewrap(ctx.input("X"), torch.reshape(out, out_shape)))


for name, fn in [
    ("elementwise_add", torch.add),
    ("elementwise_sub", torch.sub),
    ("elementwise_mul", torch.mul),
    ("elementwise_div", torch.div),
    ("elementwise_max", torch.maximum),
    ("elementwise_min", torch.minimum),
    ("elementwise_pow", torch.pow),
]:
    # Out mirrors X: Y's dims align to a run of X's
    register_op(name, inputs=("X", "Y"), infer_shape=infer_same_shape)(
        functools.partial(lambda ctx, f: elementwise(ctx, f), f=fn))
