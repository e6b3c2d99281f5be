"""Tensor ops: fill_constant and the random initializers that the
startup program runs (``paddle_tpu/ops/tensor_ops.py:218/255/266``), and
the copies the backward pass emits: assign, cast, fill_zeros_like
(``:239-250``).

The random ops draw from a ``torch.Generator``: the run's generator, or
one seeded from the op's ``seed`` attr when that is set.  They never
reproduce jax's bits; tests that compare the two packages carry weights
over instead of re-running the initializers.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.common import torch_dtype, unary
from paddle_tpu_torch.registry import (SkipInferShape, infer_same_shape,
                                       register_op)


def _infer_attr_shape(op, block):
    # source ops whose static shape IS their "shape" attribute
    outs = op.outputs.get("Out", [])
    if len(outs) != 1:
        raise SkipInferShape
    ov = block.find_var(outs[0]) if outs[0] else None
    shape = op.attr("shape", None)
    if ov is None or not shape:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = tuple(int(s) for s in shape)


def _generator(ctx, device):
    seed = ctx.attr("seed", 0)
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return ctx.generator()


@register_op("fill_constant", inputs=(), stop_gradient=True,
             infer_shape=_infer_attr_shape)
def _fill_constant(ctx):
    shape = tuple(ctx.attr("shape", ()))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    ctx.set_output("Out", torch.full(shape, ctx.attr("value", 0.0),
                                     dtype=dtype, device=ctx.device))


@register_op("uniform_random", inputs=(), stop_gradient=True,
             infer_shape=_infer_attr_shape)
def _uniform_random(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.uniform_(lo, hi, generator=_generator(ctx, ctx.device))
    ctx.set_output("Out", out.to(dtype))


@register_op("gaussian_random", inputs=(), stop_gradient=True,
             infer_shape=_infer_attr_shape)
def _gaussian_random(ctx):
    shape = tuple(ctx.attr("shape"))
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    out = torch.empty(shape, dtype=torch.float32, device=ctx.device)
    out.normal_(ctx.attr("mean", 0.0), ctx.attr("std", 1.0),
                generator=_generator(ctx, ctx.device))
    ctx.set_output("Out", out.to(dtype))


@register_op("fill_zeros_like", inputs=("X",), stop_gradient=True,
             infer_shape=infer_same_shape)
def _fill_zeros_like(ctx):
    unary(ctx, torch.zeros_like)


@register_op("assign", inputs=("X",), infer_shape=infer_same_shape)
def _assign(ctx):
    ctx.set_output("Out", ctx.input("X"))


@register_op("cast", inputs=("X",), infer_shape=infer_same_shape)
def _cast(ctx):
    dtype = torch_dtype(ctx.attr("out_dtype", ctx.attr("dtype", "float32")))
    unary(ctx, lambda x: x.to(dtype))
