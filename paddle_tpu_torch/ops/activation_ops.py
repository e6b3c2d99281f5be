"""Activation ops (``paddle_tpu/ops/activation_ops.py``), as torch
one-liners."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import unary
from paddle_tpu_torch.registry import infer_same_shape, register_op


def _reg(name, fn, with_attrs):
    @register_op(name, inputs=("X",), infer_shape=infer_same_shape)
    def _act(ctx):
        unary(ctx, (lambda x: fn(x, ctx)) if with_attrs else fn)


_SIMPLE = {
    "sigmoid": torch.sigmoid,
    "logsigmoid": F.logsigmoid,
    "exp": torch.exp,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sqrt": torch.sqrt,
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,
    "reciprocal": lambda x: 1.0 / x,
    "log": torch.log,
    "square": torch.square,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "tanh_shrink": lambda x: x - torch.tanh(x),
}

_WITH_ATTRS = {
    "leaky_relu": lambda x, ctx: torch.where(
        x >= 0, x, x * ctx.attr("alpha", 0.02)),
    "elu": lambda x, ctx: torch.where(
        x >= 0, x, ctx.attr("alpha", 1.0) * (torch.exp(x) - 1)),
    "relu6": lambda x, ctx: torch.clamp(x, 0.0, ctx.attr("threshold", 6.0)),
    "pow": lambda x, ctx: torch.pow(x, ctx.attr("factor", 1.0)),
    "stanh": lambda x, ctx: ctx.attr("scale_b", 1.7159) * torch.tanh(
        ctx.attr("scale_a", 2.0 / 3.0) * x),
    "brelu": lambda x, ctx: torch.clamp(
        x, ctx.attr("t_min", 0.0), ctx.attr("t_max", 24.0)),
    "soft_relu": lambda x, ctx: torch.log1p(torch.exp(torch.clamp(
        x, -ctx.attr("threshold", 40.0), ctx.attr("threshold", 40.0)))),
    "softshrink": lambda x, ctx: torch.where(
        x > ctx.attr("lambda", 0.5), x - ctx.attr("lambda", 0.5),
        torch.where(x < -ctx.attr("lambda", 0.5),
                    x + ctx.attr("lambda", 0.5), torch.zeros_like(x))),
    "hard_shrink": lambda x, ctx: torch.where(
        torch.abs(x) > ctx.attr("threshold", 0.5), x, torch.zeros_like(x)),
    "thresholded_relu": lambda x, ctx: torch.where(
        x > ctx.attr("threshold", 1.0), x, torch.zeros_like(x)),
    "hard_sigmoid": lambda x, ctx: torch.clamp(
        ctx.attr("slope", 0.2) * x + ctx.attr("offset", 0.5), 0.0, 1.0),
    "swish": lambda x, ctx: x * torch.sigmoid(ctx.attr("beta", 1.0) * x),
}

for _n, _f in _SIMPLE.items():
    _reg(_n, _f, with_attrs=False)
for _n, _f in _WITH_ATTRS.items():
    _reg(_n, _f, with_attrs=True)


@register_op("prelu", inputs=("X", "Alpha"), infer_shape=infer_same_shape)
def _prelu(ctx):
    x = ctx.input("X")
    alpha = unwrap(ctx.input("Alpha"))
    xd = unwrap(x)
    ctx.set_output("Out", rewrap(x, torch.where(xd >= 0, xd, alpha * xd)))
