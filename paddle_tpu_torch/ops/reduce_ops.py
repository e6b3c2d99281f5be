"""Reduce ops (``paddle_tpu/ops/reduce_ops.py``): ``mean`` and
``reduce_sum``, ``reduce_mean``, ``reduce_max``, ``reduce_min`` with
``dim``, ``keep_dim`` and ``reduce_all``, and ``l1_norm``.  Their
gradients are the generic replay."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.ops.common import absolute
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _reduce_io_vars(op, block):
    xs, outs = op.input("X"), op.output("Out")
    if len(xs) != 1 or len(outs) != 1 or not xs[0] or not outs[0]:
        raise SkipInferShape
    xv, ov = block.find_var(xs[0]), block.find_var(outs[0])
    if xv is None or ov is None or xv.shape is None:
        raise SkipInferShape
    return xv, ov


def _infer_scalar_shape(op, block):
    """mean collapses X to a rank-0 scalar."""
    _, ov = _reduce_io_vars(op, block)
    if ov.shape is None:
        ov.shape = ()


def _infer_reduce_shape(op, block):
    """reduce_{sum,mean,max,min}: drop (or keep as 1) the reduced dim,
    mirroring the lowering's axis semantics."""
    xv, ov = _reduce_io_vars(op, block)
    if ov.shape is not None:
        return
    keep = op.attr("keep_dim", False)
    if op.attr("reduce_all", False):
        ov.shape = (1,) * len(xv.shape) if keep else ()
        return
    dim = op.attr("dim", 0)
    if not isinstance(dim, int):
        raise SkipInferShape
    ndim = len(xv.shape)
    if not -ndim <= dim < ndim:
        raise ValueError(f"dim {dim} out of range for shape {xv.shape}")
    dim %= ndim
    shape = list(xv.shape)
    if keep:
        shape[dim] = 1
    else:
        del shape[dim]
    ov.shape = tuple(shape)


@register_op("mean", inputs=("X",), infer_shape=_infer_scalar_shape)
def _mean(ctx):
    x = unwrap(ctx.input("X"))
    ctx.set_output("Out", x.mean().reshape(()))


def _reg_reduce(name, fn):
    @register_op(name, inputs=("X",), infer_shape=_infer_reduce_shape)
    def _red(ctx):
        x = unwrap(ctx.input("X"))
        keep = ctx.attr("keep_dim", False)
        if ctx.attr("reduce_all", False):
            out = fn(x, dim=tuple(range(x.ndim)))
            ctx.set_output("Out", out.reshape((1,) * x.ndim) if keep else out)
            return
        ctx.set_output("Out", fn(x, dim=ctx.attr("dim", 0), keepdim=keep))


for _n, _f in [
    ("reduce_sum", torch.sum),
    ("reduce_mean", torch.mean),
    ("reduce_max", torch.amax),
    ("reduce_min", torch.amin),
]:
    _reg_reduce(_n, _f)


@register_op("l1_norm", inputs=("X",), infer_shape=_infer_scalar_shape)
def _l1_norm(ctx):
    """sum |x|, a rank-0 scalar; |x| with gradient 1 at 0, as ``jnp.abs``."""
    x = unwrap(ctx.input("X"))
    ctx.set_output("Out", torch.sum(absolute(x)).reshape(()))
