"""Reduce ops of the training slice: ``mean``
(``paddle_tpu/ops/reduce_ops.py:54``)."""

from __future__ import annotations

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_scalar_shape(op, block):
    """mean collapses X to a rank-0 scalar."""
    xs, outs = op.input("X"), op.output("Out")
    if len(xs) != 1 or len(outs) != 1 or not xs[0] or not outs[0]:
        raise SkipInferShape
    xv, ov = block.find_var(xs[0]), block.find_var(outs[0])
    if xv is None or ov is None or xv.shape is None:
        raise SkipInferShape
    if ov.shape is None:
        ov.shape = ()


@register_op("mean", inputs=("X",), infer_shape=_infer_scalar_shape)
def _mean(ctx):
    x = unwrap(ctx.input("X"))
    ctx.set_output("Out", x.mean().reshape(()))
