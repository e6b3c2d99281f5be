"""Optimizer update ops (``paddle_tpu/ops/optimizer_ops.py:44-140``):
dense ``sgd``, ``momentum`` and ``adam``.  Each update is functional: it
writes new tensors for ParamOut and the accumulators, which the
Executor sets back into the scope after the run.  The row-wise updates
of sparse gradients come with the sequences slice."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_update(**pairs):
    """Each output slot mirrors its paired input slot (``ParamOut=Param``,
    ``VelocityOut=Velocity``, ...)."""

    def infer(op, block):
        hit = False
        for out_slot, in_slot in pairs.items():
            ins = op.inputs.get(in_slot, [])
            outs = op.outputs.get(out_slot, [])
            if len(ins) != 1 or len(outs) != 1 or not ins[0] or not outs[0]:
                continue
            iv = block.find_var(ins[0])
            ov = block.find_var(outs[0])
            if iv is None or ov is None or iv.shape is None:
                continue
            hit = True
            if ov.shape is None:
                ov.shape = tuple(iv.shape)
        if not hit:
            raise SkipInferShape

    return infer


def _lr(ctx):
    return unwrap(ctx.input("LearningRate")).reshape(())


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param"))
def _sgd(ctx):
    p = unwrap(ctx.input("Param"))
    g = unwrap(ctx.input("Grad"))
    ctx.set_output("ParamOut", p - _lr(ctx).to(p.dtype) * g.to(p.dtype))


@register_op("momentum", inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param",
                                       VelocityOut="Velocity"))
def _momentum(ctx):
    """v' = mu * v + g; p' = p - lr * v' (Nesterov: p - (g + mu v') lr)."""
    p = unwrap(ctx.input("Param"))
    g = unwrap(ctx.input("Grad")).to(p.dtype)
    v = unwrap(ctx.input("Velocity"))
    mu = ctx.attr("mu", 0.9)
    lr = _lr(ctx).to(p.dtype)
    v_new = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    ctx.set_output("ParamOut", p_new)
    ctx.set_output("VelocityOut", v_new)


@register_op("adam",
             inputs=("Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out"),
             stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", Moment1Out="Moment1",
                                       Moment2Out="Moment2"))
def _adam(ctx):
    """Moments in float32; the step lr * sqrt(1 - b2^t) / (1 - b1^t)
    takes the bias corrections from the Beta{1,2}Pow accumulators."""
    p = unwrap(ctx.input("Param"))
    m1 = unwrap(ctx.input("Moment1"))
    m2 = unwrap(ctx.input("Moment2"))
    b1p = unwrap(ctx.input("Beta1Pow")).reshape(())
    b2p = unwrap(ctx.input("Beta2Pow")).reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p) / (1 - b1p)
    g = unwrap(ctx.input("Grad")).float()
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * torch.square(g)
    p_new = p.float() - lr_t * m1n / (torch.sqrt(m2n) + eps)
    ctx.set_output("ParamOut", p_new.to(p.dtype))
    ctx.set_output("Moment1Out", m1n)
    ctx.set_output("Moment2Out", m2n)
