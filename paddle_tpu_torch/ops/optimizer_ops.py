"""Optimizer update ops (``paddle_tpu/ops/optimizer_ops.py``): ``sgd``,
``momentum``, ``adam``, ``adamax``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``ftrl``, ``proximal_gd`` and
``proximal_adagrad``.  Each update is functional: it writes new tensors
for ParamOut and the accumulators, which the Executor sets back into the
scope after the run.

A ``SparseGrad`` (an ``is_sparse`` table's gradient) takes the sparse
branch of ``sgd`` (a scatter-add of the looked-up rows), ``momentum``,
``adam`` and ``adagrad`` (lazy row-wise updates of the distinct rows,
``sparse.rowwise_update``: rows the batch did not touch keep their value
and their state bit for bit).  The other ops read it densified
(``lod.unwrap``), as the JAX ops do."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import SkipInferShape, register_op
from paddle_tpu_torch.sparse import is_sparse_grad, rowwise_update


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


def _grad32(ctx):
    return unwrap(ctx.input("Grad")).float()


def _set(ctx, **outs):
    for slot, value in outs.items():
        ctx.set_output(slot, value)


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param"))
def _sgd(ctx):
    """p - lr g; a SparseGrad scatter-adds -lr g at its rows, duplicates
    accumulating (exact for SGD)."""
    p = unwrap(ctx.input("Param"))
    graw = ctx.input("Grad")
    lr = _lr(ctx).to(p.dtype)
    if is_sparse_grad(graw):
        ctx.set_output("ParamOut", p.index_add(
            0, graw.rows, -lr * graw.values.to(p.dtype)))
        return
    ctx.set_output("ParamOut", p - lr * unwrap(graw).to(p.dtype))


@register_op("momentum", inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param",
                                       VelocityOut="Velocity"))
def _momentum(ctx):
    """v' = mu * v + g; p' = p - lr * v' (Nesterov: p - (g + mu v') lr);
    a SparseGrad moves only its rows' velocities."""
    p = unwrap(ctx.input("Param"))
    graw = ctx.input("Grad")
    v = unwrap(ctx.input("Velocity"))
    mu = ctx.attr("mu", 0.9)
    lr = _lr(ctx).to(p.dtype)
    nesterov = ctx.attr("use_nesterov", False)

    def upd(p_rows, g_rows, v_rows):
        v_new = mu * v_rows + g_rows
        if nesterov:
            return p_rows - (g_rows + mu * v_new) * lr, v_new
        return p_rows - lr * v_new, v_new

    if is_sparse_grad(graw):
        p_new, v_new = rowwise_update(p, graw, upd, v)
    else:
        p_new, v_new = upd(p, unwrap(graw).to(p.dtype), v)
    _set(ctx, ParamOut=p_new, VelocityOut=v_new)


@register_op("adam",
             inputs=("Param", "Grad", "LearningRate", "Moment1", "Moment2",
                     "Beta1Pow", "Beta2Pow"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out"),
             stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", Moment1Out="Moment1",
                                       Moment2Out="Moment2"))
def _adam(ctx):
    """Moments in float32; the step lr * sqrt(1 - b2^t) / (1 - b1^t)
    takes the bias corrections from the Beta{1,2}Pow accumulators.  A
    SparseGrad advances only its rows' moments (lazy Adam)."""
    p = unwrap(ctx.input("Param"))
    m1 = unwrap(ctx.input("Moment1"))
    m2 = unwrap(ctx.input("Moment2"))
    b1p = unwrap(ctx.input("Beta1Pow")).reshape(())
    b2p = unwrap(ctx.input("Beta2Pow")).reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = _lr(ctx) * torch.sqrt(1 - b2p) / (1 - b1p)

    def upd(p_rows, g_rows, m1_rows, m2_rows):
        g = g_rows.float()
        m1n = b1 * m1_rows + (1 - b1) * g
        m2n = b2 * m2_rows + (1 - b2) * torch.square(g)
        return p_rows.float() - lr_t * m1n / (torch.sqrt(m2n) + eps), m1n, m2n

    graw = ctx.input("Grad")
    if is_sparse_grad(graw):
        p_new, m1n, m2n = rowwise_update(p, graw, upd, m1, m2)
    else:
        p_new, m1n, m2n = upd(p, unwrap(graw), m1, m2)
    _set(ctx, ParamOut=p_new.to(p.dtype), Moment1Out=m1n, Moment2Out=m2n)


@register_op("adamax",
             inputs=("Param", "Grad", "LearningRate", "Moment", "InfNorm",
                     "Beta1Pow"),
             outputs=("ParamOut", "MomentOut", "InfNormOut"),
             stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", MomentOut="Moment",
                                       InfNormOut="InfNorm"))
def _adamax(ctx):
    p = unwrap(ctx.input("Param"))
    g = _grad32(ctx)
    m = unwrap(ctx.input("Moment"))
    u = unwrap(ctx.input("InfNorm"))
    b1p = unwrap(ctx.input("Beta1Pow")).reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    u_new = torch.maximum(b2 * u, torch.abs(g))
    p_new = p.float() - (_lr(ctx) / (1 - b1p)) * m_new / (u_new + eps)
    _set(ctx, ParamOut=p_new.to(p.dtype), MomentOut=m_new, InfNormOut=u_new)


@register_op("adagrad", inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", MomentOut="Moment"))
def _adagrad(ctx):
    """m' = m + g^2, p' = p - lr g / (sqrt(m') + eps); a SparseGrad's
    duplicate rows are merged before this non-linear update."""
    p = unwrap(ctx.input("Param"))
    m = unwrap(ctx.input("Moment"))
    eps = ctx.attr("epsilon", 1e-6)
    lr = _lr(ctx)

    def upd(p_rows, g_rows, m_rows):
        g = g_rows.float()
        m_new = m_rows + torch.square(g)
        return p_rows.float() - lr * g / (torch.sqrt(m_new) + eps), m_new

    graw = ctx.input("Grad")
    if is_sparse_grad(graw):
        p_new, m_new = rowwise_update(p, graw, upd, m)
    else:
        p_new, m_new = upd(p, unwrap(graw), m)
    _set(ctx, ParamOut=p_new.to(p.dtype), MomentOut=m_new)


@register_op("decayed_adagrad",
             inputs=("Param", "Grad", "Moment", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", MomentOut="Moment"))
def _decayed_adagrad(ctx):
    p = unwrap(ctx.input("Param"))
    g = _grad32(ctx)
    m = unwrap(ctx.input("Moment"))
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * torch.square(g)
    p_new = p.float() - _lr(ctx) * g / (torch.sqrt(m_new) + eps)
    _set(ctx, ParamOut=p_new.to(p.dtype), MomentOut=m_new)


@register_op("adadelta",
             inputs=("Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"),
             outputs=("ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"),
             stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param",
                                       AvgSquaredGradOut="AvgSquaredGrad",
                                       AvgSquaredUpdateOut="AvgSquaredUpdate"))
def _adadelta(ctx):
    """No learning rate: the step is sqrt((E[dx^2] + eps) / (E[g^2] +
    eps)) g."""
    p = unwrap(ctx.input("Param"))
    g = _grad32(ctx)
    ag = unwrap(ctx.input("AvgSquaredGrad"))
    au = unwrap(ctx.input("AvgSquaredUpdate"))
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    ag_new = rho * ag + (1 - rho) * torch.square(g)
    update = -torch.sqrt((au + eps) / (ag_new + eps)) * g
    au_new = rho * au + (1 - rho) * torch.square(update)
    _set(ctx, ParamOut=(p.float() + update).to(p.dtype),
         AvgSquaredGradOut=ag_new, AvgSquaredUpdateOut=au_new)


@register_op("rmsprop",
             inputs=("Param", "MeanSquare", "LearningRate", "Grad", "Moment"),
             outputs=("ParamOut", "MomentOut", "MeanSquareOut"),
             stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", MomentOut="Moment",
                                       MeanSquareOut="MeanSquare"))
def _rmsprop(ctx):
    p = unwrap(ctx.input("Param"))
    g = _grad32(ctx)
    ms = unwrap(ctx.input("MeanSquare"))
    mom = unwrap(ctx.input("Moment"))
    eps = ctx.attr("epsilon", 1e-10)
    decay = ctx.attr("decay", 0.9)
    momentum = ctx.attr("momentum", 0.0)
    ms_new = decay * ms + (1 - decay) * torch.square(g)
    mom_new = momentum * mom + _lr(ctx) * g / torch.sqrt(ms_new + eps)
    _set(ctx, ParamOut=(p.float() - mom_new).to(p.dtype), MomentOut=mom_new,
         MeanSquareOut=ms_new)


@register_op("ftrl",
             inputs=("Param", "SquaredAccumulator", "LinearAccumulator",
                     "Grad", "LearningRate"),
             outputs=("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
             stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param",
                                       SquaredAccumOut="SquaredAccumulator",
                                       LinearAccumOut="LinearAccumulator"))
def _ftrl(ctx):
    param = unwrap(ctx.input("Param"))
    p = param.float()
    sq = unwrap(ctx.input("SquaredAccumulator"))
    lin = unwrap(ctx.input("LinearAccumulator"))
    g = _grad32(ctx)
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    lr = _lr(ctx)
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    pre = -torch.sign(new_lin) * torch.clamp(torch.abs(new_lin) - l1, min=0.0)
    denom = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    _set(ctx, ParamOut=(pre / denom).to(param.dtype), SquaredAccumOut=new_sq,
         LinearAccumOut=new_lin)


def _proximal(prox, lr, l1, l2):
    """The l1/l2 proximal step of ``prox`` at step size ``lr``."""
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param"))
def _proximal_gd(ctx):
    param = unwrap(ctx.input("Param"))
    lr = _lr(ctx)
    p_new = _proximal(param.float() - lr * _grad32(ctx), lr,
                      ctx.attr("l1", 0.0), ctx.attr("l2", 0.0))
    ctx.set_output("ParamOut", p_new.to(param.dtype))


@register_op("proximal_adagrad",
             inputs=("Param", "Moment", "Grad", "LearningRate"),
             outputs=("ParamOut", "MomentOut"), stop_gradient=True,
             infer_shape=_infer_update(ParamOut="Param", MomentOut="Moment"))
def _proximal_adagrad(ctx):
    param = unwrap(ctx.input("Param"))
    g = _grad32(ctx)
    m_new = unwrap(ctx.input("Moment")) + torch.square(g)
    lr_eff = _lr(ctx) / torch.sqrt(m_new)
    p_new = _proximal(param.float() - lr_eff * g, lr_eff,
                      ctx.attr("l1", 0.0), ctx.attr("l2", 0.0))
    _set(ctx, ParamOut=p_new.to(param.dtype), MomentOut=m_new)
