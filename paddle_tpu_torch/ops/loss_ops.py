"""Loss ops: ``cross_entropy`` (``paddle_tpu/ops/loss_ops.py:86-98``) and
``softmax_with_cross_entropy`` (``:101-113``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import softmax as ksoftmax
from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.ops.common import grad_in, grad_out
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_rowwise(in_slot, out_slot, mirror=()):
    """``out_slot`` is a per-row (N, 1) loss column, N taken from the
    leading dim of ``in_slot``; any ``mirror`` outputs copy the input
    shape."""

    def infer(op, block):
        ins = op.inputs.get(in_slot, [])
        if not ins or not ins[0]:
            raise SkipInferShape
        xv = block.find_var(ins[0])
        if xv is None or xv.shape is None or not len(xv.shape):
            raise SkipInferShape
        outs = op.outputs.get(out_slot, [])
        if len(outs) != 1 or not outs[0]:
            raise SkipInferShape
        ov = block.find_var(outs[0])
        if ov is None:
            raise SkipInferShape
        if ov.shape is None:
            ov.shape = (xv.shape[0], 1)
        for slot in mirror:
            m_outs = op.outputs.get(slot, [])
            if len(m_outs) != 1 or not m_outs[0]:
                continue
            mv = block.find_var(m_outs[0])
            if mv is not None and mv.shape is None:
                mv.shape = tuple(xv.shape)

    return infer


def _take_label_prob(x, label):
    """x: (N, D) probabilities; label: (N, 1) or (N,) ints -> (N, 1)."""
    lab = label.long()
    if lab.ndim == 2 and lab.shape[-1] == 1:
        lab = lab[:, 0]
    return torch.take_along_dim(x, lab[:, None], dim=1)


@register_op("cross_entropy", inputs=("X", "Label"), outputs=("Y",),
             diff_inputs=("X",), infer_shape=_infer_rowwise("X", "Y"))
def _cross_entropy(ctx):
    """-log(p[label] + 1e-12) over a probability input, in float32;
    with ``soft_label``, -sum(label * log(p + 1e-12))."""
    x = unwrap(ctx.input("X")).float()
    label = unwrap(ctx.input("Label"))
    eps = 1e-12
    if ctx.attr("soft_label", False):
        y = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        y = -torch.log(_take_label_prob(x, label) + eps)
    ctx.set_output("Y", rewrap(ctx.input("X"), y))


def _softmax_with_cross_entropy_grad(ctx):
    """dLogits = (Softmax - onehot(label)) * dLoss from the Softmax the
    forward left (with ``soft_label``, Softmax * sum(label) - label), plus
    Softmax's own cotangent through the softmax where one reached it.
    The generic replay would recompute the (N, V) log_softmax and hold
    its autograd graph (1 GB each at the transformer's 8192 x 32768);
    XLA's CSE removes that replay in the JAX package."""
    name = grad_out(ctx, "Logits@GRAD")
    if name is None:
        return
    logits = unwrap(ctx.input("Logits"))
    s = unwrap(ctx.input("Softmax"))
    label = unwrap(ctx.input("Label"))
    dloss = grad_in(ctx, "Loss@GRAD")
    g = torch.zeros_like(s)
    if dloss is not None:
        dloss = unwrap(dloss).float()
        if ctx.op.attr("__fwd_attrs__").get("soft_label", False):
            lab = label.float()
            g = (s * lab.sum(-1, keepdim=True) - lab) * dloss
        else:
            g = s * dloss
            lab = label.long().reshape(-1, 1)
            g.scatter_add_(1, lab, -dloss.reshape(-1, 1))
    dsoft = grad_in(ctx, "Softmax@GRAD")
    if dsoft is not None:
        g = g + ksoftmax.softmax_backward(s, unwrap(dsoft).float())
    ctx.values[name] = g.to(logits.dtype)


@register_op("softmax_with_cross_entropy", inputs=("Logits", "Label"),
             outputs=("Softmax", "Loss"), diff_inputs=("Logits",),
             infer_shape=_infer_rowwise("Logits", "Loss",
                                        mirror=("Softmax",)),
             grad_lower=_softmax_with_cross_entropy_grad)
def _softmax_with_cross_entropy(ctx):
    """log_softmax in float32: Softmax = exp(logp), Loss = -logp[label]
    (with ``soft_label``, -sum(label * logp)), both float32."""
    logits = unwrap(ctx.input("Logits")).float()
    label = unwrap(ctx.input("Label"))
    logp = torch.log_softmax(logits, dim=-1)
    if ctx.attr("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -_take_label_prob(logp, label)
    ctx.set_output("Loss", loss)
    ctx.set_output("Softmax", logp.exp_())
