"""Loss ops of the training slice: ``cross_entropy``
(``paddle_tpu/ops/loss_ops.py:86-98``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import rewrap, unwrap
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_rowwise(in_slot, out_slot):
    """``out_slot`` is a per-row (N, 1) loss column, N taken from the
    leading dim of ``in_slot``."""

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
