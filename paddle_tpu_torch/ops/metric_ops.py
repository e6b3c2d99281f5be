"""Metric ops of the training slice: ``top_k`` and ``accuracy``
(``paddle_tpu/ops/metric_ops.py:30/58``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import unwrap
from paddle_tpu_torch.registry import SkipInferShape, register_op


def _infer_top_k_shape(op, block):
    # Out/Indices: X with the last dim replaced by k
    ins = op.inputs.get("X", [])
    if len(ins) != 1 or not ins[0]:
        raise SkipInferShape
    xv = block.find_var(ins[0])
    if xv is None or xv.shape is None or not xv.shape:
        raise SkipInferShape
    shape = tuple(xv.shape[:-1]) + (int(op.attr("k", 1)),)
    for slot in ("Out", "Indices"):
        outs = op.outputs.get(slot, [])
        if len(outs) == 1 and outs[0]:
            ov = block.find_var(outs[0])
            if ov is not None and ov.shape is None:
                ov.shape = shape


@register_op("top_k", inputs=("X",), outputs=("Out", "Indices"),
             stop_gradient=True, infer_shape=_infer_top_k_shape)
def _top_k(ctx):
    x = unwrap(ctx.input("X"))
    vals, idx = torch.topk(x, ctx.attr("k", 1), dim=-1)
    ctx.set_output("Out", vals)
    ctx.set_output("Indices", idx.long())


def _infer_accuracy_shape(op, block):
    # Accuracy is the (1,) batch mean; Correct/Total are scalar counts
    hit = False
    for slot, shape in (("Accuracy", (1,)), ("Correct", ()), ("Total", ())):
        names = op.outputs.get(slot, [])
        if len(names) != 1 or not names[0]:
            continue
        v = block.find_var(names[0])
        if v is None:
            continue
        hit = True
        if v.shape is None:
            v.shape = shape
    if not hit:
        raise SkipInferShape


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"), stop_gradient=True,
             infer_shape=_infer_accuracy_shape)
def _accuracy(ctx):
    """Top-k accuracy from top_k's outputs: a row counts when its label
    is among its k indices."""
    idx = unwrap(ctx.input("Indices"))
    label = unwrap(ctx.input("Label")).to(idx.dtype)
    if label.ndim == 2 and label.shape[-1] == 1:
        label = label[:, :1]
    else:
        label = label.reshape(-1, 1)
    hit = torch.any(idx == label, dim=1)
    n = idx.shape[0]
    correct = torch.sum(hit.to(torch.int32)).to(torch.int32)
    ctx.set_output("Correct", correct)
    ctx.set_output("Total", torch.tensor(n, dtype=torch.int32,
                                         device=idx.device))
    ctx.set_output("Accuracy", (correct / n).float().reshape(1))
