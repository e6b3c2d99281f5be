"""Metric ops (``paddle_tpu/ops/metric_ops.py``): ``top_k``,
``accuracy``, ``auc``, ``chunk_eval`` and ``positive_negative_pair``.
``chunk_eval`` keeps the JAX op's formulation: boundary masks of both
taggings and a min over each inferred chunk, no host-side span lists."""

from __future__ import annotations

import torch

from paddle_tpu_torch.lod import LoDArray, row_segment_ids, unwrap
from paddle_tpu_torch.ops.common import top_k
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
    vals, idx = top_k(unwrap(ctx.input("X")), ctx.attr("k", 1))
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


@register_op("auc", inputs=("Out", "Indices", "Label"), outputs=("AUC",),
             stop_gradient=True)
def _auc(ctx):
    """One batch's ROC AUC by the trapezoid rule over ``num_thresholds``
    evenly spaced thresholds in [0, 1] of the positive class's score."""
    probs = unwrap(ctx.input("Out"))
    label = unwrap(ctx.input("Label")).reshape(-1)
    score = probs[:, -1] if probs.ndim == 2 else probs.reshape(-1)
    thr = torch.linspace(0.0, 1.0, ctx.attr("num_thresholds", 200),
                         device=score.device)
    pred = score[None, :] >= thr[:, None]
    pos = (label > 0)[None, :]
    tp = torch.sum(pred & pos, dim=1).float()
    fp = torch.sum(pred & ~pos, dim=1).float()
    tpr = tp / torch.clamp(pos.sum(), min=1)
    fpr = fp / torch.clamp((~pos).sum(), min=1)
    ctx.set_output("AUC", (-torch.trapezoid(tpr, fpr)).reshape(1))


_TAGS_PER_TYPE = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _chunk_masks(tags, first, last, scheme, n_tag, outside):
    """(inside, type, starts, ends) of a tag sequence under a scheme, as
    ``paddle_tpu/ops/metric_ops.py:138-171`` derives them."""
    minus2 = tags.new_full((1,), -2)
    inside = tags < outside
    ttype = torch.where(inside, tags // n_tag, -1)
    tpos = torch.where(inside, tags % n_tag, -1)
    prev = torch.cat([minus2, tags[:-1]])
    prev_type = torch.where(prev >= 0, prev // n_tag, -1)
    prev_in = (prev >= 0) & (prev < outside)
    nxt = torch.cat([tags[1:], minus2])
    nxt_type = torch.where(nxt >= 0, nxt // n_tag, -1)
    nxt_in = (nxt >= 0) & (nxt < outside)
    if scheme == "IOB":        # tag 0 = B, 1 = I
        start = inside & ((tpos == 0) | first | ~prev_in
                          | (prev_type != ttype))
        end = inside & (last | ~nxt_in | (nxt_type != ttype)
                        | (nxt % n_tag == 0))
    elif scheme == "IOE":      # tag 0 = I, 1 = E
        start = inside & (first | ~prev_in | (prev_type != ttype)
                          | (prev % n_tag == 1))
        end = inside & ((tpos == 1) | last | ~nxt_in | (nxt_type != ttype))
    elif scheme == "IOBES":    # 0 = B, 1 = I, 2 = E, 3 = S
        start = inside & ((tpos == 0) | (tpos == 3))
        end = inside & ((tpos == 2) | (tpos == 3))
    else:                      # plain: every maximal same-type run
        start = inside & (first | (prev != tags))
        end = inside & (last | (nxt != tags))
    return inside, ttype, start, end


def chunk_counts(inf, lab, seq_id, scheme, num_types):
    """(inferred, labelled, correct) chunk counts of flat tag rows ``inf``
    and ``lab`` (int64) whose sequence ids are ``seq_id``: a predicted
    chunk is correct where the labels start a chunk of its type at its
    start, equal its tags throughout and end one at its end."""
    n = inf.shape[0]
    n_tag = _TAGS_PER_TYPE[scheme]
    outside = num_types * n_tag
    true1 = torch.ones(1, dtype=torch.bool, device=inf.device)
    cut = seq_id[1:] != seq_id[:-1]
    first, last = torch.cat([true1, cut]), torch.cat([cut, true1])
    inf_in, inf_type, inf_start, inf_end = _chunk_masks(
        inf, first, last, scheme, n_tag, outside)
    _, lab_type, lab_start, lab_end = _chunk_masks(
        lab, first, last, scheme, n_tag, outside)
    chunk_id = torch.cumsum(inf_start.long(), 0) - 1
    in_chunk = inf_in & (chunk_id >= 0)
    seg = chunk_id.clamp(min=0)

    def seg_all(v):
        # min over each inferred chunk of v where it lies in the chunk
        v = torch.where(in_chunk, v, True).long()
        return torch.ones(n, dtype=torch.long, device=inf.device) \
            .scatter_reduce(0, seg, v, "amin")

    all_eq = seg_all(inf == lab)
    end_ok = seg_all(torch.where(inf_end, lab_end, True))
    per_start = inf_start & lab_start & (inf_type == lab_type)
    correct = per_start & ((all_eq * end_ok)[seg] > 0)
    return inf_start.sum(), lab_start.sum(), correct.sum()


@register_op("chunk_eval", inputs=("Inference", "Label"),
             outputs=("Precision", "Recall", "F1-Score", "NumInferChunks",
                      "NumLabelChunks", "NumCorrectChunks"),
             stop_gradient=True)
def _chunk_eval(ctx):
    """Chunk precision, recall and F1 of a tagging under IOB, IOE, IOBES
    or plain.  A LoD input's sequences are scored apart; a padded input
    counts as one sequence (its rows run on), as the JAX op has it.
    ``excluded_chunk_types`` is read by neither package."""
    x = ctx.input("Inference")
    inf = unwrap(x).long().reshape(-1)
    lab = unwrap(ctx.input("Label")).long().reshape(-1)
    if isinstance(x, LoDArray):
        seq_id = row_segment_ids(x.last_level(), inf.shape[0])
    else:
        seq_id = torch.zeros_like(inf)
    n_inf, n_lab, n_cor = chunk_counts(
        inf, lab, seq_id, ctx.attr("chunk_scheme", "IOB"),
        int(ctx.attr("num_chunk_types", 1)))
    p = n_cor / torch.clamp(n_inf, min=1)
    r = n_cor / torch.clamp(n_lab, min=1)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-12)
    for slot, v in (("Precision", p), ("Recall", r), ("F1-Score", f1)):
        ctx.set_output(slot, v.float().reshape(1))
    for slot, v in (("NumInferChunks", n_inf), ("NumLabelChunks", n_lab),
                    ("NumCorrectChunks", n_cor)):
        ctx.set_output(slot, v.long().reshape(1))


@register_op("positive_negative_pair", inputs=("Score", "Label", "QueryID"),
             outputs=("PositivePair", "NegativePair", "NeutralPair"),
             stop_gradient=True)
def _positive_negative_pair(ctx):
    """Over the pairs i < j of one query with different labels: positive
    where the scores order them as the labels do, neutral on a score tie,
    negative otherwise; counted a block of rows at a time (memory
    O(block n))."""
    score = unwrap(ctx.input("Score")).reshape(-1)
    label = unwrap(ctx.input("Label")).reshape(-1).to(score.dtype)
    qid = unwrap(ctx.input("QueryID")).reshape(-1)
    n = score.shape[0]
    cols = torch.arange(n, device=score.device)
    pos = neu = tot = 0
    for r0 in range(0, n, 1024):
        rows = cols[r0:r0 + 1024]
        valid = ((qid[rows, None] == qid[None, :])
                 & (rows[:, None] < cols[None, :])
                 & (label[rows, None] != label[None, :]))
        s_cmp = torch.sign(score[rows, None] - score[None, :])
        l_cmp = torch.sign(label[rows, None] - label[None, :])
        pos = pos + torch.sum(valid & (s_cmp == l_cmp) & (s_cmp != 0))
        neu = neu + torch.sum(valid & (s_cmp == 0))
        tot = tot + torch.sum(valid)
    for slot, v in (("PositivePair", pos), ("NegativePair", tot - pos - neu),
                    ("NeutralPair", neu)):
        ctx.set_output(slot, torch.as_tensor(v, device=score.device)
                       .float().reshape(1))
